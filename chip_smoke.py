"""Proof that the PyTorch port runs on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version at the shapes of the main
path and at edge cases, times kernel, plain version and a PyTorch library
call beside the roofline bound, then drives the main path through the
public entry points: ``LVLM.generate`` and a chunked ``LVLM.serve`` on
qwen2-vl at smoke size (card against CPU, float32) and at the full
published width (bfloat16, random weights from seed 0). The
``compression`` phases hold every visual-token compressor on the card
against the CPU at full width, serve a batch that mixes eight
compression strategies through both kernels at their compressed prefill
lengths, and compare the mixed batch's greedy tokens card against CPU on
the smoke config. The KV-cache phases hold the paged kernel's masked mode
(windowed and compacted caches) against its plain version and time it,
serve a compacting engine (per-request KV budgets) and a prefix-cache
engine at full width, and compare both engines, every KV selector and a
block-allocated paged pool card against CPU on the smoke config. The
cluster phases serve ``LVLM.serve_cluster`` (prefill / decode roles
with KV migrated between replicas on the card, drain, the shared prefix
tier) and the SLO-adaptive controller, card against CPU on the smoke
config and at full width, and run the ``repro_torch.launch.serve`` CLI.
The architecture phases hold both kernels at head dim 192 (flash's
two-warpgroup kernel also on the edges of its 128-row items, v 192 and
128 wide) and at 48 q heads per kv head, compare granite, mistral,
nemotron and arctic smoke
card against CPU, and serve each of the four at full published width
(cut in depth to fit the card). The MLA phases hold the latent kernel
(deepseek-v3's absorbed decode; the bf16 full-width instantiation on
the tensor cores) against its plain version at both of its
instantiations, flash at MLA's prefill shapes with an explicit scale (v
at its own 128 as the prefill passes it, and padded to 192) and every
earlier flash shape's output bits, compare deepseek-v3 smoke card
against CPU through every serving path (a latent-cache migration
included), and serve deepseek-v3-671b at full width, cut to 4 of its 61
layers. The family phases hold both kernels at the shapes and modes
the ssm, hybrid, perceiver-vlm and audio families add (flash's window
and non-causal modes, the paged kernel's masked mode at head dim 64 and
over whisper's cross cache), compare rwkv6, zamba2, the perceiver vlm
and whisper smoke card against CPU, and serve the four at full published
width (depth uncut, but rwkv6's, cut to 8 of 32 layers). The training
phases hold the flash backward kernel against its plain version on both
of its routes (bf16 on the tensor cores -- at head dim 192, MLA's and
nemotron's, over two consumer warpgroups -- float32 on FMAs), check that
two launches give the same bits, and time it beside the backward of
``scaled_dot_product_attention``, train every smoke config 3 steps card
against CPU, train deepseek-v3-671b at full width cut to its 3 dense
layers (3 steps of 2 x 1024 tokens: MLA's flash backward at head dim
192 on the card's main training path), and train qwen2-vl-2b at full
width, 14 of its 28 layers (bf16, remat, batch 4 of 1024 visual + 64
text tokens) 10 steps through ``train_loop`` with a checkpoint at step 5
and a resume from it, then run the training CLI. The sharding phases run
``launch.steps``' train, prefill and serve steps of qwen2-vl-2b at full
width on a 1x1 DTensor mesh over the card (every kernel under
``local_map``), each against the same step without a mesh, with its wall,
busy, roofline share and MFU, and join the dry run of qwen2-vl-2b on the
two production meshes (a subprocess on the host's CPU, started before
the training phases). Right after the build, the ``analysis`` phase
runs the port's static analyzer (``repro_torch.analysis``) over the
checkout and holds its kernel-binding tables (admitted shapes, argtypes
lengths) to the libraries just built. Each phase prints one JSON line; the
last two lines are the kernel summary and ``{"ok": true, "device":
{...}}``. Any failure raises and exits non-zero before that line.
Needs one CUDA device of compute capability 9.0.

    python3 chip_smoke.py --mla-split-sweep
    python3 chip_smoke.py --bwd-split-sweep
    python3 chip_smoke.py --flash-fwd-compare

time the latent kernel's tensor-core route at split counts around the
wrapper's choice (``mla_split_sweep``), the flash backward's head-dim-192
cases at every count of q-head groups (``bwd_split_sweep``), or the flash
forward at the kernel table's bf16 shapes in whatever checkout the script
sits in (``flash_fwd_compare``: copied into an older checkout, it times
that one's kernel), instead.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))
from repro_torch.roofline.hw import H100_SXM  # noqa: E402 (fails outside a checkout)

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_FLOPS = {torch.bfloat16: H100_SXM.peak_flops_bf16,
              torch.float32: H100_SXM.peak_flops_f32}
# float32 kernels repeat the plain arithmetic up to summation order; the
# bfloat16 flash kernel rounds its probabilities to bf16 for the
# tensor-core product, and both round the output to bf16 (one bf16 ulp
# at |x| ~ 2 is 1.6e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SMOKE_LOGIT_TOL = 1e-3          # card vs CPU, float32 smoke model
# compressed embeddings card vs CPU (float32): gathers are exact, the
# merges' scatter-adds sum in another order on the card (atomics)
COMP_TOL = 1e-5
# one request per strategy in the mixed-compression serve
MIX = ("none", "fastv-0.5", "sparsevlm-0.5", "l2-0.5", "divprune-0.5",
       "cdpruner-0.5", "tome-0.5", "framefusion-0.25")
# its text prompt and new tokens per request, and its slot cache length
# (LVLM._cache_len of 1024 visual + 32 text + 32 new tokens)
SERVE_TEXT, SERVE_NEW, SERVE_CACHE_LEN = 32, 32, 1104
# one request per strategy in the compacting serve (default streaming-kv-256):
# four KV budgets over two selectors, no compaction, encoder-side pruners
KV_MIX = ("streaming-kv-256", "l2-kv-256", "none", "fastv-0.5",
          "streaming-kv-512", "l2-kv-128", "sparsevlm-0.5", "tome-0.5")
KV_CACHE_LEN, KV_BUDGET = 1152, 256
# speculative decoding: draft tokens per round, and the verify's query
# tokens per request (the committed token + gamma drafts)
GAMMA = 4
VERIFY_S = GAMMA + 1
#: The speculative decoder's draft pool: ``SpeculativeDecoder._bind`` sizes
#: it at cache_len + gamma + 8 rows, so ``_paged_view`` pages it by 4 tokens;
#: its last row is the draft's scratch slot.
DRAFT_CACHE_LEN, DRAFT_PAGE = SERVE_CACHE_LEN + GAMMA + 8, 4
#: The multi-query mode's limit on err / max|ref| per edge (besides TOL):
#: in bf16 one ulp of the largest output is 2^-7 = 7.8e-3 of it. A verify
#: that drops each query's own key (t < q_pos for t <= q_pos) moves the
#: serve-shaped outputs by 0.07-0.56 of their scale, so the limit sees it.
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: Verify shapes whose output bits the multi-query mode's row tiles must
#: not change (S * G <= 64 keeps one row tile): the serve's batch-8
#: verify at S = 5 and S = 1, inputs from BITS_SEED through ``_mq_case``.
BITS_SEED = 5
BITS_CASES = {
    "serve_b8_s5": dict(s=VERIFY_S, starts=[1056, 1060, 1063, 1070, 1075,
                                            1080, 1083, SERVE_CACHE_LEN - 1]),
    "serve_b8_s1": dict(s=1, starts=[1056, 1060, 1063, 1070, 1075, 1080,
                                     1083, SERVE_CACHE_LEN - 1]),
}
#: sha256 of those outputs' bytes from the kernel as it was before row
#: tiles were added (read on an NVIDIA H100 80GB HBM3)
BITS_SHA = {
    "serve_b8_s5/float32":
        "b3b61961d10ecb9a8e5ea918e1da9e29bef7c2d4fefc1eccf5e8270451d950d5",
    "serve_b8_s1/float32":
        "468747aa4eeb34a72a285ca65c5f5983197490c661573862edd8f6210e1aa614",
    "serve_b8_s5/bfloat16":
        "0ead15c29905f2ef1cc9dee1d99775c953e3d572bb76df9de87ed928bbc0c71a",
    "serve_b8_s1/bfloat16":
        "0fec139e5906004c61b97c6b0e4551acc96ce58ed92b450ece3bcaa7aabb8f23",
}
#: sha256 (first 16 hex digits) of the flash kernel's outputs on
#: ``_flash_bits_cases`` at the default scale, from the kernel as it was
#: before its ``scale=`` argument existed (read on an NVIDIA H100 80GB HBM3)
FLASH_BITS_SHA = {
    "d128/main/float32": "2665a0c2af374a3b",
    "d128/prefill_0.5/float32": "2e597b0cbf76e292",
    "d128/prefill_0.25/float32": "ef9e7b4d227cf349",
    "d128/sq_not_tile_multiple/float32": "b5f16d78d3213f28",
    "d128/kv_len_lt_sk/float32": "41c4ca7e938703d5",
    "d128/q_offset/float32": "998c305080778e36",
    "d128/window/float32": "5573a9dd6379536c",
    "d128/head_dim_64/float32": "da2f9fec41e958e1",
    "d128/keyless_rows/float32": "19933a32c2c96a3e",
    "d128/sq_sk_2048/float32": "011075fdc711a593",
    "d128/strided_views/float32": "05d5bca0b536f657",
    "d32/main/float32": "db1691da3d9e3a00",
    "d32/window_64/float32": "2f5973209cd1b44f",
    "d32/kv_len_lt_sk/float32": "06495d8fe4911430",
    "d32/keyless_rows/float32": "8191e3e61bbfcea3",
    "d32/non_causal/float32": "73544a6909ad274b",
    "d192/main/float32": "c43d8c23bb8375d5",
    "g48/main/float32": "5ef9195579fd8b67",
    "g48/window/float32": "5096cce3d8a70d49",
    "d128/main/bfloat16": "2c90a83209044845",
    "d128/prefill_0.5/bfloat16": "4ff29f841e97d0a0",
    "d128/prefill_0.25/bfloat16": "b46af49fa405f92c",
    "d128/sq_not_tile_multiple/bfloat16": "646dc1cbfc4e5d68",
    "d128/kv_len_lt_sk/bfloat16": "c534a361bb0681f8",
    "d128/q_offset/bfloat16": "2b2b4f9e647286b2",
    "d128/window/bfloat16": "bfc9f280ece59a03",
    "d128/head_dim_64/bfloat16": "ecd631660a623227",
    "d128/keyless_rows/bfloat16": "f20a6c7ed382ff01",
    "d128/sq_sk_2048/bfloat16": "10c5a017f11f66f1",
    "d128/strided_views/bfloat16": "7dbc5af1b9d4b2c1",
    "d32/main/bfloat16": "36bcd4a18dafc0f3",
    "d32/window_64/bfloat16": "83e22c84e0ebdc7c",
    "d32/kv_len_lt_sk/bfloat16": "d36ce14319f9cdf2",
    "d32/keyless_rows/bfloat16": "1359ab4c91a6576c",
    "d32/non_causal/bfloat16": "792a2bc7069728ee",
    "d192/main/bfloat16": "0be08a9c95d21ff3",
    "g48/main/bfloat16": "440b6fba41f519e6",
    "g48/window/bfloat16": "8e0bc62220c72257",
}

#: the disaggregation phases' traffic (``disagg_burst`` of
#: ``benchmarks/bench_serving.py``): a chat cohort of 16 requests (8-24
#: text tokens from numpy seed 34, 16 new tokens, Poisson arrivals at
#: 2000 req/s from seed 33) and, at the 5th chat arrival, a burst of 3
#: requests 0.5 ms apart with 4 new tokens each
CHAT_N, CHAT_NEW, CHAT_RATE, BURST_N, BURST_NEW = 16, 16, 2000.0, 3, 4
#: full-width cluster slots: 1024 visual + 32 text + 4 new fit, and the
#: modeled KV link carries bf16 K and V of 28 layers x 2 kv heads x 128
CLUSTER_CACHE_LEN, CLUSTER_CHUNK = 1152, 256
KV_BYTES_PER_TOKEN = 28 * 2 * 2 * 128 * 2
#: the prefix-affinity smoke's shared prefix: its first 16-token block
#: consistent-hashes to replica 1 (crc32 mod 2), so the first request
#: publishes it there
PREFIX_SEED = 40


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``t`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T_START,
                      **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, flush: torch.Tensor, n: int = 20, reps: int = 3) -> float:
    """Device time of one ``fn`` with the 50 MB L2 flushed before it (the
    main path meets its K/V cold: 28 layers of cache do not fit L2).

    Two loops, flush+fn and flush alone, each ``n`` times, are captured as
    CUDA graphs and replayed between CUDA events, in turns, ``reps`` times;
    the difference of the fastest replays over ``n`` is fn's time. Graph
    replay keeps the host's enqueue time out of the reading: a wrapper's
    Python takes longer than a small kernel runs, and timed eagerly the
    card would wait on the host."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)

    def replay(g) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    best = [float("inf")] * 2
    for _ in range(reps):
        for i, g in enumerate(graphs):
            best[i] = min(best[i], replay(g))
    return (best[0] - best[1]) / n


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def randn(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to("cuda", dtype)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


# ---------------------------------------------------------------- phases --

def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit("env", nvidia_smi=smi, device=name, capability=list(cap),
         torch=torch.__version__, cuda=torch.version.cuda,
         device_count=torch.cuda.device_count())
    check(cap == (9, 0), f"needs compute capability 9.0, found {cap}")
    # float32 products in full float32 (the card check is tight)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"smi": smi, "name": name}


def _ptxas_report(log: str) -> list:
    """Per kernel instantiation, what ``ptxas -v`` said: registers,
    spills and static shared memory."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"entry": ln.split("'")[1]}
            out.append(cur)
        elif cur is not None and "spill" in ln:
            cur["spills"] = ln.strip()
        elif cur is not None and "Used" in ln:
            cur["used"] = ln.split(": ", 1)[1].strip()
    return out


def phase_build() -> dict:
    """Build the four kernels from the checkout's sources (one nvcc each,
    in parallel); print ptxas's registers and spills, each kernel's
    dynamic shared memory (per head dim -- the flash forward's per (q/k,
    v) head dims; the latent kernel's per latent rank) and the count of
    HGMMA (wgmma) instructions in the flash library's SASS, which must not
    be 0; the flash forward's two-warpgroup kernels at D 192 (v 192 and
    128) and the flash backward's D 192 kernels have HGMMA and no spills,
    and the backward's wgmma route has HGMMA at every bf16 head dim."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    res = build.build_all()
    seconds = time.perf_counter() - t0
    smem = {}
    for name in build.KERNELS:
        fn = getattr(build.load(name), f"{name}_smem_bytes")
        if name == "flash_attention":
            smem[name] = {f"{dt}/d{d}_v{dv}": fn(code, d, dv)
                          for dt, code in (("float32", 0), ("bfloat16", 1))
                          for d, dv in fa.HEAD_DIM_PAIRS}
            continue
        dims = (32, 512) if name == "mla_attention" else (32, 64, 128, 192)
        smem[name] = {f"{dt}/d{d}": fn(code, d)
                      for dt, code in (("float32", 0), ("bfloat16", 1))
                      for d in dims}
    hgmma = _hgmma_count("flash_attention")
    wide = _flash_wide(res["flash_attention"]["log"])
    routes = _mla_routes(res["mla_attention"]["log"])
    bwd_routes = _bwd_routes(res["flash_attention_bwd"]["log"])
    emit("build", seconds=seconds, flash_sass_hgmma=hgmma,
         flash_wide=wide, flash_bwd_routes=bwd_routes,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "dynamic_smem_bytes": smem[k],
                      "ptxas": _ptxas_report(v["log"]),
                      "warnings": [ln.strip() for ln in v["log"].splitlines()
                                   if "warning" in ln.lower()
                                   or "Performance Loss" in ln]}
                  for k, v in res.items()}, mla_routes=routes)
    check(hgmma > 0, "the flash library's SASS has no HGMMA instruction")
    check(all(r["ptxas"] is not None and r["hgmma"] > 0
              and " 0 bytes spill stores" in r["ptxas"]["spills"]
              for r in wide.values()),
          f"flash forward D 192 kernels spill, lack HGMMA or are missing: "
          f"{wide}")
    check(routes["bfloat16/R512"]["route"] == "wgmma"
          and routes["bfloat16/R512"]["hgmma"] > 0
          and all(r["route"] == "fma" for k, r in routes.items()
                  if k != "bfloat16/R512"),
          f"latent kernel routes: {routes}")
    check(all((r["route"] == "wgmma") == (r["hgmma"] > 0)
              for r in bwd_routes.values()),
          f"flash backward routes: {bwd_routes}")
    d192 = bwd_routes["bfloat16/d192"]["ptxas"]
    check(all(e is not None and " 0 bytes spill stores" in e["spills"]
              for e in d192.values()),
          f"flash backward D 192 wgmma kernels spill or are missing: {d192}")
    return res


#: a head dim / latent rank that no wrapper admits and no library
#: instantiates: every ``<lib>_smem_bytes`` must answer -1 for it
ANALYSIS_OUTSIDE = 96


def phase_analysis() -> None:
    """The port's static analyzer (``repro_torch.analysis``) over the
    checkout on the card's host: 0 findings. Then the K-rules' static
    reading against the libraries ``build`` just compiled: for every
    (dtype, head dim or latent rank) a wrapper admits, the loaded
    library's ``<lib>_smem_bytes`` is positive; for ``ANALYSIS_OUTSIDE``
    it is -1; and each wrapper's bound ``argtypes`` has the length that
    K001 folded from its source, which is the C definition's parameter
    count. A library whose ``<lib>_smem_bytes`` takes two shape values
    (the flash forward's (q/k, v) head dims) is read at admitted pairs and
    at (ANALYSIS_OUTSIDE, ANALYSIS_OUTSIDE). Mirrors how the sanitizer
    confirms the R-rules at run time."""
    import ctypes
    import importlib
    from repro_torch.analysis import RULE_FAMILIES, run_analysis
    from repro_torch.analysis.rules_kernels import binding_table
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    report = run_analysis(root=root)
    lint_s = time.perf_counter() - t0
    by_family = {fam: sum(f.rule.startswith(fam) for f in report.findings)
                 for fam in RULE_FAMILIES}
    check(report.ok, "repro_torch.analysis findings:\n" + report.render())
    rows = binding_table(root)
    check(sorted(r["lib"] for r in rows) == sorted(build.KERNELS),
          f"bindings {[r['lib'] for r in rows]} != {build.KERNELS}")
    bindings = {}
    for r in rows:
        smem = getattr(build.load(r["lib"]), r["lib"] + "_smem_bytes")
        # one value a shape, or a (q/k, v) pair of head dims
        pairs = isinstance(r["admitted"][0], tuple)
        smem.argtypes = [ctypes.c_int] * (3 if pairs else 2)
        smem.restype = ctypes.c_int
        outside = (ANALYSIS_OUTSIDE,) * 2 if pairs else ANALYSIS_OUTSIDE
        got = {f"{dt}/{x}".replace(" ", ""):
               smem(code, *(x if pairs else (x,)))
               for dt, code in (("float32", 0), ("bfloat16", 1))
               for x in r["admitted"] + [outside]}
        bad = {k: v for k, v in got.items()
               if (v != -1 if k.endswith(f"/{outside}".replace(" ", ""))
                   else v <= 0)}
        check(not bad, f"{r['lib']}_smem_bytes disagrees with the admitted "
                       f"shapes {r['admitted']}: {bad}")
        fn = getattr(importlib.import_module(r["module"]), r["function"])()
        check(len(fn.argtypes) == r["argtypes"] == r["c_params"],
              f"{r['symbol']}: bound argtypes {len(fn.argtypes)}, folded "
              f"{r['argtypes']}, C parameters {r['c_params']}")
        bindings[r["symbol"]] = {
            "binding": f"{r['module']}.{r['function']}",
            "argtypes": len(fn.argtypes), "c_params": r["c_params"],
            "instantiated": r["instantiated"], "smem_bytes": got}
    emit("analysis", seconds=time.perf_counter() - t0, lint_seconds=lint_s,
         files_checked=report.files_checked, findings=len(report.findings),
         findings_by_family=by_family, bindings=bindings)


def _hgmma_count(name: str, function: str = "") -> int:
    """HGMMA (wgmma) instructions in kernel ``name``'s library SASS, in
    the functions whose name holds ``function``."""
    return sum(n for f, n in _hgmma_by_function(name).items()
               if function in f)


def _flash_wide(log: str) -> dict:
    """The flash forward's two-consumer-warpgroup instantiations (bf16 at
    D 192, v 192 and 128): ptxas's registers and spills of each, its
    dynamic shared memory and the HGMMA count of its SASS."""
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    entries = _ptxas_report(log)
    hgmma = _hgmma_by_function("flash_attention")
    out = {}
    for d, dv in ((192, 192), (192, 128)):
        name = f"flash_fwd_wide_kernelILi{d}ELi{dv}EE"
        out[f"bfloat16/d{d}_v{dv}"] = {
            "dynamic_smem_bytes": lib.flash_attention_smem_bytes(1, d, dv),
            "ptxas": next(({x: e.get(x) for x in ("used", "spills")}
                           for e in entries if name in e["entry"]), None),
            "hgmma": sum(n for f, n in hgmma.items() if name in f)}
    return out


def _mla_routes(log: str) -> dict:
    """Per instantiation of the latent kernel (cache dtype, latent rank):
    the route the library takes (``mla_attention_route``, which the
    wrapper's ``route`` must repeat), its entry's ptxas registers and
    spills, its dynamic shared memory and, for the tensor-core route, the
    HGMMA count of its SASS."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_attention as ma
    lib = build.load("mla_attention")
    entries = _ptxas_report(log)
    tc_hgmma = _hgmma_count("mla_attention", "mla_tc_kernel")
    out = {}
    for dtype, code, mangled in ((torch.float32, 0, "If"),
                                 (torch.bfloat16, 1, "I13__nv_bfloat16")):
        for r in (32, 512):
            route = {1: "wgmma", 0: "fma"}[lib.mla_attention_route(code, r)]
            check(route == ma.route(dtype, r),
                  f"mla route of {dtype} R {r}: library {route}, wrapper "
                  f"{ma.route(dtype, r)}")
            name = "mla_tc_kernel" if route == "wgmma" else \
                f"mla_split_kernel{mangled}Li{r}E"
            ptx = [e for e in entries if name in e["entry"]]
            out[f"{str(dtype)[6:]}/R{r}"] = {
                "route": route, "dynamic_smem_bytes":
                    lib.mla_attention_smem_bytes(code, r),
                "ptxas": ptx[0] if ptx else None,
                "hgmma": tc_hgmma if route == "wgmma" else 0}
    return out


def _bwd_routes(log: str) -> dict:
    """Per (dtype, head dim) of the flash backward: the route the library
    takes (``flash_attention_bwd_route``, which the wrapper's
    ``bwd_route`` must repeat), its dynamic shared memory, ptxas's
    registers and spills of each of its kernels, and the HGMMA count of
    their SASS (wgmma route: the dK/dV kernel with one bf16 operand and
    with hi + lo -- at D 192 the one with two consumer warpgroups -- the
    dQ kernel and the prep kernel)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    lib = build.load("flash_attention_bwd")
    entries = _ptxas_report(log)
    hgmma = _hgmma_by_function("flash_attention_bwd")
    out = {}
    for dtype, code, mangled in ((torch.float32, 0, "If"),
                                 (torch.bfloat16, 1, "I13__nv_bfloat16")):
        for d in fa.HEAD_DIMS:
            route = {1: "wgmma", 0: "fma"}[lib.flash_attention_bwd_route(
                code, d)]
            check(route == fa.bwd_route(dtype, d),
                  f"flash bwd route of {dtype} D {d}: library {route}, "
                  f"wrapper {fa.bwd_route(dtype, d)}")
            inner = 32 if d == 192 else 64
            kv = "wide" if d == 192 else "tc"   # two consumer warpgroups
            names = {
                "dkdv": f"flash_bwd_dkdv_{kv}_kernelILi{d}ELb0E",
                "dkdv_hilo": f"flash_bwd_dkdv_{kv}_kernelILi{d}ELb1E",
                "dq": f"flash_bwd_dq_{kv}_kernelILi{d}E",
                "prep": f"flash_bwd_prep_kernelILi{d}E"} \
                if route == "wgmma" else {
                "dkdv": f"flash_bwd_dkdv_kernel{mangled}Li{d}ELi{inner}E",
                "dq": f"flash_bwd_dq_kernel{mangled}Li{d}ELi{inner}E"}
            out[f"{str(dtype)[6:]}/d{d}"] = {
                "route": route,
                "dynamic_smem_bytes": lib.flash_attention_bwd_smem_bytes(
                    code, d),
                "hgmma": sum(n for f, n in hgmma.items()
                             if any(x in f for x in names.values())),
                "ptxas": {k: next(({x: e.get(x) for x in ("used", "spills")}
                                   for e in entries if n in e["entry"]),
                                  None)
                          for k, n in names.items()}}
    return out


def _hgmma_by_function(name: str) -> dict:
    """HGMMA (wgmma) instructions of each function in kernel ``name``'s
    library SASS."""
    from repro_torch.kernels import build
    sass = subprocess.run([os.path.join(os.path.dirname(build.nvcc_path()),
                                        "cuobjdump"), "-sass",
                           str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            cur = ln.split("Function :", 1)[1].strip()
            out[cur] = 0
        elif cur is not None and "HGMMA" in ln:
            out[cur] += 1
    return out


def _serve_prompt_lens(nv: int) -> list:
    """Post-compression prompt length of each request of the mixed serve
    (MIX order): its prefill length, and its decode seq_lens run from one
    past it to SERVE_NEW - 1 past it."""
    from repro_torch.api import compressed_token_count, resolve_compression
    return [SERVE_TEXT + compressed_token_count(resolve_compression(c), nv)
            for c in MIX]


def _flash_cases():
    """Main-path shape (qwen2-vl-2b prefill of 1024 visual + 32 text
    tokens), the compressed prefills of the mixed serve (a 0.5 keep and
    framefusion-0.25: 544 and 288 tokens, not multiples of the 64-row
    tile), then the edge cases."""
    main = dict(b=1, h=12, kvh=2, sq=1056, sk=1056, d=128)
    return main, [
        ("main", main, {}),
        ("prefill_0.5", dict(main, sq=544, sk=544), {}),
        ("prefill_0.25", dict(main, sq=288, sk=288), {}),
        ("sq_not_tile_multiple", dict(main, sq=1000, sk=1000), {}),
        ("kv_len_lt_sk", dict(main, sq=64, sk=1104), dict(kv_len=1072)),
        ("q_offset", dict(main, sq=16, sk=1104),
         dict(kv_len=1056, q_offset=1000)),
        ("window", main, dict(window=256)),
        ("head_dim_64", dict(main, h=4, kvh=2, d=64, sq=300, sk=300), {}),
        ("keyless_rows", dict(main, sq=200, sk=200), dict(q_offset=-30)),
        ("sq_sk_2048", dict(main, sq=2048, sk=2048), {}),
        ("strided_views", dict(main, sq=80, sk=1104, views=True),
         dict(kv_len=1056, q_offset=976)),
    ]


def _flash_inputs(rng, c, dtype):
    """q, k, v of a flash case; with ``views`` they are the model's
    layout, q [B,S,H,D] and a [B,L,K,D] cache prefix, passed transposed."""
    if not c.get("views"):
        return (randn(rng, (c["b"], c["h"], c["sq"], c["d"]), dtype),
                randn(rng, (c["b"], c["kvh"], c["sk"], c["d"]), dtype),
                randn(rng, (c["b"], c["kvh"], c["sk"], c["d"]), dtype))
    q = randn(rng, (c["b"], c["sq"], c["h"], c["d"]), dtype)
    cache = randn(rng, (2, c["b"], c["sk"] + 64, c["kvh"], c["d"]), dtype)
    return (q.transpose(1, 2), cache[0, :, :c["sk"]].transpose(1, 2),
            cache[1, :, :c["sk"]].transpose(1, 2))


def phase_kernels(flush) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(0)
    out = {}

    # ---- flash (prefill) ----
    main, cases = _flash_cases()
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, c, kw in cases:
            q, k, v = _flash_inputs(rng, c, dtype)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            e = max_err(got, fa.flash_attention_plain(q, k, v, **kw))
            if c.get("views"):      # the layout must not change the result
                same = fa.flash_attention(q.contiguous(), k.contiguous(),
                                          v.contiguous(), **kw)
                check(torch.equal(got, same),
                      f"flash {name} {dtype}: views != contiguous copies")
            errs[f"{name}/{str(dtype)[6:]}"] = e
            check(e <= TOL[dtype], f"flash {name} {dtype}: err {e}")
    dtype = torch.bfloat16
    q = randn(rng, (1, main["h"], main["sq"], main["d"]), dtype)
    k = randn(rng, (1, main["kvh"], main["sk"], main["d"]), dtype)
    v = randn(rng, (1, main["kvh"], main["sk"], main["d"]), dtype)
    sq, d, h = main["sq"], main["d"], main["h"]
    elt = q.element_size()
    nbytes = elt * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * d * h * sq * (sq + 1) / 2           # causal: valid keys only
    b_ms, b_by = bound(nbytes, flops, dtype)
    out["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:83",
        "max_abs_err": errs["main/bfloat16"],
        "ms": time_ms(lambda: fa.flash_attention(q, k, v), flush),
        "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), flush),
    }
    emit("kernels", kernel="flash_attention", shape=main, errors=errs,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         **{k_: out["flash_attention"][k_] for k_ in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})

    # ---- paged (decode) ----
    b, h, kvh, d, length, page = 4, 12, 2, 128, 1104, 16
    pps = length // page
    seqs = torch.tensor([1060, 1100, 40, 1103], dtype=torch.int32,
                        device="cuda")
    ident = torch.arange(b * pps, dtype=torch.int32,
                         device="cuda").view(b, pps)
    perm = torch.from_numpy(rng.permutation(b * pps).astype(np.int32)
                            ).to("cuda").view(b, pps)
    zero_seq = torch.tensor([0, 5, 0, 1103], dtype=torch.int32,
                            device="cuda")
    # around the kernel's split boundaries
    split = pa.CHUNK
    straddle = torch.tensor([split - 1, split, split + 1, 2 * split + 1],
                            dtype=torch.int32, device="cuda")
    full = torch.tensor([length], dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd = randn(rng, (b, h, d), dtype)
        kp = randn(rng, (b * pps, page, kvh, d), dtype)
        vp = randn(rng, (b * pps, page, kvh, d), dtype)
        for name, table, sl in (("identity_table", ident, seqs),
                                ("permuted_table", perm, seqs),
                                ("seq_len_0", perm, zero_seq),
                                ("split_boundaries", perm, straddle),
                                ("b1_full_table", perm[:1], full)):
            got = pa.paged_attention(qd[:len(table)], kp, vp, table, sl)
            torch.cuda.synchronize()
            e = max_err(got, pa.paged_attention_plain(qd[:len(table)], kp,
                                                      vp, table, sl))
            errs[f"{name}/{str(dtype)[6:]}"] = e
            check(e <= TOL[dtype], f"paged {name} {dtype}: err {e}")
    errs.update(_paged_serve_cases(rng, h, kvh, d, page))
    errs.update(_paged_cluster_cases(rng, h, kvh, d, page))
    dtype = torch.bfloat16
    qd = randn(rng, (b, h, d), dtype)
    cache_k = randn(rng, (b, length, kvh, d), dtype)
    cache_v = randn(rng, (b, length, kvh, d), dtype)
    kp = cache_k.view(b * pps, page, kvh, d)
    vp = cache_v.view(b * pps, page, kvh, d)
    elt = qd.element_size()
    n_tok = int(seqs.sum().item())
    nbytes = elt * (2 * qd.numel() + 2 * n_tok * kvh * d) \
        + 4 * (ident.numel() + b)
    flops = 4 * h * d * n_tok
    b_ms, b_by = bound(nbytes, flops, dtype)
    # the library yardstick: SDPA over the same slot cache seen densely,
    # masked to each request's valid positions (identity table only)
    mask = (torch.arange(length, device="cuda")[None]
            < seqs[:, None])[:, None, None, :]
    qs, ks, vs = qd[:, :, None], cache_k.transpose(1, 2), \
        cache_v.transpose(1, 2)
    split_sweep = _paged_split_sweep(rng, flush, h, kvh, d, length, page,
                                     seqs.tolist())
    out["paged_attention"] = {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:68",
        "max_abs_err": errs["identity_table/bfloat16"],
        "ms": time_ms(lambda: pa.paged_attention(qd, kp, vp, ident, seqs),
                      flush),
        "plain_ms": time_ms(lambda: pa.paged_attention_plain(
            qd, kp, vp, ident, seqs), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
    }
    emit("kernels", kernel="paged_attention",
         shape=dict(b=b, h=h, kvh=kvh, d=d, cache_len=length, page=page,
                    seq_lens=seqs.tolist(), split_tokens=split),
         split_sweep=split_sweep,
         errors=errs, tolerance={"float32": TOL[torch.float32],
                                 "bfloat16": TOL[torch.bfloat16]},
         **{k_: out["paged_attention"][k_] for k_ in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return out


def _paged_serve_cases(rng, h, kvh, d, page) -> dict:
    """The wrapper at the mixed-compression serve's decode batch: one slot
    per strategy of MIX over its SERVE_CACHE_LEN cache, whose seq_lens
    differ by hundreds of tokens (1056 / 544 / 288 prompts plus the tokens
    decoded so far), at the first and last decode step and at steps drawn
    per slot; identity table (the engine's) and a permuted one, float32
    and bfloat16, each held against the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    b, length = len(MIX), SERVE_CACHE_LEN
    pps = length // page
    prompt = np.array(_serve_prompt_lens(
        get_config("qwen2-vl-2b").num_visual_tokens))
    steps = {"serve_first_step": prompt + 1,
             "serve_last_step": prompt + SERVE_NEW - 1,
             "serve_mixed_steps": prompt + rng.integers(1, SERVE_NEW, b)}
    ident = torch.arange(b * pps, dtype=torch.int32,
                         device="cuda").view(b, pps)
    perm = torch.from_numpy(rng.permutation(b * pps).astype(np.int32)
                            ).to("cuda").view(b, pps)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        qd = randn(rng, (b, h, d), dtype)
        kp = randn(rng, (b * pps, page, kvh, d), dtype)
        vp = randn(rng, (b * pps, page, kvh, d), dtype)
        for name, lens in steps.items():
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            for tname, table in (("identity", ident), ("permuted", perm)):
                got = pa.paged_attention(qd, kp, vp, table, sl)
                torch.cuda.synchronize()
                e = max_err(got, pa.paged_attention_plain(qd, kp, vp,
                                                          table, sl))
                errs[f"{name}_{tname}/{str(dtype)[6:]}"] = e
                check(e <= TOL[dtype], f"paged {name} {tname} {dtype}: "
                      f"err {e} at seq_lens {lens.tolist()}")
    return errs


def _paged_cluster_cases(rng, h, kvh, d, page) -> dict:
    """The wrapper at the cluster serve's decode batches: 16 slots (the
    decode replica) and 12 (a unified one) of CLUSTER_CACHE_LEN rows, as
    the engine decodes the whole slot pool: imported burst requests
    (1056-token prompts plus decoded tokens), chat requests (8-24 tokens
    plus up to CHAT_NEW decoded), and free slots, which read every row
    (seq_len = cache_len) of whatever an earlier occupant left. Pages
    are random, so every row past a request's seq_len is stale data;
    identity table (the engine's), float32 and bfloat16, each held
    against the plain version."""
    from repro_torch.kernels import paged_attention as pa
    length, errs = CLUSTER_CACHE_LEN, {}
    pps = length // page
    for b in (16, 12):
        burst = 1024 + SERVE_TEXT + rng.integers(1, BURST_NEW, BURST_N)
        chat = rng.integers(8, 24, b - BURST_N - 3) \
            + rng.integers(1, CHAT_NEW, b - BURST_N - 3)
        lens = np.concatenate([burst, chat, [length] * 3])
        sl = torch.tensor(rng.permutation(lens), dtype=torch.int32,
                          device="cuda")
        table = torch.arange(b * pps, dtype=torch.int32,
                             device="cuda").view(b, pps)
        for dtype in (torch.float32, torch.bfloat16):
            qd = randn(rng, (b, h, d), dtype)
            kp = randn(rng, (b * pps, page, kvh, d), dtype)
            vp = randn(rng, (b * pps, page, kvh, d), dtype)
            got = pa.paged_attention(qd, kp, vp, table, sl)
            torch.cuda.synchronize()
            e = max_err(got, pa.paged_attention_plain(qd, kp, vp, table, sl))
            errs[f"cluster_b{b}/{str(dtype)[6:]}"] = e
            check(e <= TOL[dtype], f"paged cluster b={b} {dtype}: err {e} "
                  f"at seq_lens {sl.tolist()}")
    return errs


def _paged_split_sweep(rng, flush, h, kvh, d, length, page, seqs) -> dict:
    """The split kernel at 32 (the wrapper's), 64 and 128 tokens per CTA
    (one, two and four cp.async chunks), at the main decode shape and
    batches up to 32 (the engine's default max_batch is 8): each run is
    held against the plain version in float32 and bfloat16, then timed in
    bfloat16. seq_lens repeat the main path's; 1060 and 40 end inside the
    second chunk of a 64- or 128-token split."""
    from repro_torch.kernels import paged_attention as pa
    pps = length // page
    sweep = {}
    for b in (4, 8, 16, 32):
        sl = torch.tensor((seqs * b)[:b], dtype=torch.int32, device="cuda")
        table = torch.arange(b * pps, dtype=torch.int32,
                             device="cuda").view(b, pps)
        row = {"ms": {}, "errors": {}}
        for dtype in (torch.float32, torch.bfloat16):
            qd = randn(rng, (b, h, d), dtype)
            kp = randn(rng, (b * pps, page, kvh, d), dtype)
            vp = randn(rng, (b * pps, page, kvh, d), dtype)
            want = pa.paged_attention_plain(qd, kp, vp, table, sl)
            for st in (32, 64, 128):
                e = max_err(pa._launch(qd, kp, vp, table, sl, st), want)
                row["errors"][f"{st}/{str(dtype)[6:]}"] = e
                check(e <= TOL[dtype], f"paged split {st} b={b} {dtype}: "
                      f"err {e}")
                if dtype == torch.bfloat16:
                    row["ms"][st] = time_ms(lambda st=st: pa._launch(
                        qd, kp, vp, table, sl, st), flush)
        sweep[f"b{b}"] = row
    return sweep


class CallTimer:
    """Wraps a model's prefill/extend/decode_step on the instance: counts
    calls and wall seconds (synchronized), for the main-path report, and
    the sequence length of each prefill with its seconds."""

    def __init__(self, model):
        self.reset()
        for name in self.calls:
            setattr(model, name, self._wrap(name, getattr(model, name)))

    def reset(self) -> None:
        self.calls = {"prefill": 0, "extend": 0, "decode_step": 0}
        self.seconds = dict.fromkeys(self.calls, 0.0)
        self.prefills = []          # [(visual + text tokens, seconds)]

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.seconds[name] += dt
            self.calls[name] += 1
            if name == "prefill":
                batch = a[1]
                n = batch["tokens"].shape[1] + (
                    batch["visual_embeds"].shape[1]
                    if "visual_embeds" in batch else 0)
                self.prefills.append((n, dt))
            return res
        return timed


def _reset_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_attention as ma
    from repro_torch.kernels import paged_attention as pa
    fa.flash_attention.launches = 0
    fa.flash_attention_bwd.launches = 0
    pa.paged_attention.launches = 0
    ma.mla_attention.launches = 0


def _counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return {"flash_attention": fa.flash_attention.launches,
            "paged_attention": pa.paged_attention.launches}


def _mla_counts() -> dict:
    """``_counts`` and the latent kernel's launches (the MLA phases)."""
    from repro_torch.kernels import mla_attention as ma
    return dict(_counts(), mla_attention=ma.mla_attention.launches)


def _requests(Request, prompts, ves, max_new):
    return [Request(rid=i, tokens=list(p), max_new_tokens=max_new,
                    visual_embeds=ve) for i, (p, ve) in enumerate(zip(prompts,
                                                                     ves))]


def phase_main_path_smoke() -> None:
    """qwen2-vl smoke config in float32: the port on the card (kernels)
    against the port on the CPU (plain versions), same weights."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    cpu = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0,
                               device="cpu")
    card = cpu.with_params(_tree_to(cpu.params, "cuda"))
    cfg = cpu.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (12, 40, 12, 7)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32), None,
           rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32), None]
    # logits: prefill, one decode step
    toks = torch.tensor([prompts[0]])
    batch = {"tokens": toks, "visual_embeds": torch.from_numpy(ves[0])[None]}
    lc, cc = cpu.model.prefill(cpu.params, batch, cache_len=64)
    lg, cg = card.model.prefill(card.params, _tree_to(batch, "cuda"),
                                cache_len=64)
    e_pre = max_err(lg.cpu(), lc)
    nxt = torch.tensor([[3]])
    pos = torch.tensor([len(prompts[0]) + cfg.num_visual_tokens])
    dc, _ = cpu.model.decode_step(cpu.params, cc, nxt, pos)
    dg, _ = card.model.decode_step(card.params, cg, nxt.cuda(), pos.cuda())
    e_dec = max_err(dg.cpu(), dc)
    check(e_pre <= SMOKE_LOGIT_TOL and e_dec <= SMOKE_LOGIT_TOL,
          f"smoke logits card vs CPU: prefill {e_pre}, decode {e_dec}")
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    _reset_counts()
    tc = [r.tokens for r in cpu.generate(prompts, gen, visual_embeds=ves)]
    tg = [r.tokens for r in card.generate(prompts, gen, visual_embeds=ves)]
    ec = EngineConfig(max_batch=4, cache_len=80, scheduler="chunked",
                      chunk_size=16, token_budget=64)
    sc = cpu.serve(_requests(Request, prompts, ves, 8), ec, gen)
    sg = card.serve(_requests(Request, prompts, ves, 8), ec, gen)
    counts = _counts()
    same_gen = tc == tg
    same_serve = ({r.rid: r.generated for r in sc.requests}
                  == {r.rid: r.generated for r in sg.requests})
    emit("main_path_smoke", config=cfg.name, dtype=cfg.dtype,
         prefill_logit_err=e_pre, decode_logit_err=e_dec,
         tolerance=SMOKE_LOGIT_TOL, generate_tokens_equal=same_gen,
         chunked_serve_tokens_equal=same_serve, launches=counts)
    check(same_gen and same_serve, "smoke greedy tokens card != CPU")
    check(all(counts.values()), f"a kernel was not launched: {counts}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_main_path_full() -> tuple:
    """qwen2-vl-2b at full width, bfloat16, random weights (seed 0)."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvlm = LVLM.from_pretrained("qwen2-vl-2b", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = lvlm.cfg
    check(lvlm.device.type == "cuda", "from_pretrained did not land on cuda")
    rng = np.random.default_rng(2)
    n_text, n_new = 32, 32
    prompts = [rng.integers(0, cfg.vocab_size, n_text).tolist()
               for _ in range(4)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32), None,
           rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32), None]
    # one full-width prefill: finite logits of the expected shape
    logits, _ = lvlm.model.prefill(
        lvlm.params, {"tokens": torch.tensor([prompts[0]], device="cuda"),
                      "visual_embeds": torch.from_numpy(ves[0]
                                                        ).cuda()[None]},
        last_only=True)
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "bad full-width logits")

    timer = CallTimer(lvlm.model)
    gen = GenerationConfig(max_new_tokens=n_new, decoder="greedy")
    _reset_counts()
    t0 = time.perf_counter()
    res = lvlm.generate(prompts, gen, visual_embeds=ves)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_counts = _counts()
    gen_calls = dict(timer.calls)
    gen_secs = dict(timer.seconds)
    toks = [r.tokens for r in res]
    check(all(len(t) == n_new and all(0 <= x < cfg.vocab_size for x in t)
              for t in toks), "generate returned malformed tokens")
    L = cfg.num_layers
    check(gen_counts["flash_attention"] >= L * gen_calls["prefill"] > 0,
          f"flash launches {gen_counts} vs prefills {gen_calls}")
    check(gen_counts["paged_attention"] >= L * gen_calls["decode_step"] > 0,
          f"paged launches {gen_counts} vs decode steps {gen_calls}")
    decode_tokens = sum(len(t) - 1 for t in toks)

    timer.reset()
    ec = EngineConfig(max_batch=4, cache_len=LVLM._cache_len(
        _requests(Request, prompts, ves, n_new), gen), scheduler="chunked",
        chunk_size=16, token_budget=2048)
    _reset_counts()
    t0 = time.perf_counter()
    rep = lvlm.serve(_requests(Request, prompts, ves, n_new), ec, gen)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_counts = _counts()
    serve_calls = dict(timer.calls)
    check(len(rep.requests) == 4 and all(len(r.generated) == n_new
                                         for r in rep.requests),
          "chunked serve did not finish every request")
    check(serve_calls["extend"] > 0, "chunked serve ran no extend")
    check(serve_counts["flash_attention"]
          >= L * (serve_calls["prefill"] + serve_calls["extend"]),
          f"flash launches {serve_counts} vs calls {serve_calls}")
    check(serve_counts["paged_attention"] >= L * serve_calls["decode_step"]
          > 0, f"paged launches {serve_counts} vs calls {serve_calls}")
    serve_tokens = {r.rid: r.generated for r in rep.requests}
    agree = float(np.mean([a == b for r, t in zip(res, toks)
                           for a, b in zip(t, serve_tokens[r.request.rid])]))
    emit("main_path_full", config=cfg.name, dtype=cfg.dtype,
         layers=L, init_seconds=init_s,
         generate={"wall_seconds": gen_wall,
                   "prefill_wall_seconds": gen_secs["prefill"],
                   "prefills": gen_calls["prefill"],
                   "decode_steps": gen_calls["decode_step"],
                   "decode_wall_seconds": gen_secs["decode_step"],
                   "decode_tokens": decode_tokens,
                   "decode_tokens_per_s":
                       decode_tokens / gen_secs["decode_step"],
                   "launches": gen_counts},
         serve_chunked={"wall_seconds": serve_wall,
                        "calls": serve_calls,
                        "seconds": dict(timer.seconds),
                        "virtual_ttft_mean_s": rep.stats.get("ttft_mean"),
                        "launches": serve_counts,
                        "token_agreement_with_generate": agree},
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return {k: gen_counts[k] + serve_counts[k] for k in gen_counts}, \
        (lvlm, prompts, ves), timer


# ------------------------------------------------------------ compression --

def _result_parts(res) -> dict:
    """A compressor's result as named tensors: the output, the kept
    indices where it returns them, and the tensors of its info dict."""
    if isinstance(res, torch.Tensor):
        return {"out": res}
    parts = {"out": res[0]}
    if len(res) == 3 and res[1] is not None:
        parts["idx"] = res[1]
    info = res[-1] if isinstance(res[-1], dict) else {}
    parts.update({f"info/{k}": v for k, v in info.items()
                  if isinstance(v, torch.Tensor)})
    return parts


def _compressor_cases(x, q, vid, static):
    """(name, function, tensors, other arguments) of every compressor at
    full width: the five pruners and two mergers at a 0.5 (framefusion
    0.25) keep of 1024 tokens, ``compress_visual_tokens`` for each preset
    the mixed serve runs, and the five video functions on a random and a
    static video (every frame the same: every score ties)."""
    from repro_torch.api import resolve_compression
    from repro_torch.core.token_compression import (merging, policy,
                                                    pruning, video)

    def fastv(x):
        return pruning.prune_fastv(
            x, 512, scores=-torch.linalg.vector_norm(x, dim=-1))
    cases = [
        ("prune_fastv", fastv, (x,), {}),
        ("prune_sparsevlm", pruning.prune_sparsevlm, (x,),
         {"keep": 512, "query": q}),
        ("prune_l2", pruning.prune_l2, (x,), {"keep": 512}),
        ("prune_divprune", pruning.prune_divprune, (x,), {"keep": 512}),
        ("prune_cdpruner", pruning.prune_cdpruner, (x,),
         {"keep": 512, "query": q}),
        ("tome_to_count", merging.tome_to_count, (x,), {"keep": 512}),
        ("prune_then_merge", merging.prune_then_merge, (x,), {"keep": 256}),
    ]
    for preset in MIX:
        cc = resolve_compression(preset)
        cases.append((f"compress_visual_tokens/{preset}",
                      lambda x, q, cc=cc: policy.compress_visual_tokens(
                          cc, x, query=q), (x, q), {}))
    for tag, v in (("random", vid), ("static", static)):
        cases += [
            (f"frame_similarity/{tag}", video.frame_similarity, (v,), {}),
            (f"temporal_merge/{tag}", video.temporal_merge, (v,),
             {"num_segments": 3}),
            (f"llama_vid_compress/{tag}", video.llama_vid_compress, (v, q),
             {}),
            (f"dycoke_ratio/{tag}", video.dycoke_ratio, (v,), {}),
            (f"dynamic_compress/{tag}", video.dynamic_compress, (v,),
             {"token_budget": 256}),
            (f"framefusion/{tag}", video.framefusion, (v,), {"keep": 256}),
        ]
    return cases


def phase_compressors() -> None:
    """Every compressor on the card and on the CPU on the same float32
    inputs (seed 3): kept indices identical, outputs within COMP_TOL, each
    ``compress_visual_tokens`` output as long as ``compressed_token_count``
    says; wall ms per call on the card, synchronised (median of 3 after a
    warm-up call)."""
    from repro_torch.api import compressed_token_count, resolve_compression
    rng = np.random.default_rng(3)
    d = 1536
    host = {"x": rng.standard_normal((1, 1024, d)).astype(np.float32),
            "q": rng.standard_normal((1, 32, d)).astype(np.float32),
            "vid": rng.standard_normal((1, 8, 128, d)).astype(np.float32)}
    host["static"] = np.repeat(host["vid"][:, :1], 8, axis=1)
    cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    card = {k: v.cuda() for k, v in cpu.items()}
    report = {}
    for (name, fn, args, kw), (_, cfn, cargs, ckw) in zip(
            _compressor_cases(**card), _compressor_cases(**cpu)):
        got = _result_parts(fn(*args, **kw))
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn(*args, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        want = _result_parts(cfn(*cargs, **ckw))
        check(set(got) == set(want), f"{name}: parts {set(got)} vs "
              f"{set(want)}")
        row = {"ms": sorted(times)[1], "shape": list(got["out"].shape)}
        for part, w in want.items():
            g = got[part]
            check(g.device.type == "cuda", f"{name}/{part} left the card")
            check(tuple(g.shape) == tuple(w.shape),
                  f"{name}/{part}: shape {tuple(g.shape)} vs "
                  f"{tuple(w.shape)}")
            if part == "idx":
                check(torch.equal(g.cpu(), w),
                      f"{name}: kept indices differ card vs CPU")
            else:
                e = max_err(g.cpu(), w)
                row[f"{part}_err"] = e
                check(e <= COMP_TOL, f"{name}/{part}: err {e}")
        if name.startswith("compress_visual_tokens/"):
            cc = resolve_compression(name.split("/", 1)[1])
            check(got["out"].shape[1] == compressed_token_count(cc, 1024),
                  f"{name}: {got['out'].shape[1]} tokens, count says "
                  f"{compressed_token_count(cc, 1024)}")
        report[name] = row
    emit("compression_compressors", tolerance=COMP_TOL,
         inputs={"visual": [1, 1024, d], "query": [1, 32, d],
                 "video": [1, 8, 128, d], "dtype": "float32"},
         compressors=report)


def _mixed_requests(Request, cfg, rng, n_text, n_new):
    prompts = [rng.integers(0, cfg.vocab_size, n_text).tolist()
               for _ in MIX]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) for _ in MIX]

    def make():
        return [Request(rid=i, tokens=list(p), max_new_tokens=n_new,
                        visual_embeds=v, compression=c)
                for i, (p, v, c) in enumerate(zip(prompts, ves, MIX))]
    return make, prompts, ves


def phase_compression_serve(lvlm, timer) -> dict:
    """qwen2-vl-2b at full width, bf16: ``LVLM.serve`` (continuous,
    max_batch 8) of 8 requests of 1024 visual + 32 text tokens and 32 new
    tokens, one per strategy of MIX, then ``generate`` with
    ``GenerationConfig(compression="fastv-0.5")`` on two of the prompts.
    Checks every request finished, the exact compression stats and KV
    reservations, and the launches of both kernels per prefill (at the
    compressed lengths) and per decode step."""
    from repro_torch.api import (EngineConfig, GenerationConfig, LVLM,
                                 Request, compressed_token_count,
                                 resolve_compression)
    cfg = lvlm.cfg
    L, nv = cfg.num_layers, cfg.num_visual_tokens
    n_text, n_new = SERVE_TEXT, SERVE_NEW
    make, prompts, ves = _mixed_requests(Request, cfg,
                                         np.random.default_rng(4),
                                         n_text, n_new)
    gen = GenerationConfig(max_new_tokens=n_new, decoder="greedy")
    ec = EngineConfig(max_batch=8, scheduler="continuous",
                      cache_len=LVLM._cache_len(make(), gen))
    check(ec.cache_len == SERVE_CACHE_LEN,
          f"serve cache_len {ec.cache_len}: the paged kernel was checked "
          f"at {SERVE_CACHE_LEN}")
    timer.reset()
    _reset_counts()
    t0 = time.perf_counter()
    rep = lvlm.serve(make(), ec, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    calls, prefills = dict(timer.calls), list(timer.prefills)
    eng = rep.engine
    check(len(rep.requests) == len(MIX)
          and all(len(r.generated) == n_new for r in rep.requests),
          "the mixed-compression serve did not finish every request")
    nv_out = {c: compressed_token_count(resolve_compression(c), nv)
              for c in MIX}
    check(nv_out["none"] == nv and nv_out["framefusion-0.25"] == nv // 4
          and all(nv_out[c] == nv // 2 for c in MIX[1:-1]),
          f"unexpected compressed counts {nv_out}")
    want = {c: {"visual_tokens_in": nv, "visual_tokens_out": nv_out[c],
                "prefill_token_reduction": 1.0 - nv_out[c] / nv}
            for c in MIX}
    check(eng.compression_stats() == want,
          f"compression_stats {eng.compression_stats()} != {want}")
    kv = {r.compression: eng.kv_request_tokens(r) for r in rep.requests}
    for c in MIX:
        need = n_text + nv_out[c] + n_new
        check(kv[c] == -(-need // 16) * 16, f"kv_request_tokens[{c}]")
    check(all(kv[c] < kv["none"] for c in MIX[1:])
          and kv["framefusion-0.25"] < kv["fastv-0.5"],
          f"KV reservations do not shrink with the keep ratio: {kv}")
    lengths = sorted(n for n, _ in prefills)
    check(lengths == sorted(n_text + nv_out[c] for c in MIX)
          == sorted(_serve_prompt_lens(nv)),
          f"prefill lengths {lengths}")
    check(counts["flash_attention"] >= L * calls["prefill"] > 0,
          f"flash launches {counts} vs prefills {calls}")
    check(counts["paged_attention"] >= L * calls["decode_step"] > 0,
          f"paged launches {counts} vs decode steps {calls}")
    by_len = {}
    for n, dt in prefills:
        by_len.setdefault(n, []).append(dt * 1e3)

    # the facade's default strategy
    timer.reset()
    _reset_counts()
    gres = lvlm.generate(prompts[:2], GenerationConfig(
        max_new_tokens=n_new, decoder="greedy", compression="fastv-0.5"),
        visual_embeds=ves[:2])
    torch.cuda.synchronize()
    gcounts, gcalls = _counts(), dict(timer.calls)
    check(all(len(r.tokens) == n_new and r.request.nv_compressed == nv // 2
              for r in gres), "generate(compression='fastv-0.5') failed")
    check(sorted(n for n, _ in timer.prefills) == [n_text + nv // 2] * 2,
          f"generate prefill lengths {timer.prefills}")
    check(gcounts["flash_attention"] >= L * gcalls["prefill"] > 0
          and gcounts["paged_attention"] >= L * gcalls["decode_step"] > 0,
          f"generate launches {gcounts} vs calls {gcalls}")
    emit("compression_serve", config=cfg.name, dtype=cfg.dtype,
         presets=list(MIX), wall_seconds=wall, calls=calls,
         prefill_wall_ms_by_length=by_len,
         compression_stats=eng.compression_stats(),
         kv_request_tokens=kv,
         virtual_ttft_s={r.compression: r.ttft() for r in rep.requests},
         slot_seq_lens_at_end=[int(x) for x in eng.slot_pos],
         launches=counts,
         generate_fastv={"calls": gcalls, "launches": gcounts,
                         "nv_compressed": [r.request.nv_compressed
                                           for r in gres]})
    return {k: counts[k] + gcounts[k] for k in counts}


def phase_compression_smoke() -> None:
    """The mixed-compression batch on the float32 smoke config: greedy
    tokens and compression stats of the port on the card equal the port
    on the CPU (the compressors run on the card there)."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    cpu = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0,
                               device="cpu")
    card = cpu.with_params(_tree_to(cpu.params, "cuda"))
    make, _, _ = _mixed_requests(Request, cpu.cfg, np.random.default_rng(5),
                                 12, 8)
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    out = {}
    for sched in ("continuous", "chunked"):
        ec = EngineConfig(max_batch=4, cache_len=48, scheduler=sched,
                          chunk_size=8, token_budget=32)
        _reset_counts()
        sc = cpu.serve(make(), ec, gen)
        sg = card.serve(make(), ec, gen)
        counts = _counts()
        same = ({r.rid: r.generated for r in sc.requests}
                == {r.rid: r.generated for r in sg.requests})
        same_stats = (sc.engine.compression_stats()
                      == sg.engine.compression_stats())
        out[sched] = {"tokens_equal": same, "stats_equal": same_stats,
                      "finished": len(sg.requests), "launches": counts}
        check(same and same_stats and len(sg.requests) == len(MIX),
              f"mixed-compression smoke card != CPU under {sched}")
        check(all(counts.values()), f"a kernel was not launched: {counts}")
    emit("compression_smoke", config=cpu.cfg.name, presets=list(MIX), **out)


# ------------------------------------------------------------- kv cache --

def _masked_cases(rng, dtype, h, kvh, d, page):
    """The masked paged kernel's inputs at batch 8 over a KV_CACHE_LEN-row
    slot cache: (name, args, masking kwargs, key rows per request). The
    ``compacted`` slot_pos comes from a real streaming (slots 0-3) and a
    real l2 (4-7) compaction to KV_BUDGET of 1056 tokens, then a random
    count of decoded rows; ``ring`` holds positions past the cache;
    ``window_256`` is a plain cache with no k_pos; ``ahead`` reads every
    row, those past the query's position masked. Each is given with the
    identity table and a permuted one (physical page table[j] holds
    logical page j)."""
    from repro_torch.core.kv_cache.selection import SELECTORS
    b, length, prompt = 8, KV_CACHE_LEN, 1056
    pps = length // page
    q = randn(rng, (b, h, d), dtype)
    k = randn(rng, (b, length, kvh, d), dtype)
    v = randn(rng, (b, length, kvh, d), dtype)
    sp = torch.full((b, length), -1, dtype=torch.int32, device="cuda")
    pos0 = torch.arange(prompt, dtype=torch.int32, device="cuda")
    for sel, rows in (("streaming", slice(0, 4)), ("l2", slice(4, 8))):
        nk, nv, kept = SELECTORS[sel](k[rows, :prompt], v[rows, :prompt],
                                      budget=KV_BUDGET, pos=pos0)
        k[rows, :KV_BUDGET], v[rows, :KV_BUDGET] = nk, nv
        k[rows, KV_BUDGET:prompt], v[rows, KV_BUDGET:prompt] = 0, 0
        sp[rows, :KV_BUDGET] = kept
    steps = rng.integers(0, SERVE_NEW, b)
    for i, t in enumerate(steps):             # rows decoded since
        sp[i, prompt:prompt + t + 1] = torch.arange(
            prompt, prompt + t + 1, dtype=torch.int32, device="cuda")
    q_comp = torch.from_numpy((prompt + steps).astype(np.int32)).cuda()
    ring_q = rng.integers(length, 3 * length, b)
    ring = torch.full((b, length), -1, dtype=torch.int32)
    for i, qp in enumerate(ring_q):
        p = np.arange(qp - length + 1, qp + 1)
        ring[i, torch.from_numpy(p % length)] = torch.from_numpy(
            p.astype(np.int32))
    win_q = torch.from_numpy(rng.integers(300, length, b).astype(np.int32)
                             ).cuda()
    ahead_q = torch.from_numpy(rng.integers(0, length - 8, b).astype(
        np.int32)).cuda()
    full = torch.full((b,), length, dtype=torch.int32, device="cuda")
    rows = torch.arange(length, dtype=torch.int32, device="cuda")
    cases = {                         # slot_pos, q_pos, window, seq_lens
        "compacted": (sp, q_comp, 0, None),
        "ring": (ring.cuda(), torch.from_numpy(ring_q.astype(np.int32)
                                               ).cuda(), length, None),
        "window_256": (None, win_q, 256, None),
        "ahead": (rows.expand(b, length).contiguous(), ahead_q, 0, full),
    }
    ident = torch.arange(b * pps, dtype=torch.int32, device="cuda")
    perm = torch.from_numpy(rng.permutation(b * pps).astype(np.int32)
                            ).cuda()
    out = []
    for name, (slot_pos, q_pos, window, seq) in cases.items():
        if seq is None:
            seq = torch.clamp(q_pos + 1, max=length).to(torch.int32)
        for tname, table in (("identity", ident), ("permuted", perm)):
            pages = []
            for x in (k, v) + (() if slot_pos is None else (slot_pos,)):
                y = torch.empty_like(x).view(b * pps, page, *x.shape[2:])
                y[table.long()] = x.reshape(b * pps, page, *x.shape[2:])
                pages.append(y)
            kw = dict(q_pos=q_pos, window=window,
                      k_pos=pages[2] if slot_pos is not None else None)
            out.append((f"{name}_{tname}", (q, pages[0], pages[1],
                                            table.view(b, pps), seq), kw))
    return out, (k, v, sp, q_comp)


def phase_paged_masked(flush) -> None:
    """The paged kernel's masked mode (windowed and compacted caches)
    against its plain version in float32 and bf16, then the compacted case
    timed (bf16, identity table) beside the unmasked kernel at the same
    seq_lens, the byte bound of the masked function, and SDPA over the
    dense slot cache with the boolean mask built from slot_pos."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_key_mask
    rng = np.random.default_rng(6)
    h, kvh, d, page = 12, 2, 128, 16
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        cases, _ = _masked_cases(rng, dtype, h, kvh, d, page)
        for name, args, kw in cases:
            got = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            e = max_err(got, pa.paged_attention_plain(*args, **kw))
            errs[f"{name}/{str(dtype)[6:]}"] = e
            check(e <= TOL[dtype], f"paged masked {name} {dtype}: err {e}")
    dtype = torch.bfloat16
    cases, (k, v, sp, q_pos) = _masked_cases(rng, dtype, h, kvh, d, page)
    _, args, kw = cases[0]                   # compacted, identity table
    q, kp, vp, table, seq = args
    read, key = paged_key_mask(seq, table, page, **kw)
    n_read, n_key = int(read.sum()), int(key.sum())
    elt = q.element_size()
    # the masked function needs every read row's position but only the
    # key rows' K and V
    nbytes = elt * (2 * q.numel() + 2 * n_key * kvh * d) \
        + 4 * (table.numel() + 2 * len(seq) + n_read)
    b_ms, b_by = bound(nbytes, 4 * h * d * n_key, dtype)
    mask = ((sp >= 0) & (sp <= q_pos[:, None]))[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    row = {"ms": time_ms(lambda: pa.paged_attention(*args, **kw), flush),
           "unmasked_ms": time_ms(lambda: pa.paged_attention(*args), flush),
           "plain_ms": time_ms(lambda: pa.paged_attention_plain(*args, **kw),
                               flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
           "rows_read": n_read, "key_rows": n_key}
    row["masked_over_unmasked"] = row["ms"] / row["unmasked_ms"]
    emit("paged_masked", shape=dict(b=8, h=h, kvh=kvh, d=d,
                                    cache_len=KV_CACHE_LEN, page=page,
                                    budget=KV_BUDGET,
                                    seq_lens=seq.tolist()),
         errors=errs, tolerance={"float32": TOL[torch.float32],
                                 "bfloat16": TOL[torch.bfloat16]},
         compacted_bf16=row)


def _mq_case(rng, dtype, *, s, starts, h=12, kvh=2, d=128, page=16,
             length=SERVE_CACHE_LEN, permute=False):
    """Multi-query (verify) inputs over a ``length``-slot cache, one row
    per start: ((q [B,S,H,D], k/v pages, table, seq_lens), q_pos [B,S],
    (k, v) as the dense cache). Physical page table[j] holds logical page
    j; a start of length - 1 is an inactive row routed to the scratch
    slot (its queries past the cache read every row)."""
    starts = np.asarray(starts)
    b = len(starts)
    pps = length // page
    q = randn(rng, (b, s, h, d), dtype)
    k = randn(rng, (b, length, kvh, d), dtype)
    v = randn(rng, (b, length, kvh, d), dtype)
    order = rng.permutation(b * pps) if permute else np.arange(b * pps)
    table = torch.from_numpy(order.reshape(b, pps).astype(np.int32)).cuda()
    pages = []
    for x in (k, v):
        y = torch.empty((b * pps, page, kvh, d), dtype=dtype, device="cuda")
        y[table.flatten().long()] = x.reshape(b * pps, page, kvh, d)
        pages.append(y)
    q_pos = torch.from_numpy((starts[:, None] + np.arange(s)).astype(np.int32)
                             ).cuda()
    seq = torch.from_numpy(np.minimum(starts + s, length).astype(np.int32)
                           ).cuda()
    return (q, pages[0], pages[1], table, seq), q_pos, (k, v)


def phase_paged_verify(flush) -> dict:
    """The paged kernel's multi-query mode (the per-row-start verify and
    the draft's 2-token lead; tensor cores for bf16 with S >= 2) against
    its plain version in float32 and bf16 on every edge: the serve's
    batch-8 verify (S = 5 over the SERVE_CACHE_LEN cache, rows at
    1056-1083), a permuted table, inactive rows routed to the scratch
    slot, blocks across 32-token split boundaries, S = 1, 2 and 8, G = 8
    at D = 64 (64 rows a CTA), pages of 5 tokens, and the draft pool
    (DRAFT_CACHE_LEN rows in 4-token pages): its 2-token lead at the
    serve's text positions with two rows at the scratch slot, and its
    one-query decode steps at batch 8. Each edge is held to TOL and to
    REL_TOL of its reference's largest value; on the serve-shaped edges
    the plain version with each query's own key dropped must miss
    REL_TOL by 4x. S = 1 must give the one-query kernel's bits; head dim 48,
    bad q_pos and q_pos with k_pos or a window are refused. Then the
    batch-8 verify timed (bf16, identity table) beside its bound, the
    one-query kernel at the same seq_lens, S one-query launches (seq_lens
    = start + i + 1) and SDPA over the slot cache with the boolean causal
    mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(11)
    L = SERVE_CACHE_LEN
    serve = 1056 + rng.integers(0, SERVE_NEW - VERIFY_S, 8)
    # the draft's lead starts at text positions t_len - 1 (prompt of
    # SERVE_TEXT, up to SERVE_NEW emitted); inactive rows at d_scr - 1
    text = SERVE_TEXT - 1 + rng.integers(0, SERVE_NEW, 8)
    lead = np.concatenate([text[:6], [DRAFT_CACHE_LEN - 2] * 2])
    pool = dict(page=DRAFT_PAGE, length=DRAFT_CACHE_LEN)
    edges = {
        "serve_b8": dict(s=VERIFY_S, starts=serve),
        "serve_b8_permuted": dict(s=VERIFY_S, starts=serve, permute=True),
        "scratch_rows": dict(s=VERIFY_S, starts=[1060, L - 1, 40, L - 1,
                                                 L - 2 - VERIFY_S, 0]),
        "split_boundaries": dict(s=VERIFY_S, starts=[29, 30, 31, 62, 63, 95,
                                                     127, 1], permute=True),
        "s1": dict(s=1, starts=serve),
        "s2_lead": dict(s=2, starts=serve - 1000),
        "s8": dict(s=8, starts=[0, 25, 500, L - 1, L - 9, 1070]),
        "g8_d64_s8": dict(s=8, starts=[3, 300, L - 1, 700], h=16, d=64),
        "page5": dict(s=VERIFY_S, starts=[0, 33, 500, 1090, L - 1],
                      page=5, length=1100, permute=True),
        "draft_pool_lead": dict(s=2, starts=lead, **pool),
        "draft_pool_lead_permuted": dict(s=2, starts=lead, permute=True,
                                         **pool),
    }
    sensed = ("serve_b8", "serve_b8_permuted", "s2_lead", "draft_pool_lead",
              "draft_pool_lead_permuted")
    # the draft's decode steps: one query at text position t_len + 1 (the
    # lead's second token's successor), inactive rows at d_scr
    steps = np.concatenate([text[:6] + 2, [DRAFT_CACHE_LEN - 1] * 2])
    errs, rel, sense = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for name, kw in edges.items():
            args, qp, _ = _mq_case(rng, dtype, **kw)
            got = pa.paged_attention(*args, q_pos=qp)
            torch.cuda.synchronize()
            want = pa.paged_attention_plain(*args, q_pos=qp)
            scale = float(want.float().abs().max())
            e = errs[f"{name}/{dt}"] = max_err(got, want)
            r = rel[f"{name}/{dt}"] = e / scale
            check(e <= TOL[dtype] and r <= REL_TOL[dtype],
                  f"paged verify {name} {dtype}: err {e}, {r} of max|ref|")
            if name in sensed:
                wrong = pa.paged_attention_plain(*args, q_pos=qp - 1)
                d = sense[f"{name}/{dt}"] = max_err(wrong, want) / scale
                check(d > 4 * REL_TOL[dtype], f"paged verify {name} {dtype}:"
                      f" a dropped causal key moves it only {d} of max|ref|")
            if name == "s1":
                one = pa.paged_attention(args[0][:, 0].contiguous(),
                                         *args[1:])
                check(torch.equal(got[:, 0], one),
                      f"paged verify S=1 {dtype} != the one-query kernel")
        for perm in (False, True):   # the draft's one-query decode steps
            name = "draft_pool_decode" + ("_permuted" if perm else "")
            args, _, _ = _mq_case(rng, dtype, s=1, starts=steps,
                                  permute=perm, **pool)
            q1 = (args[0][:, 0].contiguous(),) + args[1:]
            got = pa.paged_attention(*q1)
            torch.cuda.synchronize()
            want = pa.paged_attention_plain(*q1)
            e = errs[f"{name}/{dt}"] = max_err(got, want)
            r = rel[f"{name}/{dt}"] = e / float(want.float().abs().max())
            check(e <= TOL[dtype] and r <= REL_TOL[dtype],
                  f"paged draft decode {name} {dtype}: err {e}, {r} of "
                  "max|ref|")
    refused = {}
    args, qp, _ = _mq_case(rng, torch.bfloat16, s=VERIFY_S, starts=serve)
    q48 = torch.zeros((8, 9, 12, 48), dtype=torch.bfloat16, device="cuda")
    kp48 = torch.zeros(args[1].shape[:3] + (48,), dtype=torch.bfloat16,
                       device="cuda")
    bad = {"head_dim_48": ((q48, kp48, kp48) + args[3:], dict(
               q_pos=torch.zeros((8, 9), dtype=torch.int32, device="cuda"))),
           "q_pos_int64": (args, dict(q_pos=qp.long())),
           "q_pos_b": (args, dict(q_pos=qp[:, 0].contiguous())),
           "with_k_pos": (args, dict(q_pos=qp, k_pos=torch.zeros(
               args[1].shape[:2], dtype=torch.int32, device="cuda"))),
           "with_window": (args, dict(q_pos=qp, window=64))}
    for name, (a, kw) in bad.items():
        try:
            pa.paged_attention(*a, **kw)
            refused[name] = False
        except ValueError:
            refused[name] = True
    check(all(refused.values()), f"paged verify refusals {refused}")

    # timing: the serve's batch-8 verify (bf16, identity table)
    dtype = torch.bfloat16
    args, qp, (k, v) = _mq_case(rng, dtype, s=VERIFY_S, starts=serve)
    q, kp, vp, table, seq = args
    b, s, h, d = q.shape
    kvh = kp.shape[2]
    elt = q.element_size()
    n_keys = int(torch.minimum(qp + 1, seq[:, None]).sum())
    nbytes = elt * (2 * q.numel() + 2 * int(seq.sum()) * kvh * d) \
        + 4 * (table.numel() + b + qp.numel())
    b_ms, b_by = bound(nbytes, 4 * h * d * n_keys, dtype)
    q1 = q[:, -1].contiguous()
    singles = [(q[:, i].contiguous(), (qp[:, i] + 1).contiguous())
               for i in range(s)]

    def s_launches():
        for qi, sl in singles:
            pa.paged_attention(qi, kp, vp, table, sl)
    rows = torch.arange(SERVE_CACHE_LEN, device="cuda")
    mask = ((rows[None, None] < seq[:, None, None])
            & (rows[None, None] <= qp[:, :, None]))[:, None]   # [B,1,S,L]
    qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = {"ms": time_ms(lambda: pa.paged_attention(*args, q_pos=qp), flush),
           "one_query_ms": time_ms(lambda: pa.paged_attention(q1, kp, vp,
                                                              table, seq),
                                   flush),
           "s_launches_ms": time_ms(s_launches, flush),
           "plain_ms": time_ms(lambda: pa.paged_attention_plain(
               *args, q_pos=qp), flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               qs, ks, vs, attn_mask=mask, enable_gqa=True), flush),
           "max_abs_err": errs["serve_b8/bfloat16"]}
    check(row["ms"] < row["s_launches_ms"],
          f"the multi-query kernel ({row['ms']} ms) is not faster than "
          f"{s} one-query launches ({row['s_launches_ms']} ms)")
    emit("paged_verify", shape=dict(b=b, s=s, h=h, kvh=kvh, d=d,
                                    cache_len=SERVE_CACHE_LEN, page=16,
                                    seq_lens=seq.tolist()),
         draft_pool=dict(cache_len=DRAFT_CACHE_LEN, page=DRAFT_PAGE,
                         lead_starts=lead.tolist(),
                         decode_seq_lens=(steps + 1).tolist()),
         errors=errs, rel_errors=rel, dropped_key_rel=sense,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         rel_tolerance={"float32": REL_TOL[torch.float32],
                        "bfloat16": REL_TOL[torch.bfloat16]},
         refused=refused, bytes=nbytes, key_rows=n_keys,
         verify_bf16=row)
    return row


class EngineProbe:
    """For one phase, wraps three ``Engine`` methods at class level (the
    compacting engine builds its own model, so the model-level CallTimer
    does not see it): counts prefill chunks and decode iterations, and for
    each compaction records its request, budget, synchronised wall ms and
    the count of ``slot_pos >= 0`` in every layer right after it."""
    NAMES = ("_do_prefill_chunk", "_decode_iteration", "_compact_slot")

    def __enter__(self):
        from repro_torch.core.serving.engine import Engine
        self.cls, self.orig = Engine, {n: getattr(Engine, n)
                                       for n in self.NAMES}
        self.prefill_chunks, self.decode_iters, self.compactions = 0, 0, []
        probe = self

        def chunk(eng, req, n):
            probe.prefill_chunks += 1
            return probe.orig["_do_prefill_chunk"](eng, req, n)

        def decode(eng, reqs):
            probe.decode_iters += 1
            return probe.orig["_decode_iteration"](eng, reqs)

        def compact(eng, slot, selector, budget):
            pos_end = int(eng.slot_pos[slot])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe.orig["_compact_slot"](eng, slot, selector, budget)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kept = (eng.pool["layers"]["slot_pos"][:, slot] >= 0).sum(-1)
            req = eng.slot_req[slot]
            probe.compactions.append({
                "rid": req.rid, "compression": req.compression,
                "selector": selector, "budget": budget, "pos_end": pos_end,
                "kept_min": int(kept.min()), "kept_max": int(kept.max()),
                "ms": ms})
        for n, fn in zip(self.NAMES, (chunk, decode, compact)):
            setattr(Engine, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.cls, n, fn)


def _profile_calls(runs: dict, cpu: bool = True) -> dict:
    """Device busy and wall ms per call of each ``(fn, n)`` under
    torch.profiler (device-side events only; ``cpu=False`` records the
    device's activity alone, for calls of ~10^5 launches, whose host
    events would take minutes to sort), after one warm-up call:
    idle share (1 - busy / wall), the largest kernels, the port's kernels'
    device ms per launch (comparable across the kernels phase's timing
    methods) and device ms per call of every kernel (``by_kernel``)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (fn, n) in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if cpu else [])) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        evts = _kernel_events(prof)
        busy = sum(_device_ms(e) for e in evts) / n
        top = sorted(evts, key=_device_ms, reverse=True)[:8]
        out[name] = {"wall_ms_per_call": wall,
                     "device_busy_ms_per_call": busy if evts else None,
                     "idle_share": (1 - busy / wall) if evts else None,
                     "top_kernels": [{"name": e.key[:60],
                                      "ms_per_call": _device_ms(e) / n,
                                      "count_per_call": e.count / n}
                                     for e in top],
                     "port_kernels_ms_per_launch": {
                         k: _device_ms(e) / e.count for e in evts
                         for k in ("flash_fwd_kernel", "flash_fwd_wide_kernel",
                                   "paged_split_kernel",
                                   "paged_mma_kernel", "paged_combine_kernel",
                                   "mla_split_kernel", "mla_tc_kernel",
                                   "mla_merge_kernel")
                         if k in e.key},
                     "by_kernel": {e.key[:60]: _device_ms(e) / n
                                   for e in evts}}
    return out


def _busy_diff(a: dict, b: dict, n: int = 5) -> list:
    """The kernels whose device ms per call differ most between two
    ``_profile_calls`` readings (a minus b); pops their ``by_kernel``."""
    ka, kb = a.pop("by_kernel"), b.pop("by_kernel")
    diff = {k: ka.get(k, 0.0) - kb.get(k, 0.0) for k in set(ka) | set(kb)}
    return [{"name": k, "ms_per_call": v}
            for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:n]]


def phase_kv_compaction_serve(lvlm) -> dict:
    """qwen2-vl-2b at full width, bf16: a compacting engine (the default
    strategy streaming-kv-256 through ``LVLM.serve``), cache_len 1152,
    max_batch 8, 8 requests of 1024 visual + 32 text tokens and 32 new
    tokens, each naming its own strategy (KV_MIX), under the continuous
    and then the chunked scheduler (16-token chunks, so the windowed
    extend runs: 32 text tokens fit one 256-token chunk). Checks every
    request finished, every compacted slot holds exactly its budget of
    positions in every layer, and both kernels' launches per prefill
    chunk and decode step; prints compaction ms per request and the
    device busy per decode step of the compacted pool beside a plain pool
    at the same positions. Then ``generate`` with
    ``GenerationConfig(compression="l2-kv")`` on two prompts."""
    from repro_torch.api import (EngineConfig, GenerationConfig, LVLM,
                                 Request, resolve_compression)
    from repro_torch.core.token_compression.policy import CompressionStrategy
    cfg = lvlm.cfg
    L, nv = cfg.num_layers, cfg.num_visual_tokens
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_TEXT).tolist()
               for _ in KV_MIX]
    ves = [rng.standard_normal((nv, cfg.d_model)).astype(np.float32)
           for _ in KV_MIX]

    def make():
        return [Request(rid=i, tokens=list(p), max_new_tokens=SERVE_NEW,
                        visual_embeds=ve, compression=c)
                for i, (p, ve, c) in enumerate(zip(prompts, ves, KV_MIX))]
    budgets = {c: CompressionStrategy(resolve_compression(c)).decode_budget()
               for c in KV_MIX}
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, decoder="greedy",
                           compression=KV_MIX[0])
    out, launches = {}, None
    for sched, extra in (("continuous", {}),
                         ("chunked", dict(chunk_size=16, token_budget=4096))):
        ec = EngineConfig(max_batch=8, cache_len=KV_CACHE_LEN,
                          scheduler=sched, **extra)
        _reset_counts()
        t0 = time.perf_counter()
        with EngineProbe() as probe:
            rep = lvlm.serve(make(), ec, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        launches = counts if launches is None else {
            k: launches[k] + counts[k] for k in counts}
        eng = rep.engine
        check(eng.compacting and eng.cfg.sliding_window == KV_CACHE_LEN,
              "the kv default did not build a compacting engine")
        check(len(rep.requests) == len(KV_MIX)
              and all(len(r.generated) == SERVE_NEW for r in rep.requests),
              f"compacting serve ({sched}) did not finish every request")
        by_c = {c["compression"]: c for c in probe.compactions}
        want = {c for c, bud in budgets.items() if bud}
        check(set(by_c) == want, f"compacted {sorted(by_c)}, want "
              f"{sorted(want)}")
        for c, rec in by_c.items():
            check(rec["kept_min"] == rec["kept_max"] == budgets[c]
                  and rec["pos_end"] == SERVE_TEXT + nv,
                  f"{c}: slot_pos >= 0 {rec} after compaction, budget "
                  f"{budgets[c]}")
        check(counts["flash_attention"] >= L * probe.prefill_chunks > 0,
              f"flash launches {counts} vs {probe.prefill_chunks} chunks")
        check(counts["paged_attention"] >= L * probe.decode_iters > 0,
              f"paged launches {counts} vs {probe.decode_iters} steps")
        out[sched] = {
            "wall_seconds": wall, "prefill_chunks": probe.prefill_chunks,
            "decode_steps": probe.decode_iters, "launches": counts,
            "compaction": {c: {k: r[k] for k in ("selector", "budget",
                                                 "pos_end", "kept_min",
                                                 "ms")}
                           for c, r in by_c.items()},
            "compression_stats": eng.compression_stats(),
            "virtual_ttft_s": {r.compression: r.ttft() for r in rep.requests}}
        if sched == "continuous":
            tokens = {r.rid: r.generated for r in rep.requests}
            ceng = eng
        else:
            agree = float(np.mean([a == b for r in rep.requests
                                   for a, b in zip(r.generated,
                                                   tokens[r.rid])]))
            out[sched]["token_agreement_with_continuous"] = agree
    # device busy per decode step: the compacted (windowed, masked) pool
    # against a plain pool read at the same positions (batch 8)
    model, params = ceng.model, ceng.params
    cls = type(model)
    toks = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    pos = torch.full((8,), 1056 + SERVE_NEW // 2, device="cuda")
    plain = lvlm.model.init_cache(8, KV_CACHE_LEN, device="cuda")
    prof = _profile_calls({
        "decode_step_b8_compacted": (lambda: cls.decode_step(
            model, params, ceng.pool, toks, pos, windowed=True), 10),
        "decode_step_b8_plain": (lambda: cls.decode_step(
            lvlm.model, params, plain, toks, pos), 10)})
    prof["compacted_minus_plain"] = _busy_diff(
        prof["decode_step_b8_compacted"], prof["decode_step_b8_plain"])
    # the facade's default: generate with a kv preset
    _reset_counts()
    with EngineProbe() as probe:
        gres = lvlm.generate(prompts[:2], GenerationConfig(
            max_new_tokens=SERVE_NEW, decoder="greedy", compression="l2-kv"),
            visual_embeds=ves[:2])
    torch.cuda.synchronize()
    gcounts = _counts()
    check(all(len(r.tokens) == SERVE_NEW for r in gres)
          and [c["budget"] for c in probe.compactions] == [64, 64]
          and all(c["kept_min"] == c["kept_max"] == 64
                  for c in probe.compactions),
          f"generate(compression='l2-kv') failed: {probe.compactions}")
    check(gcounts["flash_attention"] >= L * probe.prefill_chunks > 0
          and gcounts["paged_attention"] >= L * probe.decode_iters > 0,
          f"generate launches {gcounts}")
    emit("kv_compaction_serve", config=cfg.name, dtype=cfg.dtype,
         presets=list(KV_MIX), cache_len=KV_CACHE_LEN, **out,
         profile=prof,
         generate_l2_kv={"launches": gcounts,
                         "compaction_ms": [c["ms"] for c in
                                           probe.compactions]})
    return {k: launches[k] + gcounts[k] for k in launches}


def phase_prefix_cache_serve(lvlm) -> dict:
    """qwen2-vl-2b at full width, bf16, ``EngineConfig(prefix_cache=True,
    prefix_block=16)``: a request of the 512-token system prompt alone,
    then 8 text-only requests of that system prompt plus their own 32-token
    tail, 32 new tokens each, under the continuous and chunked schedulers
    (chunks of 1024 tokens: a hit reuses at most the first chunk, less
    one token, as in the reference). The engine caches whole
    block-aligned prompts (the reference's host map), so the system
    prompt becomes reusable once the first request has served it. Checks greedy tokens equal the same serve without the
    prefix cache and 28 flash launches per prefill or extend; prints the
    token hit rate, and the device busy and wall ms of a hit (a 32-token
    extend over 544 keys) against a cold 544-token prefill."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    cfg = lvlm.cfg
    L = cfg.num_layers
    rng = np.random.default_rng(8)
    system = rng.integers(0, cfg.vocab_size, 512).tolist()
    prompts = [system] + [system + rng.integers(0, cfg.vocab_size,
                                                SERVE_TEXT).tolist()
                          for _ in range(8)]

    def make():
        return [Request(rid=i, tokens=list(p), max_new_tokens=SERVE_NEW)
                for i, p in enumerate(prompts)]
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, decoder="greedy")
    cache_len = LVLM._cache_len(make(), gen)
    out, launches = {}, None
    for sched, extra in (("continuous", {}),
                         ("chunked", dict(chunk_size=1024,
                                          token_budget=8192))):
        res = {}
        for prefix in (True, False):
            ec = EngineConfig(max_batch=8, cache_len=cache_len,
                              scheduler=sched, prefix_cache=prefix,
                              prefix_block=16, **extra)
            _reset_counts()
            t0 = time.perf_counter()
            with EngineProbe() as probe:
                rep = lvlm.serve(make(), ec, gen)
            torch.cuda.synchronize()
            res[prefix] = (rep, time.perf_counter() - t0, _counts(),
                           probe.prefill_chunks)
        rep, wall, counts, chunks = res[True]
        launches = counts if launches is None else {
            k: launches[k] + counts[k] for k in counts}
        same = ({r.rid: r.generated for r in rep.requests}
                == {r.rid: r.generated for r in res[False][0].requests})
        check(same and len(rep.requests) == len(prompts),
              f"prefix-cache serve ({sched}) tokens differ from the serve "
              "without it")
        check(rep.stats["prefix_hit_tokens"] == 8 * 512,
              f"prefix hits {rep.stats['prefix_hit_tokens']}, want "
              f"{8 * 512}")
        check(counts["flash_attention"] == L * chunks,
              f"flash launches {counts} vs {chunks} prefill chunks")
        out[sched] = {"prefix_hit_tokens": rep.stats["prefix_hit_tokens"],
                      "prefix_token_hit_rate":
                          rep.stats["prefix_token_hit_rate"],
                      "flash_launches_per_prefill":
                          counts["flash_attention"] / chunks,
                      "wall_seconds": wall,
                      "wall_seconds_without_prefix_cache": res[False][1],
                      "virtual_ttft_mean_s": rep.stats["ttft_mean"],
                      "virtual_ttft_mean_s_without":
                          res[False][0].stats["ttft_mean"],
                      "launches": counts}
    # device busy and wall of a hit (extend 32 over 544 keys) against a
    # cold prefill of the same 544 tokens
    model, params = lvlm.model, lvlm.params
    cls = type(model)
    toks = torch.tensor([prompts[1]], device="cuda")
    _, pool = cls.prefill(model, params, {"tokens": toks[:, :512]},
                          cache_len=cache_len)
    prof = _profile_calls({
        "prefix_hit_extend_32_over_544": (lambda: cls.extend(
            model, params, pool, toks[:, 512:], 512), 5),
        "cold_prefill_544": (lambda: cls.prefill(
            model, params, {"tokens": toks}, cache_len=cache_len,
            last_only=True), 5)})
    prof["hit_minus_cold"] = _busy_diff(prof["prefix_hit_extend_32_over_544"],
                                        prof["cold_prefill_544"])
    emit("prefix_cache_serve", config=cfg.name, dtype=cfg.dtype,
         system_prompt=512, tail=SERVE_TEXT, requests=len(prompts),
         cache_len=cache_len, **out, profile=prof)
    return launches


def phase_kv_cache_smoke() -> None:
    """qwen2-vl smoke in float32, the port on the card against the port on
    the CPU: the compacting engine (per-request KV budgets) and the
    prefix-cache engine give identical greedy tokens, compression stats
    and prefix stats; every selector keeps the same positions; a
    ``PagedKVPool`` filled through a ``BlockAllocator``, with two sequences
    sharing prefix blocks through ``RadixPrefixCache``, is read through
    the paged kernel against its plain version."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.core.kv_cache import (SELECTORS, BlockAllocator,
                                           PagedKVPool, RadixPrefixCache,
                                           SeqBlocks)
    from repro_torch.kernels import paged_attention as pa
    cpu = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0,
                               device="cpu")
    card = cpu.with_params(_tree_to(cpu.params, "cuda"))
    cfg = cpu.cfg
    rng = np.random.default_rng(9)
    mix = ("streaming-kv-16", "l2-kv-12", "none", "fastv-0.5",
           "streaming-kv-24", "l2-kv-8")
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 12, 7, 14, 10, 8)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) for _ in mix]
    system = rng.integers(0, cfg.vocab_size, 24).tolist()
    pre = [system] + [system + rng.integers(0, cfg.vocab_size, 3 + i
                                            ).tolist() for i in range(5)]

    def kv_reqs():
        return [Request(rid=i, tokens=list(p), max_new_tokens=6,
                        visual_embeds=v, arrival=0.002 * i, compression=c)
                for i, (p, v, c) in enumerate(zip(prompts, ves, mix))]

    def prefix_reqs():
        return [Request(rid=i, tokens=list(p), max_new_tokens=6,
                        arrival=0.002 * i) for i, p in enumerate(pre)]
    out = {}
    for sched in ("continuous", "chunked"):
        kw = dict(max_batch=3, cache_len=48, scheduler=sched, chunk_size=8,
                  token_budget=24)
        gen = GenerationConfig(max_new_tokens=6, decoder="greedy",
                               compression=mix[0])
        _reset_counts()
        sc = cpu.serve(kv_reqs(), EngineConfig(**kw), gen)
        sg = card.serve(kv_reqs(), EngineConfig(**kw), gen)
        kv_counts = _counts()
        pkw = dict(kw, prefix_cache=True, prefix_block=8)
        gen = GenerationConfig(max_new_tokens=6, decoder="greedy")
        pc = cpu.serve(prefix_reqs(), EngineConfig(**pkw), gen)
        pg = card.serve(prefix_reqs(), EngineConfig(**pkw), gen)
        row = {
            "compacting_tokens_equal": ({r.rid: r.generated
                                         for r in sc.requests}
                                        == {r.rid: r.generated
                                            for r in sg.requests}),
            "compacting_stats_equal": (sc.engine.compression_stats()
                                       == sg.engine.compression_stats()),
            "prefix_tokens_equal": ({r.rid: r.generated for r in pc.requests}
                                    == {r.rid: r.generated
                                        for r in pg.requests}),
            "prefix_stats_equal": all(
                pc.stats[k] == pg.stats[k]
                for k in ("prefix_hit_tokens", "prefix_token_hit_rate")),
            "prefix_hit_tokens": pg.stats["prefix_hit_tokens"],
            "compacting_launches": kv_counts}
        check(all(v for k, v in row.items() if k.endswith("_equal"))
              and len(sg.requests) == len(mix)
              and pg.stats["prefix_hit_tokens"] > 0
              and all(kv_counts.values()),
              f"kv smoke card != CPU under {sched}: {row}")
        out[sched] = row
    # every selector, card against CPU (float32, layers as the batch)
    k = rng.standard_normal((4, 96, 2, 64)).astype(np.float32)
    v = rng.standard_normal((4, 96, 2, 64)).astype(np.float32)
    a = rng.random((4, 3, 96, 96)).astype(np.float32)
    sel = {}
    for name, fn in SELECTORS.items():
        args = [torch.from_numpy(x) for x in (k, v, a)]
        kc, vc, pc_ = fn(args[0], args[1], budget=40, attn=args[2])
        kg, vg, pg_ = fn(*(x.cuda() for x in args[:2]), budget=40,
                         attn=args[2].cuda())
        same = torch.equal(pg_.cpu(), pc_) and torch.equal(kg.cpu(), kc) \
            and torch.equal(vg.cpu(), vc)
        sel[name] = same
        check(same, f"selector {name}: card != CPU")
    # a paged pool filled through the block allocator; sequence B shares
    # sequence A's first two blocks through the radix prefix cache
    page, kvh, d, h = 16, 2, 128, 12
    alloc = BlockAllocator(num_blocks=16, block_size=page)
    pool = PagedKVPool(1, 16, page, kvh, d, torch.float32, device="cuda")
    radix = RadixPrefixCache(alloc)
    toks_a = rng.integers(0, 1000, 45).tolist()
    seq_a = SeqBlocks([alloc.alloc() for _ in range(3)])
    pool.write_prefill(seq_a, randn(rng, (1, 45, kvh, d), torch.float32),
                       randn(rng, (1, 45, kvh, d), torch.float32))
    radix.insert(toks_a, seq_a.block_ids, page)
    toks_b = toks_a[:32] + rng.integers(1000, 2000, 20).tolist()
    shared, matched, pinned = radix.match_prefix(toks_b)
    check(matched == 32 and shared == seq_a.block_ids[:2],
          f"radix match {matched} tokens, blocks {shared}")
    for blk in shared:
        alloc.share(blk)
    seq_b = SeqBlocks(shared + [alloc.alloc() for _ in range(2)],
                      length=matched)
    for _ in range(len(toks_b) - matched):
        pool.append_token(seq_b, randn(rng, (1, kvh, d), torch.float32),
                          randn(rng, (1, kvh, d), torch.float32))
    table = torch.tensor([seq_a.block_ids + [0], seq_b.block_ids],
                         dtype=torch.int32, device="cuda")
    seq = torch.tensor([seq_a.length, seq_b.length], dtype=torch.int32,
                       device="cuda")
    q = randn(rng, (2, h, d), torch.float32)
    got = pa.paged_attention(q, pool.k[0], pool.v[0], table, seq)
    torch.cuda.synchronize()
    e_pool = max_err(got, pa.paged_attention_plain(q, pool.k[0], pool.v[0],
                                                   table, seq))
    check(e_pool <= TOL[torch.float32], f"paged pool read: err {e_pool}")
    kb, _ = pool.gather(seq_b, 0)
    ka, _ = pool.gather(seq_a, 0)
    check(torch.equal(kb[:32], ka[:32]), "shared blocks differ")
    radix.unpin(pinned)
    emit("kv_cache_smoke", config=cfg.name, **out, selectors_equal=sel,
         paged_pool={"seq_lens": seq.tolist(), "shared_blocks": shared,
                     "err": e_pool, "allocator_free": alloc.num_free})


def _top2_gap(lvlm, prompt, ve, stream) -> float:
    """The target's top-2 logit gap where it chose ``stream``'s last
    token: the last position of a prefill of prompt + stream[:-1] (after
    the visual embeddings ``ve``, if any)."""
    batch = {"tokens": torch.tensor([list(prompt) + stream[:-1]],
                                    device="cuda")}
    if ve is not None:
        batch["visual_embeds"] = torch.from_numpy(ve).cuda()[None]
    logits, _ = lvlm.model.prefill(lvlm.params, batch, last_only=True)
    top = torch.topk(logits[0, -1].float(), 2).values
    return float(top[0] - top[1])


def phase_spec_serve(lvlm) -> dict:
    """qwen2-vl-2b at full width, bf16, speculative decoding through
    ``LVLM.serve``: 8 requests of 1024 visual + 32 text tokens, 32 new
    tokens, gamma 4, temperature 0, max_batch 8, with the target drafting
    for itself (``draft=None``) and with a 2-layer draft cut from the
    target's config (same widths and vocab, random weights, seed 1),
    beside a greedy serve of the same inputs; then one serve mixing
    greedy, sampling, speculative and early-exit requests per
    ``Request.decoder`` (temperature 0.7). Checks every request finished,
    >= 2 slots per round, 28 + draft-depth multi-query launches per round
    (the verify and the draft's lead), and counts the requests whose
    tokens equal greedy's, with the top-2 logit gap at each first
    difference (bf16 verify and decode round differently). Then the hard
    check in float32: 4 text + visual requests, 16 new tokens,
    speculative tokens identical to greedy. Profiles a batch-8 verify
    (S = 5), the draft's lead and decode step and a plain decode step."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.kernels import paged_attention as pa
    cfg = lvlm.cfg
    L, nv = cfg.num_layers, cfg.num_visual_tokens
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_TEXT).tolist()
               for _ in range(8)]
    ves = [rng.standard_normal((nv, cfg.d_model)).astype(np.float32)
           for _ in range(8)]

    def make(decs=(None,) * 8):
        return [Request(rid=i, tokens=list(p), max_new_tokens=SERVE_NEW,
                        visual_embeds=ve, decoder=dec)
                for i, (p, ve, dec) in enumerate(zip(prompts, ves, decs))]
    spec = GenerationConfig(max_new_tokens=SERVE_NEW, decoder="speculative",
                            gamma=GAMMA, temperature=0.0)
    ec = EngineConfig(max_batch=8, cache_len=LVLM._cache_len(make(), spec))
    check(ec.cache_len == SERVE_CACHE_LEN, f"spec cache_len {ec.cache_len}")
    n_tok = 8 * SERVE_NEW
    _reset_counts()
    t0 = time.perf_counter()
    greedy = lvlm.serve(make(), ec, GenerationConfig(
        max_new_tokens=SERVE_NEW, decoder="greedy"))
    torch.cuda.synchronize()
    greedy_wall = time.perf_counter() - t0
    launches = _counts()
    want = {r.rid: r.generated for r in greedy.requests}
    draft = LVLM.from_config(cfg.with_(num_layers=2), seed=1)
    out = {"greedy": {"wall_seconds": greedy_wall,
                      "wall_ms_per_token": greedy_wall * 1e3 / n_tok,
                      "launches": dict(launches)}}
    for name, d, depth in (("self_draft", None, L),
                           ("draft_2_layers", draft, 2)):
        _reset_counts()
        pa.paged_attention.multi_query_launches = 0
        t0 = time.perf_counter()
        rep = lvlm.serve(make(), ec, spec, draft=d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, mq = _counts(), pa.paged_attention.multi_query_launches
        launches = {k: launches[k] + counts[k] for k in counts}
        st = rep.stats
        check(len(rep.requests) == 8 and all(len(r.generated) == SERVE_NEW
                                             for r in rep.requests),
              f"speculative serve ({name}) did not finish every request")
        check(st["max_slots_per_round"] >= 2,
              f"{name}: {st['max_slots_per_round']} slots per round")
        check(mq == (L + depth) * st["spec_rounds"] > 0,
              f"{name}: {mq} multi-query launches for {st['spec_rounds']} "
              f"rounds")
        check(st["proposed"] == GAMMA * st["target_calls"],
              f"{name}: a round cut its gamma")
        check(counts["flash_attention"] >= L * 8,
              f"{name}: flash launches {counts}")
        diffs = {}
        for r in rep.requests:
            g = want[r.rid]
            k = next((i for i, (a, b) in enumerate(zip(r.generated, g))
                      if a != b), None)
            if k is not None:
                diffs[r.rid] = {"first_difference": k, "target_top2_gap":
                                _top2_gap(lvlm, prompts[r.rid], ves[r.rid],
                                          g[:k + 1])}
        out[name] = {
            "wall_seconds": wall, "wall_ms_per_token": wall * 1e3 / n_tok,
            "acceptance": st["acceptance"],
            "mean_accepted_per_call": st["mean_accepted_per_call"],
            "max_slots_per_round": st["max_slots_per_round"],
            "spec_rounds": st["spec_rounds"],
            "multi_query_launches": mq, "launches": counts,
            "requests_equal_to_greedy": 8 - len(diffs),
            "differences": diffs}

    # one serve mixing the four strategies (two requests each)
    decs = ("greedy", "sampling", "speculative", "early_exit") * 2
    _reset_counts()
    pa.paged_attention.multi_query_launches = 0
    t0 = time.perf_counter()
    rep = lvlm.serve(make(decs), ec, GenerationConfig(
        max_new_tokens=SERVE_NEW, decoder="greedy", gamma=GAMMA,
        temperature=0.7))
    torch.cuda.synchronize()
    counts, mq = _counts(), pa.paged_attention.multi_query_launches
    launches = {k: launches[k] + counts[k] for k in counts}
    st = rep.stats
    check(len(rep.requests) == 8 and all(len(r.generated) == SERVE_NEW
                                         for r in rep.requests)
          and st["speculative/max_slots_per_round"] >= 2
          and "early_exit/exit_rate" in st and mq > 0,
          f"mixed-decoder serve failed: {mq} multi-query launches, "
          f"{ {k: v for k, v in st.items() if '/' in k} }")
    out["mixed"] = {"wall_seconds": time.perf_counter() - t0,
                    "decoders": list(decs), "launches": counts,
                    "multi_query_launches": mq,
                    "decode_cost_by_group": st["decode_cost_by_group"],
                    "speculative/acceptance": st["speculative/acceptance"],
                    "early_exit/layers_used_mean":
                        st["early_exit/layers_used_mean"]}

    # device busy: a batch-8 verify, the draft's steps, a decode step
    model, params = lvlm.model, lvlm.params
    cls = type(model)                 # bypass the CallTimer wrappers
    pool = model.init_cache(8, SERVE_CACHE_LEN, device="cuda")
    d_pool = draft.model.init_cache(8, SERVE_CACHE_LEN + GAMMA + 8,
                                    device="cuda")
    starts = torch.from_numpy(1056 + rng.integers(0, 27, 8)).cuda()
    blk = torch.zeros((8, VERIFY_S), dtype=torch.long, device="cuda")
    prof = _profile_calls({
        "verify_extend_b8_s5": (lambda: cls.extend(
            model, params, pool, blk, starts), 5),
        "self_draft_lead_extend_b8_s2": (lambda: cls.extend(
            model, params, pool, blk[:, :2], starts - 1), 5),
        "decode_step_b8": (lambda: cls.decode_step(
            model, params, pool, blk[:, :1], starts), 5),
        "draft2_lead_extend_b8_s2": (lambda: draft.model.extend(
            draft.params, d_pool, blk[:, :2], starts - 1025), 5),
        "draft2_decode_step_b8": (lambda: draft.model.decode_step(
            draft.params, d_pool, blk[:, :1], starts - 1023), 5)})
    for row in prof.values():
        row.pop("by_kernel")
    del draft, pool, d_pool

    # the hard check: float32 at full width, speculative == greedy
    f32 = LVLM.from_pretrained("qwen2-vl-2b", seed=0, dtype="float32")
    f_prompts = [rng.integers(0, cfg.vocab_size, SERVE_TEXT).tolist()
                 for _ in range(4)]
    f_ves = [rng.standard_normal((nv, cfg.d_model)).astype(np.float32)
             for _ in range(4)]
    _reset_counts()
    pa.paged_attention.multi_query_launches = 0
    f_spec = f32.generate(f_prompts, GenerationConfig(
        max_new_tokens=16, decoder="speculative", gamma=GAMMA,
        temperature=0.0), visual_embeds=f_ves)
    f_mq = pa.paged_attention.multi_query_launches
    f_counts = _counts()
    f_greedy = f32.generate(f_prompts, GenerationConfig(
        max_new_tokens=16, decoder="greedy"), visual_embeds=f_ves)
    torch.cuda.synchronize()
    same32 = [a.tokens == b.tokens for a, b in zip(f_spec, f_greedy)]
    check(all(same32) and f_mq > 0,
          f"float32 speculative != greedy at full width: {same32}, "
          f"{f_mq} multi-query launches")
    out["float32"] = {"requests_equal_to_greedy": sum(same32),
                      "acceptance": f_spec[0].stats["acceptance"],
                      "multi_query_launches": f_mq, "launches": f_counts}
    del f32, f_spec, f_greedy
    torch.cuda.empty_cache()
    emit("spec_serve", config=cfg.name, dtype=cfg.dtype, gamma=GAMMA,
         cache_len=SERVE_CACHE_LEN, **out, profile=prof)
    return launches


def phase_early_exit_serve(lvlm, timer) -> dict:
    """qwen2-vl-2b at full width, bf16, early exit through
    ``LVLM.generate``, one request at a time (max_batch 1, so greedy runs
    the same shapes): 2 requests of 1024 visual + 32 text tokens and 2 of
    32 text tokens, 16 new tokens. ``exit_threshold=1.1`` never fires
    (tokens equal greedy's, 28 layers for every token);
    ``exit_threshold=0.0, exit_patience=0, exit_min_layers=1`` exits at
    layer 1 and back-fills 27 layers through the paged kernel. Prints
    wall ms per decoded token of each beside greedy's, and the device
    busy of one never-firing step beside a plain batch-1 decode step."""
    from repro_torch.api import GenerationConfig
    from repro_torch.core.decoding.early_exit import early_exit_decode_step
    cfg = lvlm.cfg
    L, nv = cfg.num_layers, cfg.num_visual_tokens
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_TEXT).tolist()
               for _ in range(4)]
    ves = [rng.standard_normal((nv, cfg.d_model)).astype(np.float32), None,
           rng.standard_normal((nv, cfg.d_model)).astype(np.float32), None]
    n_new = 16
    runs = {"greedy": dict(decoder="greedy"),
            "never_fires": dict(decoder="early_exit", exit_threshold=1.1),
            "exits_at_layer_1": dict(decoder="early_exit",
                                     exit_threshold=0.0, exit_patience=0,
                                     exit_min_layers=1)}
    out, toks, launches = {}, {}, None
    for name, kw in runs.items():
        _reset_counts()
        timer.reset()
        wall, res = 0.0, []
        for p, ve in zip(prompts, ves):
            t0 = time.perf_counter()
            res.append(lvlm.generate(p, GenerationConfig(
                max_new_tokens=n_new, temperature=0.0, **kw),
                visual_embeds=ve))
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        counts = _counts()
        launches = counts if launches is None else {
            k: launches[k] + counts[k] for k in counts}
        toks[name] = [r.tokens for r in res]
        decoded = sum(len(r.tokens) - 1 for r in res)
        decode_s = wall - timer.seconds["prefill"]
        out[name] = {"wall_seconds": wall,
                     "decode_ms_per_token": decode_s * 1e3 / decoded,
                     "launches": counts}
        check(all(len(t) == n_new for t in toks[name]),
              f"early exit {name}: short outputs")
        check(counts["paged_attention"] >= L * decoded,
              f"early exit {name}: paged launches {counts} for {decoded} "
              "decoded tokens")
        if name != "greedy":
            used = [u for r in res for u in r.stats["layers_used"]]
            out[name]["layers_used"] = sorted(set(used))
            out[name]["exit_rate"] = float(np.mean(
                [r.stats["exit_rate"] for r in res]))
    check(toks["never_fires"] == toks["greedy"]
          and out["never_fires"]["layers_used"] == [L]
          and out["never_fires"]["exit_rate"] == 0.0,
          f"exit_threshold=1.1 fired or left greedy: {out['never_fires']}")
    check(out["exits_at_layer_1"]["layers_used"] == [1]
          and out["exits_at_layer_1"]["exit_rate"] == 1.0,
          f"exit_threshold=0.0 did not exit at layer 1: "
          f"{out['exits_at_layer_1']}")
    # device busy of one step: never firing (28 layers + 27 logit lenses)
    # and exiting at layer 1 (+ 27 back-filled layers) beside a decode step
    model, params = lvlm.model, lvlm.params
    cls = type(model)
    pool = model.init_cache(1, SERVE_CACHE_LEN, device="cuda")
    tok = torch.zeros((1, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([1060], device="cuda")
    prof = _profile_calls({
        "early_exit_step_never_fires": (lambda: early_exit_decode_step(
            model, params, pool, tok, pos, threshold=1.1), 5),
        "early_exit_step_exits_at_1": (lambda: early_exit_decode_step(
            model, params, pool, tok, pos, threshold=0.0, patience=0,
            min_layers=1), 5),
        "decode_step_b1": (lambda: cls.decode_step(model, params, pool, tok,
                                                   pos), 5)})
    for row in prof.values():
        row.pop("by_kernel")
    emit("early_exit_serve", config=cfg.name, dtype=cfg.dtype,
         new_tokens=n_new, **out, profile=prof)
    return launches


def phase_decoding_smoke() -> None:
    """qwen2-vl smoke in float32, the port on the card against the port on
    the CPU: ``speculative_generate`` with a 1-layer draft (tokens and
    every SpecStats field), self-draft acceptance exactly 1.0 on a
    text-only prompt whose rounds tile (1 + 2 * (gamma + 1) tokens),
    LANTERN at temperature 0 (k 256, delta 0.6), a serve mixing the four
    strategies (visual and text requests, continuous and chunked), and
    ``early_exit_decode_step`` logits and depth at thresholds 1.1 and 0."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.core.decoding import speculative as sp
    from repro_torch.core.decoding.early_exit import early_exit_decode_step
    from repro_torch.kernels import paged_attention as pa
    cpu = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0,
                               device="cpu")
    card = cpu.with_params(_tree_to(cpu.params, "cuda"))
    dcpu = LVLM.from_config(cpu.cfg.with_(num_layers=1), seed=1,
                            device="cpu")
    dcard = dcpu.with_params(_tree_to(dcpu.params, "cuda"))
    cfg = cpu.cfg
    rng = np.random.default_rng(14)
    prompt = rng.integers(1, cfg.vocab_size, 12).tolist()
    g = 3
    out = {}
    _reset_counts()
    pa.paged_attention.multi_query_launches = 0

    def both(self_draft=False, **kw):
        res = []
        for t, d in ((cpu, dcpu), (card, dcard)):
            dd = t if self_draft else d
            res.append(sp.speculative_generate(
                t.model, dd.model, t.params, dd.params, prompt, gamma=g,
                temperature=0.0, **kw))
        (tc, sc), (tg, sg) = res
        return tc == tg and sc == sg, sg
    same, _ = both(max_new_tokens=10)
    out["speculative_generate_equal"] = same
    same_self, st_self = both(max_new_tokens=1 + 2 * (g + 1),
                              self_draft=True)
    out["self_draft_acceptance"] = sp.acceptance_rate(st_self)
    same_l, st_l = both(max_new_tokens=10, lantern_k=256,
                        lantern_delta=0.6)
    out["lantern_equal"] = same_l
    out["lantern_accepted"] = st_l.accepted
    check(same and same_self and same_l
          and out["self_draft_acceptance"] == 1.0,
          f"speculative_generate card != CPU: {out}")
    ps = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (9, 12, 7, 14,
                                                                10, 8)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) * 0.02 if i % 2 else None
           for i in range(6)]
    decs = ("speculative", "greedy", "early_exit", "speculative",
            "sampling", None)

    def reqs():
        return [Request(rid=i, tokens=list(p), max_new_tokens=8,
                        visual_embeds=ve, decoder=dec, arrival=0.002 * i)
                for i, (p, ve, dec) in enumerate(zip(ps, ves, decs))]
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy", gamma=g,
                           temperature=0.0)
    for sched in ("continuous", "chunked"):
        ec = EngineConfig(max_batch=4, cache_len=64, scheduler=sched,
                          chunk_size=8, token_budget=24)
        sc = cpu.serve(reqs(), ec, gen, draft=dcpu)
        sg = card.serve(reqs(), ec, gen, draft=dcard)
        same = ({r.rid: r.generated for r in sc.requests}
                == {r.rid: r.generated for r in sg.requests})
        same_stats = all(sc.stats[k] == sg.stats[k] for k in sc.stats
                         if "/" in k or k.endswith("_mean"))
        out[f"mixed_serve_{sched}"] = {"tokens_equal": same,
                                       "stats_equal": same_stats}
        check(same and same_stats and len(sg.requests) == 6,
              f"mixed-decoder smoke card != CPU under {sched}")
    for name, kw in (("never_fires", dict(threshold=1.1)),
                     ("exits_at_1", dict(threshold=0.0, patience=0,
                                         min_layers=1))):
        toks = torch.tensor([prompt])
        res = []
        for t in (cpu, card):
            _, cache = t.model.prefill(t.params, {"tokens": toks.to(
                t.device)}, cache_len=32)
            logits, cache, info = early_exit_decode_step(
                t.model, t.params, cache, toks[:, -1:].to(t.device), 12,
                **kw)
            res.append((logits.cpu(), cache["layers"]["k"][:, :, 12].cpu(),
                        info))
        e = max_err(res[1][0], res[0][0])
        e_cache = max_err(res[1][1], res[0][1])
        out[f"early_exit_{name}"] = {"logit_err": e, "cache_err": e_cache,
                                     "info": res[1][2]}
        check(e <= SMOKE_LOGIT_TOL and e_cache <= SMOKE_LOGIT_TOL
              and res[0][2] == res[1][2],
              f"early exit {name} card != CPU: {out[f'early_exit_{name}']}")
    out["launches"] = _counts()
    out["multi_query_launches"] = pa.paged_attention.multi_query_launches
    check(out["multi_query_launches"] > 0 and all(out["launches"].values()),
          f"decoding smoke launches {out['launches']}")
    emit("decoding_smoke", config=cfg.name, tolerance=SMOKE_LOGIT_TOL, **out)


# ------------------------------------------ head dim 32 and long verifies --

def _kernel_row(fn, plain, library, flush, nbytes, flops, dtype, err):
    """ms of ``fn``, ``plain`` and ``library`` beside the bound."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {"max_abs_err": err, "ms": time_ms(fn, flush),
            "plain_ms": time_ms(plain, flush), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(library, flush)}


def phase_kernels_d32(flush) -> dict:
    """Both kernels at head dim 32 (phi4-mini smoke's and every reference
    smoke config's but qwen2-vl's; a bf16 row is 64 bytes: the flash
    kernel's 64-byte-swizzled TMA box, the paged kernel's 4-piece
    swizzle) in float32 and bf16 against their plain versions at TOL:
    flash causal, windowed, kv_len < Sk, q_offset, keyless rows,
    non-causal and strided views; paged one-query (identity, permuted,
    seq_len 0, split boundaries), masked (compacted, ring, window, ahead)
    and multi-query (S = 2, 5, 9 and 17 at G = 4, also within REL_TOL of
    max|ref|). Then, in bf16, flash at phi4-mini smoke's heads (8 / 2) and
    the main path's 1056-token prefill, and the one-query kernel at batch
    8 over 1104 slots, each timed beside its bound, its plain version and
    SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(32)
    h, kvh, d, page, length = 8, 2, 32, 16, SERVE_CACHE_LEN
    main = dict(b=1, h=h, kvh=kvh, sq=1056, sk=1056, d=d)
    flash_cases = [
        ("main", main, {}),
        ("window_64", main, dict(window=64)),
        ("kv_len_lt_sk", dict(main, sq=64, sk=1104), dict(kv_len=1072)),
        ("q_offset", dict(main, sq=16, sk=1104),
         dict(kv_len=1056, q_offset=1000)),
        ("keyless_rows", dict(main, sq=200, sk=200), dict(q_offset=-30)),
        ("non_causal", dict(main, sq=70, sk=64), dict(causal=False,
                                                      kv_len=40)),
        ("window_64_sq70", dict(main, sq=70, sk=70), dict(window=64)),
        ("strided_views", dict(main, sq=80, sk=1104, views=True),
         dict(kv_len=1056, q_offset=976)),
    ]
    b, pps = 8, length // page
    seqs = torch.tensor([1060, 1100, 40, 1103, 1056, 1070, 500, 1083],
                        dtype=torch.int32, device="cuda")
    ident = torch.arange(b * pps, dtype=torch.int32,
                         device="cuda").view(b, pps)
    perm = torch.from_numpy(rng.permutation(b * pps).astype(np.int32)
                            ).cuda().view(b, pps)
    zero_seq = seqs.clone()
    zero_seq[::2] = 0
    straddle = torch.tensor([31, 32, 33, 65, 63, 64, 1, 97],
                            dtype=torch.int32, device="cuda")
    errs, rel = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for name, c, kw in flash_cases:
            q, k, v = _flash_inputs(rng, c, dtype)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            e = errs[f"flash/{name}/{dt}"] = max_err(
                got, fa.flash_attention_plain(q, k, v, **kw))
            check(e <= TOL[dtype], f"flash d32 {name} {dtype}: err {e}")
        qd = randn(rng, (b, h, d), dtype)
        kp = randn(rng, (b * pps, page, kvh, d), dtype)
        vp = randn(rng, (b * pps, page, kvh, d), dtype)
        for name, table, sl in (("identity", ident, seqs),
                                ("permuted", perm, seqs),
                                ("seq_len_0", perm, zero_seq),
                                ("split_boundaries", perm, straddle)):
            got = pa.paged_attention(qd, kp, vp, table, sl)
            torch.cuda.synchronize()
            e = errs[f"paged/{name}/{dt}"] = max_err(
                got, pa.paged_attention_plain(qd, kp, vp, table, sl))
            check(e <= TOL[dtype], f"paged d32 {name} {dtype}: err {e}")
        cases, _ = _masked_cases(rng, dtype, h, kvh, d, page)
        for name, args, kw in cases:
            got = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            e = errs[f"paged_masked/{name}/{dt}"] = max_err(
                got, pa.paged_attention_plain(*args, **kw))
            check(e <= TOL[dtype], f"paged d32 masked {name} {dtype}: {e}")
        for s in (2, VERIFY_S, 9, 17):
            for perm_t in (False, True):
                name = f"multi_query_s{s}" + ("_permuted" if perm_t else "")
                args, qp, _ = _mq_case(
                    rng, dtype, s=s, h=h, kvh=kvh, d=d, permute=perm_t,
                    starts=[0, 29, 500, length - 1, length - 1 - s, 1070])
                got = pa.paged_attention(*args, q_pos=qp)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(*args, q_pos=qp)
                e = errs[f"paged/{name}/{dt}"] = max_err(got, want)
                r = rel[f"paged/{name}/{dt}"] = e / float(
                    want.float().abs().max())
                check(e <= TOL[dtype] and r <= REL_TOL[dtype],
                      f"paged d32 {name} {dtype}: err {e}, {r} of max|ref|")
    dtype = torch.bfloat16
    out = {}
    q, k, v = _flash_inputs(rng, main, dtype)
    sq = main["sq"]
    out["flash_attention"] = dict(shape=main, **_kernel_row(
        lambda: fa.flash_attention(q, k, v),
        lambda: fa.flash_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        flush, q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
        4 * d * h * sq * (sq + 1) / 2, dtype, errs["flash/main/bfloat16"]))
    cache_k = randn(rng, (b, length, kvh, d), dtype)
    cache_v = randn(rng, (b, length, kvh, d), dtype)
    qd = randn(rng, (b, h, d), dtype)
    kp, vp = (x.view(b * pps, page, kvh, d) for x in (cache_k, cache_v))
    n_tok = int(seqs.sum())
    mask = (torch.arange(length, device="cuda")[None]
            < seqs[:, None])[:, None, None, :]
    out["paged_attention"] = dict(
        shape=dict(b=b, h=h, kvh=kvh, d=d, cache_len=length, page=page,
                   seq_lens=seqs.tolist()), **_kernel_row(
            lambda: pa.paged_attention(qd, kp, vp, ident, seqs),
            lambda: pa.paged_attention_plain(qd, kp, vp, ident, seqs),
            lambda: F.scaled_dot_product_attention(
                qd[:, :, None], cache_k.transpose(1, 2),
                cache_v.transpose(1, 2), attn_mask=mask, enable_gqa=True),
            flush, qd.element_size() * (2 * qd.numel()
                                        + 2 * n_tok * kvh * d)
            + 4 * (ident.numel() + b), 4 * h * d * n_tok, dtype,
            errs["paged/identity/bfloat16"]))
    emit("kernels_d32", errors=errs, rel_errors=rel,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         rel_tolerance={"float32": REL_TOL[torch.float32],
                        "bfloat16": REL_TOL[torch.bfloat16]},
         timed_bf16=out)
    return out


def _sha(t) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def phase_paged_verify_long(flush) -> dict:
    """The multi-query mode at S = 9, 13 and 17 (verifies of gamma 8, 12
    and 16) for G = 6 (qwen2-vl, 12 / 2 heads) and G = 16 (32 / 2 heads),
    D = 128: S x G = 54 to 272 query rows per kv head, so past 64 rows the
    rows of a kv head go to several row-tile CTAs. In float32 and bf16
    against the plain version at TOL and REL_TOL: the serve's batch-8
    verify, a permuted table with scratch rows, pages of 5; on the serve
    edge the plain version with each query's own key dropped must miss
    REL_TOL by 4x. BITS_CASES (S = 5 and S = 1, one row tile) must give
    the bits of the kernel before row tiles (BITS_SHA). Then, in bf16 at
    G = 6 for each S (and G = 16 at S = 9), the batch-8 verify timed
    beside its bound, S one-query launches, its plain version and SDPA
    over the slot cache with the boolean causal mask."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    rng = np.random.default_rng(15)
    L = SERVE_CACHE_LEN
    bits = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, kw in BITS_CASES.items():
            args, qp, _ = _mq_case(np.random.default_rng(BITS_SEED), dtype,
                                   **kw)
            key = f"{name}/{str(dtype)[6:]}"
            bits[key] = _sha(pa.paged_attention(*args, q_pos=qp)) \
                == BITS_SHA[key]
    check(all(bits.values()), f"multi-query bits changed: {bits}")
    errs, rel, sense = {}, {}, {}
    heads = {6: dict(h=12, kvh=2), 16: dict(h=32, kvh=2)}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for g, hk in heads.items():
            for s in (9, 13, 17):
                serve = 1056 + rng.integers(0, SERVE_NEW - s, 8)
                edges = {
                    "serve_b8": dict(starts=serve),
                    "permuted_scratch": dict(
                        starts=[1060, L - 1, 40, L - 1, L - 2 - s, 0],
                        permute=True),
                    "page5": dict(starts=[0, 33, 500, 1080, L - 1], page=5,
                                  length=1100, permute=True),
                }
                for name, kw in edges.items():
                    args, qp, _ = _mq_case(rng, dtype, s=s, **hk, **kw)
                    got = pa.paged_attention(*args, q_pos=qp)
                    torch.cuda.synchronize()
                    want = pa.paged_attention_plain(*args, q_pos=qp)
                    scale = float(want.float().abs().max())
                    key = f"g{g}_s{s}/{name}/{dt}"
                    e = errs[key] = max_err(got, want)
                    r = rel[key] = e / scale
                    check(e <= TOL[dtype] and r <= REL_TOL[dtype],
                          f"long verify {key}: err {e}, {r} of max|ref|")
                    if name == "serve_b8":
                        wrong = pa.paged_attention_plain(*args, q_pos=qp - 1)
                        dk = sense[key] = max_err(wrong, want) / scale
                        check(dk > 4 * REL_TOL[dtype], f"long verify {key}:"
                              f" a dropped key moves it only {dk}")
    dtype = torch.bfloat16
    timed = {}
    for g, s in ((6, 9), (6, 13), (6, 17), (16, 9)):
        serve = 1056 + rng.integers(0, SERVE_NEW - s, 8)
        args, qp, (k, v) = _mq_case(rng, dtype, s=s, starts=serve,
                                    **heads[g])
        q, kp, vp, table, seq = args
        h, kvh, d = q.shape[2], kp.shape[2], q.shape[3]
        n_keys = int(torch.minimum(qp + 1, seq[:, None]).sum())
        nbytes = q.element_size() * (2 * q.numel()
                                     + 2 * int(seq.sum()) * kvh * d) \
            + 4 * (table.numel() + 8 + qp.numel())
        singles = [(q[:, i].contiguous(), (qp[:, i] + 1).contiguous())
                   for i in range(s)]

        def s_launches(singles=singles, kp=kp, vp=vp, table=table):
            for qi, sl in singles:
                pa.paged_attention(qi, kp, vp, table, sl)
        rows = torch.arange(L, device="cuda")
        mask = ((rows[None, None] < seq[:, None, None])
                & (rows[None, None] <= qp[:, :, None]))[:, None]
        qs, ks, vs = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        row = _kernel_row(
            lambda args=args, qp=qp: pa.paged_attention(*args, q_pos=qp),
            lambda args=args, qp=qp: pa.paged_attention_plain(*args,
                                                              q_pos=qp),
            lambda qs=qs, ks=ks, vs=vs, mask=mask:
                F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True),
            flush, nbytes, 4 * h * d * n_keys, dtype,
            errs[f"g{g}_s{s}/serve_b8/bfloat16"])
        row["s_launches_ms"] = time_ms(s_launches, flush)
        row["rows_per_kv_head"] = s * g
        row["row_tiles"] = -(-s * g // 64)
        check(row["ms"] < row["s_launches_ms"],
              f"G={g} S={s}: the multi-query kernel ({row['ms']} ms) is not "
              f"faster than {s} one-query launches")
        timed[f"g{g}_s{s}"] = row
    emit("paged_verify_long", bits_equal=bits, errors=errs, rel_errors=rel,
         dropped_key_rel=sense,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         rel_tolerance={"float32": REL_TOL[torch.float32],
                        "bfloat16": REL_TOL[torch.bfloat16]},
         timed_bf16=timed)
    return timed


def phase_phi4_smoke() -> dict:
    """phi4-mini smoke (head dim 32) built with no ``device=``, so on
    the card, against the same weights on the CPU (float32): prefill and
    decode logits within SMOKE_LOGIT_TOL, and the greedy tokens of
    ``generate`` (prompts of 9-70 tokens), of a chunked ``serve`` and of a
    speculative serve at gamma 12 with self-draft (a 13-token verify: 52
    rows at G = 4) identical. Returns the kernel launches of the card
    runs."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.kernels import paged_attention as pa
    card = LVLM.from_pretrained("phi4-mini-3.8b", smoke=True, seed=0)
    check(card.device.type == "cuda", "phi4-mini smoke did not land on cuda")
    cpu = card.with_params(_tree_to(card.params, "cpu"))
    cfg = card.cfg
    rng = np.random.default_rng(16)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 70, 9, 33)]
    toks = torch.tensor([prompts[1]])
    lc, cc = cpu.model.prefill(cpu.params, {"tokens": toks}, cache_len=96)
    lg, cg = card.model.prefill(card.params, {"tokens": toks.cuda()},
                                cache_len=96)
    e_pre = max_err(lg.cpu(), lc)
    nxt, pos = torch.tensor([[3]]), torch.tensor([70])
    dc, _ = cpu.model.decode_step(cpu.params, cc, nxt, pos)
    dg, _ = card.model.decode_step(card.params, cg, nxt.cuda(), pos.cuda())
    e_dec = max_err(dg.cpu(), dc)
    check(e_pre <= SMOKE_LOGIT_TOL and e_dec <= SMOKE_LOGIT_TOL,
          f"phi4 smoke logits card vs CPU: prefill {e_pre}, decode {e_dec}")
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    spec = GenerationConfig(max_new_tokens=14, decoder="speculative",
                            gamma=12, temperature=0.0)
    ec = EngineConfig(max_batch=4, cache_len=112, scheduler="chunked",
                      chunk_size=16, token_budget=64)

    def reqs(n_new):
        return _requests(Request, prompts, [None] * 4, n_new)
    res = {}
    _reset_counts()
    pa.paged_attention.multi_query_launches = 0
    for name, t in (("card", card), ("cpu", cpu)):
        res[name] = (
            [r.tokens for r in t.generate(prompts, gen)],
            {r.rid: r.generated for r in t.serve(reqs(8), ec, gen).requests},
            {r.rid: r.generated
             for r in t.serve(reqs(14), EngineConfig(max_batch=4,
                                                     cache_len=112),
                              spec).requests})
        if name == "card":
            torch.cuda.synchronize()
            counts = _counts()
            mq = pa.paged_attention.multi_query_launches
    same = [a == b for a, b in zip(res["card"], res["cpu"])]
    emit("phi4_smoke", config=cfg.name, dtype=cfg.dtype,
         head_dim=cfg.head_dim, sliding_window=cfg.sliding_window,
         prefill_logit_err=e_pre, decode_logit_err=e_dec,
         tolerance=SMOKE_LOGIT_TOL,
         tokens_equal=dict(zip(("generate", "chunked_serve",
                                "speculative_gamma12"), same)),
         launches=counts, multi_query_launches=mq)
    check(all(same), f"phi4 smoke tokens card != CPU: {same}")
    check(all(counts.values()) and mq > 0,
          f"phi4 smoke: a kernel was not launched: {counts}, {mq}")
    return counts


def phase_async_serve(lvlm) -> dict:
    """qwen2-vl-2b at full width, bf16, through ``LVLM.serve_async`` with
    the sanitizer on at every step, abort and pump boundary: 8 requests
    of 1024 visual + 32 text tokens, 32 new each, 3 greedy, 3 speculative
    (gamma 4, the 2-layer draft of ``spec_serve``) and 2 early exit, all
    admitted at once. (a) With ``obs=True, profile=True`` the streams'
    tokens equal a sync ``serve`` of the same requests; (b) the trace has
    no open span and passes ``validate_trace``; (c) a second traced serve
    cancels one speculative stream after 4 tokens: the other 7 complete,
    and the slot, its draft row and the committed KV are freed at once
    and back to 0 at the end; (d) an all-speculative serve at gamma 8 (a
    9-token verify) completes. Wall per emitted token is read with
    obs/profile on and off, in turns (on, off, off, on), and the
    profiler's sites by self wall time are printed. Returns the launches
    of the serves."""
    import asyncio
    from repro_torch.api import (AdmissionConfig, EngineConfig,
                                 GenerationConfig, LVLM, Request)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.registry import build
    from repro_torch.obs import to_chrome_trace, validate_trace
    cfg = lvlm.cfg
    clean = LVLM(build(cfg), lvlm.params)   # no CallTimer synchronisation
    draft = LVLM.from_config(cfg.with_(num_layers=2), seed=1)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, SERVE_TEXT).tolist()
               for _ in range(8)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) for _ in range(8)]
    decs = ("greedy", "speculative", "early_exit", "greedy", "speculative",
            "greedy", "speculative", "early_exit")

    def make(decoders=decs):
        return [Request(rid=i, tokens=list(p), max_new_tokens=SERVE_NEW,
                        visual_embeds=ve, decoder=dec)
                for i, (p, ve, dec) in enumerate(zip(prompts, ves,
                                                     decoders))]
    gen = GenerationConfig(max_new_tokens=SERVE_NEW, decoder="greedy",
                           gamma=GAMMA, temperature=0.0)
    ec = EngineConfig(max_batch=8, cache_len=SERVE_CACHE_LEN, sanitize=True)
    adm = AdmissionConfig(high_watermark=1.0, low_watermark=0.9)
    n_tok = 8 * SERVE_NEW

    def serve_async(obs, cancel_rid=None):
        server = clean.serve_async(ec, gen, draft=draft, admission=adm,
                                   obs=obs, profile=obs)
        eng, mid = server.engine, {}

        async def consume(stream):
            out = []
            async for tok in stream:
                out.append(tok)
                if stream.request.rid == cancel_rid and len(out) == 4:
                    stream.cancel()
                    slot = stream.request._slot
                    mid.update(
                        slot_freed=eng.slot_req[slot] is None,
                        draft_row_freed=slot not in
                        eng._decoders["speculative"].bound_slots(),
                        committed_is_others=eng.kv_committed_tokens()
                        == sum(eng.kv_request_tokens(r)
                               for r in eng.running + eng.waiting
                               if not r.aborted))
                    break
            return out

        async def drive():
            async with server:
                return await asyncio.gather(
                    *(consume(server.submit(r)) for r in make()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = asyncio.run(drive())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return server, dict(enumerate(outs)), wall, mid

    sync = clean.serve(make(), ec, gen, draft=draft)
    want = {r.rid: r.generated for r in sync.requests}
    _reset_counts()
    server, got, wall_on, _ = serve_async(True)
    launches = _counts()
    tracer, prof, summary = server.tracer, server.profiler, server.summary()
    problems = validate_trace(to_chrome_trace(tracer.events))
    check(got == want, "async streams != sync serve at temperature 0")
    check(not problems and tracer.open_spans() == [],
          f"trace invalid: {problems[:5]}, open {tracer.open_spans()}")
    walls = {"on": [wall_on], "off": []}
    for obs in (False, False, True):
        _, g2, w, _ = serve_async(obs)
        check(g2 == want, f"async serve (obs={obs}) tokens changed")
        walls["on" if obs else "off"].append(w)
    sites = sorted(prof.snapshot().items(),
                   key=lambda kv: -kv[1]["wall_self_s"])
    top_sites = [{"site": k, "count": v["count"],
                  "wall_total_s": v["wall_total_s"],
                  "wall_self_s": v["wall_self_s"],
                  "virtual_s": v["virtual_s"]} for k, v in sites[:8]]
    # (c) a mid-decode cancel, then the pool back at baseline
    _reset_counts()
    server, got_c, _, mid = serve_async(True, cancel_rid=1)
    counts = _counts()
    launches = {k: launches[k] + counts[k] for k in launches}
    eng = server.engine
    s = server.summary()
    others = all(len(got_c[i]) == SERVE_NEW for i in got_c if i != 1)
    baseline = dict(committed=eng.kv_committed_tokens(),
                    slots_free=all(r is None for r in eng.slot_req),
                    draft_rows=sorted(
                        eng._decoders["speculative"].bound_slots()))
    check(others and len(got_c[1]) == 4 and s["aborted"] == 1
          and s["finished"] == 7 and all(mid.values()) and len(mid) == 3
          and baseline == dict(committed=0, slots_free=True, draft_rows=[])
          and server.tracer.open_spans() == [],
          f"cancel serve: {mid}, {baseline}, summary aborted "
          f"{s['aborted']} finished {s['finished']}")
    # (d) gamma 8: a 9-token verify of 54 rows per kv head
    spec8 = GenerationConfig(max_new_tokens=SERVE_NEW, decoder="speculative",
                             gamma=8, temperature=0.0)
    reqs8 = make(("speculative",) * 8)
    ec8 = EngineConfig(max_batch=8, cache_len=LVLM._cache_len(reqs8, spec8),
                       sanitize=True)
    _reset_counts()
    pa.paged_attention.multi_query_launches = 0
    rep8 = clean.serve(reqs8, ec8, spec8, draft=draft)
    torch.cuda.synchronize()
    counts, mq8 = _counts(), pa.paged_attention.multi_query_launches
    launches = {k: launches[k] + counts[k] for k in launches}
    check(len(rep8.requests) == 8 and all(len(r.generated) == SERVE_NEW
                                          for r in rep8.requests)
          and mq8 > 0 and rep8.stats["proposed"]
          == 8 * rep8.stats["target_calls"],
          f"gamma-8 speculative serve failed: {mq8} multi-query launches")
    per_tok = {k: [w * 1e3 / n_tok for w in v] for k, v in walls.items()}
    emit("async_serve", config=cfg.name, dtype=cfg.dtype,
         decoders=list(decs), tokens_equal_sync=True,
         trace_events=len(tracer.events), trace_problems=len(problems),
         wall_ms_per_token=per_tok,
         on_over_off=float(np.mean(per_tok["on"]) / np.mean(per_tok["off"])),
         top_sites=top_sites, summary={k: v for k, v in summary.items()
                                       if not isinstance(v, dict)},
         cancel=dict(mid=mid, end=baseline),
         gamma8=dict(multi_query_launches=mq8,
                     spec_rounds=rep8.stats["spec_rounds"],
                     acceptance=rep8.stats["acceptance"],
                     cache_len=ec8.cache_len),
         launches=launches)
    del clean, draft
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- cluster --

def _chat_burst(Request, cfg, burst: bool, video):
    """(chat, burst) requests of the disaggregation phases; ``video(rng,
    j)`` gives the j-th burst request's (tokens, visual_embeds) from the
    arrival generator, as the reference draws its burst."""
    rng = np.random.RandomState(33)
    r34 = np.random.RandomState(34)
    pre = list(r34.randint(1, cfg.vocab_size, size=0))
    chat = [Request(rid=i, tokens=pre + list(r34.randint(
        1, cfg.vocab_size, size=r34.randint(8, 24))),
        max_new_tokens=CHAT_NEW, arrival=i * 0.001) for i in range(CHAT_N)]
    arr = np.cumsum(rng.exponential(1 / CHAT_RATE, size=CHAT_N))
    for r, t in zip(chat, arr):
        r.arrival = float(t)
    vid = []
    for j in range(BURST_N if burst else 0):
        toks, ve = video(rng, j)
        vid.append(Request(rid=100 + j, tokens=toks,
                           max_new_tokens=BURST_NEW, visual_embeds=ve,
                           arrival=float(arr[4]) + j * 0.0005))
    return chat, vid


def _control_burst(Request, SLO, cfg):
    """``control_burst``'s traffic: 16 requests of 160 visual embeddings
    and 8-14 text tokens, 8 new, Poisson arrivals at 4000 req/s, SLO
    30 ms TTFT / 6 ms TPOT (seeds 77 and 78)."""
    rng = np.random.RandomState(77)
    r78 = np.random.RandomState(78)
    reqs = []
    for i in range(16):
        toks = list(r78.randint(1, cfg.vocab_size, size=r78.randint(8, 14)))
        reqs.append(Request(rid=i, tokens=toks, max_new_tokens=8))
    arrivals = np.cumsum(rng.exponential(1 / 4000.0, size=len(reqs)))
    for i, r in enumerate(reqs):
        r.arrival = float(arrivals[i])
        r.slo = SLO(ttft_ms=30.0, tpot_ms=6.0)
        r.visual_embeds = rng.randn(160, cfg.d_model).astype(
            np.float32) * 0.02
    return reqs


def _drive(front, reqs, on_token=None):
    """Serve ``reqs`` through a server or router (one consumer task
    each); returns {rid: tokens} and the wall seconds. ``on_token(stream,
    tokens)`` runs after every token a consumer reads."""
    import asyncio

    async def consume(stream):
        out = []
        async for tok in stream:
            out.append(tok)
            if on_token is not None:
                on_token(stream, out)
        return out

    async def drive():
        async with front:
            return await asyncio.gather(
                *(consume(front.submit(r)) for r in reqs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = asyncio.run(drive())
    torch.cuda.synchronize()
    return {r.rid: o for r, o in zip(reqs, outs)}, time.perf_counter() - t0


def _servers(front):
    return [rep.server for rep in front.replicas] \
        if hasattr(front, "replicas") else [front]


def _fleet_state(front) -> dict:
    """What a run leaves that must not depend on the device: every
    replica's records on the virtual clock, migrations, remote prefix
    hits and the fleet summary."""
    import dataclasses
    servers = _servers(front)
    return {"records": [[dataclasses.asdict(r) for r in s.metrics.records]
                        for s in servers],
            "migrated": [(s.engine.migrated_in, s.engine.migrated_out)
                         for s in servers],
            "remote_prefix_hits": [s.engine.remote_prefix_hits
                                   for s in servers],
            "migrations": list(getattr(front, "migrations", [])),
            "summary": front.summary()}


def _at_baseline(front) -> bool:
    """Every pool back at its baseline: no committed KV, every slot free,
    no export ticket, no router assignment left."""
    for s in _servers(front):
        e = s.engine
        if e.kv_committed_tokens() or any(r is not None for r in e.slot_req) \
                or e._exports or s._streams:
            return False
    return all(not rep.inflight for rep in getattr(front, "replicas", ()))


def _chat_tpot_p95(chat) -> float:
    return float(np.percentile(
        [(r.finish_time - r.first_token_time) / max(1, len(r.generated) - 1)
         for r in chat], 95))


def _drain_run(lvlm, ec, gen, chat, drain: bool):
    """``chat`` on a 2-replica unified fleet of ``ec``; with ``drain``,
    ``Router.drain(0)`` once every stream has 4 tokens. Returns (tokens,
    wall seconds, router)."""
    front = lvlm.serve_cluster(2, ec, gen=gen)
    seen = set()

    def on_token(stream, toks):
        if drain and len(toks) == 4:
            seen.add(stream.request.rid)
            if len(seen) == len(chat):
                front.drain(0)
    toks, wall = _drive(front, chat, on_token)
    return toks, wall, front


def _control_run(lvlm, ctl, cfg):
    """``control_burst`` on one server (max_batch 8, cache_len 256,
    ``kv_capacity_tokens`` 512, watermarks 0.9 / 0.7, sanitizer on) with
    ``control=ctl``. Returns (tokens, wall seconds, server)."""
    from repro_torch.api import (AdmissionConfig, EngineConfig,
                                 GenerationConfig, Request, SLO)
    server = lvlm.serve_async(
        EngineConfig(max_batch=8, cache_len=256, kv_capacity_tokens=512,
                     temperature=0.0, sanitize=True),
        gen=GenerationConfig(decoder="greedy", temperature=0.0,
                             max_new_tokens=8),
        admission=AdmissionConfig(high_watermark=0.9, low_watermark=0.7),
        control=ctl)
    toks, wall = _drive(server, _control_burst(Request, SLO, cfg))
    return toks, wall, server


def phase_cluster_smoke() -> dict:
    """qwen2-vl smoke in float32, ``LVLM.serve_cluster`` / ``serve_async``
    on the card (built with no ``device=``) against the same weights on
    the CPU, sanitizer on in every engine: the reference's
    ``disagg_burst`` (colocated 2 x 12 and prefill 8 / decode 16, each
    without and with the burst of three 420-token prompts, cost
    ``kv_bytes_per_token=100_000``) and ``control_burst`` (defer-only and
    adaptive) scenarios, a ``Router.drain(0)`` once every stream has 4
    tokens against the undrained run, and a ``prefix_affinity`` fleet
    with the shared tier where the second replica hits a prefix the
    first one published. Tokens, virtual-clock records (TTFT, TPOT, JCT,
    arrival, finish), migrations, remote prefix hits and the control
    counters are equal on both devices, no override stays open, and
    every pool is back at its baseline. Returns the card runs' kernel
    launches."""
    from repro_torch.api import (ControlConfig, CostModel, EngineConfig,
                                 GenerationConfig, LVLM, Request)
    t0 = time.perf_counter()
    card = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0)
    check(card.device.type == "cuda", "cluster smoke did not land on cuda")
    cpu = card.with_params(_tree_to(card.params, "cpu"))
    cfg = card.cfg
    gen16 = GenerationConfig(decoder="greedy", temperature=0.0,
                             max_new_tokens=CHAT_NEW)
    cost = CostModel(kv_bytes_per_token=100_000)

    def ec(batch, **kw):
        return EngineConfig(max_batch=batch, cache_len=512,
                            scheduler="chunked", chunk_size=32,
                            temperature=0.0, cost=cost, sanitize=True, **kw)

    def text_burst(rng, j):
        return list(rng.randint(1, cfg.vocab_size, size=420)), None

    def fleet(lvlm, label):
        if label == "disagg":
            return lvlm.serve_cluster(
                [{"role": "prefill", "engine_cfg": ec(8)},
                 {"role": "decode", "engine_cfg": ec(16)}], ec(8), gen=gen16)
        return lvlm.serve_cluster(2, ec(12), gen=gen16)

    launches = {"flash_attention": 0, "paged_attention": 0}

    def both(run):
        """run(lvlm) -> (tokens, front, extra) on the card, then the
        CPU; the card's launches are added up."""
        _reset_counts()
        g = run(card)
        torch.cuda.synchronize()
        for k, n in _counts().items():
            launches[k] += n
        return g, run(cpu)

    out, problems = {}, []

    def compare(name, g, c):
        (gt, gf, gx), (ct, cf, cx) = g, c
        same = dict(tokens=gt == ct, state=_fleet_state(gf)
                    == _fleet_state(cf), extra=gx == cx,
                    baseline=_at_baseline(gf) and _at_baseline(cf))
        if not all(same.values()):
            problems.append((name, same))
        return same

    # (a) disagg_burst
    for label in ("colocated", "disagg"):
        row = {}
        for phase in ("baseline", "burst"):
            def run(lvlm, label=label, phase=phase):
                chat, vid = _chat_burst(Request, cfg, phase == "burst",
                                        text_burst)
                front = fleet(lvlm, label)
                toks, _ = _drive(front, chat + vid)
                return toks, front, _chat_tpot_p95(chat)
            g, c = both(run)
            row[phase] = dict(equal=compare(f"{label}/{phase}", g, c),
                              chat_tpot_p95=g[2],
                              migrations=len(g[1].migrations))
        row["tpot_ratio"] = (row["burst"]["chat_tpot_p95"]
                             / row["baseline"]["chat_tpot_p95"])
        out[f"disagg_burst/{label}"] = row
    check(out["disagg_burst/disagg"]["burst"]["migrations"]
          == CHAT_N + BURST_N, "disagg fleet: not every request migrated")

    # (b) control_burst
    for label, ctl in (("defer_only", None),
                       ("adaptive", ControlConfig(cooldown_s=0.001))):
        def run(lvlm, ctl=ctl):
            toks, _, server = _control_run(lvlm, ctl, cfg)
            return toks, server, None
        g, c = both(run)
        s = g[1].summary()
        out[f"control_burst/{label}"] = dict(
            equal=compare(f"control/{label}", g, c),
            slo_e2e_attainment=s["slo_e2e_attainment"],
            deferred=s["deferred"],
            control={k: s.get(k) for k in (
                "control_commits", "control_reverts",
                "control_overrides_open")})
    adaptive = out["control_burst/adaptive"]
    check(adaptive["control"]["control_overrides_open"] == 0
          and adaptive["control"]["control_commits"] > 0
          and adaptive["slo_e2e_attainment"]
          > out["control_burst/defer_only"]["slo_e2e_attainment"],
          f"control burst: {adaptive}")

    # (c) drain once every stream has 4 tokens, against the undrained run
    def run_drain(lvlm, drain):
        chat, _ = _chat_burst(Request, cfg, False, text_burst)
        toks, _, front = _drain_run(lvlm, ec(12), gen16, chat, drain)
        return toks, front, None
    g, c = both(lambda lvlm: run_drain(lvlm, True))
    undrained = run_drain(card, False)[0]
    out["drain"] = dict(equal=compare("drain", g, c),
                        equals_undrained=g[0] == undrained,
                        migrations=len(g[1].migrations))
    check(g[0] == undrained and out["drain"]["migrations"] > 0,
          f"drain: {out['drain']}")

    # (d) prefix affinity over the shared tier: a first request publishes
    # the prefix from replica 1 (its cold hash), then replica 0 -- the
    # first candidate once both see the prefix through the tier -- takes
    # the rest and installs the tier's snapshot
    rng = np.random.RandomState(PREFIX_SEED)
    shared = list(rng.randint(1, cfg.vocab_size, size=32))
    fam = [shared + list(rng.randint(1, cfg.vocab_size,
                                     size=rng.randint(4, 8)))
           for _ in range(4)]

    def run_prefix(lvlm):
        front = lvlm.serve_cluster(
            2, EngineConfig(max_batch=4, cache_len=128, temperature=0.0,
                            prefix_cache=True, sanitize=True),
            gen=GenerationConfig(decoder="greedy", temperature=0.0,
                                 max_new_tokens=4),
            routing="prefix_affinity", shared_prefix=True)
        reqs = [Request(rid=i, tokens=list(p), max_new_tokens=4)
                for i, p in enumerate(fam)]
        first, _ = _drive(front, reqs[:1])
        rest, _ = _drive(front, reqs[1:])
        return {**first, **rest}, front, [rep.dispatched
                                          for rep in front.replicas]
    g, c = both(run_prefix)
    out["prefix_affinity"] = dict(
        equal=compare("prefix_affinity", g, c), dispatched=g[2],
        remote_prefix_hits=[rep.server.engine.remote_prefix_hits
                            for rep in g[1].replicas],
        tier=g[1].prefix_tier.stats())
    check(g[2] == [3, 1] and out["prefix_affinity"]["remote_prefix_hits"][0]
          >= 1, f"prefix tier: {out['prefix_affinity']}")
    emit("cluster_smoke", config=cfg.name, dtype=cfg.dtype, sanitize=True,
         **out, launches=launches, seconds=time.perf_counter() - t0)
    check(not problems, f"cluster smoke card != CPU: {problems}")
    check(all(launches.values()), f"cluster smoke launches {launches}")
    return launches


class _FleetProbe:
    """Instruments a fleet's engines (instance attributes, so nothing in
    the port changes): the kernel launches inside each engine's steps,
    CUDA events around every ``export_kv`` and ``import_kv`` with the
    bytes each moves, and, for every import, the ticket's snapshot and a
    device copy of the slot rows ``[0, pos)`` it was written into (hashed
    after the run, so the serve pays no host read). On each replica's
    first step that decodes a burst request (rid >= 100), every call of
    the paged wrapper is recorded -- its inputs, the whole slot pool with
    the stale rows of earlier occupants, and the kernel's output -- to be
    held against the plain version after the run."""

    def __init__(self, front):
        self.launches = [dict.fromkeys(("flash_attention",
                                        "paged_attention"), 0)
                         for _ in front.replicas]
        self.exports, self.imports = [], []
        self.imported = [set() for _ in front.replicas]
        self.paged_calls = [None for _ in front.replicas]
        for i, rep in enumerate(front.replicas):
            eng = rep.server.engine
            eng.step = self._step(i, eng, eng.step)
            eng.export_kv = self._export(eng.export_kv)
            eng.import_kv = self._import(i, eng, eng.import_kv)

    def _step(self, i, eng, step):
        from repro_torch.core.serving.request import State
        from repro_torch.kernels import ops

        def counted():
            before = _counts()
            burst = [r.rid for r in eng.running if r.rid >= 100
                     and r.state == State.DECODE
                     and getattr(r, "_ready_at", 0.0) <= eng.clock]
            if self.paged_calls[i] is not None or not burst:
                res = step()
            else:
                calls, real = [], ops._paged

                def recorded(q, *args, **kw):
                    o = real(q, *args, **kw)
                    if q.ndim == 3:
                        calls.append(([t.clone() for t in (q, *args)],
                                      {k: v.clone() if torch.is_tensor(v)
                                       else v for k, v in kw.items()},
                                      o.clone()))
                    return o
                ops._paged = recorded
                try:
                    res = step()
                finally:
                    ops._paged = real
                if calls:
                    self.paged_calls[i] = (burst, calls)
            for k, n in _counts().items():
                self.launches[i][k] += n - before[k]
            return res
        return counted

    def _export(self, export_kv):
        def timed(rid):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ticket = export_kv(rid)
            end.record()
            self.exports.append((rid, ticket["pos"], start, end))
            return ticket
        return timed

    def _import(self, i, eng, import_kv):
        def timed(req, ticket, *, ready_at=0.0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            import_kv(req, ticket, ready_at=ready_at)
            end.record()
            self.imported[i].add(req.rid)
            pos, slot = ticket["pos"], req._slot
            rows = {k: v[:, slot:slot + 1, :pos].clone()
                    for k, v in eng.pool["layers"].items()}
            self.imports.append((req.rid, pos, start, end,
                                 ticket["snap"]["layers"], rows))
        return timed

    def _paged_check(self, i) -> dict:
        """The recorded decode step of replica ``i``: every layer's kernel
        output against ``paged_attention_plain`` on the same inputs, held
        to TOL and REL_TOL (err over the reference's largest value)."""
        from repro_torch.kernels import paged_attention as pa
        burst, calls = self.paged_calls[i]
        errs, rels = [], []
        for args, kw, got in calls:
            want = pa.paged_attention_plain(*args, **kw)
            e = max_err(got, want)
            errs.append(e)
            rels.append(e / float(want.float().abs().max()))
        q, kp, _, table, sl = calls[0][0]
        return {"replica": i, "batch": q.shape[0], "dtype": str(q.dtype)[6:],
                "slot_rows": table.shape[1] * kp.shape[1],
                "seq_lens": sl.tolist(), "layers": len(calls),
                "burst_rids": burst,
                "imported_rids": sorted(set(burst) & self.imported[i]),
                "max_abs_err": max(errs), "max_rel_err": max(rels),
                "ok": all(e <= TOL[q.dtype] and r <= REL_TOL[q.dtype]
                          for e, r in zip(errs, rels))}

    def report(self) -> dict:
        """Per migration: KV tokens and bytes, export and import device
        ms (CUDA events around the call), and whether the imported rows'
        sha256 equals the snapshot's; per replica that decoded a burst
        request, its recorded paged calls against the plain version."""
        torch.cuda.synchronize()
        exp = {rid: (pos, s.elapsed_time(e))
               for rid, pos, s, e in self.exports}
        rows = []
        for rid, pos, s, e, snap, got in self.imports:
            nbytes = sum(v.numel() * v.element_size() for v in snap.values())
            rows.append({
                "rid": rid, "kv_tokens": pos, "bytes": nbytes,
                "export_ms": exp[rid][1], "import_ms": s.elapsed_time(e),
                "copy_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
                "sha_equal": all(_sha(snap[k]) == _sha(got[k])
                                 for k in snap)})
        paged = [self._paged_check(i) for i, c in enumerate(self.paged_calls)
                 if c is not None]
        self.paged_calls = [None] * len(self.paged_calls)
        return {"migrations": rows, "launches": self.launches,
                "paged_checks": paged}


def _bf16_bar(lvlm, reqs, got, want) -> list:
    """The bf16 bar between two runs of the same requests: every stream
    equal, or its first differing token chosen where the target's top-2
    logit gap is exactly 0. Returns (rid, step, gap) of each stream that
    differs."""
    out = []
    for r in reqs:
        a, b = got[r.rid], want[r.rid]
        if a == b:
            continue
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        out.append((r.rid, i, _top2_gap(lvlm, r.tokens, r.visual_embeds,
                                        a[:i + 1])))
    return out


def _copy_ms(snap_shape_tokens: int, pool, flush) -> float:
    """Device ms of one migration's copy alone at ``snap_shape_tokens``
    rows (K and V of every layer from a slot into a buffer), replayed as
    a CUDA graph after an L2 flush: what ``export_kv``'s clone and
    ``import_kv``'s install each cost on the card without the host."""
    src = {k: v[:, 0, :snap_shape_tokens] for k, v in pool["layers"].items()}
    dst = {k: torch.empty_like(v) for k, v in src.items()}

    def copy():
        for k in src:
            dst[k].copy_(src[k])
    return time_ms(copy, flush)


def phase_cluster_serve(lvlm) -> dict:
    """qwen2-vl-2b at full published width, bf16, through
    ``LVLM.serve_cluster`` with one set of weights behind every replica,
    sanitizer on. (a) Disaggregation under a visual burst: the chat
    cohort of ``disagg_burst`` and, at its 5th arrival, 3 requests of
    1024 visual embeddings + 32 text tokens; cache_len 1152, chunked
    (chunks of 256), ``CostModel(kv_bytes_per_token=28672)`` (bf16 K and
    V at these widths); fleets prefill 8 / decode 16 and 2 x 12
    unified, each without and with the burst. In ``disagg`` the decode
    replica's admission gate counts its 16 slots (``max_inflight``): an
    import that passes the KV watermark but finds every slot taken fails,
    and the request then decodes on the prefill replica (as in the
    reference), so the gate makes it wait for a slot. Every request of
    that fleet migrates; each imported slot's rows ``[0, pos)`` hash to
    its ticket snapshot's; the prefill replica launches only the flash
    kernel and the decode replica only the paged kernel, over the
    imported KV. ``disagg_ungated`` is the same fleet with the burst and
    no gate, as the reference runs it: the imports that find no slot
    cancel their export, and those requests decode on the prefill
    replica, which then launches the paged kernel. On every burst run,
    each replica's first decode step over a burst request records its
    paged calls (batch 16 on the decode replica over imported KV, 12 on a
    unified one, 8 on the prefill one; 1152-row slots holding earlier
    occupants' stale rows), held against the plain version at TOL and
    REL_TOL. The streams of every fleet meet the bf16 bar against the
    colocated one. (b) Drain: the chat cohort on 2 x 12 unified,
    ``drain(0)`` once every stream has 4 tokens: streams meet the bf16
    bar against the undrained run, and every pool is back at its
    baseline. (c) Control: ``control_burst`` at full width, defer-only
    and adaptive. Prints the chat TPOT p95 (virtual) burst over
    no-burst, migrations and their KV tokens and bytes, wall ms per
    emitted token, the export and import device ms beside their bytes
    and the copy's bound, and each replica's launches. Returns the
    serves' launches."""
    from repro_torch.api import (AdmissionConfig, ControlConfig, CostModel,
                                 EngineConfig, GenerationConfig, LVLM,
                                 Request)
    from repro_torch.models.registry import build
    t0 = time.perf_counter()
    cfg = lvlm.cfg
    clean = LVLM(build(cfg), lvlm.params)   # no CallTimer synchronisation
    nv = cfg.num_visual_tokens
    gen16 = GenerationConfig(decoder="greedy", temperature=0.0,
                             max_new_tokens=CHAT_NEW)
    cost = CostModel(kv_bytes_per_token=KV_BYTES_PER_TOKEN)

    def ec(batch):
        return EngineConfig(max_batch=batch, cache_len=CLUSTER_CACHE_LEN,
                            scheduler="chunked", chunk_size=CLUSTER_CHUNK,
                            temperature=0.0, cost=cost, sanitize=True)

    def fleet(label):
        if label == "colocated":
            return clean.serve_cluster(2, ec(12), gen=gen16)
        gate = ({"admission": AdmissionConfig(max_inflight=16)}
                if label == "disagg" else {})
        return clean.serve_cluster(
            [{"role": "prefill", "engine_cfg": ec(8)},
             {"role": "decode", "engine_cfg": ec(16), **gate}], ec(8),
            gen=gen16)

    def image_burst(rng, j):
        toks = list(rng.randint(1, cfg.vocab_size, size=SERVE_TEXT))
        return toks, rng.randn(nv, cfg.d_model).astype(np.float32) * 0.02

    launches = {"flash_attention": 0, "paged_attention": 0}

    def counted(fn):
        _reset_counts()
        res = fn()
        torch.cuda.synchronize()
        for k, n in _counts().items():
            launches[k] += n
        return res

    out, streams = {}, {}
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for label, phase in (("colocated", "baseline"), ("colocated", "burst"),
                         ("disagg", "baseline"), ("disagg", "burst"),
                         ("disagg_ungated", "burst")):
        row = out.setdefault(label, {})
        chat, vid = _chat_burst(Request, cfg, phase == "burst", image_burst)
        front = fleet(label)
        probe = _FleetProbe(front)
        toks, wall = counted(lambda: _drive(front, chat + vid))
        streams[label, phase] = (chat + vid, toks)
        n_tok = sum(len(t) for t in toks.values())
        s = front.summary()
        rep = probe.report()
        moves = rep["migrations"]
        moved = {m["rid"] for m in moves}
        row[phase] = {
            "chat_tpot_p95": _chat_tpot_p95(chat),
            "wall_ms_per_token": wall * 1e3 / n_tok,
            "migrations": s.get("disaggregation", {}).get("migrations", 0),
            "migrated_kv_tokens": s.get("disaggregation", {}).get(
                "migrated_kv_tokens", 0),
            "migrated_kv_bytes": sum(m["bytes"] for m in moves),
            "burst_migrations": [m for m in moves if m["rid"] >= 100],
            "failed_back": sorted(r.rid for r in chat + vid
                                  if r.rid not in moved)
            if label != "colocated" else [],
            "launches_by_replica": rep["launches"],
            "paged_checks": rep["paged_checks"],
            "at_baseline": _at_baseline(front)}
        check(all(m["sha_equal"] for m in moves),
              f"{label}/{phase}: imported rows != ticket snapshot")
        check(row[phase]["at_baseline"], f"{label}/{phase} not at baseline")
        checks = {c["replica"]: c for c in rep["paged_checks"]}
        check(all(c["ok"] for c in checks.values()),
              f"{label}/{phase}: paged kernel != plain on the serve's "
              f"inputs: {rep['paged_checks']}")
        pf, dec = rep["launches"]
        if phase == "burst":
            want = ({0: 8, 1: 16} if label == "disagg_ungated"
                    else {1: 16} if label == "disagg" else {})
            check(all(i in checks and checks[i]["batch"] == b
                      and checks[i]["slot_rows"] == CLUSTER_CACHE_LEN
                      for i, b in want.items())
                  and (label != "colocated" or any(
                      c["batch"] == 12 for c in checks.values()))
                  and (label == "colocated"
                       or checks[1]["imported_rids"]),
                  f"{label}/burst: paged calls recorded {checks}")
        if label == "disagg":
            check(len(moves) == len(chat + vid)
                  and pf["paged_attention"] == 0
                  and pf["flash_attention"] > 0
                  and dec["flash_attention"] == 0
                  and dec["paged_attention"] > 0,
                  f"disagg/{phase}: {len(moves)} migrations, launches "
                  f"{rep['launches']}")
            if phase == "burst":
                burst = row[phase]["burst_migrations"]
                check(sorted(m["rid"] for m in burst) == [100, 101, 102]
                      and all(m["kv_tokens"] == nv + SERVE_TEXT
                              for m in burst),
                      f"burst requests did not all migrate: {burst}")
                row["copy_ms_graph"] = _copy_ms(
                    nv + SERVE_TEXT, front.replicas[1].server.engine.pool,
                    flush)
        if label == "disagg_ungated":
            back = row[phase]["failed_back"]
            check(back and all(len(toks[rid]) == (
                BURST_NEW if rid >= 100 else CHAT_NEW) for rid in back)
                  and set(checks[0]["burst_rids"]) <= set(back)
                  and pf["paged_attention"] > 0,
                  f"disagg_ungated: failed back {back}, launches "
                  f"{rep['launches']}, checks {checks}")
        del front, probe, rep, moves
        if len(row) == 2:
            row["tpot_ratio"] = (row["burst"]["chat_tpot_p95"]
                                 / row["baseline"]["chat_tpot_p95"])
    del flush
    bars = {f"{label}/{phase}": _bf16_bar(clean, *streams[label, phase],
                                          streams["colocated", phase][1])
            for label, phase in streams if label != "colocated"}
    out["bf16_bar_vs_colocated"] = bars
    check(all(g == 0.0 for b in bars.values() for _, _, g in b),
          f"disaggregated vs colocated streams differ at a nonzero gap: "
          f"{bars}")

    # (b) drain
    def run_drain(drain):
        chat, _ = _chat_burst(Request, cfg, False, image_burst)
        return (chat, *counted(lambda: _drain_run(clean, ec(12), gen16, chat,
                                                  drain)))
    chat, undrained, _, _ = run_drain(False)
    _, drained, wall, front = run_drain(True)
    bar = _bf16_bar(clean, chat, drained, undrained)
    out["drain"] = {
        "migrations": len(front.migrations),
        "wall_ms_per_token": wall * 1e3 / sum(len(t)
                                              for t in drained.values()),
        "bf16_bar": bar, "at_baseline": _at_baseline(front),
        "replica_states": front.summary()["replica_states"]}
    check(all(g == 0.0 for _, _, g in bar) and out["drain"]["at_baseline"]
          and out["drain"]["migrations"] > 0, f"drain: {out['drain']}")
    del front

    # (c) control
    for label, ctl in (("defer_only", None),
                       ("adaptive", ControlConfig(cooldown_s=0.001))):
        toks, wall, server = counted(lambda: _control_run(clean, ctl, cfg))
        s = server.summary()
        out[f"control/{label}"] = {
            "slo_e2e_attainment": s["slo_e2e_attainment"],
            "deferred": s["deferred"], "finished": s["finished"],
            "wall_ms_per_token": wall * 1e3 / sum(len(t)
                                                  for t in toks.values()),
            **{k: s.get(k) for k in ("control_commits", "control_reverts",
                                     "control_overrides_open")},
            "at_baseline": _at_baseline(server)}
    on, off = out["control/adaptive"], out["control/defer_only"]
    check(on["finished"] == off["finished"] == 16
          and on["control_overrides_open"] == 0
          and on["slo_e2e_attainment"] > off["slo_e2e_attainment"]
          and on["at_baseline"] and off["at_baseline"],
          f"control at full width: {on} vs {off}")
    emit("cluster_serve", config=cfg.name, dtype=cfg.dtype,
         cache_len=CLUSTER_CACHE_LEN, kv_bytes_per_token=KV_BYTES_PER_TOKEN,
         **out, launches=launches, seconds=time.perf_counter() - t0)
    del clean
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- other architectures (dim 3) --

#: full-width configs, each cut in depth to fit one 80 GB card with its
#: float32 init draw (PERF.md section 4): (arch, layers kept)
ARCH_FULL = (("granite-34b", 24), ("mistral-large-123b", 8),
             ("nemotron-4-340b", 2), ("arctic-480b", 1))
#: their serve: 4 text prompts of these lengths, ARCH_NEW new tokens each
ARCH_PROMPTS, ARCH_NEW = (64, 300, 700, 1024), 16
#: smoke configs held card against CPU (float32, head dim 32)
ARCH_SMOKE = (("granite-34b", {}), ("mistral-large-123b", {}),
              ("nemotron-4-340b", {}), ("arctic-480b", {}),
              ("arctic-480b", dict(first_k_dense_layers=1,
                                   num_shared_experts=1)))
#: decode after an S-1 prefill against forward at S-1, bf16 at full width:
#: flash and paged kernels round P and every activation differently, over
#: up to 24 layers; the bar is on max|diff| / max|forward logit|
CONSISTENCY_TOL = 5e-2


def _timed_row(fn, plain, library, flush, nbytes, flops, dtype, err,
               **extra):
    return dict(_kernel_row(fn, plain, library, flush, nbytes, flops, dtype,
                            err), **extra)


def _paged_onequery_case(rng, dtype, b, h, kvh, d, length=SERVE_CACHE_LEN,
                         page=16):
    """One-query decode over a dense ``length``-slot cache viewed as pages
    (identity table), seq_lens 1056-1103: (args, dense k, v)."""
    pps = length // page
    k = randn(rng, (b, length, kvh, d), dtype)
    v = randn(rng, (b, length, kvh, d), dtype)
    q = randn(rng, (b, h, d), dtype)
    seqs = torch.from_numpy(rng.integers(1056, length, b).astype(np.int32)
                            ).cuda()
    ident = torch.arange(b * pps, dtype=torch.int32,
                         device="cuda").view(b, pps)
    return (q, k.view(b * pps, page, kvh, d), v.view(b * pps, page, kvh, d),
            ident, seqs), (k, v)


def _flash_wide_cases():
    """Head dim 192 on the flash forward's two-warpgroup kernel, whose CTA
    holds a pair of 64-row q tiles: the edges of that pair. (name, case,
    kwargs)."""
    c = dict(b=1, h=8, kvh=2, d=192)
    return [
        ("window", dict(c, sq=600, sk=600), dict(window=100)),
        ("kv_len_lt_sk", dict(c, sq=200, sk=1104), dict(kv_len=1072)),
        ("q_offset", dict(c, sq=16, sk=1104), dict(kv_len=1056,
                                                   q_offset=1000)),
        ("keyless_rows", dict(c, sq=200, sk=200), dict(q_offset=-30)),
        # rows 100-127 see no key: the pair's second tile visits all keys,
        # its first only its own
        ("keyless_second_tile", dict(c, sq=200, sk=200),
         dict(kv_len=61, window=40)),
        ("sq_1000", dict(c, sq=1000, sk=1000), {}),
        ("sq_70", dict(c, h=4, kvh=1, sq=70, sk=70), {}),
        ("sq_64", dict(c, h=4, kvh=1, sq=64, sk=300), {}),
        ("non_causal", dict(c, h=4, kvh=4, sq=70, sk=1500),
         dict(causal=False)),
    ]


def phase_kernels_new_shapes(flush) -> dict:
    """The kernels at the shapes the dense-family and MoE configs add, in
    float32 and bf16 against their plain versions (TOL; the multi-query
    mode also REL_TOL): head dim 192 (nemotron-4-340b, 96 / 8 heads) --
    flash causal over 1056 tokens, paged one-query at batch 4 over 1104
    slots, masked (the compacted, ring, window and ahead cases at batch 8)
    and multi-query S = 5 -- and 48 q heads per kv head (granite-34b,
    48 / 1, D 128) -- flash over 1056 tokens, paged one-query, masked,
    multi-query S = 5 and 9 (240 and 432 rows a kv head: 4 and 7 row
    tiles). Each bf16 case is timed beside its bound, its plain version
    and SDPA; float32 flash at D = 192 too. Then flash at D = 192 on the
    edges of its 128-row CTA (``_flash_wide_cases``), v 192 and 128 wide,
    in both dtypes."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_key_mask
    rng = np.random.default_rng(18)
    shapes = {"head_dim_192": dict(h=96, kvh=8, d=192),
              "group_48": dict(h=48, kvh=1, d=128)}
    errs, rel, timed = {}, {}, {k: {} for k in shapes}
    for key, hk in shapes.items():
        h, kvh, d = hk["h"], hk["kvh"], hk["d"]
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            c = dict(b=1, sq=1056, sk=1056, **hk)
            q, k, v = _flash_inputs(rng, c, dtype)
            got = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            e = errs[f"{key}/flash/{dt}"] = max_err(
                got, fa.flash_attention_plain(q, k, v))
            check(e <= TOL[dtype], f"flash {key} {dtype}: err {e}")
            if dtype == torch.bfloat16 or key == "head_dim_192":
                timed[key][f"flash_{dt}"] = _timed_row(
                    lambda q=q, k=k, v=v: fa.flash_attention(q, k, v),
                    lambda q=q, k=k, v=v: fa.flash_attention_plain(q, k, v),
                    lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True),
                    flush, q.element_size() * (2 * q.numel() + k.numel()
                                               + v.numel()),
                    4 * d * h * 1056 * 1057 / 2, dtype, e, shape=c)
            # one-query decode, batch 4 over 1104 slots
            args, (kd, vd) = _paged_onequery_case(rng, dtype, 4, h, kvh, d)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            e = errs[f"{key}/paged/{dt}"] = max_err(
                got, pa.paged_attention_plain(*args))
            check(e <= TOL[dtype], f"paged {key} {dtype}: err {e}")
            if dtype == torch.bfloat16:
                qd, seqs = args[0], args[4]
                n_tok = int(seqs.sum())
                mask = (torch.arange(SERVE_CACHE_LEN, device="cuda")[None]
                        < seqs[:, None])[:, None, None, :]
                timed[key]["paged_one_query"] = _timed_row(
                    lambda args=args: pa.paged_attention(*args),
                    lambda args=args: pa.paged_attention_plain(*args),
                    lambda qd=qd, kd=kd, vd=vd, mask=mask:
                        F.scaled_dot_product_attention(
                            qd[:, :, None], kd.transpose(1, 2),
                            vd.transpose(1, 2), attn_mask=mask,
                            enable_gqa=True),
                    flush, qd.element_size() * (2 * qd.numel()
                                                + 2 * n_tok * kvh * d)
                    + 4 * (args[3].numel() + 4), 4 * h * d * n_tok, dtype,
                    e, shape=dict(b=4, cache_len=SERVE_CACHE_LEN, page=16,
                                  seq_lens=seqs.tolist(), **hk))
            # masked mode, batch 8 over KV_CACHE_LEN slots
            cases, (kc, vc, sp, q_comp) = _masked_cases(rng, dtype, h, kvh,
                                                       d, 16)
            for name, margs, kw in cases:
                got = pa.paged_attention(*margs, **kw)
                torch.cuda.synchronize()
                e = errs[f"{key}/paged_masked/{name}/{dt}"] = max_err(
                    got, pa.paged_attention_plain(*margs, **kw))
                check(e <= TOL[dtype], f"paged masked {key} {name} {dtype}:"
                      f" err {e}")
            if dtype == torch.bfloat16:
                _, margs, kw = cases[0]          # compacted, identity table
                qm, _, _, table, seq = margs
                read, keys = paged_key_mask(seq, table, 16, **kw)
                n_read, n_key = int(read.sum()), int(keys.sum())
                mask = ((sp >= 0) & (sp <= q_comp[:, None]))[:, None, None]
                timed[key]["paged_masked_compacted"] = _timed_row(
                    lambda margs=margs, kw=kw: pa.paged_attention(*margs,
                                                                  **kw),
                    lambda margs=margs, kw=kw: pa.paged_attention_plain(
                        *margs, **kw),
                    lambda qm=qm, kc=kc, vc=vc, mask=mask:
                        F.scaled_dot_product_attention(
                            qm[:, :, None], kc.transpose(1, 2),
                            vc.transpose(1, 2), attn_mask=mask,
                            enable_gqa=True),
                    flush, qm.element_size() * (2 * qm.numel()
                                                + 2 * n_key * kvh * d)
                    + 4 * (table.numel() + 2 * len(seq) + n_read),
                    4 * h * d * n_key, dtype,
                    errs[f"{key}/paged_masked/compacted_identity/{dt}"],
                    shape=dict(b=8, cache_len=KV_CACHE_LEN, page=16,
                               budget=KV_BUDGET, **hk))
            # multi-query: the verify of gamma 4 (and 8 at G = 48)
            for s in ((VERIFY_S, 9) if key == "group_48" else (VERIFY_S,)):
                serve = 1056 + rng.integers(0, SERVE_NEW - s, 8)
                qargs, qp, (kq, vq) = _mq_case(rng, dtype, s=s, starts=serve,
                                               **hk)
                got = pa.paged_attention(*qargs, q_pos=qp)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(*qargs, q_pos=qp)
                name = f"{key}/paged_multi_query_s{s}/{dt}"
                e = errs[name] = max_err(got, want)
                r = rel[name] = e / float(want.float().abs().max())
                check(e <= TOL[dtype] and r <= REL_TOL[dtype],
                      f"paged multi-query {name}: err {e}, {r} of max|ref|")
                if dtype != torch.bfloat16:
                    continue
                qm, _, _, table, seq = qargs
                n_keys = int(torch.minimum(qp + 1, seq[:, None]).sum())
                rows = torch.arange(SERVE_CACHE_LEN, device="cuda")
                mask = ((rows[None, None] < seq[:, None, None])
                        & (rows[None, None] <= qp[:, :, None]))[:, None]
                timed[key][f"paged_multi_query_s{s}"] = _timed_row(
                    lambda qargs=qargs, qp=qp: pa.paged_attention(
                        *qargs, q_pos=qp),
                    lambda qargs=qargs, qp=qp: pa.paged_attention_plain(
                        *qargs, q_pos=qp),
                    lambda qs=qm.transpose(1, 2), ks=kq.transpose(1, 2),
                    vs=vq.transpose(1, 2), mask=mask:
                        F.scaled_dot_product_attention(
                            qs, ks, vs, attn_mask=mask, enable_gqa=True),
                    flush, qm.element_size() * (2 * qm.numel() + 2 * int(
                        seq.sum()) * kvh * d)
                    + 4 * (table.numel() + 8 + qp.numel()),
                    4 * h * d * n_keys, dtype, e,
                    rows_per_kv_head=s * h // kvh,
                    row_tiles=-(-s * h // kvh // 64))
    # flash at D 192 (the two-warpgroup kernel, 128 q rows a CTA) on the
    # edges of its pair of q tiles, v 192 wide and MLA's 128 (a strided
    # view of the same v), the 128-wide output also against the padded
    # call's first 128 columns
    for name, c, kw in _flash_wide_cases():
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            q, k, v = _flash_inputs(rng, c, dtype)
            for dv in (192, 128):
                got = fa.flash_attention(q, k, v[..., :dv], **kw)
                torch.cuda.synchronize()
                e = errs[f"head_dim_192/flash_edges/{name}/v{dv}/{dt}"] = \
                    max_err(got, fa.flash_attention_plain(q, k, v[..., :dv],
                                                          **kw))
                check(bool(torch.isfinite(got).all()) and e <= TOL[dtype],
                      f"flash D 192 {name} v {dv} {dtype}: err {e}")
                if dv == 128:
                    pad = fa.flash_attention(
                        q, k, F.pad(v[..., :dv], (0, 64)), **kw)[..., :dv]
                    e = errs[f"head_dim_192/flash_edges/{name}/v128_vs_"
                             f"padded/{dt}"] = max_err(got, pad)
                    check(e <= TOL[dtype], f"flash D 192 {name} v 128 "
                          f"{dtype} against the padded call: err {e}")
    emit("kernels_new_shapes", errors=errs, rel_errors=rel,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         rel_tolerance={"float32": REL_TOL[torch.float32],
                        "bfloat16": REL_TOL[torch.bfloat16]},
         timed=timed)
    return timed


def phase_arch_smoke() -> dict:
    """granite, mistral, nemotron and arctic smoke (float32, head dim 32)
    and arctic smoke with a dense prefix layer and a shared expert, each
    built with no ``device=`` (so on the card) against the same weights on
    the CPU: prefill and decode logits within SMOKE_LOGIT_TOL, identical
    greedy tokens from ``generate`` and a continuous ``serve``, and on
    arctic smoke a self-draft speculative serve (gamma 4). Returns the
    card runs' kernel launches."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    spec = GenerationConfig(max_new_tokens=11, decoder="speculative",
                            gamma=GAMMA, temperature=0.0)
    ec = EngineConfig(max_batch=3, cache_len=96, scheduler="continuous")
    total = dict.fromkeys(("flash_attention", "paged_attention"), 0)
    rows = {}
    for arch, kw in ARCH_SMOKE:
        card = LVLM.from_pretrained(arch, smoke=True, seed=0, **kw)
        check(card.device.type == "cuda", f"{arch} smoke not on cuda")
        cpu = card.with_params(_tree_to(card.params, "cpu"))
        cfg = card.cfg
        rng = np.random.default_rng(19)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in (20, 61, 9)]
        toks = torch.tensor([prompts[1]])
        lc, cc = cpu.model.prefill(cpu.params, {"tokens": toks},
                                   cache_len=80)
        lg, cg = card.model.prefill(card.params, {"tokens": toks.cuda()},
                                    cache_len=80)
        e_pre = max_err(lg.cpu(), lc)
        nxt, pos = torch.tensor([[3]]), torch.tensor([61])
        dc, _ = cpu.model.decode_step(cpu.params, cc, nxt, pos)
        dg, _ = card.model.decode_step(card.params, cg, nxt.cuda(),
                                       pos.cuda())
        e_dec = max_err(dg.cpu(), dc)
        res = {}
        _reset_counts()
        for name, t in (("card", card), ("cpu", cpu)):
            reqs = _requests(Request, prompts, [None] * 3, 8)
            res[name] = [[r.tokens for r in t.generate(prompts, gen)],
                         {r.rid: r.generated
                          for r in t.serve(reqs, ec, gen).requests}]
            if kw == {} and cfg.family == "moe":
                res[name].append({r.rid: r.generated for r in t.serve(
                    _requests(Request, prompts, [None] * 3, 11),
                    EngineConfig(max_batch=3, cache_len=96), spec).requests})
            if name == "card":
                torch.cuda.synchronize()
                counts = _counts()
        same = [a == b for a, b in zip(res["card"], res["cpu"])]
        label = cfg.name + ("+dense_prefix+shared" if kw else "")
        rows[label] = dict(prefill_logit_err=e_pre, decode_logit_err=e_dec,
                           tokens_equal=same, launches=counts)
        check(e_pre <= SMOKE_LOGIT_TOL and e_dec <= SMOKE_LOGIT_TOL,
              f"{label} logits card vs CPU: prefill {e_pre}, decode {e_dec}")
        check(all(same), f"{label} tokens card != CPU: {same}")
        check(all(counts.values()), f"{label}: a kernel was not launched: "
              f"{counts}")
        total = {k: total[k] + counts[k] for k in total}
        del card, cpu
    emit("arch_smoke", tolerance=SMOKE_LOGIT_TOL, configs=rows,
         checks=["generate", "continuous_serve", "speculative_serve (moe)"])
    return total


class _CallRecorder:
    """Records every kernel-wrapper call (cloned inputs and output) made
    inside the ``with`` block, to be held against the plain versions."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, (ops._flash, ops._paged, ops._mla)
        self.calls = {"flash_attention": [], "paged_attention": [],
                      "mla_attention": []}

        def rec(name, fn):
            def recorded(*args, **kw):
                out = fn(*args, **kw)
                self.calls[name].append((
                    [t.clone() for t in args],
                    {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in kw.items()}, out.clone()))
                return out
            return recorded
        ops._flash = rec("flash_attention", self.real[0])
        ops._paged = rec("paged_attention", self.real[1])
        ops._mla = rec("mla_attention", self.real[2])
        return self

    def __exit__(self, *exc):
        self.ops._flash, self.ops._paged, self.ops._mla = self.real

    def check(self) -> dict:
        """max err and err / max|ref| of every call against its plain
        version; fails past REL_TOL of max|ref| (and past TOL for the
        paged calls). At full width the flash outputs reach |x| ~ 4,
        where one bf16 ulp (3.1e-2) is past TOL: REL_TOL is 1.3 ulp of
        the largest output. The latent kernel's calls are all float32
        arithmetic: MLA_REL_TOL."""
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mla_attention as ma
        from repro_torch.kernels import paged_attention as pa
        plain = {"flash_attention": fa.flash_attention_plain,
                 "paged_attention": pa.paged_attention_plain,
                 "mla_attention": ma.mla_attention_plain}
        out = {}
        for name, calls in self.calls.items():
            errs, rels = [], []
            for args, kw, got in calls:
                want = plain[name](*args, **kw)
                e = max_err(got, want)
                errs.append(e)
                rels.append(e / float(want.float().abs().max()))
                dtype = got.dtype
                if name == "mla_attention":
                    check(rels[-1] <= MLA_REL_TOL, f"recorded {name} call: "
                          f"err {e}, {rels[-1]} rel")
                    continue
                check(rels[-1] <= REL_TOL[dtype] and (
                    name == "flash_attention" or e <= TOL[dtype]),
                      f"recorded {name} call: err {e}, {rels[-1]} rel")
            out[name] = {"calls": len(calls),
                         "max_abs_err": max(errs) if errs else None,
                         "max_rel_err": max(rels) if rels else None}
        return out


def _arch_full_one(arch, layers) -> dict:
    """One config at full published width, ``layers`` deep, bf16, random
    weights from seed 0 (see ``phase_arch_full``)."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    gc.collect()                  # the last config's engines hold cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvlm = LVLM.from_pretrained(arch, seed=0, num_layers=layers)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    cfg, model, params = lvlm.cfg, lvlm.model, lvlm.params
    check(lvlm.device.type == "cuda", f"{arch}: not on cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ARCH_PROMPTS]
    cls = type(model)

    # decode after an S-1 prefill against forward at S-1 (dropless MoE on
    # both sides), every kernel call of the prefill and of the decode step
    # held against the plain version
    s = 256
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s))).cuda()
    full, _ = cls.forward(model, params, {"tokens": toks}, moe_cap=None)
    want = full[:, -1].float()
    del full
    with _CallRecorder() as rec:
        _, cache = cls.prefill(model, params, {"tokens": toks[:, :-1]},
                               cache_len=s + 16, moe_cap=None,
                               last_only=True)
        got, _ = cls.decode_step(model, params, cache, toks[:, -1:], s - 1,
                                 moe_cap=None)
    torch.cuda.synchronize()
    del cache
    recorded = rec.check()
    del rec
    scale = float(want.abs().max())
    cons = max_err(got, want) / scale
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(
        want).all()), f"{arch}: NaN or inf logits")
    check(cons <= CONSISTENCY_TOL, f"{arch}: decode after prefill vs "
          f"forward differ by {cons} of the logit scale")
    check(recorded["flash_attention"]["calls"] == cfg.num_layers
          and recorded["paged_attention"]["calls"] == cfg.num_layers,
          f"{arch}: recorded {recorded}")

    # generate and a continuous serve of the 4 prompts
    gen = GenerationConfig(max_new_tokens=ARCH_NEW, decoder="greedy")
    timer = CallTimer(model)
    _reset_counts()
    t0 = time.perf_counter()
    res = lvlm.generate(prompts, gen)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_counts, gen_calls = _counts(), dict(timer.calls)
    gen_secs = dict(timer.seconds)
    toks_gen = [r.tokens for r in res]
    check(all(len(t) == ARCH_NEW and all(0 <= x < cfg.vocab_size for x in t)
              for t in toks_gen), f"{arch}: generate returned bad tokens")
    L = cfg.num_layers
    check(gen_counts["flash_attention"] >= L * gen_calls["prefill"] > 0
          and gen_counts["paged_attention"] >= L * gen_calls["decode_step"]
          > 0, f"{arch}: launches {gen_counts} vs calls {gen_calls}")
    timer.reset()
    reqs = _requests(Request, prompts, [None] * 4, ARCH_NEW)
    ec = EngineConfig(max_batch=4, cache_len=LVLM._cache_len(reqs, gen),
                      scheduler="continuous")
    _reset_counts()
    t0 = time.perf_counter()
    rep = lvlm.serve(reqs, ec, gen)
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_counts, serve_calls = _counts(), dict(timer.calls)
    served = {r.rid: r.generated for r in rep.requests}
    check(len(served) == 4 and all(len(t) == ARCH_NEW
                                   for t in served.values()),
          f"{arch}: the serve did not finish every request")
    check(all(serve_counts.values()), f"{arch}: serve launches "
          f"{serve_counts}")
    agree = float(np.mean([a == b for r, t in zip(res, toks_gen)
                           for a, b in zip(t, served[r.request.rid])]))
    counts = {k: gen_counts[k] + serve_counts[k] for k in gen_counts}
    row = {"layers": L, "of_layers": get_config(arch).num_layers,
           "params": n_params,
           "init_seconds": init_s,
           "init_peak_gib": init_peak / 2 ** 30,
           "decode_vs_forward_rel": cons, "recorded_calls": recorded,
           "generate": {"wall_seconds": gen_wall, "calls": gen_calls,
                        "prefill_wall_seconds": gen_secs["prefill"],
                        "decode_wall_seconds": gen_secs["decode_step"],
                        "launches": gen_counts},
           "serve_continuous": {"wall_seconds": serve_wall,
                                "calls": serve_calls,
                                "launches": serve_counts,
                                "token_agreement_with_generate": agree}}
    if cfg.num_kv_heads == 1:
        # granite: a gamma-4 self-draft speculative serve puts the
        # multi-query mode at G = 48 (5 x 48 = 240 rows a kv head)
        spec = GenerationConfig(max_new_tokens=ARCH_NEW, temperature=0.0,
                                decoder="speculative", gamma=GAMMA)
        reqs = _requests(Request, prompts, [None] * 4, ARCH_NEW)
        timer.reset()
        _reset_counts()
        pa.paged_attention.multi_query_launches = 0
        t0 = time.perf_counter()
        srep = lvlm.serve(reqs, EngineConfig(
            max_batch=4, cache_len=LVLM._cache_len(reqs, spec)), spec)
        torch.cuda.synchronize()
        mq = pa.paged_attention.multi_query_launches
        spec_counts = _counts()
        check(mq > 0 and all(len(r.generated) == ARCH_NEW
                             for r in srep.requests),
              f"{arch}: speculative serve, {mq} multi-query launches")
        row["speculative_serve"] = {
            "wall_seconds": time.perf_counter() - t0,
            "multi_query_launches": mq, "launches": spec_counts,
            "acceptance": srep.stats.get("acceptance"),
            "token_agreement_with_greedy": float(np.mean(
                [a == b for r in srep.requests
                 for a, b in zip(r.generated, served[r.rid])]))}
        counts = {k: counts[k] + spec_counts[k] for k in counts}
    # wall and device busy per prefill (the 1024-token prompt) and per
    # decode step of a 4-slot pool at the prompts' lengths
    cache_len = ec.cache_len
    pool = model.init_cache(4, cache_len, device="cuda")
    dtoks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    dpos = torch.tensor(list(ARCH_PROMPTS), device="cuda")
    batch = {"tokens": torch.tensor([prompts[-1]], device="cuda")}
    prof = _profile_calls({
        "prefill_1024": (lambda: cls.prefill(model, params, batch,
                                             cache_len=cache_len,
                                             last_only=True), 2),
        "decode_step_b4": (lambda: cls.decode_step(model, params, pool,
                                                   dtoks, dpos), 5)})
    for p in prof.values():
        p.pop("by_kernel")
    row["profile"] = prof
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    row["launches"] = counts
    return row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_arch_full() -> dict:
    """granite-34b, mistral-large-123b, nemotron-4-340b and arctic-480b at
    full published width, bf16, random weights from seed 0, each cut in
    depth to fit the card (ARCH_FULL) and freed before the next: decode
    after an S-1 prefill against forward at S-1 within CONSISTENCY_TOL
    of the logit scale, every kernel call of that prefill and decode step
    against the plain version, no NaN; 4 text requests (ARCH_PROMPTS
    tokens, ARCH_NEW new) through ``generate`` and a continuous ``serve``;
    granite also a gamma-4 speculative serve (the multi-query mode at
    G = 48); wall and device-busy ms per 1024-token prefill and per
    batch-4 decode step; the peak of device memory. Arctic's dropless
    decode runs every expert on its buffer, as the reference does."""
    total = dict.fromkeys(("flash_attention", "paged_attention"), 0)
    for arch, layers in ARCH_FULL:
        row = _arch_full_one(arch, layers)
        total = {k: total[k] + row["launches"][k] for k in total}
        emit("arch_full", config=arch, dtype="bfloat16", **row)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------------ MLA --

#: the latent kernel's bar: its arithmetic is float32 in both cache
#: dtypes (q_lat, scores, softmax, o_lat), so it must agree with the plain
#: version within this share of the plain version's largest output
MLA_REL_TOL = 1e-4
#: the latent kernel's times on ``_mla_cases``' timed cases (bf16 cache)
#: when it ran float32 FMAs, before its tensor-core route, as this script
#: measured them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6)
MLA_FMA_MS = {"one_query": 0.076189, "multi_query": 0.54775}
#: (kv_lora_rank, qk_rope_head_dim, heads, q/k width nope + rope) of
#: deepseek-v3 smoke and full: the latent kernel's two instantiations
MLA_SHAPES = {"smoke": (32, 16, 4, 48), "full": (512, 64, 128, 192)}
#: deepseek-v3-671b at full width is cut to its 3 dense layers + 1 MoE
#: layer. Its decode after prefill is held against forward at the bar of
#: the other full-width configs (CONSISTENCY_TOL): forward runs the naive
#: form (k_nope, v and flash's P rounded to bf16), decode the absorbed
#: one in float32, and the two differ by 1.1e-2 of the logit scale on
#: this seed (PERF.md, PR 19). The check runs 2 sequences of this length:
#: dropless MoE (C = T * k, as the reference) gives each of the 256
#: experts a [T * 8, 7168] buffer, 4.7 GB at T = 160
MLA_FULL_LAYERS, MLA_CONSISTENCY_LEN = 4, 80


def _flash_bits_cases():
    """Every flash shape of the earlier slices whose output bits the
    ``scale=`` argument (left at None) must not change: the kernels
    phase's cases at D = 128 and 64, head dim 32 at phi4-mini smoke's
    heads, head dim 192 and 48 q heads per kv head."""
    _, cases = _flash_cases()
    d32 = dict(b=1, h=8, kvh=2, sq=1056, sk=1056, d=32)
    g48 = dict(b=1, h=48, kvh=1, sq=1056, sk=1056, d=128)
    return [(f"d128/{n}", c, kw) for n, c, kw in cases] + [
        ("d32/main", d32, {}), ("d32/window_64", d32, dict(window=64)),
        ("d32/kv_len_lt_sk", dict(d32, sq=64, sk=1104), dict(kv_len=1072)),
        ("d32/keyless_rows", dict(d32, sq=200, sk=200), dict(q_offset=-30)),
        ("d32/non_causal", dict(d32, sq=70, sk=64),
         dict(causal=False, kv_len=40)),
        ("d192/main", dict(b=1, h=96, kvh=8, sq=1056, sk=1056, d=192), {}),
        ("g48/main", g48, {}),
        ("g48/window", dict(g48, sq=300, sk=300), dict(window=100))]


@functools.lru_cache(maxsize=1)
def flash_bits() -> dict:
    """The first 16 hex digits of the sha256 of the flash kernel's output
    on every ``_flash_bits_cases`` case in float32 and bf16 at the default
    scale, inputs drawn from a generator seeded by the case's name. Read
    once a run (the flash backward and MLA phases both hold it against
    FLASH_BITS_SHA)."""
    import zlib
    from repro_torch.kernels import flash_attention as fa
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, c, kw in _flash_bits_cases():
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            q, k, v = _flash_inputs(rng, c, dtype)
            out[f"{name}/{str(dtype)[6:]}"] = _sha(
                fa.flash_attention(q, k, v, **kw))[:16]
    return out


def _mla_cases(rng, dtype, r, rr, h):
    """The latent kernel's cases at one instantiation: (name, args, kw).
    one_query: decode at batch 4 over 1104-row slots (q_pos 1055-1103);
    short_row: a row at q_pos 39 among them (splits past it are empty);
    multi_query: the [B]-start verify, S = 5 at batch 8 (the last row
    routed to start L - 1, so its queries sit past the cache); window: a
    100-key window on the plain cache; k_pos: a 256-slot ring after 100 to
    600 writes (slot_pos, window 256), one row with holes (-1) and one
    with no valid key (the mean of ckv)."""
    length = SERVE_CACHE_LEN

    def inputs(b, sq, n):
        return (randn(rng, (b, sq, h, r), torch.float32),
                randn(rng, (b, sq, h, rr), torch.float32),
                randn(rng, (b, n, r), dtype), randn(rng, (b, n, rr), dtype))

    def pos(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")
    one = pos(rng.integers(1055, length, 4)[:, None])
    starts = np.array([1056, 1060, 1063, 1070, 1075, 1080, 1083, length - 1])
    multi = pos(starts[:, None] + np.arange(VERIFY_S)[None])
    ring, written = 256, np.array([100, 300, 600, 257])
    slot = np.full((4, ring), -1, np.int64)
    for b, n in enumerate(written):
        for p in range(n):
            slot[b, p % ring] = p
    slot[1, rng.choice(ring, 40, replace=False)] = -1     # holes
    slot[3] = -1                                          # no valid key
    kw_ring = dict(k_pos=pos(slot), window=ring)
    return [
        ("one_query", inputs(4, 1, length) + (one,), {}),
        ("short_row", inputs(4, 1, length) + (pos([[1059], [39], [1103],
                                                   [1080]]),), {}),
        ("multi_query", inputs(8, VERIFY_S, length) + (multi,), {}),
        ("window", inputs(4, 1, length) + (one,), dict(window=100)),
        ("k_pos", inputs(4, 1, ring) + (pos(written[:, None] - 1),),
         kw_ring),
    ]


def _mla_row(args, kw, scale, flush, err, **extra):
    """The latent kernel's timed row on ``args``: ms, the plain version
    (the reference's einsum formulation: matmul, softmax, matmul), SDPA
    in float32 as the library call (keys ckv | k_rope and values ckv
    upcast and concatenated once, outside the timing), the route, the
    split count and the bound over the keys each query sees: on the
    tensor-core route the function's operations at the bf16 rate
    (``bound_ms``), beside the split design's twice as many
    (``bound_split_ms``: q_lat and P each as two bf16 products) and the
    float32 FMA bound (``bound_f32_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import mla_attention as ma
    from repro_torch.kernels.ref import mla_key_mask
    q_lat, q_rope, ckv, k_rope, q_pos = args
    b, sq, h, r = q_lat.shape
    rr, length = k_rope.shape[-1], ckv.shape[1]
    mask = mla_key_mask(q_pos, length, **kw)                # [B, Sq, L]
    n_keys = int(mask.sum())
    elt = ckv.element_size()
    rows_read = int(mask.any(1).sum())
    nbytes = 4 * (q_lat.numel() + q_rope.numel() + b * sq * h * r
                  + q_pos.numel()) + elt * rows_read * (r + rr)
    flops = 2 * h * (r + rr + r) * n_keys
    qs = torch.cat([q_lat, q_rope], -1).transpose(1, 2)
    ks = torch.cat([ckv, k_rope], -1).float()[:, None]
    vs = ckv.float()[:, None]
    am = mask[:, None]
    route = ma.route(ckv.dtype, r)
    if route == "wgmma":
        extra["bound_split_ms"] = bound(nbytes, 2 * flops,
                                        torch.bfloat16)[0]
        extra["bound_f32_ms"] = bound(nbytes, flops, torch.float32)[0]
        dtype = torch.bfloat16
        split = ma.tc_split(b, sq, h, length, torch.cuda
                            .get_device_properties(0).multi_processor_count)
    else:
        dtype, split = torch.float32, ma.SPLIT
    extra["n_split"] = -(-length // split)
    return _timed_row(
        lambda: ma.mla_attention(*args, **kw, scale=scale),
        lambda: ma.mla_attention_plain(*args, **kw, scale=scale),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                               scale=scale, enable_gqa=True),
        flush, nbytes, flops, dtype, err, keys=n_keys,
        cache_dtype=str(ckv.dtype)[6:], route=route, **extra)


def phase_mla_kernels(flush) -> dict:
    """The latent kernel against its plain version at both
    instantiations (deepseek-v3 smoke: R 32, Rr 16, 4 heads; full: 512,
    64, 128 heads) and both cache dtypes on every ``_mla_cases`` case,
    within MLA_REL_TOL of the plain version's largest output; the bf16
    full-width one-query and verify cases (the tensor-core route) timed
    beside both bounds, with the split count the wrapper picked and the
    FMA route's times (MLA_FMA_MS); the verify must beat the plain
    einsums. Flash with an explicit
    ``scale=`` at MLA's prefill shapes (B = 1, H = KVH = 128, D = 192 over
    1024 tokens, v 128 wide as the prefill passes it -- timed, within TOL
    of the plain version and of the call with v zero-padded to 192, whose
    time stands beside it -- and the padded call itself; the smoke's
    48-wide q/k and 32-wide v zero-padded to 64, scale 1/sqrt(48)) within
    TOL, and every earlier flash shape's bits at the default scale
    (FLASH_BITS_SHA). Returns the kernels-line rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_attention as ma
    rng = np.random.default_rng(19)
    errs, timed = {}, {}
    for key, (r, rr, h, dqk) in MLA_SHAPES.items():
        scale = 1.0 / dqk ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            for name, args, kw in _mla_cases(rng, dtype, r, rr, h):
                got = ma.mla_attention(*args, **kw, scale=scale)
                torch.cuda.synchronize()
                want = ma.mla_attention_plain(*args, **kw, scale=scale)
                e = max_err(got, want)
                rel = e / float(want.abs().max())
                errs[f"{key}/{name}/{dt}"] = rel
                check(bool(torch.isfinite(got).all()) and rel <= MLA_REL_TOL,
                      f"mla {key} {name} {dt}: err {e}, {rel} of max|ref|")
                if key == "full" and dtype == torch.bfloat16 \
                        and name in ("one_query", "multi_query"):
                    timed[name] = _mla_row(args, kw, scale, flush, e,
                                           shape=dict(r=r, rr=rr, h=h,
                                                      b=args[0].shape[0],
                                                      sq=args[0].shape[1],
                                                      cache_len=args[2]
                                                      .shape[1]))
    # flash at MLA's prefill shapes, explicit scale
    flash = {}
    for key, (h, s, dqk, dv, d) in {"full": (128, 1024, 192, 128, 192),
                                    "smoke": (4, 61, 48, 32, 64)}.items():
        scale = 1.0 / dqk ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            q = F.pad(randn(rng, (1, s, h, dqk), dtype), (0, d - dqk))
            k = F.pad(randn(rng, (1, s, h, dqk), dtype), (0, d - dqk))
            v = randn(rng, (1, s, h, dv), dtype)
            vp = F.pad(v, (0, d - dv))
            args = (q.transpose(1, 2), k.transpose(1, 2), vp.transpose(1, 2))
            got = fa.flash_attention(*args, scale=scale)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(*args, scale=scale)
            e = max_err(got, want)
            check(e <= TOL[dtype] and max_err(got[..., dv:], 0 * got[
                ..., dv:]) == 0.0, f"flash mla {key} {dt}: err {e}")
            errs[f"flash_{key}/{dt}"] = e
            if key != "full":       # (64, 32) has no kernel: v stays padded
                continue
            # v at its own width, as the prefill passes it (no autograd)
            nargs = args[:2] + (v.transpose(1, 2),)
            got_n = fa.flash_attention(*nargs, scale=scale)
            torch.cuda.synchronize()
            e_n = errs[f"flash_{key}_v{dv}/{dt}"] = max_err(
                got_n, fa.flash_attention_plain(*nargs, scale=scale))
            e_p = errs[f"flash_{key}_v{dv}_vs_padded/{dt}"] = max_err(
                got_n, got[..., :dv])
            check(got_n.shape[-1] == dv and e_n <= TOL[dtype]
                  and e_p <= TOL[dtype], f"flash mla {key} v {dv} {dt}: "
                  f"err {e_n}, against the padded call {e_p}")
            if dtype == torch.bfloat16:
                qs, ks = args[0][..., :dqk], args[1][..., :dqk]
                vs = v.transpose(1, 2)
                n = s * (s + 1) / 2
                flash["mla_prefill"] = _timed_row(
                    lambda: fa.flash_attention(*nargs, scale=scale),
                    lambda: fa.flash_attention_plain(*nargs, scale=scale),
                    lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=True, scale=scale),
                    flush, q.element_size() * (2 * h * s * dqk
                                               + 2 * h * s * dv),
                    2 * h * n * (dqk + dv), dtype, e_n,
                    padded_v_ms=time_ms(
                        lambda: fa.flash_attention(*args, scale=scale),
                        flush),
                    padded_v_max_abs_err=e,
                    shape=dict(b=1, h=h, kvh=h, sq=s, sk=s, d=d, d_qk=dqk,
                               d_v=dv))
    bits = flash_bits()
    same = {k: v == FLASH_BITS_SHA.get(k) for k, v in bits.items()}
    emit("mla_kernels", rel_errors={k: v for k, v in errs.items()
                                    if not k.startswith("flash")},
         flash_errors={k: v for k, v in errs.items()
                       if k.startswith("flash")},
         rel_tolerance=MLA_REL_TOL, timed=timed, fma_route_ms=MLA_FMA_MS,
         flash=flash, flash_bits_unchanged=sum(same.values()),
         flash_bits_cases=len(same))
    check(all(same.values()) and len(same) == len(FLASH_BITS_SHA),
          f"flash bits changed: {[k for k, v in same.items() if not v]}")
    mq = timed["multi_query"]
    check(mq["route"] == "wgmma" and mq["ms"] < mq["plain_ms"],
          f"the S = {VERIFY_S} verify on the latent kernel is not faster "
          f"than its plain version: {mq}")
    main = timed["one_query"]
    return {"mla_attention": {
        "name": "mla_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
        "replaces": "src/repro/models/attention.py:503",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "bound_split_ms",
                                "bound_f32_ms", "n_split")},
        "multi_query": timed["multi_query"]},
        "flash_mla_prefill": flash["mla_prefill"]}


def mla_split_sweep() -> None:
    """``python3 chip_smoke.py --mla-split-sweep``, a measurement outside
    the standing check: the tensor-core latent kernel at ``_mla_cases``'
    timed shapes (one-query B = 4 and the S = 5 verify B = 8, 1104 rows,
    bf16) at 1-18 CTAs a row tile and at the wrapper's choice
    (``tc_split``), each held to MLA_REL_TOL before it is timed, and at
    one split over the first 32 rows (a single key tile): with one split
    over every row, device us per key tile and per CTA besides its
    tiles. Prints the env line and one JSON line."""
    from repro_torch.kernels import build
    from repro_torch.kernels import mla_attention as ma
    phase_env()
    build.load("mla_attention")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    r, rr, h, dqk = MLA_SHAPES["full"]
    scale = 1.0 / dqk ** 0.5
    cases = {name: args for name, args, kw in
             _mla_cases(np.random.default_rng(19), torch.bfloat16, r, rr, h)
             if name in ("one_query", "multi_query")}
    out = {}
    for name, args in cases.items():
        q_lat, q_rope, ckv, k_rope, q_pos = args
        b, sq, h, _ = q_lat.shape
        length = ckv.shape[1]
        key_tiles = -(-length // ma.TC_KEYS)
        want = ma.mla_attention_plain(*args, scale=scale)
        chosen = ma.tc_split(b, sq, h, length, sms)
        splits = {ma.TC_KEYS * -(-key_tiles // n)
                  for n in (1, 2, 3, 4, 6, 9, 12, 16, 18)} | {chosen}
        ms = {}
        for split in sorted(splits, reverse=True):
            fn = (lambda split=split: ma._launch(*args, None, 0, scale,
                                                 split))
            rel = max_err(fn(), want) / float(want.abs().max())
            check(rel <= MLA_REL_TOL, f"mla sweep {name} split {split}: {rel}")
            ms[-(-length // split)] = time_ms(fn, flush)
        short = (q_lat, q_rope, ckv[:, :32].contiguous(),
                 k_rope[:, :32].contiguous(), q_pos.clamp(max=31))
        one_tile = time_ms(lambda: ma._launch(*short, None, 0, scale, 32),
                           flush)
        tile_us = (ms[1] - one_tile) * 1e3 / (key_tiles - 1)
        out[name] = {"chosen_n_split": -(-length // chosen),
                     "ms_by_n_split": ms, "one_split_one_tile_ms": one_tile,
                     "tile_us": tile_us, "cta_us": one_tile * 1e3 - tile_us}
    emit("mla_split_sweep", sms=sms, **out)


def _latent_serves(t, prompts, Request, serves=None):
    """deepseek-v3 smoke through every serving path the phase holds
    (``serves`` names a subset):
    generate, continuous and chunked serves, a gamma-4 self-draft
    speculative serve, a prefix-cache serve (three prompts on a shared
    16-token head, the first one block-aligned at it; one slot, so each
    later request finds the block its predecessor published at retire)
    and a prefill / decode fleet that migrates every
    request's latent cache."""
    from repro_torch.api import EngineConfig, GenerationConfig
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy",
                           temperature=0.0)
    spec = GenerationConfig(max_new_tokens=9, decoder="speculative",
                            gamma=GAMMA, temperature=0.0)
    ec = dict(max_batch=3, cache_len=96)
    out = {}
    for name, g in (("speculative", spec), ("greedy_9", gen)):
        out[name] = {r.rid: r.generated for r in t.serve(
            _requests(Request, prompts, [None] * 3, 9), EngineConfig(**ec),
            g).requests}
    if serves is not None:
        return {k: out[k] for k in serves}
    out["generate"] = [r.tokens for r in t.generate(prompts, gen)]
    for sched, kw in (("continuous", {}),
                      ("chunked", dict(chunk_size=16, token_budget=48))):
        out[sched] = {r.rid: r.generated for r in t.serve(
            _requests(Request, prompts, [None] * 3, 8),
            EngineConfig(scheduler=sched, **ec, **kw), gen).requests}
    head = prompts[1][:16]
    shared = [Request(rid=i, tokens=head + p[:n], max_new_tokens=8,
                      arrival=0.002 * i)
              for i, (p, n) in enumerate(zip(prompts, (5, 12, 7)))]
    rep = t.serve(shared, EngineConfig(
        prefix_cache=True, prefix_block=8, scheduler="continuous",
        max_batch=1, cache_len=96), gen)   # a block is published at retire
    out["prefix"] = {r.rid: r.generated for r in rep.requests}
    out["prefix_hits"] = rep.stats["prefix_hit_tokens"]
    front = t.serve_cluster(2, EngineConfig(temperature=0.0, sanitize=True,
                                            **ec), gen=gen,
                            roles=["prefill", "decode"])
    out["disaggregated"], _ = _drive(front, _requests(
        Request, prompts, [None] * 3, 8))
    out["migrations"] = len(front.migrations)
    return out


def phase_mla_smoke() -> dict:
    """deepseek-v3 smoke in float32, built with no ``device=`` (so on the
    card), against the same weights on the CPU: prefill, decode and a
    [B]-start extend (the verify, absorbed on the latent kernel) logits
    within SMOKE_LOGIT_TOL; one prefill launches flash num_layers times
    and nothing else, one decode step and one [B]-start extend the latent
    kernel num_layers times and nothing else; then ``_latent_serves``
    tokens equal on both devices, prefix hits > 0 and every request
    migrated; and the speculative serve equal to greedy on the smoke
    config with dense FFNs (its MoE verify may drop tokens that greedy's
    dropless decode keeps). Returns the card runs' kernel launches."""
    from repro_torch.api import LVLM, Request
    card = LVLM.from_pretrained("deepseek-v3-671b", smoke=True, seed=0)
    check(card.device.type == "cuda", "deepseek smoke not on cuda")
    cpu = card.with_params(_tree_to(card.params, "cpu"))
    cfg, L = card.cfg, card.cfg.num_layers
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (20, 61, 9)]
    toks = torch.tensor([prompts[1], prompts[1]])
    steps = {}
    _reset_counts()
    lc, cc = cpu.model.prefill(cpu.params, {"tokens": toks}, cache_len=80)
    lg, cg = card.model.prefill(card.params, {"tokens": toks.cuda()},
                                cache_len=80)
    torch.cuda.synchronize()
    steps["prefill"] = _mla_counts()
    e_pre = max_err(lg.cpu(), lc)
    nxt, pos = torch.tensor([[3], [5]]), torch.tensor([61, 61])
    _reset_counts()
    dc, cc = cpu.model.decode_step(cpu.params, cc, nxt, pos)
    dg, cg = card.model.decode_step(card.params, cg, nxt.cuda(), pos.cuda())
    torch.cuda.synchronize()
    steps["decode_step"] = _mla_counts()
    e_dec = max_err(dg.cpu(), dc)
    ext, starts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 5))
                                   ), torch.tensor([62, 58])
    _reset_counts()
    xc, _ = cpu.model.extend(cpu.params, cc, ext, starts)
    xg, _ = card.model.extend(card.params, cg, ext.cuda(), starts.cuda())
    torch.cuda.synchronize()
    steps["extend_rows"] = _mla_counts()
    e_ext = max_err(xg.cpu(), xc)
    check(max(e_pre, e_dec, e_ext) <= SMOKE_LOGIT_TOL,
          f"deepseek smoke logits card vs CPU: prefill {e_pre}, decode "
          f"{e_dec}, [B]-start extend {e_ext}")
    want = {"prefill": (L, 0, 0), "decode_step": (0, 0, L),
            "extend_rows": (0, 0, L)}
    for step, (f, p, m) in want.items():
        got = steps[step]
        check((got["flash_attention"], got["paged_attention"],
               got["mla_attention"]) == (f, p, m),
              f"deepseek smoke {step}: launches {got}")
    res = {}
    for name, t in (("card", card), ("cpu", cpu)):
        _reset_counts()
        res[name] = _latent_serves(t, prompts, Request)
        if name == "card":
            torch.cuda.synchronize()
            counts = _mla_counts()
    same = {k: res["card"][k] == res["cpu"][k] for k in res["card"]}
    emit("mla_smoke", config=cfg.name, dtype=cfg.dtype,
         prefill_logit_err=e_pre, decode_logit_err=e_dec,
         extend_rows_logit_err=e_ext, tolerance=SMOKE_LOGIT_TOL,
         step_launches=steps, tokens_equal=same,
         prefix_hit_tokens=res["card"]["prefix_hits"],
         migrations=res["card"]["migrations"], launches=counts)
    check(all(same.values()), f"deepseek smoke card != CPU: {same}")
    # speculative == greedy where the verify's MoE cannot drop a token
    # (its extend runs at capacity 1.25, greedy's decode dropless: the
    # reference quirk of ROADMAP C5): MLA with dense FFNs on the card
    dense = LVLM.from_pretrained("deepseek-v3-671b", smoke=True, seed=0,
                                 num_experts=0)
    _reset_counts()
    dres = _latent_serves(dense, prompts, Request, serves=("speculative",
                                                           "greedy_9"))
    torch.cuda.synchronize()
    counts = {k: v + _mla_counts()[k] for k, v in counts.items()}
    emit("mla_smoke_speculative",
         moe_speculative_equals_greedy=res["card"]["speculative"]
         == res["card"]["greedy_9"],
         dense_ffn_speculative_equals_greedy=dres["speculative"]
         == dres["greedy_9"],
         moe_speculative=res["card"]["speculative"],
         moe_greedy=res["card"]["greedy_9"])
    check(dres["speculative"] == dres["greedy_9"],
          "deepseek smoke (dense FFNs) speculative serve != greedy")
    check(res["card"]["prefix_hits"] > 0 and res["card"]["migrations"] == 3,
          f"prefix hits {res['card']['prefix_hits']}, migrations "
          f"{res['card']['migrations']}")
    check(counts["flash_attention"] > 0 and counts["mla_attention"] > 0,
          f"deepseek smoke: a kernel was not launched: {counts}")
    return counts


def phase_mla_full() -> dict:
    """deepseek-v3-671b at full published width, bf16, random weights
    from seed 0, cut to MLA_FULL_LAYERS of 61 layers (the 3 dense layers
    and 1 MoE layer): decode after an S-1 prefill against forward at S-1
    within CONSISTENCY_TOL of the logit scale (dropless MoE on both
    sides), every kernel call of that prefill and decode step against its
    plain version; the 4 ARCH_PROMPTS requests (ARCH_NEW new tokens)
    through ``generate``, a continuous serve and a gamma-4 self-draft
    speculative serve (the verify on the latent kernel, S = 5); wall and
    device busy per 1024-token prefill, per 4-slot decode step and per
    4-slot S = 5 verify extend (the speculative serve's), each kernel's
    device ms per launch; peak memory."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    from repro_torch.configs import get_config
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvlm = LVLM.from_pretrained("deepseek-v3-671b", seed=0,
                                num_layers=MLA_FULL_LAYERS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    cfg, model, params = lvlm.cfg, lvlm.model, lvlm.params
    check(lvlm.device.type == "cuda", "deepseek full: not on cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ARCH_PROMPTS]
    cls, L = type(model), cfg.num_layers

    s = MLA_CONSISTENCY_LEN
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s))).cuda()
    full, _ = cls.forward(model, params, {"tokens": toks}, moe_cap=None)
    want = full[:, -1].float()
    del full
    with _CallRecorder() as rec:
        _, cache = cls.prefill(model, params, {"tokens": toks[:, :-1]},
                               cache_len=s + 16, moe_cap=None,
                               last_only=True)
        got, _ = cls.decode_step(model, params, cache, toks[:, -1:], s - 1,
                                 moe_cap=None)
    torch.cuda.synchronize()
    del cache
    recorded = rec.check()
    del rec
    scale = float(want.abs().max())
    cons = max_err(got, want) / scale
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(
        want).all()), "deepseek full: NaN or inf logits")
    check(cons <= CONSISTENCY_TOL, f"deepseek full: decode after prefill "
          f"vs forward differ by {cons} of the logit scale")
    check(recorded["flash_attention"]["calls"] == L
          and recorded["mla_attention"]["calls"] == L
          and recorded["paged_attention"]["calls"] == 0,
          f"deepseek full: recorded {recorded}")

    gen = GenerationConfig(max_new_tokens=ARCH_NEW, decoder="greedy")
    timer = CallTimer(model)
    row = {"layers": L, "of_layers": get_config("deepseek-v3-671b"
                                                ).num_layers,
           "params": n_params, "init_seconds": init_s,
           "init_peak_gib": init_peak / 2 ** 30,
           "decode_vs_forward_rel": cons, "logit_scale": scale,
           "recorded_calls": recorded}
    counts = dict.fromkeys(("flash_attention", "paged_attention",
                            "mla_attention"), 0)
    runs = {}
    spec = GenerationConfig(max_new_tokens=ARCH_NEW, temperature=0.0,
                            decoder="speculative", gamma=GAMMA)
    for name in ("generate", "serve_continuous", "serve_speculative"):
        timer.reset()
        _reset_counts()
        t0 = time.perf_counter()
        if name == "generate":
            res = lvlm.generate(prompts, gen)
            runs[name] = {i: r.tokens for i, r in enumerate(res)}
        else:
            g = gen if name == "serve_continuous" else spec
            reqs = _requests(Request, prompts, [None] * 4, ARCH_NEW)
            rep = lvlm.serve(reqs, EngineConfig(
                max_batch=4, cache_len=LVLM._cache_len(reqs, g),
                scheduler="continuous"), g)
            runs[name] = {r.rid: r.generated for r in rep.requests}
        torch.cuda.synchronize()
        c = _mla_counts()
        row[name] = {"wall_seconds": time.perf_counter() - t0,
                     "calls": dict(timer.calls), "launches": c,
                     "prefill_wall_seconds": timer.seconds["prefill"],
                     "decode_wall_seconds": timer.seconds["decode_step"]}
        check(len(runs[name]) == 4 and all(
            len(t) == ARCH_NEW and all(0 <= x < cfg.vocab_size for x in t)
            for t in runs[name].values()), f"deepseek full {name}: tokens")
        check(c["flash_attention"] >= L * timer.calls["prefill"] > 0
              and c["mla_attention"] >= L * (timer.calls["decode_step"]
                                             + timer.calls["extend"]) > 0
              and c["paged_attention"] == 0,
              f"deepseek full {name}: launches {c} vs {timer.calls}")
        counts = {k: counts[k] + c[k] for k in counts}
    for name in ("serve_continuous", "serve_speculative"):
        row[name]["token_agreement_with_generate"] = float(np.mean(
            [a == b for i, t in runs["generate"].items()
             for a, b in zip(t, runs[name][i])]))
    check(runs["serve_continuous"] == runs["generate"],
          "deepseek full: the continuous serve != generate")
    cache_len = LVLM._cache_len(_requests(Request, prompts, [None] * 4,
                                          ARCH_NEW), gen)
    pool = model.init_cache(4, cache_len, device="cuda")
    dtoks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    vtoks = torch.zeros((4, VERIFY_S), dtype=torch.long, device="cuda")
    dpos = torch.tensor(list(ARCH_PROMPTS), device="cuda")
    batch = {"tokens": torch.tensor([prompts[-1]], device="cuda")}
    prof = _profile_calls({
        "prefill_1024": (lambda: cls.prefill(model, params, batch,
                                             cache_len=cache_len,
                                             last_only=True), 2),
        "decode_step_b4": (lambda: cls.decode_step(model, params, pool,
                                                   dtoks, dpos), 5),
        "verify_b4_s5": (lambda: cls.extend(model, params, pool, vtoks,
                                            dpos), 5)})
    for p in prof.values():
        p.pop("by_kernel")
    row["profile"] = prof
    row["cache_bytes_per_token"] = cfg.kv_head_dim * L * 2
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    row["launches"] = counts
    emit("mla_full", config=cfg.name, dtype=cfg.dtype, **row)
    del lvlm, model, params, pool, timer, res, rep, prof
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------- the remaining families --

#: smoke configs of the ssm, hybrid, perceiver-vlm and audio families, held
#: card against CPU (float32)
FAMILY_SMOKE = (("rwkv6-3b", {}), ("zamba2-1.2b", {}),
                ("qwen2-vl-2b", dict(projector="perceiver", num_latents=8)),
                ("whisper-tiny", {}))
#: the same families at full published width and depth, uncut (bf16), but
#: rwkv6-3b at 8 of its 32 layers: its token loop is launch-bound (~27 us
#: a launch, ~4 a token a layer) and at full depth took 67 of the script's
#: seconds, which the training phases need
FAMILY_FULL = (("rwkv6-3b", dict(num_layers=8)), ("zamba2-1.2b", {}),
               ("whisper-tiny", {}), ("qwen2-vl-2b", dict(projector="perceiver")))
#: decode after prefill against forward in float32 at full width (rwkv6)
F32_CONSISTENCY_TOL = 1e-3
#: whisper's decoder prompt and the perceiver's text prompt (tokens)
FAMILY_PROMPT = 16
PERCEIVER_TEXT = 32


def _family_label(arch, kw) -> str:
    return arch + ("+perceiver" if kw.get("projector") == "perceiver"
                   else "")


def _greedy_loop(model, params, batch, n_new, cache_len):
    """Model-level greedy decoding (whisper: the facade cannot drive it):
    one prefill of ``batch``, then ``n_new - 1`` decode steps. Returns the
    tokens [B, n_new]."""
    logits, cache = model.prefill(params, batch, cache_len=cache_len,
                                  last_only=True)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    out, s = [tok], batch["tokens"].shape[1]
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, cache, tok, s + i)
        tok = logits.argmax(-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, 1)


def phase_families_smoke() -> dict:
    """rwkv6, zamba2, qwen2-vl with the perceiver projector and whisper at
    smoke size (float32), built with no ``device=`` (so on the card)
    against the same weights on the CPU: prefill and decode logits within
    SMOKE_LOGIT_TOL; identical greedy tokens through ``LVLM.generate`` (a
    75-token zamba2 prompt wraps the shared block's ring of 64) and,
    for whisper, through a ``Model``-level greedy loop. Returns the card
    runs' kernel launches (none for the attention-free rwkv6)."""
    from repro_torch.api import GenerationConfig, LVLM
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    total = dict.fromkeys(("flash_attention", "paged_attention"), 0)
    rows = {}
    for arch, kw in FAMILY_SMOKE:
        card = LVLM.from_pretrained(arch, smoke=True, seed=0, **kw)
        check(card.device.type == "cuda", f"{arch} smoke not on cuda")
        cpu = card.with_params(_tree_to(card.params, "cpu"))
        cfg, label = card.cfg, _family_label(arch, kw)
        rng = np.random.default_rng(21)
        lens = (75, 9) if cfg.family == "hybrid" else (20, 9)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
        ves = None
        batch = {"tokens": torch.tensor([prompts[0]] * 2)}
        if cfg.family == "vlm":
            ves = [rng.standard_normal((n, cfg.d_model)).astype(np.float32)
                   for n in (16, 5)]
            batch["visual_embeds"] = torch.from_numpy(np.stack([ves[0]] * 2))
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        gbatch = {k: v.cuda() for k, v in batch.items()}
        lc, cc = cpu.model.prefill(cpu.params, batch, cache_len=96)
        _reset_counts()
        lg, cg = card.model.prefill(card.params, gbatch, cache_len=96)
        e_pre = max_err(lg.cpu(), lc)
        n = lc.shape[1]
        nxt, pos = torch.tensor([[3], [4]]), torch.tensor([n, n])
        dc, _ = cpu.model.decode_step(cpu.params, cc, nxt, pos)
        dg, _ = card.model.decode_step(card.params, cg, nxt.cuda(),
                                       pos.cuda())
        e_dec = max_err(dg.cpu(), dc)
        res = {}
        for name, t in (("card", card), ("cpu", cpu)):
            if cfg.family == "audio":
                b = gbatch if name == "card" else batch
                res[name] = _greedy_loop(t.model, t.params, b, 8,
                                         n + 8).cpu().tolist()
            else:
                res[name] = [r.tokens for r in t.generate(
                    prompts, gen, visual_embeds=ves)]
            if name == "card":
                torch.cuda.synchronize()
                counts = _counts()
        rows[label] = dict(prefill_logit_err=e_pre, decode_logit_err=e_dec,
                           tokens_equal=res["card"] == res["cpu"],
                           launches=counts)
        check(e_pre <= SMOKE_LOGIT_TOL and e_dec <= SMOKE_LOGIT_TOL,
              f"{label} logits card vs CPU: prefill {e_pre}, decode {e_dec}")
        check(res["card"] == res["cpu"], f"{label} tokens card != CPU: "
              f"{res}")
        check(all(counts.values()) != cfg.is_attention_free,
              f"{label}: kernel launches {counts}")
        total = {k: total[k] + counts[k] for k in total}
        del card, cpu
    emit("families_smoke", tolerance=SMOKE_LOGIT_TOL, configs=rows,
         checks=["prefill/decode logits", "generate (whisper: Model-level "
                 "greedy loop)"])
    return total


def _ring_case(rng, dtype, q_pos, h, kvh, d, length, page=16):
    """One-query masked decode over a dense ring cache of ``length`` slots
    per request (identity table): request b holds positions
    max(0, q_pos[b] - length + 1) .. q_pos[b] at slot p % length
    (``slot_pos``; -1 elsewhere), the zamba2 shared block's cache. Returns
    ((q, k_pages, v_pages, table, seq_lens), masked kwargs, dense k, v,
    slot_pos [B, length])."""
    b, pps = len(q_pos), length // page
    k = randn(rng, (b, length, kvh, d), dtype)
    v = randn(rng, (b, length, kvh, d), dtype)
    sp = np.full((b, length), -1, np.int32)
    for i, qp in enumerate(q_pos):
        p = np.arange(max(0, qp - length + 1), qp + 1)
        sp[i, p % length] = p
    sp_t = torch.from_numpy(sp).cuda()
    table = torch.arange(b * pps, dtype=torch.int32,
                         device="cuda").view(b, pps)
    seq = torch.from_numpy(np.minimum(np.asarray(q_pos) + 1, length)
                           .astype(np.int32)).cuda()
    args = (randn(rng, (b, h, d), dtype), k.view(b * pps, page, kvh, d),
            v.view(b * pps, page, kvh, d), table, seq)
    kw = dict(k_pos=sp_t.view(b * pps, page), window=4096,
              q_pos=torch.tensor(q_pos, dtype=torch.int32, device="cuda"))
    return args, kw, (k, v, sp_t)


def phase_kernels_families(flush) -> dict:
    """Both kernels at the shapes and modes the four families add, in
    float32 (TOL) and bf16 (TOL and REL_TOL of the largest output) against
    their plain versions, each bf16 case timed beside its bound, its plain
    version and SDPA: (a) flash's window mode at zamba2's shared block (D
    64, 32 / 32 heads, window 4096) over a 1024-token prompt, and checked
    over 4200 tokens, where the window cuts; (b) flash non-causal over
    whisper's 1500 encoder frames (6 / 6 heads, D 64, batch 4); (c) its
    cross prefill, 16 queries over 1500 frames; (d) paged masked decode on
    zamba2's ring at the serve's positions (batch 4, 1056 slots), and
    checked on a wrapped ring of 4096; (e) paged one-query decode over
    whisper's self-attention cache of 448 slots; (f) over its cross cache
    of 1500 rows paged by 4 tokens (``_page_size(1500)``), every key
    read."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import _page_size
    rng = np.random.default_rng(22)
    flash = {
        "a_zamba2_window": (dict(b=1, h=32, kvh=32, sq=1024, sk=1024, d=64),
                            dict(window=4096)),
        "a_zamba2_window_cut": (dict(b=1, h=32, kvh=32, sq=4200, sk=4200,
                                     d=64), dict(window=4096)),
        "b_whisper_encoder": (dict(b=4, h=6, kvh=6, sq=1500, sk=1500, d=64),
                              dict(causal=False)),
        "c_whisper_cross_prefill": (dict(b=4, h=6, kvh=6, sq=FAMILY_PROMPT,
                                         sk=1500, d=64), dict(causal=False)),
    }
    errs, rel, timed = {}, {}, {}

    def hold(name, got, want, dtype):
        e = errs[name] = max_err(got, want)
        r = rel[name] = e / float(want.float().abs().max())
        check(e <= TOL[dtype] and (dtype == torch.float32
                                   or r <= REL_TOL[dtype]),
              f"{name}: err {e}, {r} of max|ref|")
        return e

    for key, (c, kw) in flash.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_inputs(rng, c, dtype)
            got = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            e = hold(f"{key}/{str(dtype)[6:]}", got,
                     fa.flash_attention_plain(q, k, v, **kw), dtype)
            if dtype != torch.bfloat16 or key.endswith("_cut"):
                continue
            causal = kw.get("causal", True)
            pairs = (c["sq"] * (c["sq"] + 1) / 2 if causal
                     else c["sq"] * c["sk"])
            timed[key] = _timed_row(
                lambda q=q, k=k, v=v, kw=kw: fa.flash_attention(q, k, v,
                                                                **kw),
                lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_plain(
                    q, k, v, **kw),
                lambda q=q, k=k, v=v, causal=causal:
                    F.scaled_dot_product_attention(q, k, v,
                                                   is_causal=causal),
                flush, q.element_size() * (2 * q.numel() + k.numel()
                                           + v.numel()),
                4 * c["d"] * c["h"] * c["b"] * pairs, dtype, e,
                shape=dict(c, **kw))
    # (d) zamba2's shared-block decode: the serve's batch-4 ring (1056
    # slots, positions 64 / 300 / 700 / 1024: not wrapped at full width),
    # then a wrapped ring of 4096 (the full window)
    paged = {"d_zamba2_ring": ([64, 300, 700, 1024], 1056),
             "d_zamba2_ring_wrapped": ([4500, 6000, 8191, 4096], 4096)}
    for key, (q_pos, length) in paged.items():
        for dtype in (torch.float32, torch.bfloat16):
            args, kw, (kd, vd, sp) = _ring_case(rng, dtype, q_pos, 32, 32, 64,
                                                length)
            got = pa.paged_attention(*args, **kw)
            torch.cuda.synchronize()
            e = hold(f"{key}/{str(dtype)[6:]}", got,
                     pa.paged_attention_plain(*args, **kw), dtype)
            if dtype != torch.bfloat16 or key.endswith("_wrapped"):
                continue
            qd, seq = args[0], args[4]
            n_key = int((sp >= 0).sum())
            mask = ((sp >= 0) & (sp <= kw["q_pos"][:, None]))[:, None, None]
            timed[key] = _timed_row(
                lambda args=args, kw=kw: pa.paged_attention(*args, **kw),
                lambda args=args, kw=kw: pa.paged_attention_plain(*args,
                                                                  **kw),
                lambda qd=qd, kd=kd, vd=vd, mask=mask:
                    F.scaled_dot_product_attention(
                        qd[:, :, None], kd.transpose(1, 2),
                        vd.transpose(1, 2), attn_mask=mask),
                flush, qd.element_size() * (2 * qd.numel()
                                            + 2 * n_key * 32 * 64)
                + 4 * (args[3].numel() + 2 * len(q_pos) + int(seq.sum())),
                4 * 32 * 64 * n_key, dtype, e,
                shape=dict(b=4, h=32, kvh=32, d=64, ring=length, page=16,
                           q_pos=q_pos, window=4096))
    # (e) whisper's decoder self-attention over 448 slots, (f) its cross
    # decode over the 1500-row cross cache, pages of 4
    for key, length, seqs in (
            ("e_whisper_self", 448, [17, 120, 300, 447]),
            ("f_whisper_cross", 1500, [1500] * 4)):
        page = _page_size(length)
        pps = length // page
        for dtype in (torch.float32, torch.bfloat16):
            kd = randn(rng, (4, length, 6, 64), dtype)
            vd = randn(rng, (4, length, 6, 64), dtype)
            seq = torch.tensor(seqs, dtype=torch.int32, device="cuda")
            args = (randn(rng, (4, 6, 64), dtype),
                    kd.view(4 * pps, page, 6, 64),
                    vd.view(4 * pps, page, 6, 64),
                    torch.arange(4 * pps, dtype=torch.int32,
                                 device="cuda").view(4, pps), seq)
            got = pa.paged_attention(*args)
            torch.cuda.synchronize()
            e = hold(f"{key}/{str(dtype)[6:]}", got,
                     pa.paged_attention_plain(*args), dtype)
            if dtype != torch.bfloat16:
                continue
            qd, n_tok = args[0], int(seq.sum())
            mask = (torch.arange(length, device="cuda")[None]
                    < seq[:, None])[:, None, None, :]
            timed[key] = _timed_row(
                lambda args=args: pa.paged_attention(*args),
                lambda args=args: pa.paged_attention_plain(*args),
                lambda qd=qd, kd=kd, vd=vd, mask=mask:
                    F.scaled_dot_product_attention(
                        qd[:, :, None], kd.transpose(1, 2),
                        vd.transpose(1, 2), attn_mask=mask),
                flush, qd.element_size() * (2 * qd.numel()
                                            + 2 * n_tok * 6 * 64)
                + 4 * (args[3].numel() + 4), 4 * 6 * 64 * n_tok, dtype, e,
                shape=dict(b=4, h=6, kvh=6, d=64, cache_len=length,
                           page=page, seq_lens=seqs))
    emit("kernels_families", errors=errs, rel_errors=rel,
         tolerance={"float32": TOL[torch.float32],
                    "bfloat16": TOL[torch.bfloat16]},
         rel_tolerance={"bfloat16": REL_TOL[torch.bfloat16]}, timed=timed)
    return timed


class _ScanTimer:
    """Synchronised wall seconds inside the recurrences' Python loops
    (rwkv's ``_wkv_scan`` over tokens, Mamba-2's ``_chunk_scan`` over
    chunk states) while the ``with`` block runs, and their calls, by the
    loop's length (tokens, or chunks)."""

    def __enter__(self):
        from repro_torch.models import mamba, rwkv
        self.real = [(rwkv, "_wkv_scan", rwkv._wkv_scan),
                     (mamba, "_chunk_scan", mamba._chunk_scan)]
        self.seconds, self.calls = {}, {}

        def wrap(fn):
            def timed(*a):
                steps = a[1].shape[1]      # r [B,T,..] / s_chunk [B,nc,..]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                self.seconds[steps] = self.seconds.get(steps, 0.0) \
                    + time.perf_counter() - t0
                self.calls[steps] = self.calls.get(steps, 0) + 1
                return out
            return timed
        for mod, name, fn in self.real:
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def _family_batch(cfg, rng, b, s):
    """A batch of ``b`` prompts of ``s`` tokens on the card, with whisper's
    1500 frames or the perceiver's 1024 patches."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s))).cuda()}
    if cfg.family == "audio":
        batch["frames"] = randn(rng, (b, cfg.encoder_seq, cfg.d_model),
                                torch.float32)
    if cfg.family == "vlm":
        batch["visual_embeds"] = randn(rng, (b, 1024, cfg.d_model),
                                       torch.float32)
    return batch


def _decode_vs_forward(model, params, batch, s):
    """max|decode - forward| / max|forward| of the last position: decode
    after a prefill of the first S-1 tokens against forward over all S,
    every kernel call of the prefill and decode held against the plain
    version. Returns (that share, the recorded calls' check)."""
    cfg, cls = model.cfg, type(model)
    nv = cfg.num_latents if cfg.family == "vlm" else 0
    full, _ = cls.forward(model, params, batch)
    want = full[:, -1].float()
    del full
    with _CallRecorder() as rec:
        _, cache = cls.prefill(model, params, dict(
            batch, tokens=batch["tokens"][:, :-1]), cache_len=nv + s + 16,
            last_only=True)
        got, _ = cls.decode_step(model, params, cache,
                                 batch["tokens"][:, -1:], nv + s - 1)
    torch.cuda.synchronize()
    del cache
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(
        want).all()), f"{cfg.name}: NaN or inf logits")
    return max_err(got, want) / float(want.abs().max()), rec.check()


def _family_full_one(arch, kw) -> dict:
    """One family config at full published width and depth (see
    ``phase_families_full``)."""
    from repro_torch.api import EngineConfig, GenerationConfig, LVLM, Request
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lvlm = LVLM.from_pretrained(arch, seed=0, **kw)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, model, params = lvlm.cfg, lvlm.model, lvlm.params
    check(lvlm.device.type == "cuda", f"{arch}: not on cuda")
    cls = type(model)
    rng = np.random.default_rng(23)
    row = {"layers": cfg.num_layers, "params": sum(
        v.numel() for v in _leaves(params)), "init_seconds": init_s}
    # attention calls of one prefill + decode step: (flash, paged)
    if cfg.family == "audio":
        n_attn = (cfg.encoder_layers + 2 * cfg.num_layers,
                  2 * cfg.num_layers)
    elif cfg.family == "hybrid":
        n_attn = (model.n_hybrid_groups()[0],) * 2
    else:
        n_attn = (0, 0) if cfg.is_attention_free else (cfg.num_layers,) * 2

    # decode after an S-1 prefill against forward at S-1, every kernel
    # call held against the plain version
    s = FAMILY_PROMPT if cfg.family == "audio" else (
        PERCEIVER_TEXT if cfg.family == "vlm" else 256)
    batch = _family_batch(cfg, rng, 2, s)
    cons, recorded = _decode_vs_forward(model, params, batch, s)
    check((recorded["flash_attention"]["calls"],
           recorded["paged_attention"]["calls"]) == n_attn,
          f"{arch}: recorded {recorded}, expected {n_attn}")
    row.update(decode_vs_forward_rel=cons, recorded_calls=recorded)
    if cfg.is_attention_free:
        # RWKV-6's 32 random-weight layers amplify rounding: in bf16 its
        # decode after prefill misses CONSISTENCY_TOL at full width, in
        # float32 it agrees with forward within ~2e-5. So the cache path
        # is held in float32 at full width, and the bf16 figure above is
        # reported.
        f32 = LVLM.from_pretrained(arch, seed=0, dtype="float32", **kw)
        cons32, _ = _decode_vs_forward(f32.model, f32.params, batch, s)
        del f32
        check(cons32 <= F32_CONSISTENCY_TOL, f"{arch}: float32 decode "
              f"after prefill vs forward differ by {cons32}")
        row["decode_vs_forward_rel_float32"] = cons32
    else:
        check(cons <= CONSISTENCY_TOL, f"{arch}: decode after prefill vs "
              f"forward differ by {cons} of the logit scale")

    timer = CallTimer(model)
    _reset_counts()
    counts = None
    if cfg.family == "audio":
        # 4 requests of 1500 frames with FAMILY_PROMPT-token prompts and
        # ARCH_NEW new tokens, batched in a Model-level greedy loop
        wb = _family_batch(cfg, rng, 4, FAMILY_PROMPT)
        t0 = time.perf_counter()
        toks = _greedy_loop(model, params, wb, ARCH_NEW,
                            FAMILY_PROMPT + ARCH_NEW)
        torch.cuda.synchronize()
        row["greedy_loop"] = {
            "wall_seconds": time.perf_counter() - t0,
            "calls": dict(timer.calls), "seconds": dict(timer.seconds),
            "launches": _counts()}
        check(toks.shape == (4, ARCH_NEW) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{arch}: greedy loop returned bad tokens")
        counts = _counts()
        pool_len = FAMILY_PROMPT + ARCH_NEW
        pbatch = _family_batch(cfg, rng, 1, FAMILY_PROMPT)
        dpos = torch.full((4,), FAMILY_PROMPT, device="cuda")
        prof_name = "prefill_1500_frames"
    else:
        if cfg.family == "vlm":
            prompts = [rng.integers(0, cfg.vocab_size, PERCEIVER_TEXT
                                    ).tolist() for _ in range(4)]
            ves = [rng.standard_normal((1024, cfg.d_model)).astype(
                np.float32) for _ in range(4)]
        else:
            prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                       for n in ARCH_PROMPTS]
            ves = [None] * 4
        gen = GenerationConfig(max_new_tokens=ARCH_NEW, decoder="greedy")
        t0 = time.perf_counter()
        with _ScanTimer() as scan:
            res = lvlm.generate(prompts, gen, visual_embeds=None
                                if cfg.family != "vlm" else ves)
            torch.cuda.synchronize()
        gen_counts = _counts()
        row["generate"] = {"wall_seconds": time.perf_counter() - t0,
                           "calls": dict(timer.calls),
                           "prefill_wall_seconds": timer.seconds["prefill"],
                           "decode_wall_seconds":
                               timer.seconds["decode_step"],
                           "launches": gen_counts}
        timer_prefills = list(timer.prefills)
        toks_gen = {r.request.rid: r.tokens for r in res}
        check(all(len(t) == ARCH_NEW and all(0 <= x < cfg.vocab_size
                                             for x in t)
                  for t in toks_gen.values()),
              f"{arch}: generate returned bad tokens")
        reqs = _requests(Request, prompts, ves, ARCH_NEW)
        ec = EngineConfig(max_batch=4, cache_len=LVLM._cache_len(reqs, gen),
                          scheduler="continuous")
        timer.reset()
        _reset_counts()
        t0 = time.perf_counter()
        rep = lvlm.serve(reqs, ec, gen)
        torch.cuda.synchronize()
        serve_counts = _counts()
        served = {r.rid: r.generated for r in rep.requests}
        check(len(served) == 4 and all(len(t) == ARCH_NEW
                                       for t in served.values()),
              f"{arch}: the serve did not finish every request")
        row["serve_continuous"] = {
            "wall_seconds": time.perf_counter() - t0,
            "calls": dict(timer.calls), "launches": serve_counts,
            "token_agreement_with_generate": float(np.mean(
                [a == b for r in res for a, b in zip(
                    r.tokens, served[r.request.rid])]))}
        counts = {k: gen_counts[k] + serve_counts[k] for k in gen_counts}
        pool_len = ec.cache_len
        if cfg.family == "vlm":
            pbatch = {"tokens": torch.tensor([prompts[0]], device="cuda"),
                      "visual_embeds": torch.from_numpy(ves[0])[None].cuda()}
            dpos = torch.full((4,), 1024 + PERCEIVER_TEXT, device="cuda")
            prof_name = "prefill_1024_patches"
        else:
            pbatch = {"tokens": torch.tensor([prompts[-1]], device="cuda")}
            dpos = torch.tensor(list(ARCH_PROMPTS), device="cuda")
            prof_name = "prefill_1024"
            # the recurrences' share of each prompt's prefill wall in the
            # generate (a loop of T tokens, or of T / chunk chunks)
            scans = {}
            for n, secs in timer_prefills:
                steps = n // (cls._chunk(torch.empty(1, n))
                              if cfg.family == "hybrid" else 1)
                scans[n] = {
                    "prefill_wall_ms": secs * 1e3,
                    "scan_wall_ms": scan.seconds[steps] * 1e3,
                    "scan_share": scan.seconds[steps] / secs,
                    "scan_calls": scan.calls[steps], "loop_steps": steps}
            row["recurrence_share_of_prefill"] = scans
    check(all(c >= n for c, n in zip(counts.values(), n_attn))
          and (all(counts.values()) or cfg.is_attention_free),
          f"{arch}: launches {counts}")
    pool = model.init_cache(4, pool_len, device="cuda")
    dtoks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    t_prof = time.perf_counter()
    # rwkv6's prefill launches ~1.3e5 kernels: its device activity alone
    prof = _profile_calls({prof_name: (
        lambda: cls.prefill(model, params, pbatch, cache_len=pool_len,
                            last_only=True),
        1 if cfg.is_attention_free else 2)},
        cpu=not cfg.is_attention_free)
    prof.update(_profile_calls({"decode_step_b4": (
        lambda: cls.decode_step(model, params, pool, dtoks, dpos), 5)}))
    for p in prof.values():
        p.pop("by_kernel")
    row["profile"] = prof
    row["profile_seconds"] = time.perf_counter() - t_prof
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    row["launches"] = counts
    return row


def phase_families_full() -> dict:
    """rwkv6-3b (8 of its 32 layers, d 2560), zamba2-1.2b (38 Mamba-2
    layers and 6 calls of the shared block, d 2048), whisper-tiny (4 + 4
    layers, 1500 frames) and qwen2-vl-2b with the perceiver projector
    (1024 patches to 64 latents) at full published width, bf16, random
    weights from seed 0, each freed before the next: decode after an S-1
    prefill against forward at S-1 within CONSISTENCY_TOL of the logit
    scale with every kernel call held against the plain version; 4
    requests (ARCH_PROMPTS text tokens; the perceiver 1024 patches + 32
    text; whisper 1500 frames + 16 tokens in a ``Model``-level loop),
    ARCH_NEW new tokens, through ``generate`` and a continuous ``serve``;
    the recurrences' share of each prompt's prefill wall (rwkv's token
    loop, Mamba-2's chunk scan: chunk 4 at 300 and 700 tokens); wall and
    device-busy ms per 1024-token prefill (1500 frames, 1024 patches) and
    batch-4 decode step; peak device memory. Returns the launches."""
    total = dict.fromkeys(("flash_attention", "paged_attention"), 0)
    for arch, kw in FAMILY_FULL:
        t0 = time.perf_counter()
        row = _family_full_one(arch, kw)
        row["seconds"] = time.perf_counter() - t0
        total = {k: total[k] + row["launches"][k] for k in total}
        emit("families_full", config=_family_label(arch, kw),
             dtype="bfloat16", **row)
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_serve_cli() -> None:
    """``python -m repro_torch.launch.serve --roles prefill:1,decode:1
    --control --open-loop 2000 --requests 8`` on the card, in a
    subprocess, with ``--metrics-out -``: the report (the last JSON
    object of its output) parses with 8 finished requests, and the
    Prometheus text counts more than 0 migrations (the reference CLI's
    report keeps only scalar keys, so the ``disaggregation`` block is
    read there)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve",
           "--roles", "prefill:1,decode:1", "--control", "--open-loop",
           "2000", "--requests", "8", "--metrics-out", "-"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=300, env=dict(
                             os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"serve CLI failed: {res.stderr[-2000:]}")
    text = res.stdout
    report = json.loads(text[text.rfind("\n{") + 1:])
    moved = [ln for ln in text.splitlines()
             if ln.startswith("repro_migrations_total")]
    migrations = int(float(moved[0].split()[-1])) if moved else 0
    emit("serve_cli", seconds=seconds, finished=report.get("finished"),
         migrations=migrations, control_overrides_open=report.get(
             "control_overrides_open"),
         ttft_p95=report.get("ttft_p95"), tpot_p95=report.get("tpot_p95"))
    check(report.get("finished") == 8 and migrations > 0,
          f"serve CLI: {report}, migrations {migrations}")


def _device_ms(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0)) / 1e3


def _kernel_events(prof):
    """Device-side events only (kernels, memcpy/memset): the operator
    events above them carry the same device time again."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and _device_ms(e) > 0]


def phase_profile(lvlm, prompts, ves) -> None:
    """Where the time goes at full width: one prefill of the 1056-token
    visual prompt, of the lengths a 0.5 and a 0.25 keep of its 1024
    visual tokens leave (544 and 288: the dimension-1 saving), and decode
    steps of a 4-slot pool with two long and two short requests, before
    and after the same compressions, under torch.profiler (device time by
    kernel; busy share = device time / wall time)."""
    model, params = lvlm.model, lvlm.params
    cls = type(model)               # bypass the CallTimer wrappers
    batch = {"tokens": torch.tensor([prompts[0]], device="cuda"),
             "visual_embeds": torch.from_numpy(ves[0]).cuda()[None]}

    def prefill(nv):
        b = dict(batch, visual_embeds=batch["visual_embeds"][:, :nv])
        return lambda: cls.prefill(model, params, b, cache_len=1104,
                                   last_only=True)
    n_ctx = len(prompts[0]) + len(ves[0])
    pool = model.init_cache(4, 1104, device="cuda")
    toks = torch.zeros((4, 1), dtype=torch.long, device="cuda")
    pos = torch.tensor([n_ctx, n_ctx + 4, 40, 44], device="cuda")
    pos_compressed = torch.tensor([544, 548, 288, 292], device="cuda")
    runs = {
        "prefill_1056": (prefill(1024), 3),
        "prefill_544": (prefill(512), 3),
        "prefill_288": (prefill(256), 3),
        "decode_step_b4": (lambda: cls.decode_step(model, params, pool, toks,
                                                   pos), 10),
        "decode_step_b4_compressed": (lambda: cls.decode_step(
            model, params, pool, toks, pos_compressed), 10),
    }
    for name, row in _profile_calls(runs).items():
        del row["by_kernel"]
        emit("profile", run=name, **row)


# ------------------------------------------------------------- training --

#: The flash backward's cases (name, shape, flash kwargs), timed in bf16
#: and checked in both dtypes: the training shape (qwen2-vl-2b at batch 4
#: of 1024 visual + 64 text tokens), a window that masks (zamba2's heads),
#: whisper's cross attention (16 decoder tokens over 1500 frames), MLA's
#: prefill at head dim 192 with ``scale=`` and v zero-padded from 128,
#: nemotron-4-340b's 96 q heads over 8 kv heads at head dim 192 (G 12:
#: hi + lo operands), head dim 32, and 48 q heads per kv head.
FLASH_BWD_CASES = (
    ("train", dict(b=4, h=12, kvh=2, sq=1088, sk=1088, d=128), {}),
    ("window", dict(b=1, h=32, kvh=32, sq=1024, sk=1024, d=64),
     dict(window=256)),
    ("cross", dict(b=4, h=6, kvh=6, sq=16, sk=1500, d=64),
     dict(causal=False)),
    ("mla", dict(b=1, h=128, kvh=128, sq=1024, sk=1024, d=192, v_width=128),
     dict(scale=192 ** -0.5)),
    ("nemotron", dict(b=1, h=96, kvh=8, sq=1056, sk=1056, d=192), {}),
    ("d32", dict(b=1, h=8, kvh=2, sq=1056, sk=1056, d=32), {}),
    ("g48", dict(b=1, h=48, kvh=1, sq=1056, sk=1056, d=128), {}),
)
#: the backward's bars: float32 within 1e-4 of the largest gradient (it
#: repeats the plain arithmetic up to summation order); bf16 within 1e-2
#: of the largest gradient, and each element within 3e-2 or one bf16 ulp
#: of its own size (2^-7 |x|), whichever is larger: both round a float32
#: sum to bf16, and a sum near a rounding edge rounds either way (dv of
#: 48 q heads reaches 31.5, where one ulp is 0.125)
BWD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
BWD_ABS_TOL = {torch.float32: float("inf"), torch.bfloat16: 3e-2}
BWD_ULP = 2.0 ** -7
#: the forward's log-sum-exp (float32 in both dtypes) against its plain
#: version on the rows that see a key, relative to max(1, |lse|): both
#: sum the same float32 scores, in another order
LSE_REL_TOL = 1e-4
#: train_smoke: card against CPU losses (float32, 3 steps)
TRAIN_SMOKE_TOL = 1e-4
#: train_full: resumed losses against the uninterrupted run (the
#: reference's resume bar)
TRAIN_RESUME_TOL = 1e-3
TRAIN_FULL_STEPS, TRAIN_CKPT_AT = 10, 5
#: train_full's depth: 14 of qwen2-vl-2b's 28 layers since the sharding
#: phases joined the script (its 15 GB checkpoint's save and load took 60 s
#: of the script's 600 s at full depth)
TRAIN_FULL_LAYERS = 14


def _train_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    return dict(_mla_counts(),
                flash_attention_bwd=fa.flash_attention_bwd.launches)


def _bwd_inputs(rng, c, dtype):
    """q, k, v as the model gives them ([B,S,N,D] tensors seen as
    [B,N,S,D]) and a dense dO; MLA's v and dO have zero columns past v's
    width (the model slices those columns off the output)."""
    b, h, kvh, sq, sk, d = (c[x] for x in ("b", "h", "kvh", "sq", "sk", "d"))
    q = randn(rng, (b, sq, h, d), dtype).transpose(1, 2)
    k = randn(rng, (b, sk, kvh, d), dtype).transpose(1, 2)
    v = randn(rng, (b, sk, kvh, d), dtype).transpose(1, 2)
    do = randn(rng, (b, h, sq, d), dtype)
    if c.get("v_width"):
        v[..., c["v_width"]:] = 0
        do[..., c["v_width"]:] = 0
    return q, k, v, do


def _bwd_visible(c, kw) -> torch.Tensor:
    """[Sq, Sk] mask of a case: True where the query sees the key."""
    from repro_torch.kernels import flash_attention as fa
    causal = kw.get("causal", True)
    kv_len, q_off = fa.resolve_offsets(c["sq"], c["sk"], causal,
                                       kw.get("kv_len"),
                                       kw.get("q_offset", 0))
    qp = torch.arange(c["sq"])[:, None] + q_off
    kp = torch.arange(c["sk"])[None]
    valid = kp < kv_len
    if causal:
        valid = valid & (kp <= qp)
        if kw.get("window"):
            valid = valid & (kp > qp - kw["window"])
    return valid.expand(c["sq"], c["sk"])   # non-causal: every query alike


def phase_kernels_flash_bwd(flush, ptxas) -> dict:
    """The flash backward kernel (``csrc/flash_attention_bwd.cu``) against
    its plain version on the card at every ``FLASH_BWD_CASES`` shape, in
    float32 and bf16, from the forward kernel's own output and
    log-sum-exp; the forward's output with its lse epilogue equals its
    output without (bits), its lse is within LSE_REL_TOL of
    ``flash_attention_lse_plain`` on every row that sees a key (the
    gradients' check reads the kernel's own lse, so it alone would not
    see a wrong one), and every pinned flash shape keeps its bits
    (``FLASH_BITS_SHA``). bf16 times (L2 flushed, graph-replayed) beside
    the bound -- 5 products of 2 D operations a visible pair at the bf16
    peak, or its bytes (q, k, v, o, dO and lse read, dq, dk, dv written
    once) at the HBM rate -- the plain version and the backward alone of
    ``scaled_dot_product_attention(..., enable_gqa=True)`` (a boolean mask
    for the window; its forward + backward less its forward). Each case
    names its route (``bwd_route``: bf16 on ``wgmma`` -- at D 192, MLA's
    and nemotron's cases, the kernels with two consumer warpgroups --
    float32 on FMAs) and, on ``wgmma``, its dK/dV head groups and whether
    it takes hi + lo operands; MLA's dv is exactly 0 in v's padded
    columns; two launches on the same inputs must give the same bits, at
    every case in both dtypes, and the bf16 training and MLA calls'
    device ms by kernel (torch.profiler) are printed. Prints
    ptxas's registers and spills of the backward's instantiations.
    Returns the kernels-line row."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sm_count
    rng = np.random.default_rng(22)
    errs, rows = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, c, kw in FLASH_BWD_CASES:
            q, k, v, do = _bwd_inputs(rng, c, dtype)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            check(torch.equal(o, fa.flash_attention(q, k, v, **kw)),
                  f"flash {name} {dtype}: the lse epilogue changed O")
            visible = _bwd_visible(c, kw)
            seen = visible.any(-1).to(lse.device)
            want_lse = fa.flash_attention_lse_plain(q, k, **kw)
            lse_err = float(((lse - want_lse).abs()
                             / want_lse.abs().clamp(min=1.0))[..., seen].max())
            check(lse_err <= LSE_REL_TOL,
                  f"flash {name} {dtype}: lse off by {lse_err} (relative)")
            got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            e = {"lse_rel": lse_err, "route": fa.bwd_route(dtype, c["d"])}
            if e["route"] == "wgmma":
                g = c["h"] // c["kvh"]
                e["splits"] = fa.bwd_splits(c["b"], c["kvh"], g, c["sk"],
                                            sm_count(q.device), c["d"])
                e["hilo"] = g > fa.BWD_HILO_G
            # a second launch gives the same bits
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            e["deterministic"] = all(torch.equal(x, y)
                                     for x, y in zip(got, again))
            check(e["deterministic"],
                  f"flash bwd {name} {dtype}: two launches differ")
            del again
            for g, w, what in zip(got, want, ("dq", "dk", "dv")):
                scale = float(w.float().abs().max())
                diff = (g.float() - w.float()).abs()
                e[what] = float(diff.max())
                e[what + "_rel"] = e[what] / max(scale, 1e-30)
                e[what + "_over_elementwise_bar"] = int((diff > torch.clamp(
                    w.float().abs() * BWD_ULP,
                    min=BWD_ABS_TOL[dtype])).sum())
                check(e[what + "_over_elementwise_bar"] == 0
                      and e[what + "_rel"] <= BWD_REL_TOL[dtype],
                      f"flash bwd {name} {dtype} {what}: {e}, largest "
                      f"{scale}")
            if c.get("v_width"):   # v's zero columns get exactly 0
                check(not got[2][..., c["v_width"]:].any(),
                      f"flash bwd {name} {dtype}: dv's padded columns")
            errs[f"{name}/{str(dtype)[6:]}"] = e
            if dtype != torch.bfloat16:
                continue
            pairs = int(visible.sum()) * c["b"] * c["h"]
            elt = q.element_size()
            nbytes = elt * 4 * (q.numel() + k.numel()) + 4 * lse.numel()
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            causal = kw.get("causal", True)
            mask = None
            if kw.get("window"):
                qp = torch.arange(c["sq"], device="cuda")[:, None]
                kp = torch.arange(c["sk"], device="cuda")[None]
                mask = (kp <= qp) & (kp > qp - kw["window"])

            def sdpa():
                return F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask,
                    is_causal=causal and mask is None,
                    scale=kw.get("scale"), enable_gqa=True)
            # the library's backward alone: its forward + backward (one
            # graph: autograd replays on the forward's stream) less its
            # forward
            row = _kernel_row(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                     **kw),
                lambda: torch.autograd.grad(sdpa(), leaves, do),
                flush, nbytes, 5 * 2 * c["d"] * pairs, dtype,
                max(e[x] for x in ("dq", "dk", "dv")))
            row["library_fwd_ms"] = time_ms(sdpa, flush)
            row["library_ms"] -= row["library_fwd_ms"]
            if name in ("train", "mla"):   # where the backward's time goes
                row["kernels_ms"] = _profile_calls({"bwd": (
                    lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                    5)}, cpu=False)["bwd"]["by_kernel"]
            rows[name] = dict(shape=c, **kw, **row, pairs=pairs,
                              route=e["route"])
            del leaves
    bits = flash_bits()
    same = {k_: v_ == FLASH_BITS_SHA.get(k_) for k_, v_ in bits.items()}
    main = rows["train"]
    emit("kernels_flash_bwd", errors=errs, rows=rows,
         tolerance={"lse_rel": LSE_REL_TOL,
                    "float32_rel": BWD_REL_TOL[torch.float32],
                    "bfloat16_rel": BWD_REL_TOL[torch.bfloat16],
                    "bfloat16_elementwise": f"max({BWD_ABS_TOL[torch.bfloat16]}"
                                            f", 2^-7 |x|)"},
         ptxas=ptxas, flash_bits_unchanged=all(same.values()))
    check(all(same.values()) and len(same) == len(FLASH_BITS_SHA),
          f"flash output bits changed: {[k_ for k_, v_ in same.items() if not v_]}")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:76",
            **{k_: main[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
            "shapes": {n: {k_: r[k_] for k_ in ("route", "ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "library_ms", "max_abs_err")}
                       for n, r in rows.items()}}


def bwd_split_sweep() -> None:
    """``python3 chip_smoke.py --bwd-split-sweep``, a measurement outside
    the standing check: the flash backward's head-dim-192 cases of
    FLASH_BWD_CASES (bf16: MLA's and nemotron's) at every count of q-head
    groups a kv head (the divisors of G) beside the wrapper's choice
    (``bwd_splits``), each held to the bf16 bar of 1e-2 of the largest
    gradient before it is timed. Prints the env line and one JSON line
    a case."""
    from repro_torch.kernels import build, sm_count
    from repro_torch.kernels import flash_attention as fa
    phase_env()
    build.build_all(["flash_attention", "flash_attention_bwd"])
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(22)
    choose = fa.bwd_splits
    for name, c, kw in FLASH_BWD_CASES:
        if c["d"] != 192:
            continue
        q, k, v, do = _bwd_inputs(rng, c, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        g = c["h"] // c["kvh"]
        ms = {}
        try:
            for n in (n for n in range(1, g + 1) if g % n == 0):
                fa.bwd_splits = lambda *_, n=n: n
                got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                for x, w in zip(got, want):
                    rel = max_err(x, w) / float(w.float().abs().max())
                    check(rel <= BWD_REL_TOL[torch.bfloat16],
                          f"bwd sweep {name} splits {n}: {rel}")
                ms[n] = time_ms(lambda: fa.flash_attention_bwd(
                    q, k, v, o, lse, do, **kw), flush)
        finally:
            fa.bwd_splits = choose
        emit("bwd_split_sweep", case=name, shape=c, ms_by_splits=ms,
             chosen=choose(c["b"], c["kvh"], g, c["sk"], sm_count(q.device),
                           c["d"]))


def flash_fwd_compare() -> None:
    """``python3 chip_smoke.py --flash-fwd-compare``, a measurement outside
    the standing check that times whatever tree it sits in (copied into
    an older checkout, it times that checkout's kernel, so two versions
    can be compared on one host): the bf16 flash forward at the shapes
    the kernel table keeps -- qwen2-vl's 1056-token prefill (D 128), head
    dim 32, 48 q heads a kv head, nemotron's head dim 192 (96 / 8 heads)
    and MLA's prefill (128 heads, 1024 tokens, scale 1/sqrt(192)) with v
    zero-padded to 192 and, where the wrapper takes it
    (``HEAD_DIM_PAIRS``), at its own 128 -- each within TOL of the plain
    version, timed beside its bound, the plain version and SDPA; then
    whether every FLASH_BITS_SHA case keeps its bits. Prints the env line
    and one JSON line a case."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    phase_env()
    t0 = time.perf_counter()
    log = build.build_all(["flash_attention"])["flash_attention"]["log"]
    emit("flash_fwd_compare_build", seconds=time.perf_counter() - t0,
         warnings=[ln.strip() for ln in log.splitlines()
                   if "warning" in ln.lower()],
         flash_wide=_flash_wide(log) if hasattr(fa, "HEAD_DIM_PAIRS")
         else None)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(27)
    dtype = torch.bfloat16
    gqa = {"main_d128": dict(h=12, kvh=2, d=128),
           "d32": dict(h=8, kvh=2, d=32),
           "g48": dict(h=48, kvh=1, d=128),
           "nemotron_d192": dict(h=96, kvh=8, d=192)}
    for name, c in gqa.items():
        c = dict(b=1, sq=1056, sk=1056, **c)
        q, k, v = _flash_inputs(rng, c, dtype)
        e = max_err(fa.flash_attention(q, k, v),
                    fa.flash_attention_plain(q, k, v))
        check(e <= TOL[dtype], f"flash {name}: err {e}")
        emit("flash_fwd_compare", case=name, shape=c, **_kernel_row(
            lambda: fa.flash_attention(q, k, v),
            lambda: fa.flash_attention_plain(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True),
            flush, q.element_size() * (2 * q.numel() + k.numel()
                                       + v.numel()),
            4 * c["d"] * c["h"] * 1056 * 1057 / 2, dtype, e))
    h, s, dqk, dv = 128, 1024, 192, 128
    scale = 1.0 / dqk ** 0.5
    q, k = (randn(rng, (1, s, h, dqk), dtype).transpose(1, 2)
            for _ in range(2))
    v = randn(rng, (1, s, h, dv), dtype).transpose(1, 2)
    variants = {"mla_prefill_padded_v": F.pad(v, (0, dqk - dv))}
    if hasattr(fa, "HEAD_DIM_PAIRS"):
        variants["mla_prefill"] = v
    want = fa.flash_attention_plain(q, k, variants["mla_prefill_padded_v"],
                                    scale=scale)[..., :dv]
    for name, vx in variants.items():
        got = fa.flash_attention(q, k, vx, scale=scale)[..., :dv]
        e = max_err(got, want)
        check(e <= TOL[dtype], f"flash {name}: err {e}")
        emit("flash_fwd_compare", case=name,
             shape=dict(b=1, h=h, kvh=h, sq=s, sk=s, d_qk=dqk,
                        d_v=vx.shape[-1]), **_kernel_row(
                 lambda vx=vx: fa.flash_attention(q, k, vx, scale=scale),
                 lambda vx=vx: fa.flash_attention_plain(q, k, vx,
                                                        scale=scale),
                 lambda: F.scaled_dot_product_attention(
                     q, k, v, is_causal=True, scale=scale),
                 flush, q.element_size() * (2 * h * s * dqk + 2 * h * s * dv),
                 2 * h * s * (s + 1) / 2 * (dqk + dv), dtype, e))
    bits = flash_bits()
    emit("flash_fwd_compare_bits", cases=len(bits),
         changed=[k for k, x in bits.items() if x != FLASH_BITS_SHA.get(k)])


def _smoke_train(model, ckpt, device, num_steps=3):
    from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                      train_loop)
    seq = 80 if model.cfg.family == "hybrid" else 32   # past zamba2's window
    return train_loop(
        model, oc=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                  total_steps=num_steps),
        dc=SyntheticDataConfig(batch=2, seq_len=seq), num_steps=num_steps,
        ckpt_dir=ckpt, resume=True, log_every=0, device=device)


def phase_train_smoke() -> dict:
    """Every smoke arch (float32) trains 3 steps through ``train_loop`` on
    the card and on the CPU, both resuming from one checkpoint of the CPU
    init at step 0 (the devices' generators draw different weights):
    losses within TRAIN_SMOKE_TOL relative; the flash forward and backward
    launched for every arch with attention and not for rwkv6, the paged
    and latent kernels never (training does not decode). Returns the card
    runs' launches."""
    import tempfile
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models import build
    from repro_torch.training import adamw_init, save_checkpoint
    total = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                           "paged_attention", "mla_attention"), 0)
    rows = {}
    for arch in ARCHS:
        t0 = time.perf_counter()
        model = build(get_config(arch, smoke=True))
        params = model.init(0, "cpu")
        with tempfile.TemporaryDirectory() as d:
            save_checkpoint(d, {"params": params,
                                "opt_state": adamw_init(params)}, 0)
            _reset_counts()
            card = _smoke_train(model, d, "cuda")
            torch.cuda.synchronize()
            counts = _train_counts()
            cpu = _smoke_train(model, d, "cpu")
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["loss_curve"],
                                                      cpu["loss_curve"]))
        rows[arch] = dict(card=card["loss_curve"], cpu=cpu["loss_curve"],
                          rel_err=rel, launches=counts,
                          seconds=time.perf_counter() - t0)
        attn = not model.cfg.is_attention_free
        check(rel <= TRAIN_SMOKE_TOL, f"{arch} train card vs CPU: {rows[arch]}")
        check((counts["flash_attention"] > 0) == attn
              and (counts["flash_attention_bwd"] > 0) == attn
              and counts["paged_attention"] == 0
              and counts["mla_attention"] == 0,
              f"{arch} train launches {counts}")
        total = {k: total[k] + counts[k] for k in total}
        del card, cpu, params
    emit("train_smoke", tolerance=TRAIN_SMOKE_TOL, steps=3, archs=rows)
    return total


def _profiled_train_step(model, oc, cfg, dc, step, state) -> tuple:
    """One train step from ``state`` ([params, opt_state]) on step
    ``step``'s batch under torch.profiler (after a warm-up step):
    (the profile row, flash forward ms, flash backward ms a step)."""
    from repro_torch.training import make_train_step
    from repro_torch.training.data import make_batch
    from repro_torch.training.loop import _batch_to
    step_fn = make_train_step(model, oc)
    batch = _batch_to(make_batch(cfg, dc, step), "cuda")

    def one():
        state[0], state[1], m = step_fn(state[0], state[1], batch)
        float(m["loss"])
    prof = _profile_calls({"train_step": (one, 1)})["train_step"]
    by = prof.pop("by_kernel")
    fwd_ms = sum(v for k, v in by.items() if "flash_fwd_" in k)
    bwd_ms = sum(v for k, v in by.items() if "flash_bwd_" in k)
    return prof, fwd_ms, bwd_ms


#: train_mla_full: deepseek-v3-671b at its published width cut to its
#: ``first_k_dense_layers`` (3 dense layers, no MoE layer), 3 steps of
#: 2 x 1024 text tokens; its peak must stay below this many GiB. Its
#: learning rate is a tenth of train_full's: step 0 warms up at lr 0, so
#: the last loss follows one AdamW step, which moves every weight by about
#: lr, and at d_model 7168 lr 1e-3 overshot (losses 12.51, 10.87, 22.11
#: on the H100)
TRAIN_MLA_STEPS, TRAIN_MLA_PEAK_GIB, TRAIN_MLA_LR = 3, 75.0, 1e-4


def phase_train_mla_full() -> dict:
    """deepseek-v3-671b at full published width (d 7168, 128 heads, MLA
    with q/k 192 and v 128 wide, vocab 129280), cut to its 3 dense layers
    (3.604 B params): bf16 params, float32 moments, remat on, batch 2 x
    1024 text tokens, seed 0, lr TRAIN_MLA_LR, TRAIN_MLA_STEPS steps
    through ``train_loop`` and one profiled step. MLA's naive form runs
    flash at head dim 192 with ``scale=`` and v zero-padded from 128, so
    every layer's gradient takes the flash backward at D 192. Every loss
    finite (the loop raises otherwise), the last below the first; 2
    forward and 1 backward flash launch a layer a step, no paged or
    latent launch; peak below TRAIN_MLA_PEAK_GIB. Reports wall ms a
    step, device-busy
    ms, idle share, the flash backward's ms a step, its share of busy
    time and its route, tokens/s, peak GiB and the analytic MFU. Returns
    the launches."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build
    from repro_torch.roofline.analytic import flops_estimate
    from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                      train_loop)
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("deepseek-v3-671b")
    cfg = cfg.with_(num_layers=cfg.first_k_dense_layers)
    model = build(cfg)
    dc = SyntheticDataConfig(batch=2, seq_len=1024)
    oc = OptimizerConfig(lr=TRAIN_MLA_LR, warmup_steps=1,
                         total_steps=TRAIN_MLA_STEPS)
    tokens = dc.batch * dc.seq_len
    stamps = []

    def log(line):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    a = train_loop(model, oc=oc, dc=dc, num_steps=TRAIN_MLA_STEPS,
                   log_every=1, log_fn=log, device="cuda")
    torch.cuda.synchronize()
    launches = _train_counts()
    steps_ms = [(b - a_) * 1e3 for a_, b in zip([t0] + stamps, stamps)]
    step_ms = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    layers = cfg.num_layers
    curve = a["loss_curve"]
    prof, fwd_ms, bwd_ms = _profiled_train_step(
        model, oc, cfg, dc, TRAIN_MLA_STEPS, [a["params"], a["opt_state"]])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del a
    gc.collect()
    torch.cuda.empty_cache()
    flops = flops_estimate(cfg, ShapeConfig("train_mla_full", dc.seq_len,
                                            dc.batch, "train"))
    head_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    row = dict(config="deepseek-v3-671b", dtype="bfloat16", remat=True,
               params=cfg.param_count(), layers=layers,
               batch=f"{dc.batch} x {dc.seq_len} text", losses=curve,
               step_wall_ms=steps_ms, step_ms=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, profiled_step=prof,
               flash_fwd_ms_per_step=fwd_ms, flash_bwd_ms_per_step=bwd_ms,
               flash_bwd_share_of_busy=bwd_ms / prof[
                   "device_busy_ms_per_call"],
               flash_head_dim=head_dim,
               flash_bwd_route=fa.bwd_route(torch.bfloat16, head_dim),
               peak_gib=peak, analytic_flops=flops,
               mfu=flops / (step_ms / 1e3 * H100_SXM.peak_flops_bf16),
               seconds=time.perf_counter() - t0, launches=launches)
    emit("train_mla_full", **row)
    check(launches == {"flash_attention": 2 * layers * TRAIN_MLA_STEPS,
                       "flash_attention_bwd": layers * TRAIN_MLA_STEPS,
                       "paged_attention": 0, "mla_attention": 0},
          f"train_mla_full launches {launches}")
    check(curve[-1] < curve[0], f"train_mla_full loss did not fall: {curve}")
    check(peak < TRAIN_MLA_PEAK_GIB, f"train_mla_full peak {peak} GiB")
    return launches


def _train_cli() -> dict:
    """``python -m repro_torch.launch.train --arch phi4-mini-3.8b --smoke
    --steps 14 --vocab 128`` on the card (no ``--device``), in a
    subprocess: exit 0, the ``done:`` line, the loss falls."""
    import re
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "phi4-mini-3.8b", "--smoke", "--steps", "14", "--vocab", "128"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                         timeout=300, env=dict(
                             os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    done = re.search(r"^done: loss (\S+) -> (\S+) in 14 steps", res.stdout,
                     re.M)
    check(res.returncode == 0 and done is not None
          and float(done.group(2)) < float(done.group(1)),
          f"train CLI failed: {res.stdout[-1000:]} {res.stderr[-2000:]}")
    return {"seconds": time.perf_counter() - t0, "done": done.group(0)}


def phase_train_full() -> dict:
    """qwen2-vl-2b at full published width (d 1536, vocab 151936), cut to
    TRAIN_FULL_LAYERS of its 28 layers: bf16 params, float32 moments,
    remat on, batch 4
    of 1024 visual + 64 text tokens (``SyntheticDataConfig(batch=4,
    seq_len=64)``), through ``train_loop``: (A) TRAIN_FULL_STEPS steps
    uninterrupted, (B) TRAIN_CKPT_AT steps, then ``save_checkpoint`` of
    its params and moments (one write; the loop's own cadence would
    write it twice), (C) a resume from it to TRAIN_FULL_STEPS. Every loss finite (the loop
    raises otherwise), the last below the first, C within
    TRAIN_RESUME_TOL of A's; 2 forward and 1 backward flash launch a
    layer a step (remat runs each layer's forward twice), no paged or
    latent launch. Reports wall ms a step, device-busy ms, idle share and
    the flash forward / backward ms of one profiled step, tokens/s, peak
    GiB and the analytic MFU (``roofline.analytic`` step FLOPs over the
    step's wall at the bf16 peak); then the training CLI on the card.
    Returns run A's launches."""
    import tempfile
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build
    from repro_torch.roofline.analytic import flops_estimate
    from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                      save_checkpoint, train_loop)
    from repro_torch.kernels import flash_attention as fa
    cfg = get_config("qwen2-vl-2b").with_(num_layers=TRAIN_FULL_LAYERS)
    model = build(cfg)
    dc = SyntheticDataConfig(batch=4, seq_len=64)
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1,
                         total_steps=TRAIN_FULL_STEPS)
    tokens = dc.batch * (cfg.num_visual_tokens + dc.seq_len)
    stamps = []

    def log(line):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    a = train_loop(model, oc=oc, dc=dc, num_steps=TRAIN_FULL_STEPS,
                   log_every=1, log_fn=log, device="cuda")
    torch.cuda.synchronize()
    launches = _train_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_ms = [(b - a_) * 1e3 for a_, b in zip([t0] + stamps, stamps)]
    # steps 2.. as one window (the first builds and warms up): a stall in
    # any step counts
    step_ms = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    layers = cfg.num_layers
    check(launches == {"flash_attention": 2 * layers * TRAIN_FULL_STEPS,
                       "flash_attention_bwd": layers * TRAIN_FULL_STEPS,
                       "paged_attention": 0, "mla_attention": 0},
          f"train_full launches {launches}")
    a_curve = a["loss_curve"]
    check(a_curve[-1] < a_curve[0], f"train_full loss did not fall: {a_curve}")

    # one profiled step (after a warm-up step) from run A's state
    state = [a["params"], a["opt_state"]]
    del a
    prof, fwd_ms, bwd_ms = _profiled_train_step(model, oc, cfg, dc,
                                                TRAIN_FULL_STEPS, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as d:
        b = train_loop(model, oc=oc, dc=dc, num_steps=TRAIN_CKPT_AT,
                       log_every=0, device="cuda")
        b_curve = b["loss_curve"]
        t1 = time.perf_counter()
        save_checkpoint(d, {"params": b["params"],
                            "opt_state": b["opt_state"]}, TRAIN_CKPT_AT)
        b_s = time.perf_counter() - t1
        del b
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        c_curve = train_loop(model, oc=oc, dc=dc, num_steps=TRAIN_FULL_STEPS,
                             ckpt_dir=d, resume=True, log_every=0,
                             device="cuda")["loss_curve"]
        c_s = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    resume_err = max(abs(x - y) / abs(y) for x, y in
                     zip(c_curve, a_curve[TRAIN_CKPT_AT:]))
    flops = flops_estimate(cfg, ShapeConfig("train_full", tokens // dc.batch,
                                            dc.batch, "train"))
    row = dict(config="qwen2-vl-2b", dtype="bfloat16", remat=True,
               params=cfg.param_count(), layers=layers,
               batch=f"{dc.batch} x ({cfg.num_visual_tokens} visual + "
                     f"{dc.seq_len} text)",
               losses=a_curve, losses_to_ckpt=b_curve, losses_resumed=c_curve,
               resume_rel_err=resume_err, step_wall_ms=steps_ms,
               step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               profiled_step=prof, flash_fwd_ms_per_step=fwd_ms,
               flash_bwd_ms_per_step=bwd_ms,
               flash_bwd_share_of_busy=bwd_ms / prof[
                   "device_busy_ms_per_call"],
               flash_bwd_route=fa.bwd_route(torch.bfloat16, cfg.head_dim),
               peak_gib=peak,
               analytic_flops=flops,
               mfu=flops / (step_ms / 1e3 * H100_SXM.peak_flops_bf16),
               ckpt_save_s=b_s, resume_run_s=c_s, launches=launches,
               cli=_train_cli())
    emit("train_full", **row)
    check(len(c_curve) == TRAIN_FULL_STEPS - TRAIN_CKPT_AT
          and resume_err <= TRAIN_RESUME_TOL,
          f"train_full resume: {c_curve} vs {a_curve[TRAIN_CKPT_AT:]}")
    return launches


#: sharded_steps: qwen2-vl-2b's four step kinds at their sequence lengths,
#: the global batch cut to what one card holds
SHARDED_ARCH = "qwen2-vl-2b"
SHARDED_CUTS = {"train_4k": dict(global_batch=2),
                "prefill_32k": dict(global_batch=1),
                "decode_32k": dict(global_batch=16),
                "long_500k": {}}
#: the reference's sharded bar (tests/test_sharded_exec.py): the mesh run
#: within 1e-3 of the single-device run's logit (loss) scale
SHARDED_TOL = 1e-3


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_tree(v, fn) for v in t)
    return fn(t)


def _step_out(spec, out):
    """A step's logits (prefill, decode) or loss (train), as a plain
    tensor."""
    t = out[2] if spec.name.endswith("/train") else out[0]
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def phase_sharded_steps() -> dict:
    """``launch.steps``' train / prefill / serve steps of qwen2-vl-2b at full
    published width and depth (28 layers, d 1536, 12 / 2 heads of 128,
    vocab 151936), bf16, inputs from seed 0 (``steps.materialize``), built
    by ``build_step`` on the 1x1 ("data", "model") mesh over this card
    (``make_host_mesh``: nccl): params, batch and cache DTensors, every
    kernel call under ``local_map``. Shapes at their sequence lengths, the
    batch cut (SHARDED_CUTS). Each step's logits (loss) against the same
    step on plain tensors without a mesh within SHARDED_TOL of their
    scale, and whether the bits are equal. Flash forward, flash backward
    and paged must launch (counts reset just before each mesh run). Per
    step: wall ms, device-busy ms and idle share (profiler), the port's
    three-term roofline of the executed shape (``step_cost.step_flops``
    on meta, the inputs' bytes or the analytic traffic, collectives 0 on
    one device), its dominant term, ``roofline_frac`` (roofline ms / busy
    ms) and ``mfu`` (model FLOPs / (wall s x 989e12))."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_step, distribute_args,
                                          materialize, run_step)
    from repro_torch.roofline.analysis import (model_flops_estimate,
                                               roofline_from_costs)
    from repro_torch.roofline.analytic import bytes_estimate
    from repro_torch.roofline.step_cost import step_flops, step_memory
    mesh = make_host_mesh("cuda")
    total = dict.fromkeys(_train_counts(), 0)
    rows = {}
    for shape, cut in SHARDED_CUTS.items():
        gc.collect()
        torch.cuda.empty_cache()
        spec = build_step(SHARDED_ARCH, shape, mesh, **cut)
        args = materialize(spec, 0, "cuda")
        want = _step_out(spec, spec.step(*_tree(args, torch.clone))
                         ).float().cpu()
        dargs = distribute_args(spec, args)
        del args
        _reset_counts()
        got = _step_out(spec, run_step(spec, dargs)).float().cpu()
        torch.cuda.synchronize()
        counts = _train_counts()
        for k in total:
            total[k] += counts[k]
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max()) / scale
        check(err <= SHARDED_TOL, f"sharded_steps {shape}: {err} of scale")
        prof = _profile_calls({shape: (lambda: _step_out(
            spec, run_step(spec, dargs)).float().sum().item(), 1)})[shape]
        prof.pop("by_kernel")
        mem = step_memory(spec)
        costs = {"flops": step_flops(spec),
                 "bytes_accessed": float(mem["argument_bytes"]),
                 "collective_bytes": 0.0}
        mf = model_flops_estimate(spec.model_cfg, spec.shape_cfg)
        rep = roofline_from_costs(
            spec.name, costs, chips=1, model_flops=mf,
            analytic_bytes=bytes_estimate(spec.model_cfg, spec.shape_cfg))
        roof_ms = max(rep.compute_s, rep.memory_s, rep.collective_s) * 1e3
        busy = prof["device_busy_ms_per_call"]
        wall = prof["wall_ms_per_call"]
        sc = spec.shape_cfg
        rows[shape] = dict(
            step=spec.name.split("/")[-1], batch=sc.global_batch,
            seq_len=sc.seq_len, launches=counts, err_of_scale=err,
            bits_equal=bool(torch.equal(got, want)), wall_ms=wall,
            busy_ms=busy, idle_share=prof["idle_share"],
            flops=rep.flops, bytes=rep.bytes_accessed,
            compute_ms=rep.compute_s * 1e3, memory_ms=rep.memory_s * 1e3,
            collective_ms=rep.collective_s * 1e3, dominant=rep.dominant,
            roofline_ms=roof_ms, roofline_frac=roof_ms / busy,
            model_flops=mf, mfu=mf / (wall / 1e3 * H100_SXM.peak_flops_bf16),
            top_kernels=prof["top_kernels"][:4])
        del dargs, spec
    emit("sharded_steps", arch=SHARDED_ARCH, mesh="1x1 (data, model), nccl",
         steps=rows, launches=total)
    for k in ("flash_attention", "flash_attention_bwd", "paged_attention"):
        check(total[k] > 0, f"sharded_steps: {k} was not launched")
    return total


def start_dryrun(tmp: str):
    """``python -m repro_torch.launch.dryrun --arch qwen2-vl-2b
    --both-meshes --out <tmp>/dryrun.json`` in a subprocess (the host's
    CPU only: the production meshes hold meta stand-ins), started before
    the training and sharding phases so it runs beside them, on one
    thread; ``phase_dryrun_main`` joins it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         SHARDED_ARCH, "--both-meshes", "--out",
         os.path.join(tmp, "dryrun.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def phase_dryrun_main(proc, tmp: str) -> None:
    """The dry run of qwen2-vl-2b on the (16, 16) and (2, 16, 16)
    production meshes: the subprocess must exit 0 with all 8 pairs ``ok``.
    Per pair: the per-device bytes of the step's inputs (params, moments,
    cache, batch), whether they fit the card's 80 GB, the three roofline
    terms on the H100 and the dominant one."""
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0,
          f"dryrun_main exited {proc.returncode}: {out[-3000:]}")
    pairs = {}
    for tag in ("singlepod", "multipod"):
        with open(os.path.join(tmp, f"dryrun_{tag}.json")) as f:
            res = json.load(f)
        for key, r in res.items():
            check(r["status"] == "ok", f"dryrun_main {tag} {key}: {r}")
            rf = r["roofline"]
            arg = r["memory"]["argument_bytes"]
            pairs[f"{tag}|{key}"] = dict(
                argument_bytes=arg, fits_80gb=arg <= H100_SXM.hbm_bytes,
                compute_ms=rf["compute_s"] * 1e3,
                memory_ms=rf["memory_s"] * 1e3,
                collective_ms=rf["collective_s"] * 1e3,
                dominant=rf["dominant"],
                collective_counts=rf["collective_counts"])
    check(len(pairs) == 8, f"dryrun_main: {len(pairs)} pairs, not 8")
    emit("dryrun_main", arch=SHARDED_ARCH, pairs=pairs,
         log_tail=out.strip().splitlines()[-2:])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:] == ["--mla-split-sweep"]:
        mla_split_sweep()
        return 0
    if sys.argv[1:] == ["--bwd-split-sweep"]:
        bwd_split_sweep()
        return 0
    if sys.argv[1:] == ["--flash-fwd-compare"]:
        flash_fwd_compare()
        return 0
    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")
    t_start = time.perf_counter()
    env = phase_env()
    built = phase_build()
    phase_analysis()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernels = phase_kernels(flush)
    kernels["flash_attention_bwd"] = phase_kernels_flash_bwd(
        flush, _ptxas_report(built["flash_attention_bwd"]["log"]))
    del flush
    phase_main_path_smoke()
    launches, full, timer = phase_main_path_full()
    phase_compressors()
    comp_launches = phase_compression_serve(full[0], timer)
    phase_compression_smoke()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    phase_paged_masked(flush)
    verify = phase_paged_verify(flush)
    d32 = phase_kernels_d32(flush)
    verify_long = phase_paged_verify_long(flush)
    new_shapes = phase_kernels_new_shapes(flush)
    mla_rows = phase_mla_kernels(flush)
    families = phase_kernels_families(flush)
    del flush
    kv_launches = phase_kv_compaction_serve(full[0])
    prefix_launches = phase_prefix_cache_serve(full[0])
    phase_kv_cache_smoke()
    spec_launches = phase_spec_serve(full[0])
    ee_launches = phase_early_exit_serve(full[0], timer)
    phase_decoding_smoke()
    phi4_launches = phase_phi4_smoke()
    arch_smoke_launches = phase_arch_smoke()
    async_launches = phase_async_serve(full[0])
    cluster_smoke_launches = phase_cluster_smoke()
    cluster_launches = phase_cluster_serve(full[0])
    phase_serve_cli()
    phase_profile(*full)
    arch_full_launches = phase_arch_full()
    mla_smoke_launches = phase_mla_smoke()
    mla_full_launches = phase_mla_full()
    fam_smoke_launches = phase_families_smoke()
    fam_full_launches = phase_families_full()
    train_smoke_launches = phase_train_smoke()
    train_mla_launches = phase_train_mla_full()
    dry_tmp = tempfile.mkdtemp()
    dry = start_dryrun(dry_tmp)
    train_full_launches = phase_train_full()
    sharded_launches = phase_sharded_steps()
    phase_dryrun_main(dry, dry_tmp)
    shutil.rmtree(dry_tmp, ignore_errors=True)
    launches = {k: launches[k] + comp_launches[k] + kv_launches[k]
                + prefix_launches[k] + spec_launches[k] + ee_launches[k]
                + phi4_launches[k] + async_launches[k]
                + cluster_smoke_launches[k] + cluster_launches[k]
                + arch_smoke_launches[k] + arch_full_launches[k]
                + mla_smoke_launches[k] + mla_full_launches[k]
                + fam_smoke_launches[k] + fam_full_launches[k]
                + train_smoke_launches[k] + train_mla_launches[k]
                + train_full_launches[k] + sharded_launches[k]
                for k in launches}
    # the flash backward runs on the training path only
    launches["flash_attention_bwd"] = \
        train_smoke_launches["flash_attention_bwd"] \
        + train_mla_launches["flash_attention_bwd"] \
        + train_full_launches["flash_attention_bwd"] \
        + sharded_launches["flash_attention_bwd"]
    # the latent kernel runs on the MLA path only
    launches["mla_attention"] = mla_smoke_launches["mla_attention"] \
        + mla_full_launches["mla_attention"]
    kernels["mla_attention"] = mla_rows["mla_attention"]
    kernels["flash_attention"]["mla_prefill"] = mla_rows["flash_mla_prefill"]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = n
    kernels["paged_attention"]["multi_query"] = verify
    kernels["paged_attention"]["long_verify"] = verify_long
    for name, row in d32.items():
        kernels[name]["head_dim_32"] = row
    for shape, rows in new_shapes.items():
        kernels["flash_attention"][shape] = {
            k: v for k, v in rows.items() if k.startswith("flash")}
        kernels["paged_attention"][shape] = {
            k: v for k, v in rows.items() if k.startswith("paged")}
    # the families' cases: (a)-(c) flash, (d)-(f) paged
    kernels["flash_attention"]["families"] = {
        k: v for k, v in families.items() if k[0] in "abc"}
    kernels["paged_attention"]["families"] = {
        k: v for k, v in families.items() if k[0] in "def"}
    emit("done", seconds=time.perf_counter() - t_start)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("head_dim_32", "multi_query", "long_verify", "head_dim_192",
             "group_48", "mla_prefill", "families", "bound_split_ms",
             "bound_f32_ms", "n_split", "shapes")
    print(env["smi"])
    print(json.dumps({"kernels": [
        {k: kv[k] for k in keys + tuple(x for x in extra if x in kv)}
        for kv in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
