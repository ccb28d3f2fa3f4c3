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
block-allocated paged pool card against CPU on the smoke config. Each
phase prints one JSON line; the last two lines are the kernel summary
and ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero before that line. Needs one CUDA device of
compute capability 9.0.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_build() -> None:
    """Build both kernels from the checkout's sources (one nvcc each, in
    parallel); print ptxas's registers and spills, each kernel's dynamic
    shared memory and the count of HGMMA (wgmma) instructions in the flash
    library's SASS, which must not be 0."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build_all()
    seconds = time.perf_counter() - t0
    smem = {}
    for name in build.KERNELS:
        fn = getattr(build.load(name), f"{name}_smem_bytes")
        smem[name] = {f"{dt}/d{d}": fn(code, d)
                      for dt, code in (("float32", 0), ("bfloat16", 1))
                      for d in (64, 128)}
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    emit("build", seconds=seconds, flash_sass_hgmma=hgmma,
         kernels={k: {"seconds": v["seconds"], "cached": v["cached"],
                      "dynamic_smem_bytes": smem[k],
                      "ptxas": _ptxas_report(v["log"]),
                      "warnings": [ln.strip() for ln in v["log"].splitlines()
                                   if "warning" in ln.lower()
                                   or "Performance Loss" in ln]}
                  for k, v in res.items()})
    check(hgmma > 0, "the flash library's SASS has no HGMMA instruction")


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
    from repro_torch.kernels import paged_attention as pa
    fa.flash_attention.launches = 0
    pa.paged_attention.launches = 0


def _counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return {"flash_attention": fa.flash_attention.launches,
            "paged_attention": pa.paged_attention.launches}


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
    REL_TOL by 4x. S = 1 must give the one-query kernel's bits; S = 9,
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
    q9 = torch.zeros((8, 9) + args[0].shape[2:], dtype=torch.bfloat16,
                     device="cuda")
    bad = {"s9": ((q9,) + args[1:], dict(q_pos=torch.zeros(
               (8, 9), dtype=torch.int32, device="cuda"))),
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


def _profile_calls(runs: dict) -> dict:
    """Device busy and wall ms per call of each ``(fn, n)`` under
    torch.profiler (device-side events only), after one warm-up call:
    idle share (1 - busy / wall), the largest kernels, the port's kernels'
    device ms per launch (comparable across the kernels phase's timing
    methods) and device ms per call of every kernel (``by_kernel``)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, (fn, n) in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
                         for k in ("flash_fwd_kernel", "paged_split_kernel",
                                   "paged_mma_kernel", "paged_combine_kernel")
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
    token: the last position of a prefill of prompt + stream[:-1]."""
    logits, _ = lvlm.model.prefill(
        lvlm.params, {"tokens": torch.tensor([list(prompt) + stream[:-1]],
                                             device="cuda"),
                      "visual_embeds": torch.from_numpy(ve).cuda()[None]},
        last_only=True)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    t_start = time.perf_counter()
    env = phase_env()
    phase_build()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernels = phase_kernels(flush)
    del flush
    phase_main_path_smoke()
    launches, full, timer = phase_main_path_full()
    phase_compressors()
    comp_launches = phase_compression_serve(full[0], timer)
    phase_compression_smoke()
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    phase_paged_masked(flush)
    verify = phase_paged_verify(flush)
    del flush
    kv_launches = phase_kv_compaction_serve(full[0])
    prefix_launches = phase_prefix_cache_serve(full[0])
    phase_kv_cache_smoke()
    spec_launches = phase_spec_serve(full[0])
    ee_launches = phase_early_exit_serve(full[0], timer)
    phase_decoding_smoke()
    phase_profile(*full)
    launches = {k: launches[k] + comp_launches[k] + kv_launches[k]
                + prefix_launches[k] + spec_launches[k] + ee_launches[k]
                for k in launches}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = n
    kernels["paged_attention"]["multi_query"] = verify
    emit("done", seconds=time.perf_counter() - t_start)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(env["smi"])
    print(json.dumps({"kernels": [
        {k: kv[k] for k in keys + (("multi_query",) if "multi_query" in kv
                                   else ())}
        for kv in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
