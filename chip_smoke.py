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
the smoke config. Each phase prints one JSON line; the last two lines are
the kernel summary and ``{"ok": true, "device": {...}}``. Any failure
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
    from torch.profiler import ProfilerActivity, profile
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
    for name, (fn, n) in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        evts = _kernel_events(prof)
        busy_ms = sum(_device_ms(e) for e in evts) / n
        top = sorted(evts, key=_device_ms, reverse=True)[:8]
        emit("profile", run=name, wall_ms_per_call=wall_ms,
             device_busy_ms_per_call=busy_ms if evts else None,
             idle_share=(1 - busy_ms / wall_ms) if evts else None,
             top_kernels=[{"name": e.key[:60], "ms_per_call":
                           _device_ms(e) / n, "count_per_call": e.count / n}
                          for e in top],
             # the port's own kernels, device ms per launch (the profiler's
             # reading, comparable across timing methods of the kernels phase)
             port_kernels_ms_per_launch={
                 k: _device_ms(e) / e.count for e in evts
                 for k in ("flash_fwd_kernel", "paged_split_kernel",
                           "paged_combine_kernel") if k in e.key})


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
    phase_profile(*full)
    launches = {k: launches[k] + comp_launches[k] for k in launches}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
        kernels[name]["launches"] = n
    emit("done", seconds=time.perf_counter() - t_start)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(env["smi"])
    print(json.dumps({"kernels": [{k: kv[k] for k in keys}
                                  for kv in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
