"""On-card tests of the port: each CUDA kernel against its plain version.

Marked ``cuda``; every test skips when no CUDA device is present (the
decision is made inside the fixture, never at import). The file imports
no JAX, so on a machine with a card and no JAX it runs as

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa

pytestmark = pytest.mark.cuda

# float32 kernels repeat the plain arithmetic up to summation order;
# bfloat16 kernels round their probabilities to bf16 for the tensor-core
# product and their output to bf16 (one bf16 ulp at |x|~2 is 1.6e-2)
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=1, h=4, kvh=2, sq=100, sk=100, d=64),
    dict(b=2, h=6, kvh=2, sq=130, sk=130, d=128, window=40),
    dict(b=1, h=2, kvh=2, sq=17, sk=96, d=64, kv_len=80, q_offset=50),
    dict(b=1, h=4, kvh=1, sq=33, sk=200, d=128, kv_len=150),
    dict(b=1, h=2, kvh=1, sq=70, sk=64, d=64, causal=False, kv_len=40),
    dict(b=1, h=2, kvh=1, sq=90, sk=64, d=64, q_offset=-20),  # keyless rows
    dict(b=1, h=4, kvh=2, sq=2048, sk=2048, d=128),     # 32 q and key tiles
    # compressed qwen2-vl-2b prefills: 512 / 256 kept visual + 32 text
    dict(b=1, h=12, kvh=2, sq=544, sk=544, d=128),
    dict(b=1, h=12, kvh=2, sq=288, sk=288, d=128),
])
def test_flash_kernel_matches_plain(dev, dtype, case):
    rng = np.random.default_rng(0)
    c = dict(case)
    b, h, kvh, sq, sk, d = (c.pop(x) for x in ("b", "h", "kvh", "sq", "sk",
                                                "d"))
    q = _randn(rng, (b, h, sq, d), dtype, dev)
    k = _randn(rng, (b, kvh, sk, d), dtype, dev)
    v = _randn(rng, (b, kvh, sk, d), dtype, dev)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, **c)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,kvh,page", [(64, 4, 2, 16), (128, 12, 2, 16),
                                          (64, 16, 1, 5)])
def test_paged_kernel_matches_plain(dev, dtype, d, h, kvh, page):
    rng = np.random.default_rng(1)
    b, pps = 3, 7
    p_total = b * pps + 2
    q = _randn(rng, (b, h, d), dtype, dev)
    kp = _randn(rng, (p_total, page, kvh, d), dtype, dev)
    vp = _randn(rng, (p_total, page, kvh, d), dtype, dev)
    table = torch.from_numpy(rng.permutation(p_total)[:b * pps]
                             .reshape(b, pps).astype(np.int32)).to(dev)
    seq = torch.tensor([0, 1, pps * page - 3], dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, table, seq)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_strided_views(dev, dtype):
    """The model's layout: q [B,S,H,D] and a cache prefix [B,:kv_len,K,D],
    both passed transposed; the result equals the contiguous copies' and
    comes back with q's strides."""
    rng = np.random.default_rng(2)
    q = _randn(rng, (2, 100, 6, 128), dtype, dev)
    cache = _randn(rng, (2, 256, 2, 128), dtype, dev)
    qv, kv, vv = q.transpose(1, 2), cache[:, :180].transpose(1, 2), \
        cache[:, 50:230].transpose(1, 2)
    got = fa.flash_attention(qv, kv, vv, kv_len=180, q_offset=80)
    want = fa.flash_attention(qv.contiguous(), kv.contiguous(),
                              vv.contiguous(), kv_len=180, q_offset=80)
    torch.cuda.synchronize()
    assert got.stride() == qv.stride()
    assert torch.equal(got, want)
    ref = fa.flash_attention_plain(qv, kv, vv, kv_len=180, q_offset=80)
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


def _main_table(rng, b, seqs, dtype, dev):
    """Decode inputs at the shape of qwen2-vl-2b: 12 q / 2 kv heads, D 128,
    pages of 16 over a 1104-slot cache, a permuted table."""
    h, kvh, d, page, pps = 12, 2, 128, 16, 1104 // 16
    q = _randn(rng, (b, h, d), dtype, dev)
    kp = _randn(rng, (b * pps, page, kvh, d), dtype, dev)
    vp = _randn(rng, (b * pps, page, kvh, d), dtype, dev)
    table = torch.from_numpy(rng.permutation(b * pps).reshape(b, pps)
                             .astype(np.int32)).to(dev)
    return q, kp, vp, table, torch.tensor(seqs, dtype=torch.int32, device=dev)


# 40 and 360 end inside the second chunk of a 64-token split, 360 and 1060
# inside the second or third of a 96- or 128-token one
_MIXED = [40, 360, 1104, 1, 0, 97, 1060, 700]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,seqs", [
    (1, [1104]),                                # one request, full table
    (5, [31, 32, 33, 64, 65]),                  # around split boundaries
    (8, _MIXED),                                # the engine's max_batch
    (16, _MIXED * 2),
    # a mixed-compression batch: 1056 / 544 / 288-token prompts + decoded
    (8, [1057, 545, 560, 575, 549, 566, 552, 319]),
])
def test_paged_kernel_main_table(dev, dtype, b, seqs):
    """The decode shape of qwen2-vl-2b through the wrapper, with seq_lens
    at and across its split boundaries."""
    args = _main_table(np.random.default_rng(3), b, seqs, dtype, dev)
    n0 = pa.paged_attention.launches
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n0 + 1
    ref = pa.paged_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [64, 96, 128])
def test_paged_kernel_multi_chunk_splits(dev, dtype, split):
    """Splits of two to four 32-token chunks, as chip_smoke.py times them
    beside the wrapper's one: the two cp.async buffers, the prefetch of
    chunk c + 2 and the rescale of acc and l across chunks."""
    args = _main_table(np.random.default_rng(4), 8, _MIXED, dtype, dev)
    out = pa._launch(*args, split)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


def test_paged_merge_takes_its_most_splits(dev):
    """The merge keeps one weight per split in shared memory: 48 * 1024
    splits (one token each) launch and agree; one more is refused."""
    rng = np.random.default_rng(5)
    h, kvh, d, page, pps = 2, 1, 128, 16, 48 * 1024 // 16
    q = _randn(rng, (1, h, d), torch.float32, dev)
    kp = _randn(rng, (pps + 1, page, kvh, d), torch.float32, dev)
    vp = _randn(rng, (pps + 1, page, kvh, d), torch.float32, dev)
    table = torch.arange(pps + 1, dtype=torch.int32, device=dev)[None]
    seq = torch.tensor([pps * page - 5], dtype=torch.int32, device=dev)
    out = pa._launch(q, kp, vp, table[:, :pps].contiguous(), seq, 1)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(q, kp, vp, table[:, :pps], seq)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]
    with pytest.raises(RuntimeError):
        pa._launch(q, kp, vp, table, seq, 1)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 32, device=dev)
    with pytest.raises(ValueError):        # head dim 32 has no kernel
        fa.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):        # neither float32 nor bfloat16
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 3, 8, 64, device=dev)
    with pytest.raises(ValueError):        # 3 q heads over 2 kv heads
        fa.flash_attention(q, q[:, :2], q[:, :2])
    qd = torch.zeros(2, 4, 64, device=dev)
    pages = torch.zeros(4, 16, 2, 64, device=dev)
    table = torch.zeros(3, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):        # table rows != batch
        pa.paged_attention(qd, pages, pages, table,
                           torch.ones(2, dtype=torch.int32, device=dev))
    q = torch.zeros(1, 2, 8, 64, device=dev, dtype=torch.bfloat16)
    rows66 = torch.zeros(1, 2, 8, 66, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):        # 132-byte rows: not TMA-able
        fa.flash_attention(q, rows66[..., :64], q)
    with pytest.raises(ValueError):        # last dimension not contiguous
        fa.flash_attention(q, q, q.transpose(2, 3))
    flat = torch.zeros(1 + q.numel(), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):        # base not 16-byte aligned
        fa.flash_attention(q, flat[1:].view(q.shape), q)
    with pytest.raises(ValueError):        # non-contiguous pages
        pa.paged_attention(qd, pages.transpose(0, 1), pages.transpose(0, 1),
                           table[:2], torch.ones(2, dtype=torch.int32,
                                                 device=dev))


@pytest.mark.parametrize("preset", ["fastv-0.5", "sparsevlm-0.5", "l2-0.5",
                                    "divprune-0.5", "cdpruner-0.5",
                                    "tome-0.5", "framefusion-0.25"])
def test_compressor_on_card_matches_cpu(dev, preset):
    """Visual-token compression runs on the card (no host fallback): the
    same kept indices as on the CPU, embeddings within 1e-5 (the merges'
    scatter-adds sum in another order there)."""
    from repro_torch.api import resolve_compression
    from repro_torch.core.token_compression.policy import (
        compress_visual_tokens)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 256, 128)
                                             ).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8, 128)).astype(np.float32))
    cc = resolve_compression(preset)
    want, want_idx, _ = compress_visual_tokens(cc, x, query=q)
    got, idx, _ = compress_visual_tokens(cc, x.to(dev), query=q.to(dev))
    assert got.device.type == "cuda"
    assert (idx is None) == (want_idx is None)
    if idx is not None:
        assert torch.equal(idx.cpu(), want_idx)
    assert float((got.cpu() - want).abs().max()) <= 1e-5
