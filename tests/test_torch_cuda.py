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
    # head dim 32 (phi4-mini smoke and the other reference smoke configs):
    # causal, windowed, kv_len / q_offset, keyless rows, many tiles
    dict(b=2, h=4, kvh=2, sq=100, sk=100, d=32),
    dict(b=1, h=6, kvh=2, sq=130, sk=130, d=32, window=40),
    dict(b=1, h=2, kvh=2, sq=17, sk=96, d=32, kv_len=80, q_offset=50),
    dict(b=1, h=2, kvh=1, sq=90, sk=64, d=32, q_offset=-20),
    dict(b=1, h=4, kvh=1, sq=70, sk=64, d=32, causal=False, kv_len=40),
    dict(b=1, h=8, kvh=2, sq=1056, sk=1056, d=32),
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
                                          (64, 16, 1, 5), (32, 4, 1, 16),
                                          (32, 8, 2, 5), (32, 16, 1, 16)])
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


def _masked_inputs(rng, case, b, dtype, dev, permute, length=1152, d=128,
                   h=12, kvh=2):
    """Masked decode at the qwen2-vl-2b layout (12 / 2 heads, D 128, pages
    of 16; ``d``, ``h`` and ``kvh`` others) over a ``length``-slot ring cache: (q, k, v, table, seq_lens,
    k_pos [P, page], q_pos, window). ``ring``: positions wrapped past the
    cache; ``compacted``: 256 kept positions, -1 rows, then 32 decoded
    past a gap; ``window``: a plain cache with window 256 and no k_pos;
    ``own_key``: the query's own row is its only key; ``ahead``: every
    row read, those past the query's position masked."""
    page = 16
    pps = length // page
    q = _randn(rng, (b, h, d), dtype, dev)
    kp = _randn(rng, (b * pps, page, kvh, d), dtype, dev)
    vp = _randn(rng, (b * pps, page, kvh, d), dtype, dev)
    order = rng.permutation(b * pps) if permute else np.arange(b * pps)
    table = torch.from_numpy(order.reshape(b, pps).astype(np.int32)).to(dev)
    sp = np.full((b, length), -1, np.int32)
    window = 0
    if case == "ring":
        q_pos = rng.integers(length, 3 * length, b)
        for i, qp in enumerate(q_pos):
            p = np.arange(qp - length + 1, qp + 1)
            sp[i, p % length] = p
        window = length
    elif case == "compacted":
        q_pos = rng.integers(400, length - 1, b)
        for i, qp in enumerate(q_pos):
            sp[i, :256] = np.sort(rng.choice(qp - 31, 256, replace=False))
            sp[i, qp - 31:qp + 1] = np.arange(qp - 31, qp + 1)
    elif case == "window":
        q_pos = rng.integers(0, length, b)
        window = 256
    elif case == "ahead":
        q_pos = rng.integers(0, length - 8, b)
        sp[:] = np.arange(length, dtype=np.int32)
    else:
        q_pos = rng.integers(0, length, b)
        sp[np.arange(b), q_pos] = q_pos
    k_pos = None
    if case != "window":
        k_pos = torch.empty((b * pps, page), dtype=torch.int32, device=dev)
        k_pos[table.flatten().long()] = torch.from_numpy(
            sp.reshape(b * pps, page)).to(dev)
    seq = np.full(b, length) if case == "ahead" else np.minimum(q_pos + 1,
                                                                length)
    seq = torch.from_numpy(seq.astype(np.int32)).to(dev)
    q_pos = torch.from_numpy(q_pos.astype(np.int32)).to(dev)
    return (q, kp, vp, table, seq), dict(k_pos=k_pos, q_pos=q_pos,
                                         window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("case", ["ring", "compacted", "window", "own_key",
                                  "ahead"])
def test_paged_kernel_masked_matches_plain(dev, dtype, permute, case):
    """The masked mode (windowed and compacted caches) at batch 8 against
    the plain version; ``own_key`` is a row whose only key is the query's
    own, as decode leaves it over an empty slot."""
    args, kw = _masked_inputs(np.random.default_rng(6), case, 8, dtype, dev,
                              permute)
    n0 = pa.paged_attention.launches
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n0 + 1
    ref = pa.paged_attention_plain(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err
    if case == "own_key":       # softmax over one key: V of that row
        q, kp, vp, table, seq = args
        pos = kw["q_pos"].long()
        rows = vp[table.long()[torch.arange(8, device=dev), pos // 16],
                  pos % 16]
        want = rows.repeat_interleave(6, dim=1)
        assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_paged_kernel_masked_with_every_key_equals_unmasked(dev):
    """k_pos = each row's own index and q_pos = seq_len - 1 mask nothing:
    the masked kernel gives the unmasked kernel's bits."""
    args = _main_table(np.random.default_rng(7), 8, _MIXED, torch.bfloat16,
                       dev)
    q, kp, vp, table, seq = args
    k_pos = torch.empty(kp.shape[:2], dtype=torch.int32, device=dev)
    k_pos[table.flatten().long()] = torch.arange(
        table.numel() * 16, dtype=torch.int32, device=dev).view(-1, 16) \
        % (table.shape[1] * 16)
    got = pa.paged_attention(*args, k_pos=k_pos, q_pos=seq - 1)
    torch.cuda.synchronize()
    assert torch.equal(got[seq > 0], pa.paged_attention(*args)[seq > 0])


def test_paged_kernel_refuses_bad_masks(dev):
    qd = torch.zeros(2, 4, 64, device=dev)
    pages = torch.zeros(4, 16, 2, 64, device=dev)
    table = torch.arange(4, dtype=torch.int32, device=dev).view(2, 2)
    seq = torch.ones(2, dtype=torch.int32, device=dev)
    k_pos = torch.zeros(4, 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):        # int64 positions
        pa.paged_attention(qd, pages, pages, table, seq, k_pos=k_pos.long(),
                           q_pos=seq)
    with pytest.raises(ValueError):        # positions on the host
        pa.paged_attention(qd, pages, pages, table, seq, k_pos=k_pos.cpu(),
                           q_pos=seq)
    with pytest.raises(ValueError):        # q_pos on the host
        pa.paged_attention(qd, pages, pages, table, seq, k_pos=k_pos,
                           q_pos=seq.cpu())
    with pytest.raises(ValueError):        # no q_pos
        pa.paged_attention(qd, pages, pages, table, seq, window=8)
    with pytest.raises(ValueError):        # not [P, page]
        pa.paged_attention(qd, pages, pages, table, seq,
                           k_pos=k_pos[:, :8].contiguous(), q_pos=seq)
    with pytest.raises(ValueError):        # not contiguous
        pa.paged_attention(qd, pages, pages, table, seq,
                           k_pos=k_pos.t().contiguous().t(), q_pos=seq)


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 2, 8, 48, device=dev)
    with pytest.raises(ValueError):        # head dim 48 has no kernel
        fa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError):        # nor in the paged kernel
        pa.paged_attention(q[:, :, 0].contiguous(),
                           torch.zeros(2, 16, 1, 48, device=dev),
                           torch.zeros(2, 16, 1, 48, device=dev),
                           torch.zeros(1, 2, dtype=torch.int32, device=dev),
                           torch.ones(1, dtype=torch.int32, device=dev))
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


# ----------------------------------------------- multi-query (verify) --

def _mq_inputs(rng, s, g, dtype, dev, *, permute, page=16, b=6, kvh=2,
               length=288, d=None):
    """Multi-query inputs over a ``length``-slot cache of ``b`` requests:
    (q [B,S,H,D], k/v pages, table, seq_lens, q_pos). Row starts: the
    cache's start, one block straddling each 32-token split boundary of
    the first two, a mid-cache block, a block ending at the last live
    row (L - 2), and an inactive row routed to the scratch slot
    (start = L - 1: q_pos runs past the cache and every row is read).
    Physical page table[j] holds logical page j. ``d`` defaults to 128
    at G = 6 (qwen2-vl) and 64 otherwise."""
    if d is None:
        d = 128 if g == 6 else 64
    h = kvh * g
    pps = length // page
    starts = np.array([0, 32 - s // 2, 64 - 1, length // 2 + 3,
                       length - 1 - s, length - 1])[:b]
    q = _randn(rng, (b, s, h, d), dtype, dev)
    k = _randn(rng, (b, length, kvh, d), dtype, dev)
    v = _randn(rng, (b, length, kvh, d), dtype, dev)
    order = rng.permutation(b * pps) if permute else np.arange(b * pps)
    table = torch.from_numpy(order.reshape(b, pps).astype(np.int32)).to(dev)
    pages = []
    for x in (k, v):
        y = torch.empty((b * pps, page, kvh, d), dtype=dtype, device=dev)
        y[table.flatten().long()] = x.reshape(b * pps, page, kvh, d)
        pages.append(y)
    q_pos = starts[:, None] + np.arange(s)
    seq = np.minimum(starts + s, length)
    return (q, pages[0], pages[1], table,
            torch.from_numpy(seq.astype(np.int32)).to(dev),
            torch.from_numpy(q_pos.astype(np.int32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 6, 8])
@pytest.mark.parametrize("s", range(1, 9))
def test_paged_kernel_multi_query_matches_plain(dev, dtype, g, s):
    """The multi-query mode (the per-row-start verify) against its plain
    version: S = 1..8 query tokens, G = 1, 6 (qwen2-vl, D 128) and 8
    heads per kv head (up to 64 rows a CTA), identity and permuted
    tables, pages of 16 and 5 tokens, blocks across split boundaries and
    an inactive scratch row."""
    rng = np.random.default_rng(10 + s)
    for permute, page in ((False, 16), (True, 16), (True, 5)):
        *args, q_pos = _mq_inputs(rng, s, g, dtype, dev, permute=permute,
                                  page=page, length=320)
        n0 = pa.paged_attention.launches
        m0 = pa.paged_attention.multi_query_launches
        out = pa.paged_attention(*args, q_pos=q_pos)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches == n0 + 1
        assert pa.paged_attention.multi_query_launches == m0 + 1
        assert out.shape == args[0].shape
        ref = pa.paged_attention_plain(*args, q_pos=q_pos)
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= TOL[dtype], (permute, page, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("permute", [False, True])
def test_paged_kernel_draft_pool_matches_plain(dev, dtype, permute):
    """The speculative draft pool of the qwen2-vl serve (1104 + gamma 4 + 8
    = 1116 rows, so 4-token pages): the draft's 2-token lead at text
    positions 31..62 with two rows at the scratch slot (start 1114), and
    its one-query decode steps at batch 8 (seq_lens = text position + 3,
    or the whole pool for the scratch rows)."""
    rng = np.random.default_rng(17)
    b, length, page, kvh, g, d = 8, 1116, 4, 2, 6, 128
    pps = length // page
    text = 31 + rng.integers(0, 32, b)
    text[-2:] = length - 2
    k = _randn(rng, (b, length, kvh, d), dtype, dev)
    v = _randn(rng, (b, length, kvh, d), dtype, dev)
    order = rng.permutation(b * pps) if permute else np.arange(b * pps)
    table = torch.from_numpy(order.reshape(b, pps).astype(np.int32)).to(dev)
    kp, vp = (torch.empty((b * pps, page, kvh, d), dtype=dtype, device=dev)
              for _ in range(2))
    kp[table.flatten().long()] = k.reshape(b * pps, page, kvh, d)
    vp[table.flatten().long()] = v.reshape(b * pps, page, kvh, d)

    def ints(x):
        return torch.from_numpy(np.asarray(x, np.int32)).to(dev)
    q = _randn(rng, (b, 2, kvh * g, d), dtype, dev)
    q_pos = ints(text[:, None] + np.arange(2))
    seq = ints(np.minimum(text + 2, length))
    out = pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos)
    ref = pa.paged_attention_plain(q, kp, vp, table, seq, q_pos=q_pos)
    step = np.minimum(text + 3, length)
    q1 = _randn(rng, (b, kvh * g, d), dtype, dev)
    out1 = pa.paged_attention(q1, kp, vp, table, ints(step))
    ref1 = pa.paged_attention_plain(q1, kp, vp, table, ints(step))
    torch.cuda.synchronize()
    for got, want in ((out, ref), (out1, ref1)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_multi_query_s1_equals_one_query_bits(dev, dtype):
    """S = 1 with q_pos = seq_len - 1 masks nothing the one-query kernel
    reads: the same bits, at the qwen2-vl decode shape."""
    q, kp, vp, table, seq = _main_table(np.random.default_rng(11), 8,
                                        [40, 360, 1104, 1, 97, 1060, 700, 32],
                                        dtype, dev)
    got = pa.paged_attention(q[:, None].contiguous(), kp, vp, table, seq,
                             q_pos=(seq - 1)[:, None].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], pa.paged_attention(q, kp, vp, table, seq))


def test_paged_multi_query_refusals(dev):
    rng = np.random.default_rng(12)
    q, kp, vp, table, seq, q_pos = _mq_inputs(rng, 4, 6, torch.bfloat16,
                                              dev, permute=False)
    with pytest.raises(ValueError):        # int64 positions
        pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos.long())
    with pytest.raises(ValueError):        # [B] positions for [B, S] q
        pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos[:, 0])
    with pytest.raises(ValueError):        # no positions
        pa.paged_attention(q, kp, vp, table, seq)
    with pytest.raises(ValueError):        # k_pos is not served with it
        pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos,
                           k_pos=torch.zeros(kp.shape[:2], dtype=torch.int32,
                                             device=dev))
    with pytest.raises(ValueError):        # nor a window
        pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos, window=16)
    q0 = torch.zeros((q.shape[0], 0) + q.shape[2:], dtype=q.dtype,
                     device=dev)
    with pytest.raises(ValueError):        # no query tokens
        pa.paged_attention(q0, kp, vp, table, seq,
                           q_pos=torch.zeros(q0.shape[:2], dtype=torch.int32,
                                             device=dev))
    q48 = torch.zeros((q.shape[0], 9, 32, 48), dtype=q.dtype, device=dev)
    kp48 = torch.zeros(kp.shape[:3] + (48,), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError):        # head dim 48 has no kernel
        pa.paged_attention(q48, kp48, kp48, table, seq,
                           q_pos=torch.zeros(q48.shape[:2],
                                             dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):        # positions on the host
        pa.paged_attention(q, kp, vp, table, seq, q_pos=q_pos.cpu())


def test_per_row_extend_card_matches_cpu(dev):
    """A full [B]-start ``Model.extend`` (the batched verify) on the qwen2-vl
    smoke config, card against CPU (float32): active rows' logits within
    1e-3 (the smoke-logit bar) and their cache rows within 1e-4. The
    inactive row clips several writes onto the scratch slot, whose
    winner the card leaves unspecified: it is not compared."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    cfg = get_config("qwen2-vl-2b", smoke=True)
    model = build(cfg)
    params = model.init(0, "cpu")
    rng = np.random.default_rng(13)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 20)))
    _, cache = model.prefill(params, {"tokens": toks}, cache_len=48)
    blk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 5)))
    starts = torch.tensor([20, 14, 47])               # row 2: scratch

    def tree_to(t):
        return {k: tree_to(v) if isinstance(v, dict) else v.to(dev)
                for k, v in t.items()}
    pc, card = tree_to(params), tree_to(cache)
    n0 = pa.paged_attention.multi_query_launches
    lc, cache = model.extend(params, cache, blk, starts)
    lg, card = model.extend(pc, card, blk.to(dev), starts.to(dev))
    torch.cuda.synchronize()
    assert pa.paged_attention.multi_query_launches == n0 + cfg.num_layers
    assert (lg[:2].cpu() - lc[:2]).abs().max().item() <= 1e-3
    for name in ("k", "v"):
        got = card["layers"][name][:, :2, :25].cpu()
        want = cache["layers"][name][:, :2, :25]
        assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", [32, 96, 128])
def test_paged_multi_query_multi_chunk_splits(dev, dtype, split):
    """The multi-query kernels at one to four 32-token chunks per CTA (the
    wrapper gives the tensor-core kernel two): the cp.async ping-pong and
    the online softmax across chunks."""
    *args, q_pos = _mq_inputs(np.random.default_rng(14), 5, 6, dtype, dev,
                              permute=True, length=320)
    out = pa._launch(*args, split, q_pos=q_pos)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args, q_pos=q_pos)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


# ------------------------------------ head dim 32 and long verifies --

def _assert_mq_close(out, ref, dtype, what):
    """The multi-query bar: within TOL and within REL_TOL of max|ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    assert err <= TOL[dtype], (what, err)
    assert err <= {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype] \
        * max(scale, 1.0), (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ring", "compacted", "window", "own_key",
                                  "ahead"])
def test_paged_kernel_masked_d32_matches_plain(dev, dtype, case):
    """The masked mode at head dim 32 (the bf16 rows are 64 bytes: the
    4-piece swizzle)."""
    args, kw = _masked_inputs(np.random.default_rng(20), case, 8, dtype, dev,
                              True, length=640, d=32)
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args, **kw)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 6, 16])
@pytest.mark.parametrize("s", [1, 2, 5, 8])
def test_paged_kernel_multi_query_d32_matches_plain(dev, dtype, g, s):
    """The multi-query mode at head dim 32: the FMA kernel (float32, S = 1)
    and the tensor-core kernel, whose D = 32 takes two row tiles of 16."""
    rng = np.random.default_rng(30 + s)
    for permute, page in ((False, 16), (True, 5)):
        *args, q_pos = _mq_inputs(rng, s, g, dtype, dev, permute=permute,
                                  page=page, length=320, d=32)
        out = pa.paged_attention(*args, q_pos=q_pos)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(*args, q_pos=q_pos)
        _assert_mq_close(out, ref, dtype, (permute, page))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d", [(6, 128), (16, 64), (16, 32)])
@pytest.mark.parametrize("s", [9, 13, 17])
def test_paged_kernel_long_verify_matches_plain(dev, dtype, g, d, s):
    """Verifies of gamma 8, 12 and 16 (S = gamma + 1): S * G from 54 to 272
    rows, so past 64 rows a kv head's rows go to several row-tile CTAs."""
    rng = np.random.default_rng(40 + s)
    for permute, page in ((False, 16), (True, 5)):
        *args, q_pos = _mq_inputs(rng, s, g, dtype, dev, permute=permute,
                                  page=page, length=320, d=d)
        m0 = pa.paged_attention.multi_query_launches
        out = pa.paged_attention(*args, q_pos=q_pos)
        torch.cuda.synchronize()
        assert pa.paged_attention.multi_query_launches == m0 + 1
        ref = pa.paged_attention_plain(*args, q_pos=q_pos)
        _assert_mq_close(out, ref, dtype, (permute, page))


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_phi4_smoke_card_matches_cpu(dev):
    """phi4-mini smoke (head dim 32) with no ``device=`` runs on the card:
    prefill and decode logits within 1e-3 of the CPU port's on the same
    weights, greedy tokens identical."""
    from repro_torch.api import GenerationConfig, LVLM
    card = LVLM.from_pretrained("phi4-mini-3.8b", smoke=True, seed=0)
    assert card.device.type == "cuda"
    cpu = card.with_params(_tree_to(card.params, "cpu"))
    rng = np.random.default_rng(50)
    prompts = [rng.integers(0, card.cfg.vocab_size, n).tolist()
               for n in (20, 70, 9)]
    toks = torch.tensor([prompts[0]])
    n0 = fa.flash_attention.launches, pa.paged_attention.launches
    lc, cc = cpu.model.prefill(cpu.params, {"tokens": toks}, cache_len=48)
    lg, cg = card.model.prefill(card.params, {"tokens": toks.to(dev)},
                                cache_len=48)
    assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    nxt, pos = torch.tensor([[3]]), torch.tensor([20])
    dc, _ = cpu.model.decode_step(cpu.params, cc, nxt, pos)
    dg, _ = card.model.decode_step(card.params, cg, nxt.to(dev), pos.to(dev))
    assert (dg.cpu() - dc).abs().max().item() <= 1e-3
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy")
    got = [r.tokens for r in card.generate(prompts, gen)]
    want = [r.tokens for r in cpu.generate(prompts, gen)]
    torch.cuda.synchronize()
    assert fa.flash_attention.launches > n0[0]
    assert pa.paged_attention.launches > n0[1]
    assert got == want


def test_serve_async_card_matches_sync_and_cpu(dev):
    """``serve_async(obs=True, profile=True)`` on the card (qwen2-vl smoke,
    float32, sanitizer on): a mixed greedy / speculative / early-exit
    batch streams the tokens of a sync ``serve`` on the card and of the
    same async serve on the CPU, the trace validates, and a cancelled
    stream leaves the pool at baseline."""
    import asyncio
    from repro_torch.api import (AdmissionConfig, EngineConfig,
                                 GenerationConfig, LVLM, Request)
    from repro_torch.obs import to_chrome_trace, validate_trace
    cpu = LVLM.from_pretrained("qwen2-vl-2b", smoke=True, seed=0,
                               device="cpu")
    card = cpu.with_params(_tree_to(cpu.params, "cuda"))
    cfg = cpu.cfg
    rng = np.random.default_rng(60)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 12, 7, 14)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) if i % 2 else None
           for i in range(4)]
    decs = ("speculative", "greedy", "early_exit", "speculative")

    def reqs():
        return [Request(rid=i, tokens=list(p), max_new_tokens=8,
                        visual_embeds=ve, decoder=d)
                for i, (p, ve, d) in enumerate(zip(prompts, ves, decs))]
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy", gamma=3,
                           temperature=0.0)
    ec = EngineConfig(max_batch=4, cache_len=64, sanitize=True)
    adm = AdmissionConfig(high_watermark=1.0, low_watermark=0.9)

    def run_async(lvlm, cancel_rid=None):
        server = lvlm.serve_async(ec, gen, admission=adm, obs=True,
                                  profile=True)

        async def consume(stream):
            out = []
            async for tok in stream:
                out.append(tok)
                if stream.request.rid == cancel_rid and len(out) == 2:
                    stream.cancel()
                    break
            return out

        async def drive():
            async with server:
                return await asyncio.gather(
                    *(consume(server.submit(r)) for r in reqs()))
        return dict(enumerate(asyncio.run(drive()))), server

    got, server = run_async(card)
    torch.cuda.synchronize()
    sync = card.serve(reqs(), ec, gen)
    assert got == {r.rid: r.generated for r in sync.requests}
    assert got == run_async(cpu)[0]
    assert validate_trace(to_chrome_trace(server.tracer.events)) == []
    assert "decode:speculative" in server.profiler.snapshot()
    _, server = run_async(card, cancel_rid=0)
    eng = server.engine
    assert server.summary()["aborted"] == 1
    assert eng.kv_committed_tokens() == 0
    assert all(r is None for r in eng.slot_req)
    assert eng._decoders["speculative"].bound_slots() == set()


def _smoke_pair(arch="qwen2-vl-2b"):
    from repro_torch.api import LVLM
    cpu = LVLM.from_pretrained(arch, smoke=True, seed=0, device="cpu")
    return cpu, cpu.with_params(_tree_to(cpu.params, "cuda"))


def _run_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        assert eng.step()
    raise AssertionError("condition not reached")


def test_kv_export_import_on_card_is_bit_exact(dev):
    """``export_kv`` on the card clones the slot's rows (a device tensor,
    not a view of the pool), ``import_kv`` copies them into another
    engine's slot bit for bit, ``complete_export`` frees the source, and
    the snapshot survives the source slot's reuse; the migrated request
    decodes through the paged kernel and its float32 tokens equal an
    unmigrated run's on the card."""
    from repro_torch.api import EngineConfig, GenerationConfig, Request
    from repro_torch.core.serving.engine import Engine
    from repro_torch.core.serving.request import State
    _, card = _smoke_pair()
    cfg = card.cfg
    rng = np.random.default_rng(70)
    prompt = rng.integers(1, cfg.vocab_size, 14).tolist()
    other = rng.integers(1, cfg.vocab_size, 30).tolist()
    ve = rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                             ).astype(np.float32)
    ec = EngineConfig(max_batch=2, cache_len=80, temperature=0.0,
                      sanitize=True)
    gen = GenerationConfig(max_new_tokens=8, decoder="greedy",
                           temperature=0.0)
    plain = card.serve([Request(rid=0, tokens=list(prompt), max_new_tokens=8,
                                visual_embeds=ve)], ec, gen).requests[0]
    src = Engine(card.model, card.params, ec)
    dst = Engine(card.model, card.params, ec)
    req = Request(rid=0, tokens=list(prompt), max_new_tokens=8,
                  visual_embeds=ve)
    req.handoff = True
    src.submit(req)
    _run_until(src, lambda: req.state is State.MIGRATING)
    ticket = src.export_kv(0)
    slot, pos = ticket["slot"], ticket["pos"]
    assert pos == len(prompt) + cfg.num_visual_tokens
    snap = ticket["snap"]["layers"]
    assert all(v.is_cuda for v in snap.values())
    for k, v in snap.items():
        assert v.data_ptr() != src.pool["layers"][k].data_ptr()
        assert torch.equal(v[:, 0], src.pool["layers"][k][:, slot, :pos])
    before = {k: v.clone() for k, v in snap.items()}
    dst.import_kv(req, ticket, ready_at=ticket["clock"])
    src.complete_export(0)
    assert src.slot_req[slot] is None and src._exports == {}
    for k in snap:
        assert torch.equal(dst.pool["layers"][k][:, req._slot, :pos],
                           before[k][:, 0])
    nxt = Request(rid=1, tokens=other, max_new_tokens=2)
    src.submit(nxt)
    _run_until(src, lambda: nxt.state is State.DONE)
    assert nxt._slot == slot
    for k, v in snap.items():
        assert torch.equal(v, before[k])
    n0 = pa.paged_attention.launches
    while dst.step():
        pass
    torch.cuda.synchronize()
    assert pa.paged_attention.launches > n0
    assert req.generated == plain.generated


def test_disaggregated_fleet_on_card_matches_cpu(dev):
    """A prefill:1,decode:1 fleet on the card (qwen2-vl smoke, float32,
    sanitizer on): every request migrates, streams equal the colocated
    fleet on the card and the disaggregated fleet on the CPU, and the
    records on the virtual clock are exactly the CPU's."""
    import asyncio
    import dataclasses
    from repro_torch.api import EngineConfig, GenerationConfig, Request
    cpu, card = _smoke_pair()
    cfg = cpu.cfg
    rng = np.random.default_rng(71)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (9, 12, 7, 14)]
    ves = [rng.standard_normal((cfg.num_visual_tokens, cfg.d_model)
                               ).astype(np.float32) if i % 2 else None
           for i in range(4)]
    ec = EngineConfig(max_batch=4, cache_len=64, temperature=0.0,
                      sanitize=True)
    gen = GenerationConfig(max_new_tokens=6, decoder="greedy",
                           temperature=0.0)

    def run(lvlm, roles):
        router = lvlm.serve_cluster(2, ec, gen=gen, roles=roles)

        async def drive():
            async with router:
                return await asyncio.gather(*(
                    _consume(router.submit(Request(
                        rid=i, tokens=list(p), max_new_tokens=6,
                        visual_embeds=ve)))
                    for i, (p, ve) in enumerate(zip(prompts, ves))))
        outs = dict(enumerate(asyncio.run(drive())))
        recs = [[dataclasses.asdict(r) for r in rep.server.metrics.records]
                for rep in router.replicas]
        return outs, recs, router

    got, recs, router = run(card, ["prefill", "decode"])
    assert len(router.migrations) == 4
    assert all(rep.server.engine.kv_committed_tokens() == 0
               for rep in router.replicas)
    assert got == run(card, None)[0]
    want, want_recs, _ = run(cpu, ["prefill", "decode"])
    assert got == want and recs == want_recs


async def _consume(stream):
    return [tok async for tok in stream]


def test_shared_tier_snapshot_on_card_survives_slot_reuse(dev):
    """The shared prefix tier's snapshot (a clone on the card) keeps its
    bits after the publishing slot is reused, and a sibling's remote hit
    installs exactly them."""
    from repro_torch.api import EngineConfig, Request
    from repro_torch.cluster import SharedPrefixTier
    from repro_torch.core.serving.engine import Engine
    from repro_torch.core.serving.request import State
    _, card = _smoke_pair("phi4-mini-3.8b")
    rng = np.random.default_rng(72)
    shared = rng.integers(1, 512, 32).tolist()
    ec = EngineConfig(max_batch=1, cache_len=96, temperature=0.0,
                      prefix_cache=True, sanitize=True)
    a = Engine(card.model, card.params, ec)
    b = Engine(card.model, card.params, ec)
    a.prefix_share = b.prefix_share = tier = SharedPrefixTier(block=16)
    r0 = Request(rid=0, tokens=shared + [5, 6, 7], max_new_tokens=2)
    a.submit(r0)
    _run_until(a, lambda: r0.state is State.DONE)
    _, snap = tier.lookup("none", r0.tokens, block=16, touch=False)
    before = {k: v.clone() for k, v in snap["layers"].items()}
    r1 = Request(rid=1, tokens=rng.integers(1, 512, 40).tolist(),
                 max_new_tokens=2)
    a.submit(r1)
    _run_until(a, lambda: r1.state is State.DONE)
    assert not torch.equal(a.pool["layers"]["k"][:, 0, :32],
                           before["k"][:, 0])
    for k, v in snap["layers"].items():
        assert torch.equal(v, before[k])
    r2 = Request(rid=2, tokens=shared + [9, 9], max_new_tokens=2)
    b.submit(r2)
    b.step()
    assert b.remote_prefix_hits == 1
    for k in ("k", "v"):
        assert torch.equal(b.pool["layers"][k][:, 0, :32], before[k][:, 0])


# ---- head dim 192 (nemotron-4-340b) and 48 q heads per kv head (granite-34b)

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=1, h=12, kvh=1, sq=300, sk=300),               # G = 12
    dict(b=2, h=4, kvh=2, sq=130, sk=130, window=40),
    dict(b=1, h=2, kvh=2, sq=17, sk=96, kv_len=80, q_offset=50),
    dict(b=1, h=2, kvh=1, sq=90, sk=64, q_offset=-20),    # keyless rows
    dict(b=1, h=4, kvh=1, sq=70, sk=64, causal=False, kv_len=40),
    dict(b=1, h=48, kvh=1, sq=200, sk=200, d=128),        # granite's G
])
def test_flash_kernel_head_dim_192_matches_plain(dev, dtype, case):
    """Flash at head dim 192 (three 64-column TMA boxes, an m64n192k16 P V
    and a 96-register O in bf16; the float32 layout's 211 KB), and at
    granite's 48 q heads per kv head (D = 128)."""
    rng = np.random.default_rng(60)
    c = dict(case)
    b, h, kvh, sq, sk = (c.pop(x) for x in ("b", "h", "kvh", "sq", "sk"))
    d = c.pop("d", 192)
    q = _randn(rng, (b, h, sq, d), dtype, dev)
    k = _randn(rng, (b, kvh, sk, d), dtype, dev)
    v = _randn(rng, (b, kvh, sk, d), dtype, dev)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref = fa.flash_attention_plain(q, k, v, **c)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_head_dim_192_takes_strided_views(dev, dtype):
    """The model's layout at head dim 192: q [B,S,H,D] and a cache prefix,
    passed transposed."""
    rng = np.random.default_rng(61)
    q = _randn(rng, (2, 70, 4, 192), dtype, dev)
    cache = _randn(rng, (2, 160, 2, 192), dtype, dev)
    qv, kv = q.transpose(1, 2), cache[:, :150].transpose(1, 2)
    got = fa.flash_attention(qv, kv, kv, kv_len=150, q_offset=80)
    torch.cuda.synchronize()
    assert got.stride() == qv.stride()
    ref = fa.flash_attention_plain(qv, kv, kv, kv_len=150, q_offset=80)
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dv", [192, 128])
@pytest.mark.parametrize("case", [
    dict(b=1, h=4, kvh=1, sq=64, sk=300),          # a pair's second tile empty
    dict(b=1, h=4, kvh=1, sq=70, sk=70),           # ... holding 6 rows
    dict(b=2, h=4, kvh=2, sq=1000, sk=1000),
    dict(b=1, h=8, kvh=2, sq=200, sk=200, kv_len=61, window=40),
    dict(b=1, h=2, kvh=2, sq=200, sk=200, q_offset=-30),  # keyless rows
    dict(b=1, h=2, kvh=2, sq=16, sk=1104, kv_len=1056, q_offset=1000),
    dict(b=1, h=4, kvh=4, sq=70, sk=300, causal=False),
    dict(b=1, h=130, kvh=130, sq=256, sk=256),     # G = 1: two grid chunks
])
def test_flash_kernel_d192_pairs_of_q_tiles(dev, dtype, dv, case):
    """Head dim 192 on the two-warpgroup kernel (a CTA holds two 64-row q
    tiles) at the edges of a pair, with v 192 wide and MLA's 128: within
    TOL of the plain version; at 128 also of the padded call's first 128
    columns, with the same log-sum-exp bits (the scores' path is one)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(62)
    c = dict(case)
    b, h, kvh, sq, sk = (c.pop(x) for x in ("b", "h", "kvh", "sq", "sk"))
    q = _randn(rng, (b, h, sq, 192), dtype, dev)
    k = _randn(rng, (b, kvh, sk, 192), dtype, dev)
    v = _randn(rng, (b, kvh, sk, dv), dtype, dev)
    n0 = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, **c)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1 and out.shape[-1] == dv
    ref = fa.flash_attention_plain(q, k, v, **c)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    if dv == 128:
        o, lse = fa.flash_attention_fwd(q, k, v, **c)
        op, lsep = fa.flash_attention_fwd(q, k, F.pad(v, (0, 64)), **c)
        assert torch.equal(o, out) and torch.equal(lse, lsep)
        assert (o.float() - op[..., :dv].float()).abs().max().item() \
            <= TOL[dtype]


def test_flash_kernel_takes_only_its_v_widths(dev):
    """v narrower than q and k only at (192, 128), and never under grad
    (the backward takes equal widths)."""
    q = torch.zeros(1, 2, 8, 192, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):        # (192, 64) has no kernel
        fa.flash_attention(q, q, q[..., :64].contiguous())
    with pytest.raises(ValueError):        # nor (64, 32)
        fa.flash_attention(q[..., :64].contiguous(), q[..., :64].contiguous(),
                           q[..., :32].contiguous())
    with pytest.raises(ValueError):        # under grad
        fa.flash_attention(q.clone().requires_grad_(), q,
                           q[..., :128].contiguous())
    with pytest.raises(ValueError):        # nor the backward itself
        fa.flash_attention_bwd(q, q, q[..., :128].contiguous(), q,
                               torch.zeros(1, 2, 8, device=dev), q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,kvh", [(192, 24, 2), (192, 8, 8),
                                     (128, 48, 1), (192, 48, 1),
                                     (64, 64, 1), (32, 48, 1)])
def test_paged_kernel_new_shapes_match_plain(dev, dtype, d, h, kvh):
    """One-query decode at head dim 192 (nemotron's 96 / 8 heads are G =
    12) and at G = 48 (granite: 48 / 1) up to the 64-row limit, over a
    permuted table with seq_len 0, 1 and a split-straddling length."""
    rng = np.random.default_rng(62)
    b, pps, page = 4, 9, 16
    q = _randn(rng, (b, h, d), dtype, dev)
    kp = _randn(rng, (b * pps + 1, page, kvh, d), dtype, dev)
    vp = _randn(rng, (b * pps + 1, page, kvh, d), dtype, dev)
    table = torch.from_numpy(rng.permutation(b * pps + 1)[:b * pps]
                             .reshape(b, pps).astype(np.int32)).to(dev)
    seq = torch.tensor([0, 1, 65, pps * page], dtype=torch.int32, device=dev)
    n0 = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n0 + 1
    ref = pa.paged_attention_plain(q, kp, vp, table, seq)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,kvh", [(192, 24, 2), (128, 48, 1)])
@pytest.mark.parametrize("case", ["ring", "compacted", "window", "own_key",
                                  "ahead"])
def test_paged_kernel_masked_new_shapes_match_plain(dev, dtype, d, h, kvh,
                                                    case):
    """The masked mode at head dim 192 and at G = 48."""
    args, kw = _masked_inputs(np.random.default_rng(63), case, 4, dtype, dev,
                              True, length=640, d=d, h=h, kvh=kvh)
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,d,kvh", [(12, 192, 2), (48, 128, 1),
                                     (4, 192, 2)])
@pytest.mark.parametrize("s", [1, 2, 5, 9])
def test_paged_kernel_multi_query_new_shapes_match_plain(dev, dtype, g, d,
                                                         kvh, s):
    """The multi-query mode at head dim 192 (one, two and four 16-row
    tiles on tensor cores, row tiles past 64 rows) and at G = 48 (S = 5:
    granite's gamma-4 verify, 240 rows in 4 row tiles)."""
    rng = np.random.default_rng(64 + s)
    for permute, page in ((False, 16), (True, 5)):
        *args, q_pos = _mq_inputs(rng, s, g, dtype, dev, permute=permute,
                                  page=page, length=320, d=d, kvh=kvh)
        m0 = pa.paged_attention.multi_query_launches
        out = pa.paged_attention(*args, q_pos=q_pos)
        torch.cuda.synchronize()
        assert pa.paged_attention.multi_query_launches == m0 + 1
        ref = pa.paged_attention_plain(*args, q_pos=q_pos)
        _assert_mq_close(out, ref, dtype, (permute, page))


def test_kernels_refuse_shapes_past_the_new_ones(dev):
    """Head dims other than 32 / 64 / 128 / 192 and more than 64 q heads
    per kv head raise on the card."""
    q = torch.zeros(1, 2, 8, 256, device=dev)
    with pytest.raises(ValueError):        # head dim 256 has no kernel
        fa.flash_attention(q, q[:, :1], q[:, :1])
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    seq = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):        # nor in the paged kernel
        pa.paged_attention(q[:, :, 0].contiguous(),
                           torch.zeros(2, 16, 1, 256, device=dev),
                           torch.zeros(2, 16, 1, 256, device=dev), table, seq)
    pages = torch.zeros(2, 16, 1, 128, device=dev)
    with pytest.raises(ValueError):        # 65 q heads on one kv head
        pa.paged_attention(torch.zeros(1, 65, 128, device=dev), pages, pages,
                           table, seq)


# ---------------------------------------------------------------- MLA --

#: the latent kernel is float32 arithmetic in both cache dtypes: within
#: this share of the plain version's largest output
MLA_REL_TOL = 1e-4


def _mla_inputs(rng, dtype, dev, b, sq, h, r, rr, length):
    return (_randn(rng, (b, sq, h, r), torch.float32, dev),
            _randn(rng, (b, sq, h, rr), torch.float32, dev),
            _randn(rng, (b, length, r), dtype, dev),
            _randn(rng, (b, length, rr), dtype, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,rr,h", [(32, 16, 4), (512, 64, 128),
                                    (512, 64, 20)])
@pytest.mark.parametrize("case", ["decode", "verify", "window", "k_pos",
                                  "short_and_past"])
def test_mla_kernel_matches_plain(dev, dtype, r, rr, h, case):
    """Both instantiations (deepseek-v3 smoke and full; 20 heads: a
    partial head tile) in each mode: one-query decode over 300 rows, the
    S = 5 verify with a row past the cache, a 37-key window, the k_pos
    mode (a ring with holes and a row with no valid key: the mean of
    ckv), rows at position 0 and past L."""
    from repro_torch.kernels import mla_attention as ma
    rng = np.random.default_rng(80)
    length = 300
    b, sq = (3, 5) if case == "verify" else (4, 1)
    args = _mla_inputs(rng, dtype, dev, b, sq, h, r, rr, length)
    base = {"decode": [299, 120, 33, 250], "verify": [290, 100, 299],
            "window": [299, 120, 33, 250], "k_pos": [299, 120, 33, 250],
            "short_and_past": [0, 1, 400, 128]}[case]
    q_pos = torch.tensor(base, dtype=torch.int32, device=dev)[:, None] \
        + torch.arange(sq, dtype=torch.int32, device=dev)
    kw = {"window": 37} if case == "window" else {}
    if case == "k_pos":
        kp = torch.from_numpy(rng.permutation(length)[None].repeat(
            b, 0).astype(np.int32)).to(dev)
        kp[1, ::4] = -1
        kp[3] = -1
        kw = dict(k_pos=kp.contiguous(), window=200)
    scale = (r + rr) ** -0.5
    n0 = ma.mla_attention.launches
    out = ma.mla_attention(*args, q_pos.contiguous(), scale=scale, **kw)
    torch.cuda.synchronize()
    assert ma.mla_attention.launches == n0 + 1
    ref = ma.mla_attention_plain(*args, q_pos, scale=scale, **kw)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    err = (out - ref).abs().max().item()
    assert err <= MLA_REL_TOL * ref.abs().max().item(), err


@pytest.mark.parametrize("length", [1104, 1024, 20])
@pytest.mark.parametrize("sq", [1, 2, 5, 9, 17])
@pytest.mark.parametrize("h", [128, 20])
@pytest.mark.parametrize("q_scale", [1.0, 4.0])
def test_mla_tensor_core_route_matches_plain(dev, length, sq, h, q_scale):
    """The tensor-core route (bf16 cache at R 512, Rr 64) over 1104 rows
    (34.5 key tiles of 32), 1024 (whole tiles) and 20 (less than one
    tile: the TMA box reads past L), S = 1 to 17 (gamma up
    to 16), 20 heads (row tiles that straddle queries, a partial last
    tile), q_lat scaled by 4: rows near the end, one at the start, and a
    verify whose last row's queries sit past the cache."""
    from repro_torch.kernels import mla_attention as ma
    rng = np.random.default_rng(83)
    args = list(_mla_inputs(rng, torch.bfloat16, dev, 3, sq, h, 512, 64,
                            length))
    args[0] = args[0] * q_scale
    q_pos = torch.tensor([length - sq, 0, length - 1], dtype=torch.int32,
                         device=dev)[:, None] \
        + torch.arange(sq, dtype=torch.int32, device=dev)
    assert ma.route(torch.bfloat16, 512) == "wgmma"
    n0 = ma.mla_attention.launches
    out = ma.mla_attention(*args, q_pos.contiguous(), scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert ma.mla_attention.launches == n0 + 1
    ref = ma.mla_attention_plain(*args, q_pos, scale=192 ** -0.5)
    err = (out - ref).abs().max().item()
    assert bool(torch.isfinite(out).all())
    assert err <= MLA_REL_TOL * ref.abs().max().item(), err


@pytest.mark.parametrize("b,sq", [(4, 1), (8, 5)])
def test_mla_kernel_counts_one_launch_per_call(dev, b, sq):
    """The main path's two shapes, one-query decode at batch 4 and the
    S = 5 verify at batch 8 over 1104 rows, each add exactly one to the
    launch count, whatever the split count the wrapper picks."""
    from repro_torch.kernels import mla_attention as ma
    rng = np.random.default_rng(84)
    args = _mla_inputs(rng, torch.bfloat16, dev, b, sq, 128, 512, 64, 1104)
    q_pos = torch.full((b, sq), 1103 - sq, dtype=torch.int32, device=dev) \
        + torch.arange(sq, dtype=torch.int32, device=dev)
    n0 = ma.mla_attention.launches
    ma.mla_attention(*args, q_pos, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert ma.mla_attention.launches == n0 + 1


@pytest.mark.parametrize("split", [32, 96, 352, 1120])
def test_mla_tensor_core_route_at_any_split(dev, split):
    """The tensor-core route's C entry at 35 to 1 CTAs a row tile over
    1104 rows (the last split partial), the S = 5 verify at batch 2: the
    merge of many partials and the one-split epilogue agree with the
    plain version."""
    from repro_torch.kernels import mla_attention as ma
    rng = np.random.default_rng(85)
    args = _mla_inputs(rng, torch.bfloat16, dev, 2, 5, 128, 512, 64, 1104)
    q_pos = torch.tensor([1098, 700], dtype=torch.int32, device=dev)[:, None] \
        + torch.arange(5, dtype=torch.int32, device=dev)
    out = ma._launch(*args, q_pos.contiguous(), None, 0, 192 ** -0.5, split)
    torch.cuda.synchronize()
    ref = ma.mla_attention_plain(*args, q_pos, scale=192 ** -0.5)
    err = (out - ref).abs().max().item()
    assert err <= MLA_REL_TOL * ref.abs().max().item(), err


def test_mla_kernel_refuses_what_it_does_not_instantiate(dev):
    from repro_torch.kernels import mla_attention as ma
    z = torch.zeros
    qp = z(1, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="SHAPES|R, Rr"):     # rank 64
        ma.mla_attention(z(1, 1, 4, 64, device=dev), z(1, 1, 4, 16,
                                                        device=dev),
                         z(1, 8, 64, device=dev), z(1, 8, 16, device=dev),
                         qp, scale=1.0)
    with pytest.raises(ValueError, match="float32"):          # bf16 q_lat
        ma.mla_attention(z(1, 1, 4, 32, device=dev, dtype=torch.bfloat16),
                         z(1, 1, 4, 16, device=dev), z(1, 8, 32, device=dev),
                         z(1, 8, 16, device=dev), qp, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        ma.mla_attention(z(1, 1, 8, 32, device=dev)[:, :, ::2],
                         z(1, 1, 4, 16, device=dev), z(1, 8, 32, device=dev),
                         z(1, 8, 16, device=dev), qp, scale=1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,s,dqk,dv,d", [(4, 61, 48, 32, 64),
                                          (16, 200, 192, 128, 192)])
def test_flash_kernel_explicit_scale_at_mla_widths(dev, dtype, h, s, dqk, dv,
                                                   d):
    """MLA's naive prefill: q and k zero-padded from 48 to 64 (smoke) and v
    from 32 / 128 to the q/k width, H = KVH, scale 1/sqrt(unpadded)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(81)
    q = F.pad(_randn(rng, (1, h, s, dqk), dtype, dev), (0, d - dqk))
    k = F.pad(_randn(rng, (1, h, s, dqk), dtype, dev), (0, d - dqk))
    v = F.pad(_randn(rng, (1, h, s, dv), dtype, dev), (0, d - dv))
    out = fa.flash_attention(q, k, v, scale=dqk ** -0.5)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, scale=dqk ** -0.5)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert not out[..., dv:].any()                # padded v columns stay 0


def test_flash_kernel_default_scale_keeps_its_bits(dev):
    """Without ``scale=`` every earlier flash shape gives the bits of the
    kernel before the argument existed (``chip_smoke.FLASH_BITS_SHA``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.flash_bits() == cs.FLASH_BITS_SHA


def test_deepseek_smoke_on_card_matches_cpu(dev):
    """deepseek-v3 smoke (float32) on the card against the CPU: prefill
    (flash, num_layers launches), decode and a [B]-start extend (the
    latent kernel, num_layers launches each) logits within 1e-3."""
    from repro_torch.kernels import mla_attention as ma
    cpu, card = _smoke_pair("deepseek-v3-671b")
    n = cpu.cfg.num_layers
    toks = torch.from_numpy(np.random.default_rng(82).integers(
        0, cpu.cfg.vocab_size, (2, 23)))
    lc, cc = cpu.model.prefill(cpu.params, {"tokens": toks}, cache_len=40)
    f0 = fa.flash_attention.launches
    lg, cg = card.model.prefill(card.params, {"tokens": toks.to(dev)},
                                cache_len=40)
    assert fa.flash_attention.launches == f0 + n
    assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    m0 = ma.mla_attention.launches
    nxt, pos = torch.tensor([[3], [4]]), torch.tensor([23, 20])
    dc, cc = cpu.model.decode_step(cpu.params, cc, nxt, pos)
    dg, cg = card.model.decode_step(card.params, cg, nxt.to(dev),
                                    pos.to(dev))
    assert (dg.cpu() - dc).abs().max().item() <= 1e-3
    ext, starts = toks[:, :5], torch.tensor([24, 21])
    ec_, _ = cpu.model.extend(cpu.params, cc, ext, starts)
    eg, _ = card.model.extend(card.params, cg, ext.to(dev), starts.to(dev))
    torch.cuda.synchronize()
    assert ma.mla_attention.launches == m0 + 2 * n
    assert (eg.cpu() - ec_).abs().max().item() <= 1e-3


# ------------------------------------------- the remaining model families --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # whisper-tiny's encoder: non-causal self-attention over 1500 frames
    dict(b=2, h=6, kvh=6, sq=1500, sk=1500, d=64, causal=False),
    # its cross-attention prefill: a 16-token prompt over 1500 frames
    dict(b=2, h=6, kvh=6, sq=16, sk=1500, d=64, causal=False),
    # zamba2-1.2b's shared block: window 4096, 32 / 32 heads, D 64, over
    # a 1024-token prompt and one past the window
    dict(b=1, h=32, kvh=32, sq=1024, sk=1024, d=64, window=4096),
    dict(b=1, h=32, kvh=32, sq=4200, sk=4200, d=64, window=4096),
])
def test_flash_kernel_family_shapes_match_plain(dev, dtype, case):
    rng = np.random.default_rng(90)
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
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,length", [("ring", 640), ("ring", 4096),
                                         ("window", 640), ("own_key", 640)])
def test_paged_kernel_masked_at_d64_g1_matches_plain(dev, dtype, case,
                                                     length):
    """zamba2's shared-block decode: the masked mode at D 64, 32 / 32
    heads (G = 1) over a wrapped ring of 640 slots and of the full
    window's 4096."""
    args, kw = _masked_inputs(np.random.default_rng(91), case, 4, dtype,
                              dev, False, length=length, d=64, h=32, kvh=32)
    out = pa.paged_attention(*args, **kw)
    torch.cuda.synchronize()
    ref = pa.paged_attention_plain(*args, **kw)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel_over_the_cross_cache_matches_plain(dev, dtype):
    """whisper's cross decode: one query over the 1500-row cross cache
    [B,1500,6,64] viewed as pages of 4 tokens (``_page_size(1500)``),
    identity table, every key read."""
    from repro_torch.models.attention import _page_size, _paged_view
    rng = np.random.default_rng(92)
    b, se, h, d = 4, 1500, 6, 64
    cross = {"k": _randn(rng, (b, se, h, d), dtype, dev),
             "v": _randn(rng, (b, se, h, d), dtype, dev)}
    kp, vp, table = _paged_view(cross, b)
    assert _page_size(se) == kp.shape[1] == 4
    q = _randn(rng, (b, h, d), dtype, dev)
    seq = torch.full((b,), se, dtype=torch.int32, device=dev)
    n0 = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, table, seq)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == n0 + 1
    ref = pa.paged_attention_plain(q, kp, vp, table, seq)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-tiny"])
def test_family_smoke_on_card_matches_cpu(dev, arch):
    """zamba2 smoke (a 75-token prompt: the shared block's ring of 64
    wraps) and whisper smoke (float32) on the card against the CPU:
    prefill and two decode steps within 1e-3, every attention call on the
    kernels (zamba2: one flash and one paged launch per shared-block
    call; whisper: encoder, self and cross prefill on flash, self and
    cross decode on the paged kernel)."""
    cpu, card = _smoke_pair(arch)
    cfg = cpu.cfg
    rng = np.random.default_rng(93)
    s = 75 if arch.startswith("zamba") else 10
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, s)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        n_flash = cfg.encoder_layers + 2 * cfg.num_layers
        n_paged = 2 * cfg.num_layers
    else:
        n_flash = n_paged = cpu.model.n_hybrid_groups()[0]
    lc, cc = cpu.model.prefill(cpu.params, batch, cache_len=96)
    f0, p0 = fa.flash_attention.launches, pa.paged_attention.launches
    lg, cg = card.model.prefill(card.params, {k: v.to(dev)
                                              for k, v in batch.items()},
                                cache_len=96)
    assert fa.flash_attention.launches == f0 + n_flash
    assert (lg.cpu() - lc).abs().max().item() <= 1e-3
    for step in range(2):
        nxt = torch.tensor([[3 + step], [4 + step]])
        pos = torch.tensor([s + step, s + step])
        dc, cc = cpu.model.decode_step(cpu.params, cc, nxt, pos)
        dg, cg = card.model.decode_step(card.params, cg, nxt.to(dev),
                                        pos.to(dev))
        assert (dg.cpu() - dc).abs().max().item() <= 1e-3
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == p0 + 2 * n_paged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(b=2, h=6, kvh=2, sq=130, sk=130, d=128),
    dict(b=1, h=4, kvh=2, sq=200, sk=200, d=64, window=40),
    dict(b=1, h=2, kvh=2, sq=70, sk=64, d=64, causal=False, kv_len=40),
    dict(b=1, h=2, kvh=1, sq=90, sk=64, d=32, q_offset=-20),  # keyless rows
    dict(b=1, h=4, kvh=4, sq=96, sk=96, d=192, scale=0.07),
    dict(b=1, h=48, kvh=1, sq=100, sk=100, d=128),
    # bf16 takes the wgmma route at every D: ragged tiles
    dict(b=1, h=4, kvh=2, sq=77, sk=77, d=32),
    dict(b=1, h=6, kvh=1, sq=150, sk=150, d=64),
    dict(b=1, h=12, kvh=2, sq=100, sk=170, d=128, kv_len=150),
    # D 192: two consumer warpgroups; an odd count of q tiles (the dQ
    # CTA's second tile is empty), a window, G 12 with hi + lo
    dict(b=1, h=2, kvh=2, sq=130, sk=150, d=192, kv_len=140, window=50),
    dict(b=1, h=12, kvh=1, sq=190, sk=190, d=192),
])
def test_flash_gradients_flow_through_the_backward_kernel(dev, dtype, case):
    """q, k and v get gradients on the card (the wrapper's autograd route),
    equal to the plain backward's within TOL of the largest gradient; a
    second and third launch of the backward on the same inputs give the
    same bits (no atomics: a resumed run replays its gradients)."""
    rng = np.random.default_rng(1)
    c = dict(case)
    b, h, kvh, sq, sk, d = (c.pop(x) for x in ("b", "h", "kvh", "sq", "sk",
                                                "d"))
    q = _randn(rng, (b, sq, h, d), dtype, dev).transpose(1, 2)
    k = _randn(rng, (b, sk, kvh, d), dtype, dev).transpose(1, 2)
    v = _randn(rng, (b, sk, kvh, d), dtype, dev).transpose(1, 2)
    do = _randn(rng, (b, h, sq, d), dtype, dev)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    n_fwd, n_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = fa.flash_attention(*leaves, **c)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    out.backward(do)
    torch.cuda.synchronize()
    assert all(t.grad is not None for t in leaves)
    assert fa.flash_attention.launches == n_fwd + 1
    assert fa.flash_attention_bwd.launches == n_bwd + 1
    o = fa.flash_attention_plain(q, k, v, **c)
    lse = fa.flash_attention_lse_plain(q, k, **c)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **c)
    for t, w in zip(leaves, want):
        scale = float(w.float().abs().max())
        assert float((t.grad.float() - w.float()).abs().max()) \
            <= TOL[dtype] * max(scale, 1.0)
    o, lse = fa.flash_attention_fwd(q, k, v, **c)
    once = fa.flash_attention_bwd(q, k, v, o, lse, do, **c)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **c)
    assert all(torch.equal(x, y) for x, y in zip(once, again))
    assert all(torch.equal(x, t.grad) for x, t in zip(once, leaves))


def test_decode_kernels_refuse_gradients_on_the_card(dev):
    q = torch.zeros((2, 4, 64), device=dev, requires_grad=True)
    pages = torch.zeros((4, 16, 2, 64), device=dev)
    table = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    seqs = torch.ones((2,), dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError, match="no backward"):
        pa.paged_attention(q, pages, pages, table, seqs)


def test_phi4_smoke_trains_on_card_as_on_cpu(dev, tmp_path):
    """Three float32 steps of the phi4-mini smoke model through
    ``train_loop`` on the card and on the CPU, both resuming from one
    checkpoint of the CPU init at step 0 (the two devices' generators
    draw different weights): losses within 1e-4 relative; the flash
    kernel's forward and backward launched (remat: two forwards a
    layer)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                      adamw_init, save_checkpoint,
                                      train_loop)
    model = build(get_config("phi4-mini-3.8b", smoke=True).with_(
        vocab_size=128))
    params = model.init(0, "cpu")
    save_checkpoint(str(tmp_path), {"params": params,
                                    "opt_state": adamw_init(params)}, 0)
    kw = dict(oc=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3),
              dc=SyntheticDataConfig(batch=2, seq_len=16), num_steps=3,
              log_every=0, ckpt_dir=str(tmp_path), resume=True)
    n_fwd, n_bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    card = train_loop(model, device=dev, **kw)
    layers = model.cfg.num_layers
    assert fa.flash_attention.launches - n_fwd == 3 * 2 * layers
    assert fa.flash_attention_bwd.launches - n_bwd == 3 * layers
    cpu = train_loop(model, device="cpu", **kw)
    np.testing.assert_allclose(card["loss_curve"], cpu["loss_curve"],
                               rtol=1e-4)


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(_tree(v, fn) for v in t)
    return fn(t)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_host_mesh_step_on_card_matches_cpu(dev, shape):
    """``launch.steps``' step of qwen2-vl smoke (float32) on the 1x1 CUDA
    mesh, DTensor params / batch / cache and the kernels under
    ``local_map``, against the same step on the CPU's plain tensors:
    logits (or the loss) within 1e-3 of their scale."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (build_step, distribute_args,
                                          materialize, run_step)
    cut = {"train_4k": dict(global_batch=2, seq_len=64),
           "prefill_32k": dict(global_batch=1, seq_len=96),
           "decode_32k": dict(global_batch=4, seq_len=80),
           "long_500k": dict(global_batch=1, seq_len=300)}[shape]
    spec = build_step("qwen2-vl-2b", shape, make_host_mesh(dev), smoke=True,
                      **cut)
    args = materialize(spec, 0, "cpu")
    want = spec.step(*_tree(args, torch.clone))
    n0 = fa.flash_attention.launches + pa.paged_attention.launches
    got = run_step(spec, distribute_args(spec, _tree(args,
                                                     lambda t: t.to(dev))))
    assert fa.flash_attention.launches + pa.paged_attention.launches > n0
    i = 2 if shape == "train_4k" else 0
    g = got[i].full_tensor().cpu()
    scale = max(1.0, float(want[i].abs().max()))
    assert float((g - want[i]).abs().max()) <= 1e-3 * scale
