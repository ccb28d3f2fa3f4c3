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


def _masked_inputs(rng, case, b, dtype, dev, permute, length=1152):
    """Masked decode at the qwen2-vl-2b layout (12 / 2 heads, D 128, pages
    of 16) over a ``length``-slot ring cache: (q, k, v, table, seq_lens,
    k_pos [P, page], q_pos, window). ``ring``: positions wrapped past the
    cache; ``compacted``: 256 kept positions, -1 rows, then 32 decoded
    past a gap; ``window``: a plain cache with window 256 and no k_pos;
    ``own_key``: the query's own row is its only key; ``ahead``: every
    row read, those past the query's position masked."""
    h, kvh, d, page = 12, 2, 128, 16
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


# ----------------------------------------------- multi-query (verify) --

def _mq_inputs(rng, s, g, dtype, dev, *, permute, page=16, b=6, kvh=2,
               length=288):
    """Multi-query inputs over a ``length``-slot cache of ``b`` requests:
    (q [B,S,H,D], k/v pages, table, seq_lens, q_pos). Row starts: the
    cache's start, one block straddling each 32-token split boundary of
    the first two, a mid-cache block, a block ending at the last live
    row (L - 2), and an inactive row routed to the scratch slot
    (start = L - 1: q_pos runs past the cache and every row is read).
    Physical page table[j] holds logical page j."""
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
    q9 = torch.zeros((q.shape[0], 9) + q.shape[2:], dtype=q.dtype,
                     device=dev)
    with pytest.raises(ValueError):        # S = 9 > 8
        pa.paged_attention(q9, kp, vp, table, seq,
                           q_pos=torch.zeros(q9.shape[:2], dtype=torch.int32,
                                             device=dev))
    q16 = torch.zeros((q.shape[0], 5, 32, 64), dtype=q.dtype, device=dev)
    kp16 = torch.zeros(kp.shape[:3] + (64,), dtype=q.dtype, device=dev)
    with pytest.raises(ValueError):        # 5 tokens x 16 heads > 64 rows
        pa.paged_attention(q16, kp16, kp16, table, seq,
                           q_pos=torch.zeros(q16.shape[:2],
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
