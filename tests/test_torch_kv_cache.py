"""The port's KV-cache library against the JAX reference.

The same numpy inputs go through each reference function of
``repro.core.kv_cache`` and its port in ``repro_torch.core.kv_cache``:
selectors keep identical positions (int32) and gather K/V exactly, with and
without caller positions and on tied scores (streaming's ``inf`` sinks,
uniform attention, equal key norms); the budget allocators give identical
lists; D2O merges within 1e-5 and CHAI's head assignment is identical; the
host structures (block allocator, paged pool, radix prefix tree, tiered
store) give the same results for the same operation sequences. The paged
kernel's masked plain version is held against the reference's
``simple_sdpa`` on windowed and compacted caches within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.kv_cache import budget as jbudget
from repro.core.kv_cache import merging as jmerging
from repro.core.kv_cache import paged as jpaged
from repro.core.kv_cache import prefix_cache as jprefix
from repro.core.kv_cache import selection as jsel
from repro.core.kv_cache import tiered as jtiered
from repro.models.attention import simple_sdpa as jsimple_sdpa
from repro_torch.core.kv_cache import budget as tbudget
from repro_torch.core.kv_cache import merging as tmerging
from repro_torch.core.kv_cache import paged as tpaged
from repro_torch.core.kv_cache import prefix_cache as tprefix
from repro_torch.core.kv_cache import selection as tsel
from repro_torch.core.kv_cache import tiered as ttiered
from repro_torch.kernels import paged_attention as tpa

ATOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kv(kind, b=2, s=40, h=2, d=8, seed=0):
    """k, v [B,S,H,D] float32. ``tied``: every key row is a signed basis
    vector, so every key norm is exactly 1 (all l2 scores tie)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    if kind == "random":
        return rng.standard_normal((b, s, h, d)).astype(np.float32), v
    k = np.zeros((b, s, h, d), np.float32)
    hot = rng.integers(0, d, (b, s, h))
    sign = rng.choice([-1.0, 1.0], (b, s, h))
    np.put_along_axis(k, hot[..., None], sign[..., None], axis=-1)
    return k, v


def _attn(kind, b=2, hq=4, s=40, seed=1):
    """[B,Hq,S,S] attention probabilities: softmax of random scores, or
    uniform (every accumulated score ties)."""
    if kind == "tied":
        return np.full((b, hq, s, s), 1.0 / s, np.float32)
    x = np.random.default_rng(seed).standard_normal((b, hq, s, s))
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("with_pos", [False, True])
@pytest.mark.parametrize("name", sorted(jsel.SELECTORS))
def test_selector_matches_reference(name, with_pos, kind):
    k, v = _kv(kind)
    attn = _attn(kind)
    budget = 13
    pos = (np.arange(40, dtype=np.int32) * 3 + 5) if with_pos else None
    jk, jv, jp = jsel.SELECTORS[name](
        jnp.asarray(k), jnp.asarray(v), budget=budget, attn=jnp.asarray(attn),
        pos=None if pos is None else jnp.asarray(pos))
    tk, tv, tp = tsel.SELECTORS[name](
        torch.from_numpy(k), torch.from_numpy(v), budget=budget,
        attn=torch.from_numpy(attn),
        pos=None if pos is None else torch.from_numpy(pos))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(_np(tp), np.asarray(jp))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))


def test_selector_keeps_bfloat16_and_layers_as_batch():
    """The engine's call: a slot's layers as the batch axis, bf16 caches,
    one position vector. Kept positions equal the reference's per-layer
    (vmapped) call on the same bf16 values."""
    k, v = _kv("random", b=3, s=24)
    pos = np.arange(24, dtype=np.int32)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    jk = jnp.asarray(k, jnp.bfloat16)
    for name in ("streaming", "l2"):
        _, _, tp = tsel.SELECTORS[name](tk, tk, budget=9,
                                        pos=torch.from_numpy(pos))
        for layer in range(3):
            _, _, jp = jsel.SELECTORS[name](jk[layer:layer + 1],
                                            jk[layer:layer + 1], budget=9,
                                            pos=jnp.asarray(pos))
            np.testing.assert_array_equal(_np(tp)[layer], np.asarray(jp)[0])


def test_oracle_topk_matches_reference():
    for kind in ("random", "tied"):
        a = _attn(kind)
        want = jsel.oracle_topk(jnp.asarray(a), 11)
        got = tsel.oracle_topk(torch.from_numpy(a), 11)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("total,layers", [(64, 1), (1000, 28), (4096, 48),
                                          (100, 30), (7, 4)])
def test_budget_allocators_match_reference(total, layers):
    scores = list(np.random.default_rng(total).random(layers))
    assert tbudget.uniform_budgets(total, layers) == \
        jbudget.uniform_budgets(total, layers)
    assert tbudget.pyramid_budgets(total, layers) == \
        jbudget.pyramid_budgets(total, layers)
    assert tbudget.adaptive_budgets(total, scores, temperature=0.5) == \
        jbudget.adaptive_budgets(total, scores, temperature=0.5)


def test_cake_layer_scores_match_reference():
    attns = [_attn("random", b=1, hq=2, s=16, seed=i) for i in range(4)]
    want = jbudget.cake_layer_scores([jnp.asarray(a) for a in attns])
    got = tbudget.cake_layer_scores([torch.from_numpy(a) for a in attns])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("threshold", [0.5, 0.0, -1.0])
def test_d2o_merge_matches_reference(threshold):
    k, v = _kv("random", b=2, s=24, h=2, d=8, seed=4)
    keep = np.sort(np.stack([np.random.default_rng(i).choice(24, 10, False)
                             for i in range(2)]), -1).astype(np.int32)
    jk, jv, jinfo = jmerging.d2o_merge(jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(keep), threshold=threshold)
    tk, tv, tinfo = tmerging.d2o_merge(torch.from_numpy(k),
                                       torch.from_numpy(v),
                                       torch.from_numpy(keep),
                                       threshold=threshold)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=ATOL, rtol=0)
    assert abs(float(tinfo["merged_frac"]) - float(jinfo["merged_frac"])) \
        <= ATOL


@pytest.mark.parametrize("clusters", [1, 3, 8])
def test_chai_matches_reference(clusters):
    attn = _attn("random", b=1, hq=8, s=12, seed=7)
    ja, jinfo = jmerging.chai_cluster(jnp.asarray(attn), clusters)
    ta, tinfo = tmerging.chai_cluster(torch.from_numpy(attn), clusters)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    assert [int(r) for r in tinfo["reps"]] == [int(r) for r in jinfo["reps"]]
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 12, 8, 16)).astype(np.float32)
               for _ in range(3))
    want = jmerging.chai_shared_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), ja, jinfo["reps"])
    got = tmerging.chai_shared_attention(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), ta,
                                         tinfo["reps"])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------- paged --

def _alloc_ops(mod):
    """One operation sequence on an allocator; returns what it observed."""
    a = mod.BlockAllocator(num_blocks=6, block_size=4)
    seen = [a.alloc() for _ in range(4)]
    a.share(seen[1])
    a.free(seen[1])
    a.free(seen[2])
    seen += [a.alloc(), a.alloc(), a.alloc(), a.num_free, a.utilization(),
             a.blocks_for_tokens(9)]
    try:
        a.alloc()
        a.alloc()
    except mod.OutOfBlocksError:
        seen.append("oom")
    return seen, list(a.free_list), a.ref.tolist()


def test_block_allocator_matches_reference():
    assert _alloc_ops(tpaged) == _alloc_ops(jpaged)


def test_paged_pool_matches_reference():
    rng = np.random.default_rng(0)
    layers, s = 2, 10
    pk, pv = (rng.standard_normal((layers, s, 2, 8)).astype(np.float32)
              for _ in range(2))
    kt, vt = (rng.standard_normal((layers, 2, 8)).astype(np.float32)
              for _ in range(2))
    ids = [5, 2, 7]
    jpool = jpaged.PagedKVPool(layers, 8, 4, 2, 8)
    tpool = tpaged.PagedKVPool(layers, 8, 4, 2, 8, device="cpu")
    jseq, tseq = jpaged.SeqBlocks(list(ids)), tpaged.SeqBlocks(list(ids))
    jpool.write_prefill(jseq, jnp.asarray(pk), jnp.asarray(pv))
    tpool.write_prefill(tseq, torch.from_numpy(pk), torch.from_numpy(pv))
    jpool.append_token(jseq, jnp.asarray(kt), jnp.asarray(vt))
    tpool.append_token(tseq, torch.from_numpy(kt), torch.from_numpy(vt))
    assert tseq.length == jseq.length == s + 1
    np.testing.assert_array_equal(_np(tpool.k), np.asarray(jpool.k))
    np.testing.assert_array_equal(_np(tpool.v), np.asarray(jpool.v))
    for layer in range(layers):
        for t, j in zip(tpool.gather(tseq, layer), jpool.gather(jseq, layer)):
            np.testing.assert_array_equal(_np(t), np.asarray(j))
    seqs = [(5, [0, 1]), (4, [2]), (11, [3, 4, 6])]
    assert tpaged.fragmentation_waste(
        [tpaged.SeqBlocks(b, n) for n, b in seqs], 4) == \
        jpaged.fragmentation_waste([jpaged.SeqBlocks(b, n) for n, b in seqs],
                                   4)


def _radix_ops(paged, prefix):
    """Match, insert (with an edge split), variant namespacing, pins and
    LRU eviction on one radix cache; returns everything it observed."""
    alloc = paged.BlockAllocator(num_blocks=64, block_size=4)
    cache = prefix.RadixPrefixCache(alloc)
    sys_prompt = list(range(100, 116))
    blocks = [alloc.alloc() for _ in range(4)]
    cache.insert(sys_prompt, blocks, block_size=4)
    out = []
    got, n, pinned = cache.match_prefix(sys_prompt + [1, 2, 3])
    out.append((got, n, len(pinned)))
    cache.unpin(pinned)
    got, n, pinned = cache.match_prefix(sys_prompt[:8] + [7] * 8)  # split
    out.append((got, n, len(pinned)))
    other = [alloc.alloc() for _ in range(4)]
    cache.insert(sys_prompt[:8] + [9] * 8, other, block_size=4)
    cache.insert(sys_prompt, [alloc.alloc() for _ in range(4)],
                 block_size=4, variant="fastv-0.5")
    out.append(cache.match_prefix(sys_prompt, variant="fastv-0.5")[:2])
    out.append(cache.match_prefix(sys_prompt, variant="l2-0.5")[:2])
    out.append(cache.stats())
    out.append(cache.evict(2))           # the split's pinned top survives
    cache.unpin(pinned)
    out.append(cache.evict(3))
    out.append((cache.stats(), alloc.num_free, alloc.ref.tolist()))
    out.append(cache.evict(100))
    out.append((cache.stats(), alloc.num_free, cache.hits, cache.misses,
                cache.hit_tokens, cache.total_tokens))
    return out


def test_radix_prefix_cache_matches_reference():
    assert _radix_ops(tpaged, tprefix) == _radix_ops(jpaged, jprefix)


@pytest.mark.parametrize("index", ["mean", "kmeans", "pq"])
def test_tiered_store_matches_reference(index):
    def run(mod):
        store = mod.TieredKVStore(block_size=4, num_kv_heads=2, head_dim=8,
                                  hbm_capacity_blocks=3, index=index)
        rng = np.random.default_rng(3)
        for i in range(9):
            store.insert_block(i, rng.standard_normal((4, 2, 8)
                                                      ).astype(np.float32),
                               rng.standard_normal((4, 2, 8)
                                                   ).astype(np.float32))
        out = []
        for _ in range(3):
            q = rng.standard_normal((2, 8)).astype(np.float32)
            top, ks, vs = store.fetch_topk(q, k=3)
            out.append((top, ks.tolist(), vs.tolist()))
        return out, store.residency(), dataclasses.asdict(store.stats), \
            store.stats.transfer_seconds()
    assert run(ttiered) == run(jtiered)


def test_prefetch_schedule_matches_reference():
    for kw in (dict(compute_us_per_step=100.0, fetch_us_per_block=20.0,
                    blocks_per_step=4, steps=10),
               dict(compute_us_per_step=10.0, fetch_us_per_block=40.0,
                    blocks_per_step=2, steps=7)):
        for overlap in (True, False):
            assert ttiered.prefetch_schedule(**kw, overlap=overlap) == \
                jtiered.prefetch_schedule(**kw, overlap=overlap)


# ------------------------------------------------------- masked paged --

def _masked_case(case, rng, b=3, length=48, kvh=2, g=3, d=16):
    """A decode's cache and positions: (q, k, v [B,L,K,D], slot_pos [B,L],
    q_pos [B], seq_lens [B], window). ``ring``: positions wrapped past L;
    ``compacted``: a budget of kept positions then -1 rows and decode
    writes past a gap; ``window``: a plain cache with a window;
    ``ahead``: every row read, some holding positions past the query's
    (rows written ahead of it, as a rolled-back verify leaves them)."""
    q = rng.standard_normal((b, kvh * g, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, length, kvh, d)).astype(np.float32)
            for _ in range(2))
    sp = np.full((b, length), -1, np.int32)
    window = 0
    if case == "window":
        q_pos = np.array([10, 30, length - 1], np.int32)
        sp, window = None, 12
    elif case == "ring":
        q_pos = np.array([length + 5, 3 * length - 1, length - 1], np.int32)
        for i, qp in enumerate(q_pos):
            p = np.arange(max(0, qp - length + 1), qp + 1)
            sp[i, p % length] = p
        window = length
    elif case == "ahead":
        q_pos = np.array([7, 30, 46], np.int32)
        sp[:] = np.arange(length, dtype=np.int32)
        return q, k, v, sp, q_pos, np.full(b, length, np.int32), 0
    else:
        q_pos = np.array([40, 29, 20], np.int32)
        for i, qp in enumerate(q_pos):
            kept = np.sort(rng.choice(qp - 4, 12, replace=False))
            sp[i, :12] = kept                   # compacted to 12 of qp - 4
            sp[i, qp - 4:qp + 1] = np.arange(qp - 4, qp + 1)  # decoded
    return q, k, v, sp, q_pos, np.minimum(q_pos + 1, length).astype(
        np.int32), window


@pytest.mark.parametrize("case", ["ring", "compacted", "window", "ahead"])
def test_masked_paged_plain_matches_reference_sdpa(case):
    rng = np.random.default_rng(11)
    q, k, v, sp, q_pos, seq_lens, window = _masked_case(case, rng)
    b, length, kvh, d = k.shape
    g = q.shape[1] // kvh
    k_pos = sp if sp is not None else np.broadcast_to(
        np.arange(length, dtype=np.int32), (b, length))
    want = jsimple_sdpa(jnp.asarray(q).reshape(b, 1, kvh, g, d),
                        jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(q_pos)[:, None],
                        k_pos=jnp.asarray(k_pos), causal=True, window=window)
    page = 8
    n_pages = b * length // page
    seq_lens = torch.from_numpy(seq_lens)
    logical = [torch.from_numpy(x).reshape(n_pages, page, *x.shape[2:])
               for x in (k, v)]
    if sp is not None:
        logical.append(torch.from_numpy(sp).reshape(n_pages, page))
    ident = torch.arange(n_pages, dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(n_pages).astype(np.int32))
    for table in (ident, perm):
        # physical page table[j] holds logical page j
        phys = []
        for x in logical:
            y = torch.empty_like(x)
            y[table.long()] = x
            phys.append(y)
        kw = dict(q_pos=torch.from_numpy(q_pos), window=window,
                  k_pos=phys[2] if sp is not None else None)
        args = (torch.from_numpy(q), phys[0], phys[1], table.view(b, -1),
                seq_lens)
        outs = [tpa.paged_attention(*args, **kw)] + [
            tpa.paged_attention_split_plain(*args, split, **kw)
            for split in (1, 7, 32)]
        for got in outs:
            np.testing.assert_allclose(_np(got),
                                       np.asarray(want).reshape(b, -1, d),
                                       atol=ATOL, rtol=0)


def test_masked_paged_row_without_key_is_the_mean_of_its_read_rows():
    """A row whose read tokens are all masked (decode always writes the
    query's own key first, so the model never launches one): the plain
    versions give the mean of V over the row's seq_len tokens."""
    rng = np.random.default_rng(12)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 8, 2, 16)
                                                 ).astype(np.float32))
            for _ in range(2))
    table = torch.arange(4, dtype=torch.int32)[None]
    k_pos = torch.full((4, 8), -1, dtype=torch.int32)
    seq = torch.tensor([20], dtype=torch.int32)
    want = v.reshape(32, 2, 16)[:20].mean(0).repeat_interleave(2, 0)
    for got in (tpa.paged_attention(q, k, v, table, seq, k_pos=k_pos,
                                    q_pos=torch.tensor([19],
                                                       dtype=torch.int32)),
                tpa.paged_attention_split_plain(
                    q, k, v, table, seq, 7, k_pos=k_pos,
                    q_pos=torch.tensor([19], dtype=torch.int32))):
        np.testing.assert_allclose(_np(got)[0], _np(want), atol=ATOL, rtol=0)


def test_masked_paged_refuses_what_it_cannot_mask():
    from repro_torch.kernels import ops
    q = torch.zeros(1, 2, 16)
    pages = torch.zeros(2, 8, 2, 16)
    table = torch.zeros(1, 2, dtype=torch.int32)
    seq = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="needs q_pos"):
        ops.paged_attention(q, pages, pages, table, seq,
                            k_pos=torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs q_pos"):
        ops.paged_attention(q, pages, pages, table, seq, window=4)
    with pytest.raises(ValueError, match=r"k_pos must be \[P, page\]"):
        ops.paged_attention(q, pages, pages, table, seq,
                            k_pos=torch.zeros(16, dtype=torch.int32),
                            q_pos=seq)
