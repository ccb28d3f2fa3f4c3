"""The split-KV decode algorithm on the CPU against the JAX reference.

``paged_attention_split_plain`` is the paged kernel's algorithm in plain
PyTorch: partial softmaxes over runs of ``split_tokens`` tokens, then a
merge. It must equal the one-pass plain version and the Pallas kernel
(interpret mode) on the same numpy inputs, at split sizes that divide the
table and that do not, with permuted tables, a page of 5, seq_len 0 and
splits that lie wholly past seq_len. Tolerance 1e-5: float32 on both
sides, sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.kernels import paged_attention as pa

TOL = 1e-5


def _inputs(seed, b, h, kvh, d, page, pps, permuted):
    rng = np.random.default_rng(seed)
    p_total = b * pps + 2
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((p_total, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((p_total, page, kvh, d)).astype(np.float32)
    ids = rng.permutation(p_total)[:b * pps] if permuted \
        else np.arange(b * pps)
    return q, kp, vp, ids.reshape(b, pps).astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


PAGE, PPS = 5, 6                 # a 30-token table
SEQS = {
    # request 0: empty (mean of V); 1: one token, so every split after the
    # first lies wholly past seq_len; 2: ends inside a page and a split;
    # 3: the full table
    "mixed": np.array([0, 1, 17, PAGE * PPS], np.int32),
    "all_empty": np.array([0, 0, 0, 0], np.int32),
}


@pytest.mark.parametrize("split", [PAGE, 3 * PAGE, PAGE * PPS],
                         ids=["one_page", "three_pages", "whole_table"])
@pytest.mark.parametrize("seqs", sorted(SEQS))
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("h,kvh", [(4, 2), (6, 1)])
def test_split_matches_plain_and_pallas(split, seqs, permuted, h, kvh):
    q, kp, vp, table = _inputs(7, 4, h, kvh, 32, PAGE, PPS, permuted)
    seq = SEQS[seqs]
    want = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(table),
                             jnp.asarray(seq), interpret=True))
    got = pa.paged_attention_split_plain(*_torch(q, kp, vp, table, seq),
                                         split)
    one_pass = pa.paged_attention_plain(*_torch(q, kp, vp, table, seq))
    assert got.shape == (4, h, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("split", [1, 7, 32])
def test_split_of_any_token_count(split):
    """The kernel's split need not be a page multiple (its default is 32
    tokens against pages of 16)."""
    q, kp, vp, table = _inputs(8, 3, 4, 2, 64, 16, 4, True)
    seq = np.array([63, 40, 0], np.int32)
    got = pa.paged_attention_split_plain(*_torch(q, kp, vp, table, seq),
                                         split)
    want = pa.paged_attention_plain(*_torch(q, kp, vp, table, seq))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_empty_request_is_mean_of_v_after_merge():
    """seq_len 0: every split scores at the sentinel, so all partials share
    one max and the merge averages V over the whole table."""
    q, kp, vp, table = _inputs(9, 1, 2, 1, 32, PAGE, PPS, True)
    got = pa.paged_attention_split_plain(
        *_torch(q, kp, vp, table), torch.zeros(1, dtype=torch.int32),
        2 * PAGE)
    mean_v = vp[table[0]].reshape(-1, 32).mean(0)
    np.testing.assert_allclose(got.numpy()[0], np.stack([mean_v] * 2),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("seqs", [
    [100, 127, 3, 128],          # the main path's mix: long, short, full
    [31, 32, 33, 65],            # at and across chunk boundaries
    [0, 64, 0, 97],              # empty requests beside split-aligned ones
    [1, 1, 1, 1],                # every split but the first is empty
])
def test_wrapper_split_at_the_decode_head_layout(seqs):
    """The split the wrapper gives the kernel (one chunk of ``CHUNK``
    tokens) at qwen2-vl-2b's head layout (12 q / 2 kv heads, pages of 16),
    on a permuted 128-token table, against the Pallas kernel."""
    q, kp, vp, table = _inputs(10, 4, 12, 2, 64, 16, 8, True)
    seq = np.array(seqs, np.int32)
    want = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(table),
                             jnp.asarray(seq), interpret=True))
    got = pa.paged_attention_split_plain(*_torch(q, kp, vp, table, seq),
                                         pa.CHUNK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
