"""The split-KV decode algorithm on the CPU against the JAX reference.

``paged_attention_split_plain`` is the paged kernel's algorithm in plain
PyTorch: partial softmaxes over runs of ``split_tokens`` tokens, then a
merge. It must equal the one-pass plain version and the Pallas kernel
(interpret mode) on the same numpy inputs, at split sizes that divide the
table and that do not, with permuted tables, a page of 5, seq_len 0 and
splits that lie wholly past seq_len; and the split the wrapper chooses
from the shape (``split_tokens``) at each route, at 48 / 1 and 12 / 1
heads (granite-34b's and nemotron-4-340b's groups). Tolerance 1e-5:
float32 on both sides, sums in another order.
"""
import inspect

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
@pytest.mark.parametrize("h,kvh", [(4, 2), (6, 1), (48, 1), (12, 1)])
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


# (dtype, G, D, S) -> the split the wrapper gives the kernel
SPLIT_CASES = [
    # bf16 at G <= 16 and D <= 128 keeps the FMA kernel's one chunk (the
    # main path: qwen2-vl-2b's G 6)
    ((torch.bfloat16, 6, 128, 0), pa.CHUNK),
    ((torch.bfloat16, 16, 64, 0), pa.CHUNK),
    ((torch.bfloat16, 1, 32, 0), pa.CHUNK),
    ((torch.bfloat16, 6, 128, 1), pa.CHUNK),
    # float32 keeps the FMA kernel at every shape
    ((torch.float32, 48, 128, 0), pa.CHUNK),
    ((torch.float32, 12, 192, 1), pa.CHUNK),
    # the multi-query mode with S >= 2, as before
    ((torch.bfloat16, 6, 128, 5), pa.MQ_SPLIT),
    ((torch.bfloat16, 48, 128, 9), pa.MQ_SPLIT),
    ((torch.float32, 12, 192, 2), pa.MQ_SPLIT),
    # the tensor-core route with one query a request: the swept values
    ((torch.bfloat16, 48, 128, 0), pa.TC_SPLIT[128]),
    ((torch.bfloat16, 48, 128, 1), pa.TC_SPLIT[128]),
    ((torch.bfloat16, 12, 192, 0), pa.TC_SPLIT[192]),
    ((torch.bfloat16, 12, 192, 1), pa.TC_SPLIT[192]),
    ((torch.bfloat16, 1, 192, 0), pa.TC_SPLIT[192]),
    ((torch.bfloat16, 17, 64, 0), pa.TC_SPLIT[64]),
    ((torch.bfloat16, 48, 32, 0), pa.TC_SPLIT[32]),
]


@pytest.mark.parametrize("args,want", SPLIT_CASES,
                         ids=[f"{str(a[0])[6:]}-g{a[1]}-d{a[2]}-s{a[3]}"
                              for a, _ in SPLIT_CASES])
def test_split_tokens_follows_the_route(args, want):
    """``split_tokens`` is a function of (dtype, G, D, S) alone -- it takes
    no seq_lens, so a launch's grid never depends on the data -- and
    gives CHUNK wherever the FMA kernel runs, MQ_SPLIT with S >= 2 and
    TC_SPLIT where the tensor-core kernel takes one query a request."""
    assert set(inspect.signature(pa.split_tokens).parameters) == {
        "dtype", "g", "d", "s"}
    assert pa.split_tokens(*args) == want
    tc = args[0] == torch.bfloat16 and (args[3] >= 2 or args[1] > 16
                                        or args[2] == 192)
    assert pa.route(*args) == ("mma" if tc else "fma")


TC_PPS = 60                      # a 300-token table of 5-token pages


@pytest.mark.parametrize("split", sorted(set(pa.TC_SPLIT.values())))
@pytest.mark.parametrize("seqs", sorted(SEQS))
@pytest.mark.parametrize("h,kvh", [(48, 1), (12, 1)])
def test_chosen_split_matches_plain_and_pallas(split, seqs, h, kvh):
    """Each split the tensor-core route takes, over a permuted table long
    enough to hold several of them: the file's SEQS edges (seq_len 0, 1,
    one inside a split, the full table) scaled to that table."""
    q, kp, vp, table = _inputs(11, 4, h, kvh, 16, PAGE, TC_PPS, True)
    seq = SEQS[seqs].copy()
    if seq.any():                # "mixed": 0, 1, inside a split, full
        seq[2:] = split + 17, PAGE * TC_PPS
    want = np.asarray(jpaged(jnp.asarray(q), jnp.asarray(kp),
                             jnp.asarray(vp), jnp.asarray(table),
                             jnp.asarray(seq), interpret=True))
    got = pa.paged_attention_split_plain(*_torch(q, kp, vp, table, seq),
                                         split)
    one_pass = pa.paged_attention_plain(*_torch(q, kp, vp, table, seq))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), rtol=0,
                               atol=TOL)
