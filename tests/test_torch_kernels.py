"""The port's kernel modules on the CPU against the JAX reference.

On CPU tensors each wrapper runs its plain version; these tests hold that
version against the Pallas kernel (interpret mode, as the reference's own
tests run it) and the reference oracles, on the same numpy inputs. The
CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance 2e-5: both sides compute in float32; softmax sums run in
another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.paged_attention import paged_attention as jpaged
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref

TOL = 2e-5


def _close(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    assert np.abs(j - t).max() <= TOL * max(1.0, float(np.abs(j).max()))


def _qkv(seed, b, h, kvh, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32),
            rng.standard_normal((b, kvh, sk, d)).astype(np.float32))


FLASH_CASES = [
    # (b, h, kvh, sq, sk, d, kwargs)
    (1, 2, 2, 40, 40, 64, dict()),                          # G = 1
    (2, 4, 2, 40, 40, 64, dict()),                          # G = 2
    (1, 4, 2, 150, 150, 64, dict(window=32)),
    (1, 4, 2, 20, 150, 64, dict(kv_len=130)),               # default offset
    (1, 4, 2, 16, 150, 64, dict(kv_len=140, q_offset=100)),
    (1, 2, 1, 30, 60, 128, dict(causal=False, kv_len=45)),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(case):
    b, h, kvh, sq, sk, d, kw = case
    q, k, v = _qkv(0, b, h, kvh, sq, sk, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  interpret=True, **kw)
    fa.flash_attention.launches = 0
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **kw)
    _close(want, got)
    assert fa.flash_attention.launches == 0        # CPU: no kernel launch


@pytest.mark.parametrize("kw", [dict(), dict(kv_len=50), dict(window=16),
                                dict(kv_len=60, window=8)])
def test_flash_ref_matches_reference_oracle(kw):
    q, k, v = _qkv(1, 2, 4, 2, 24, 64, 64)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    _close(want, got)


def test_flash_resolves_offsets_like_pallas():
    assert fa.resolve_offsets(16, 100, True, None, 0) == (100, 84)
    assert fa.resolve_offsets(16, 100, True, 50, 0) == (50, 34)
    assert fa.resolve_offsets(16, 100, True, 50, 7) == (50, 7)
    assert fa.resolve_offsets(16, 100, False, None, 0) == (100, 0)
    assert fa.resolve_offsets(120, 100, True, None, 0) == (100, 0)


def _paged_inputs(seed, b, h, kvh, d, page, pps, permuted):
    rng = np.random.default_rng(seed)
    p_total = b * pps + 3
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((p_total, page, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((p_total, page, kvh, d)).astype(np.float32)
    ids = rng.permutation(p_total)[:b * pps] if permuted \
        else np.arange(b * pps)
    return q, kp, vp, ids.reshape(b, pps).astype(np.int32)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
@pytest.mark.parametrize("permuted", [False, True])
def test_paged_plain_matches_pallas_kernel(h, kvh, permuted):
    q, kp, vp, table = _paged_inputs(2, 3, h, kvh, 64, 8, 4, permuted)
    seq = np.array([0, 13, 32], np.int32)          # includes seq_len == 0
    want = jpaged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(table), jnp.asarray(seq), interpret=True)
    pa.paged_attention.launches = 0
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(table),
                             torch.from_numpy(seq))
    _close(want, got)
    assert pa.paged_attention.launches == 0


def test_paged_seq_len_zero_is_mean_of_v():
    """The parity hazard: an empty request averages V over its table."""
    q, kp, vp, table = _paged_inputs(3, 1, 2, 1, 64, 4, 3, True)
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                             torch.from_numpy(vp), torch.from_numpy(table),
                             torch.zeros(1, dtype=torch.int32))
    mean_v = vp[table[0]].reshape(-1, 1, 64).mean(0)        # [KVH, D]
    np.testing.assert_allclose(got.numpy()[0], np.repeat(mean_v, 2, 0),
                               rtol=1e-5, atol=1e-5)


def test_paged_ref_matches_reference_oracle():
    q, kp, vp, table = _paged_inputs(4, 2, 4, 2, 32, 4, 5, True)
    seq = np.array([7, 20], np.int32)
    want = jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(table),
                                    jnp.asarray(seq))
    got = tref.paged_attention_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                   torch.from_numpy(vp),
                                   torch.from_numpy(table),
                                   torch.from_numpy(seq))
    _close(want, got)


def test_rmsnorm_ref_matches_reference_oracle():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s)),
           tref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(s)))


@pytest.mark.parametrize("bad", [
    lambda z: ops.flash_attention(z(1, 2, 4, 8), z(1, 2, 4, 8), z(1, 2, 4)),
    lambda z: ops.flash_attention(z(1, 2, 4, 8), z(1, 2, 4, 8), z(1, 2, 5, 8)),
    lambda z: ops.flash_attention(z(1, 3, 4, 8), z(1, 2, 4, 8), z(1, 2, 4, 8)),
    lambda z: ops.paged_attention(z(2, 4, 8), z(3, 4, 2, 8), z(3, 4, 2, 8),
                                  z(1, 3).int(), z(2).int()),
    lambda z: ops.paged_attention(z(2, 3, 8), z(3, 4, 2, 8), z(3, 4, 2, 8),
                                  z(2, 3).int(), z(2).int()),
])
def test_ops_shape_checks(bad):
    with pytest.raises(ValueError):
        bad(torch.zeros)


def test_flash_views_equal_contiguous_copies():
    """The model passes [B,S,N,D] tensors and a cache prefix as transposed
    views; the result must not depend on the layout."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((2, 40, 4, 64)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 64, 2, 64))
                             .astype(np.float32))
    qv, kv = q.transpose(1, 2), cache[:, :50].transpose(1, 2)
    assert not qv.is_contiguous() and not kv.is_contiguous()
    got = fa.flash_attention(qv, kv, kv, kv_len=50, q_offset=10)
    want = fa.flash_attention(qv.contiguous(), kv.contiguous(),
                              kv.contiguous(), kv_len=50, q_offset=10)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_strides(dtype):
    """What the card's wrapper hands the kernel: element strides (b, head,
    seq), checked to be positive multiples of 16 bytes (TMA's rule)."""
    x = torch.zeros(2, 40, 4, 64, dtype=dtype)
    assert fa._strides("q", x.transpose(1, 2)) == [40 * 256, 64, 256]
    assert fa._strides("q", x[:1].transpose(1, 2)) == [64, 64, 256]
    with pytest.raises(ValueError):                 # last dim not contiguous
        fa._strides("q", x.transpose(2, 3))
    odd = torch.zeros(2, 4, 40, 66, dtype=dtype)[..., :64]
    with pytest.raises(ValueError):                 # 66-element rows
        fa._strides("k", odd)


# ---- v narrower than q and k (MLA's 128-wide v beside its 192-wide q, k)

NARROW_V_CASES = [
    # (b, h, kvh, sq, sk, d, dv, kwargs)
    (1, 2, 2, 70, 70, 64, 32, dict()),                      # causal
    (1, 4, 2, 150, 150, 64, 32, dict(window=32)),
    (1, 4, 2, 20, 150, 64, 32, dict(kv_len=130)),           # default offset
    (1, 2, 2, 16, 150, 48, 32, dict(kv_len=140, q_offset=100)),
    (1, 2, 1, 40, 32, 64, 16, dict(q_offset=-10)),          # keyless rows
    (1, 2, 1, 30, 60, 64, 32, dict(causal=False, kv_len=45)),
]


@pytest.mark.parametrize("case", NARROW_V_CASES)
def test_flash_plain_narrow_v_equals_padded_call(case):
    """A v narrower than q/k gives the padded call's output, sliced: the
    zero columns of a padded v add nothing to the first Dv columns."""
    b, h, kvh, sq, sk, d, dv, kw = case
    q, k, v = _qkv(7, b, h, kvh, sq, sk, d)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v[..., :dv]))
    got = fa.flash_attention_plain(q, k, v, **kw)
    want = fa.flash_attention_plain(
        q, k, torch.nn.functional.pad(v, (0, d - dv)), **kw)
    assert got.shape == (b, h, sq, dv)
    assert (got - want[..., :dv]).abs().max().item() <= 1e-6
    assert not want[..., dv:].any()


@pytest.mark.parametrize("case", NARROW_V_CASES[:4])
def test_flash_narrow_v_matches_pallas_kernel_padded(case):
    """The same inputs through the Pallas kernel (interpret mode) with v
    zero-padded to q's width, sliced, and through the port's wrapper with
    v at its own width."""
    b, h, kvh, sq, sk, d, dv, kw = case
    q, k, v = _qkv(8, b, h, kvh, sq, sk, d)
    v[..., dv:] = 0.0
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  interpret=True, **kw)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v[..., :dv].copy()), **kw)
    _close(np.asarray(want)[..., :dv], got)


def test_flash_narrow_v_output_follows_q_layout():
    """The wrapper's output at v's width keeps q's layout: a transposed
    [B,S,H,D] q gives a transposed [B,S,H,Dv] output."""
    q = torch.zeros(2, 40, 4, 192).transpose(1, 2)
    out = fa._empty_out(q, 128)
    assert out.shape == (2, 4, 40, 128)
    assert out.transpose(1, 2).is_contiguous()
    assert fa._empty_out(q, 192).stride() == q.stride()
    dense = torch.zeros(2, 4, 40, 192)
    assert fa._empty_out(dense, 128).is_contiguous()


def test_flash_autograd_refuses_narrow_v():
    """The backward kernel takes equal widths only, so the autograd route
    refuses a narrower v (MLA pads v under grad)."""
    q = torch.zeros(1, 2, 8, 64, requires_grad=True)
    k = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError):
        fa.FlashAttentionFn.apply(q, k, torch.zeros(1, 2, 8, 32), True, 0,
                                  None, 0, None)
    assert fa.flash_attention(q, k, torch.zeros(1, 2, 8, 64)).shape == \
        (1, 2, 8, 64)
