"""Why the latent kernel's tensor-core route splits q_lat and P in two.

The kernel (``src/repro_torch/kernels/csrc/mla_attention.cu``, bf16 cache
at deepseek-v3's widths) runs both products of the absorbed MLA decode on
bf16 tensor cores with float32 sums, while the reference keeps q_lat and
the probabilities in float32. The cache is bf16 already, so it enters
exactly; q_lat and P are each split into a bf16 high part and a bf16
remainder (two products each). ``_emulate`` repeats that arithmetic in
PyTorch on the CPU -- 32-key tiles, the online softmax in base 2 with the
-1e30 sentinel, float32 everywhere else -- and the tests hold it against
the JAX reference's einsums (``repro.models.attention.mla_decode_attention``)
at full width: H = 128, R = 512, Rr = 64, q_lat scaled by 1 and by 4. The
split meets the kernel's bar, MLA_REL_TOL of the largest output; bf16 or
TF32 q and P alone do not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

#: the latent kernel's bar (chip_smoke.py, tests/test_torch_cuda.py): its
#: error within this share of the plain version's largest output
MLA_REL_TOL = 1e-4
R, RR, H = 512, 64, 128          # deepseek-v3-671b's published widths
LENGTH, TILE = 320, 32           # cache rows; keys per kernel stage
LOG2E = 1.4426950408889634


def _split(x):
    """x = hi + lo to 2^-16: the kernel's bf16 pair."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()]


def _bf16(x):
    return [x.to(torch.bfloat16).float()]


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.contiguous().view(torch.int32)
    return [((bits + 0x1000) & ~0x1FFF).view(torch.float32)]


def _emulate(q_lat, q_rope, ckv, k_rope, q_pos, scale, form):
    """The tensor-core route's arithmetic with q and P in ``form`` (a list
    of bf16-exact parts whose products are summed in float32)."""
    b, sq, h, r = q_lat.shape
    q = torch.cat([q_lat, q_rope], -1).reshape(b, sq * h, -1)
    k = torch.cat([ckv, k_rope], -1).float()
    v = ckv.float()
    qp = q_pos.long().repeat_interleave(h, 1)[..., None]      # [B, rows, 1]
    qs = form(q)
    m = torch.full((b, sq * h), -1e30)
    l = torch.zeros(b, sq * h)
    acc = torch.zeros(b, sq * h, r)
    for t0 in range(0, k.shape[1], TILE):
        kt, vt = k[:, t0:t0 + TILE], v[:, t0:t0 + TILE]
        s = sum(p @ kt.transpose(1, 2) for p in qs) * (scale * LOG2E)
        keys = torch.arange(t0, t0 + kt.shape[1])
        s = torch.where(keys <= qp, s, torch.full_like(s, -1e30))
        mn = torch.maximum(m, s.amax(-1))
        c = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * c + p.sum(-1)
        acc = acc * c[..., None] + sum(pp @ vt for pp in form(p))
        m = mn
    return (acc / l[..., None]).reshape(b, sq, h, r)


def _reference(q_lat, q_rope, ckv, k_rope, q_pos, scale):
    """The reference's absorbed-decode einsums (float32, upcast cache)."""
    ckv_f = jnp.asarray(ckv.float().numpy())
    s = (jnp.einsum("bshr,bcr->bhsc", jnp.asarray(q_lat.numpy()), ckv_f)
         + jnp.einsum("bshe,bce->bhsc", jnp.asarray(q_rope.numpy()),
                      jnp.asarray(k_rope.float().numpy()))) * scale
    keys = jnp.arange(ckv.shape[1])
    valid = keys[None, None] <= jnp.asarray(q_pos.numpy())[:, :, None]
    s = jnp.where(valid[:, None], s, jattn.NEG_INF)
    return np.asarray(jnp.einsum("bhsc,bcr->bshr", jax.nn.softmax(s, -1),
                                 ckv_f))


@pytest.fixture(scope="module")
def errors():
    """Largest error over the largest output of each arithmetic, for q_lat
    scaled by 1 and 4: one-query decode at batch 2 and an S = 2 verify."""
    rng = np.random.default_rng(20)
    scale = (128 + RR) ** -0.5         # qk_nope_head_dim + qk_rope_head_dim
    out = {}
    for q_scale in (1.0, 4.0):
        for sq, pos in ((1, [[LENGTH - 1], [250]]),
                        (2, [[LENGTH - 2, LENGTH - 1], [200, 201]])):
            def t(shape, dtype=torch.float32):
                return torch.from_numpy(rng.standard_normal(shape).astype(
                    np.float32)).to(dtype)
            args = (q_scale * t((2, sq, H, R)), t((2, sq, H, RR)),
                    t((2, LENGTH, R), torch.bfloat16),
                    t((2, LENGTH, RR), torch.bfloat16),
                    torch.tensor(pos, dtype=torch.int32))
            want = _reference(*args, scale)
            big = float(np.abs(want).max())
            for name, form in (("split", _split), ("bf16", _bf16),
                               ("tf32", _tf32)):
                got = _emulate(*args, scale, form).numpy()
                out[(name, q_scale, sq)] = float(np.abs(got - want).max()
                                                 ) / big
    return out


@pytest.mark.parametrize("q_scale", [1.0, 4.0])
@pytest.mark.parametrize("sq", [1, 2])
def test_split_bf16_meets_the_kernels_bar(errors, q_scale, sq):
    assert errors[("split", q_scale, sq)] <= MLA_REL_TOL, errors


@pytest.mark.parametrize("form", ["bf16", "tf32"])
def test_one_rounding_misses_the_bar(errors, form):
    """bf16 or TF32 q and P miss MLA_REL_TOL on every case; the split's
    error is at least 10x below theirs."""
    for q_scale in (1.0, 4.0):
        for sq in (1, 2):
            e = errors[(form, q_scale, sq)]
            assert e > MLA_REL_TOL, errors
            assert errors[("split", q_scale, sq)] * 10 <= e, errors
