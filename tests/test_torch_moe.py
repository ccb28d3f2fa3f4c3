"""The port's MoE layer against the JAX reference's ``apply_moe``.

Same numpy weights and tokens through ``repro.models.moe`` and
``repro_torch.models.moe`` on the CPU in float32 (one token group on
both: the reference has no mesh here). The routing is discrete, so the
same top-k choices, capacity drops and drop counts must come out; the
outputs agree within 1e-5 of their scale (float32 products and the
combine's scatter-add summed in another order), and the aux values are
equal: ``load`` and ``dropped_frac`` exactly, the losses to float32
rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as JM
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as TM

TOL = 1e-5

VARIANTS = {
    "arctic": {},
    "relu2": dict(activation="relu2"),
    "gelu_dense_residual_off": dict(activation="gelu", dense_residual=False),
    "shared_expert": dict(num_shared_experts=1, dense_residual=False),
}


def _pair(variant):
    kw = VARIANTS[variant]
    return (get_config("arctic-480b", smoke=True).with_(**kw),
            tget("arctic-480b", smoke=True).with_(**kw))


def _params(rng, specs):
    return {k: _params(rng, s) if isinstance(s, dict)
            else (rng.standard_normal(s.shape) * s.scale).astype(np.float32)
            for k, s in specs.items()}


def _conv(tree, fn):
    return {k: _conv(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _run(variant, cap, seed, b=2, s=24, skew=0.0):
    jcfg, tcfg = _pair(variant)
    rng = np.random.default_rng(seed)
    specs = TM.moe_specs(tcfg)
    p = _params(rng, specs)
    # a skewed router (tokens of mean 1) sends most tokens to expert 0:
    # drops at capacity 1.25
    p["router"][:, 0] += skew
    x = (rng.standard_normal((b, s, tcfg.d_model)) + (skew > 0)
         ).astype(np.float32)
    jy, jaux = JM.apply_moe(_conv(p, jnp.asarray), jnp.asarray(x), jcfg,
                            capacity_factor=cap)
    ty, taux = TM.apply_moe(_conv(p, torch.from_numpy), torch.from_numpy(x),
                            tcfg, capacity_factor=cap)
    return (np.asarray(jy), {k: np.asarray(v) for k, v in jaux.items()},
            ty.numpy(), {k: v.numpy() for k, v in taux.items()})


def _same_drops(jaux, taux, pairs):
    """The same number of dropped (token, choice) pairs: 1 - mean(keep)
    is rounded differently by the two frameworks, the count is not."""
    jd, td = float(jaux["dropped_frac"]), float(taux["dropped_frac"])
    assert round(jd * pairs) == round(td * pairs)
    assert abs(jd - td) <= 1e-6


def test_specs_match_reference():
    for variant in VARIANTS:
        jcfg, tcfg = _pair(variant)
        t, j = TM.moe_specs(tcfg), JM.moe_specs(jcfg)

        def flat(tree, path=()):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from flat(v, path + (k,))
                else:
                    yield path + (k,), (v.shape, v.init, v.scale)
        assert dict(flat(t)) == dict(flat(j)), variant


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cap", [1.25, None])
@pytest.mark.parametrize("skew", [0.0, 0.01])
def test_apply_moe_matches_reference(variant, cap, skew):
    jy, jaux, ty, taux = _run(variant, cap, seed=1, skew=skew)
    scale = max(1.0, float(np.abs(jy).max()))
    assert np.abs(jy - ty).max() <= TOL * scale
    assert np.array_equal(jaux["load"], taux["load"])
    _same_drops(jaux, taux, jy.shape[0] * jy.shape[1] * 2)
    for k in ("lb_loss", "z_loss"):
        assert abs(float(jaux[k]) - float(taux[k])) <= 1e-6 * abs(
            float(jaux[k])), k
    if cap is None:
        assert float(taux["dropped_frac"]) == 0.0
    elif skew:
        assert float(taux["dropped_frac"]) > 0.0     # the drop path runs


@pytest.mark.parametrize("b,s", [(1, 1), (4, 1), (3, 5)])
def test_apply_moe_decode_and_small_batches(b, s):
    """Decode-sized token counts (T * k < E at T = 1): capacity 1.25 gives
    C = max(1, int(...)), and dropless C = T * k."""
    for cap in (1.25, None):
        jy, jaux, ty, taux = _run("shared_expert", cap, seed=2, b=b, s=s)
        assert np.abs(jy - ty).max() <= TOL * max(1.0, np.abs(jy).max())
        _same_drops(jaux, taux, b * s * 2)
