"""The port's RWKV-6 (the ``ssm`` family, rwkv6-3b smoke) against the JAX
reference's, on the CPU in float32 with the same numpy weights.

* ``time_mix_forward`` / ``channel_mix_forward`` with and without an
  incoming state, their returned ``wkv`` and shift states included, and
  ``_wkv_step``, within 1e-5.
* The ``Model``'s forward, prefill and decode logits within 1e-4 of the
  logit scale, and the prefill's state cache.
* ``LVLM.generate`` and ``serve`` tokens and virtual-clock records equal
  to the reference's, and ``serve_async``'s streams, records and summary
  on rwkv6, zamba2 (a prompt past its window) and the perceiver vlm.
* The refusals of the ``ssm`` and ``hybrid`` families (``extend``, KV
  compaction, early exit, speculative decoding, and the chunked
  scheduler's extend), with the reference's exception types.
"""
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LVLM as JLVLM
from repro.api import EngineConfig as JEngineConfig
from repro.api import GenerationConfig as JGen
from repro.api import Request as JRequest
from repro.models import rwkv as JR
from repro.models.layers import init_params
from repro.training.checkpoint import _flatten
from repro_torch.api import LVLM, EngineConfig, GenerationConfig, Request
from repro_torch.configs import get_config
from repro_torch.models import rwkv as R
from repro_torch.models.convert import params_from_flat

TOL = 1e-4
STATE_TOL = 1e-5
CFG = get_config("rwkv6-3b", smoke=True)
_PAIRS = {}


def _to_port(tree):
    return params_from_flat({k: np.asarray(v)
                             for k, v in _flatten(tree).items()}, "cpu")


#: each package's config classes, requests and token arrays
J_API = dict(gen=JGen, ec=JEngineConfig, req=JRequest, toks=jnp.asarray)
T_API = dict(gen=GenerationConfig, ec=EngineConfig, req=Request,
             toks=torch.tensor)


#: the families' smoke configs by test name: (arch, config overrides)
ARCHS = {"rwkv6-3b": ("rwkv6-3b", {}), "zamba2-1.2b": ("zamba2-1.2b", {}),
         "perceiver": ("qwen2-vl-2b", dict(projector="perceiver",
                                           num_latents=8))}


def _pair(name="rwkv6-3b"):
    if name not in _PAIRS:
        arch, kw = ARCHS[name]
        j = JLVLM.from_pretrained(arch, smoke=True, **kw)
        t = LVLM.from_pretrained(arch, smoke=True, device="cpu", **kw)
        _PAIRS[name] = (j, t.with_params(_to_port(j.params)))
    return _PAIRS[name]


def _close(j, t, tol=TOL):
    j = np.asarray(j, np.float32)
    t = t.float().numpy()
    assert j.shape == t.shape
    scale = max(1.0, float(np.abs(j).max()))
    assert np.abs(j - t).max() <= tol * scale, np.abs(j - t).max() / scale


def _mix_params():
    """One layer's time-mix and channel-mix weights, with non-zero lerp
    coefficients, decay offset and bonus (the init leaves them 0)."""
    jp = init_params(JR.rwkv_specs(CFG), jax.random.PRNGKey(0), "float32")
    rng = np.random.default_rng(5)
    for mix in ("time_mix", "channel_mix"):
        for k in jp[mix]:
            if k.startswith("mu_") or k in ("w0", "u", "ln_bias"):
                jp[mix][k] = jnp.asarray(0.3 * rng.standard_normal(
                    jp[mix][k].shape).astype(np.float32))
    return jp


def _state(rng, b):
    nh, hd = CFG.d_model // CFG.ssm_head_dim, CFG.ssm_head_dim
    return {"tm_shift": rng.standard_normal((b, CFG.d_model)),
            "cm_shift": rng.standard_normal((b, CFG.d_model)),
            "wkv": 0.5 * rng.standard_normal((b, nh, hd, hd))}


@pytest.mark.parametrize("with_state", [False, True])
def test_time_and_channel_mix_match_reference(with_state):
    jp = _mix_params()
    tp = _to_port(jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, CFG.d_model)).astype(np.float32)
    st = None
    if with_state:
        st = {k: v.astype(np.float32) for k, v in _state(rng, 2).items()}
    jst = None if st is None else {k: jnp.asarray(v) for k, v in st.items()}
    tst = None if st is None else {k: torch.from_numpy(v)
                                   for k, v in st.items()}
    jo, js = JR.time_mix_forward(jp["time_mix"], jnp.asarray(x), CFG,
                                 state=jst)
    to, ts = R.time_mix_forward(tp["time_mix"], torch.from_numpy(x), CFG,
                                state=tst)
    _close(jo, to, STATE_TOL)
    assert js.keys() == ts.keys()
    for k in js:
        _close(js[k], ts[k], STATE_TOL)
    jo, js = JR.channel_mix_forward(jp["channel_mix"], jnp.asarray(x), CFG,
                                    state=jst)
    to, ts = R.channel_mix_forward(tp["channel_mix"], torch.from_numpy(x),
                                   CFG, state=tst)
    _close(jo, to, STATE_TOL)
    _close(js["cm_shift"], ts["cm_shift"], STATE_TOL)


def test_wkv_step_matches_reference():
    rng = np.random.default_rng(7)
    nh, hd = 4, 32
    state = rng.standard_normal((3, nh, hd, hd)).astype(np.float32)
    r, k, v = (rng.standard_normal((3, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.1, 0.99, (3, nh, hd)).astype(np.float32)
    u = rng.standard_normal((nh, hd)).astype(np.float32)
    jy, js = JR._wkv_step(*(jnp.asarray(a) for a in (state, r, k, v, w, u)))
    ty, ts = R._wkv_step(*(torch.from_numpy(a) for a in (state, r, k, v, w,
                                                         u)))
    _close(jy, ty, STATE_TOL)
    _close(js, ts, STATE_TOL)


def test_ssm_model_entry_points_match_reference():
    j, t = _pair()
    rng = np.random.default_rng(8)
    toks = rng.integers(0, CFG.vocab_size, (2, 17)).astype(np.int32)
    jf, _ = j.model.forward(j.params, {"tokens": jnp.asarray(toks)})
    tf, _ = t.model.forward(t.params, {"tokens": torch.from_numpy(toks
                                                                  ).long()})
    _close(jf, tf)
    jl, jc = j.model.prefill(j.params, {"tokens": jnp.asarray(toks)},
                             cache_len=32)
    tl, tc = t.model.prefill(t.params, {"tokens": torch.from_numpy(toks
                                                                   ).long()},
                             cache_len=32)
    _close(jl, tl)
    for k in jc["layers"]:
        _close(jc["layers"][k], tc["layers"][k], STATE_TOL)
    for step in range(3):
        nxt = rng.integers(0, CFG.vocab_size, (2, 1)).astype(np.int32)
        pos = np.array([17 + step, 17 + step], np.int32)
        jd, jc = j.model.decode_step(j.params, jc, jnp.asarray(nxt),
                                     jnp.asarray(pos))
        td, tc = t.model.decode_step(t.params, tc,
                                     torch.from_numpy(nxt).long(),
                                     torch.from_numpy(pos))
        _close(jd, td)
    _close(jc["layers"]["wkv"], tc["layers"]["wkv"], STATE_TOL)


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


@pytest.mark.parametrize("scheduler", ["continuous", "static", "mlfq"])
def test_rwkv_generate_and_serve_match_reference(scheduler):
    j, t = _pair()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist()
               for n in (21, 7, 40)]
    if scheduler == "continuous":
        jr = j.generate(prompts, JGen(max_new_tokens=6, decoder="greedy"))
        tr = t.generate(prompts, GenerationConfig(max_new_tokens=6,
                                                  decoder="greedy"))
        assert [r.tokens for r in tr] == [r.tokens for r in jr]
        assert _metrics([r.request for r in tr]) == \
            _metrics([r.request for r in jr])
    ec = dict(max_batch=2, cache_len=64, scheduler=scheduler)
    jrep = j.serve([JRequest(rid=i, tokens=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], JEngineConfig(**ec),
                   JGen(decoder="greedy"))
    trep = t.serve([Request(rid=i, tokens=p, max_new_tokens=5)
                    for i, p in enumerate(prompts)], EngineConfig(**ec),
                   GenerationConfig(decoder="greedy"))
    assert _metrics(trep.requests) == _metrics(jrep.requests)


@pytest.mark.parametrize("name", list(ARCHS))
def test_serve_async_matches_reference(name):
    """``serve_async`` streams, ``RequestRecord`` s and ``summary()``
    exactly equal to the reference's (a 70-token prompt wraps zamba2's
    ring of 64; the perceiver's requests carry patches)."""
    j, t = _pair(name)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 512, n).tolist() for n in (70, 12, 30)]
    ves = [None] * 3
    if name == "perceiver":
        ves = [rng.standard_normal((n, 256)).astype(np.float32)
               for n in (16, 5, 9)]

    def run(lv, api):
        reqs = [api["req"](rid=i, tokens=p, max_new_tokens=5,
                           visual_embeds=v)
                for i, (p, v) in enumerate(zip(prompts, ves))]
        server = lv.serve_async(
            api["ec"](max_batch=2, cache_len=128),
            gen=api["gen"](decoder="greedy", temperature=0.0,
                           max_new_tokens=5))

        async def consume(stream):
            return [tok async for tok in stream]

        async def drive():
            async with server:
                return await asyncio.gather(
                    *(consume(server.submit(r)) for r in reqs))
        return (asyncio.run(drive()),
                [dataclasses.asdict(r) for r in server.metrics.records],
                server.summary())
    assert run(t, T_API) == run(j, J_API)


def _raises(fn):
    """The exception type ``fn`` raises (None if it returns)."""
    try:
        fn()
    except Exception as e:                       # noqa: BLE001
        return type(e)
    return None


def _refusal(lv, api, case):
    gen = api["gen"]
    if case == "extend":
        return lambda: lv.model.extend(lv.params, lv.model.init_cache(1, 32),
                                       api["toks"]([[1, 2]]), 3)
    if case == "chunked":
        return lambda: lv.serve(
            [api["req"](rid=0, tokens=list(range(1, 40)), max_new_tokens=2)],
            api["ec"](max_batch=1, cache_len=64, scheduler="chunked",
                      chunk_size=8), gen(decoder="greedy"))
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12]]
    if case == "compaction":
        return lambda: lv.generate(prompts, gen(
            max_new_tokens=2, decoder="greedy", compression="streaming-kv-4"))
    return lambda: lv.generate(prompts, gen(max_new_tokens=2, decoder=case,
                                            temperature=0.0))


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
@pytest.mark.parametrize("case", ["extend", "compaction", "early_exit",
                                  "speculative", "chunked"])
def test_refusals_match_reference(arch, case):
    """Now that ``build`` takes these families, the guards of the engine
    and decoders fire for them, as the reference's do."""
    j, t = _pair(arch)
    want = _raises(_refusal(j, J_API, case))
    got = _raises(_refusal(t, T_API, case))
    assert want is not None and got is want, (want, got)

