"""Serving deepseek-v3 smoke (MLA's latent cache) on the port against the
JAX reference, float32 on the CPU.

Same weights through the bridge, same requests: greedy tokens and the
virtual-clock TTFT / TPOT / JCT exactly equal under all four schedulers
and from ``generate``; a gamma-4 self-draft speculative serve (the verify
in the absorbed form on the port, the naive one in the reference) with
the same tokens and acceptance; a prefix-cache serve with the reference's
hits; and a prefill / decode fleet that migrates every request's latent
cache, with the reference's streams, records and migrations.
"""
import asyncio
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import repro.api as japi
from repro.training.checkpoint import _flatten
import repro_torch.api as tapi
from repro_torch.models.convert import params_from_flat

ARCH = "deepseek-v3-671b"
SCHEDULERS = ("static", "continuous", "mlfq", "chunked")
REF = SimpleNamespace(api=japi)
PORT = SimpleNamespace(api=tapi)


@pytest.fixture(scope="module")
def pair():
    j = japi.LVLM.from_pretrained(ARCH, smoke=True)
    flat = {k: np.asarray(v) for k, v in _flatten(j.params).items()}
    t = tapi.LVLM.from_pretrained(ARCH, smoke=True, device="cpu")
    return j, t.with_params(params_from_flat(flat, "cpu"))


def _requests(api, seed=1, lens=(9, 30, 5), new=4):
    rng = np.random.default_rng(seed)
    return [api.Request(rid=i, tokens=rng.integers(0, 512, n).tolist(),
                        max_new_tokens=new, arrival=0.002 * i)
            for i, n in enumerate(lens)]


def _metrics(reqs):
    return {r.rid: (list(r.generated), r.ttft(), r.tpot(), r.jct())
            for r in reqs}


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_serve_matches_reference_under_each_scheduler(pair, scheduler):
    kw = dict(max_batch=2, cache_len=64, scheduler=scheduler, chunk_size=8,
              token_budget=24)
    out = []
    for ns, lvlm in zip((REF, PORT), pair):
        rep = lvlm.serve(_requests(ns.api), ns.api.EngineConfig(**kw),
                         gen=ns.api.GenerationConfig(decoder="greedy"))
        out.append((_metrics(rep.requests), rep.stats["virtual_time_s"]))
    assert out[1] == out[0]


def test_generate_matches_reference(pair):
    out = []
    for ns, lvlm in zip((REF, PORT), pair):
        prompts = [r.tokens for r in _requests(ns.api, 2)]
        res = lvlm.generate(prompts, ns.api.GenerationConfig(
            max_new_tokens=6, decoder="greedy"))
        out.append(_metrics([r.request for r in res]))
    assert out[1] == out[0]


def test_speculative_self_draft_matches_reference(pair):
    """gamma 4, self-draft: the verify is a [B]-start extend, absorbed on
    the latent kernel's path in the port. Tokens, clock and the decoder's
    stats equal the reference's, and the tokens equal greedy's."""
    kw = dict(temperature=0.0, max_new_tokens=9, decoder="speculative",
              gamma=4)
    out, stats = [], []
    for ns, lvlm in zip((REF, PORT), pair):
        prompts = [r.tokens for r in _requests(ns.api, 4, (9, 14))]
        res = lvlm.generate(prompts, ns.api.GenerationConfig(**kw))
        out.append(_metrics([r.request for r in res]))
        stats.append({k: v for k, v in res[0].stats.items()
                      if isinstance(v, (int, float, str, list))})
    assert out[1] == out[0]
    assert stats[1] == stats[0]
    greedy = pair[1].generate(
        [r.tokens for r in _requests(tapi, 4, (9, 14))],
        tapi.GenerationConfig(max_new_tokens=9, decoder="greedy"))
    assert [r.tokens for r in greedy] == \
        [out[1][i][0] for i in range(len(greedy))]


def test_prefix_cache_serve_matches_reference(pair):
    def reqs(api):
        rng = np.random.default_rng(6)
        head = rng.integers(0, 512, 16).tolist()
        return [api.Request(rid=i, tokens=head + rng.integers(
            0, 512, n).tolist(), max_new_tokens=4, arrival=0.002 * i)
            for i, n in enumerate((6, 14, 3))]
    kw = dict(max_batch=2, cache_len=48, scheduler="continuous",
              prefix_cache=True, prefix_block=8)
    out = []
    for ns, lvlm in zip((REF, PORT), pair):
        rep = lvlm.serve(reqs(ns.api), ns.api.EngineConfig(**kw),
                         gen=ns.api.GenerationConfig(decoder="greedy"))
        out.append((_metrics(rep.requests), rep.stats["prefix_hit_tokens"],
                    rep.stats["virtual_time_s"]))
    assert out[1] == out[0]
    assert out[1][1] > 0


async def _consume(stream):
    return [tok async for tok in stream]


def test_disaggregated_migration_of_latent_cache(pair):
    """A prefill replica hands every request's latent cache (``ckv``,
    ``k_rope`` of both layer stacks) to a decode replica: streams,
    per-replica records, migrations and the fleet summary equal the
    reference's, and the export ticket holds the latent leaves."""
    out = []
    for ns, lvlm in zip((REF, PORT), pair):
        api = ns.api
        router = lvlm.serve_cluster(
            2, api.EngineConfig(max_batch=4, cache_len=96, temperature=0.0,
                                sanitize=True),
            gen=api.GenerationConfig(decoder="greedy", temperature=0.0,
                                     max_new_tokens=6),
            roles=["prefill", "decode"])
        reqs = _requests(api, 8, (12, 20, 9, 15), new=6)

        async def drive():
            async with router:
                return await asyncio.gather(
                    *(_consume(router.submit(r)) for r in reqs))
        streams = asyncio.run(drive())
        reps = router.replicas
        out.append(dict(
            streams=[list(s) for s in streams],
            records=[[dataclasses.asdict(r)
                      for r in rep.server.metrics.records] for rep in reps],
            migrated=[(rep.migrated_in, rep.migrated_out) for rep in reps],
            migrations=list(router.migrations), summary=router.summary()))
    assert out[1] == out[0]
    assert out[1]["migrated"][1][0] == 4           # every request moved


def test_latent_export_ticket_imports_bit_for_bit(pair):
    """``export_kv`` snapshots every latent leaf (``ckv``, ``k_rope`` of
    both layer stacks) as a clone; ``import_kv`` copies those bits into
    the importer's slot, and the migrated request decodes to the tokens
    of an unmigrated run."""
    import torch
    from repro_torch.core.serving.engine import Engine
    from repro_torch.core.serving.request import State
    _, t = pair
    ec = tapi.EngineConfig(max_batch=2, cache_len=48, temperature=0.0)
    prompt = _requests(tapi, 9, (11,))[0].tokens
    plain = t.serve([tapi.Request(rid=0, tokens=list(prompt),
                                  max_new_tokens=4)], ec,
                    gen=tapi.GenerationConfig(decoder="greedy",
                                              temperature=0.0)
                    ).requests[0].generated
    src, dst = Engine(t.model, t.params, ec), Engine(t.model, t.params, ec)
    req = tapi.Request(rid=0, tokens=list(prompt), max_new_tokens=4)
    req.handoff = True
    src.submit(req)
    for _ in range(50):
        if req.state is State.MIGRATING:
            break
        assert src.step()
    ticket = src.export_kv(0)
    slot, pos = ticket["slot"], ticket["pos"]
    assert set(ticket["snap"]) == {"dense_layers", "layers"}
    for key, stack in ticket["snap"].items():
        assert set(stack) == {"ckv", "k_rope"}
        assert stack["ckv"].shape[-1] == t.cfg.kv_lora_rank
        assert stack["k_rope"].shape[-1] == t.cfg.qk_rope_head_dim
        for leaf, v in stack.items():
            assert v.data_ptr() != src.pool[key][leaf].data_ptr()
            assert torch.equal(v[:, 0], src.pool[key][leaf][:, slot, :pos])
    dst.import_kv(req, ticket, ready_at=ticket["clock"])
    src.complete_export(0)
    for key, stack in ticket["snap"].items():
        for leaf, v in stack.items():
            assert torch.equal(dst.pool[key][leaf][:, req._slot, :pos],
                               v[:, 0])
    while dst.step():
        pass
    assert req.generated == plain
