"""Sharded execution of the port: real computations on a (2, 2) DTensor
mesh of 4 gloo ranks on the CPU, held to the port's single-device run --
the counterpart of the reference's ``tests/test_sharded_exec.py``, whose
8-device JAX mesh does not run under JAX 0.9 (ROADMAP C4).

phi4-mini smoke in float32 (heads and KV heads sharded over "model",
embed over "data" by fsdp, the batch over "data"): prefill, plain decode,
weight-stationary decode and one train step's loss on the mesh, each
within 1e-3 of the single-device run's scale; and the single-device
prefill and decode logits against the reference's on the same weights
(1e-4 of the logit scale).
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-3

SCRIPT = textwrap.dedent("""
    import json, socket, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, port):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4)
        from torch.distributed.device_mesh import DeviceMesh
        from repro_torch.configs import get_config
        from repro_torch.models import build
        from repro_torch.sharding import (ShardingRules, batch_shardings,
                                          distribute, param_shardings,
                                          use_mesh)
        from repro_torch.training import OptimizerConfig, adamw_init
        from repro_torch.training.loop import make_train_step

        cfg = get_config("phi4-mini-3.8b", smoke=True).with_(dtype="float32")
        model = build(cfg)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=gen)
        step_tok = torch.full((4, 1), 7)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
                 "loss_mask": torch.ones(4, 12)}
        oc = OptimizerConfig()

        def run(params, batch, mesh_ctx):
            out = {}
            with mesh_ctx(), torch.no_grad():
                logits, cache = model.prefill(params, {"tokens": tokens},
                                              cache_len=16)
                out["prefill"] = logits
                for ws in (False, True):
                    c = {k: {n: t.clone() for n, t in v.items()}
                         for k, v in cache.items()}
                    d, _ = model.decode_step(params, c, step_tok, 12,
                                             weight_stationary=ws)
                    out["decode_ws" if ws else "decode"] = d
            with mesh_ctx():
                step = make_train_step(model, oc, remat=True)
                _, _, m = step(params, adamw_init(params), batch)
                out["loss"] = m["loss"].reshape(1)
            return out

        import contextlib
        ref = run(model.init(0, "cpu"), batch, contextlib.nullcontext)
        mesh = DeviceMesh("cpu", [[0, 1], [2, 3]],
                          mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh, fsdp=True)
        params = distribute(model.init(0, "cpu"),
                            param_shardings(rules, model.param_specs()))
        dbatch = distribute(batch, batch_shardings(rules, batch))
        got = run(params, dbatch, lambda: use_mesh(mesh, rules))
        placed = str(params["layers"]["attn"]["wq"].placements)
        res = {}
        for k in ref:
            g = got[k].full_tensor() if hasattr(got[k], "full_tensor") \\
                else got[k]
            res[k + "_err"] = float((g - ref[k]).abs().max())
            res[k + "_scale"] = float(ref[k].abs().max())
        res["wq_placements"] = placed
        if rank == 0:
            print("RESULT " + json.dumps(res), flush=True)
        dist.destroy_process_group()

    if __name__ == "__main__":
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        mp.spawn(worker, args=(port,), nprocs=4)
""")


def test_four_rank_mesh_matches_single_device(tmp_path):
    script = tmp_path / "sharded_exec.py"      # spawned ranks import it
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout
    out = json.loads(line[0][7:])
    assert "Shard(dim=2)" in out["wq_placements"]    # heads over "model"
    for k in ("prefill", "decode", "decode_ws", "loss"):
        assert out[k + "_err"] <= TOL * max(out[k + "_scale"], 1.0), (k, out)


def test_single_device_matches_reference():
    """The bar the mesh run is held to is the reference's own logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import build as jbuild
    from repro.training.checkpoint import _flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.convert import params_from_flat

    jcfg = jget("phi4-mini-3.8b", smoke=True).with_(dtype="float32")
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 12))
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                            cache_len=16)
    jd, _ = jmodel.decode_step(jparams, jc, jnp.full((4, 1), 7), 12)

    model = build(get_config("phi4-mini-3.8b", smoke=True).with_(
        dtype="float32"))
    params = params_from_flat({k: np.asarray(v) for k, v in
                               _flatten(jparams).items()}, "cpu")
    with torch.no_grad():
        tl, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cache_len=16)
        td, _ = model.decode_step(params, tc, torch.full((4, 1), 7), 12)
    for j, t in ((jl, tl), (jd, td)):
        j = np.asarray(j)
        scale = max(1.0, float(np.abs(j).max()))
        assert np.abs(j - t.numpy()).max() <= 1e-4 * scale
