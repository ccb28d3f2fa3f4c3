"""Multi-pod dry run: trace every (arch x input shape) pair on the
production meshes, with no device allocation (``meta`` stand-ins).

Port of ``repro.launch.dryrun``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # full grid
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
        --shape decode_32k --multi-pod                              # one pair

Per pair it records whether the step ran on the mesh, the per-device
bytes of its inputs (``memory``: does it fit), its FLOPs, and its
collective schedule (``roofline.step_cost``), and the three-term roofline
on the port's card (``roofline.analysis``). Results stream into
``experiments/dryrun_torch_<mesh>.json`` so partial runs resume (pairs
already ``ok`` are kept). With ``--both-meshes`` and ``--out PATH`` each
mesh writes its own file, ``PATH`` with ``_singlepod`` / ``_multipod``
before the suffix (the reference writes both into one).

The production mesh is a fake process group of 256 / 512 ranks
(``launch.mesh``), which this process then holds; no card is needed. A
pair whose step fails is recorded as ``fail`` with its error.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.configs import ARCHS, SKIPS
from repro_torch.configs.shapes import SHAPES

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments")


def run_pair(arch: str, shape: str, mesh, *, chips: int, fsdp: bool = True,
             weight_stationary: bool = True, verbose: bool = True) -> dict:
    from repro_torch.launch.steps import build_step
    from repro_torch.roofline.analysis import (model_flops_estimate,
                                               roofline_from_costs)
    from repro_torch.roofline.analytic import bytes_estimate
    from repro_torch.roofline.step_cost import step_costs
    t0 = time.time()
    spec = build_step(arch, shape, mesh, fsdp=fsdp,
                      decode_batch_replicated=weight_stationary)
    if spec is None:
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": SKIPS[(arch, shape)]}
    try:
        costs = step_costs(spec, chips=chips)
        mf = model_flops_estimate(spec.model_cfg, spec.shape_cfg)
        ab = bytes_estimate(spec.model_cfg, spec.shape_cfg)
        rep = roofline_from_costs(spec.name, costs, chips=chips,
                                  model_flops=mf, analytic_bytes=ab)
        out = {"arch": arch, "shape": shape, "status": "ok",
               "step": spec.name.split("/")[-1],
               "compile_s": round(time.time() - t0, 1),
               "memory": costs["memory"],
               "collective_operand_bytes": costs["collective_operand_bytes"],
               "collective_unknown": costs["collective_unknown"],
               "roofline": rep.as_dict()}
        if verbose:
            arg = costs["memory"]["argument_bytes"]
            print(f"OK   {arch:22s} {shape:12s} {out['step']:7s} "
                  f"trace={out['compile_s']:6.1f}s args={arg / 1e9:7.2f} GB "
                  f"dom={rep.dominant:10s} "
                  f"c/m/x={rep.compute_s * 1e3:.1f}/{rep.memory_s * 1e3:.1f}/"
                  f"{rep.collective_s * 1e3:.1f} ms", flush=True)
        return out
    except Exception as e:
        if verbose:
            print(f"FAIL {arch:22s} {shape:12s} {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "status": "fail",
                "error": f"{type(e).__name__}: {e}",
                "compile_s": round(time.time() - t0, 1)}


def _out_path(out, tag: str, both: bool) -> str:
    if out is None:
        return os.path.join(OUT_DIR, f"dryrun_torch_{tag}.json")
    if not both:
        return out
    root, ext = os.path.splitext(out)
    return f"{root}_{tag}{ext or '.json'}"


def delegate(arch: str, shape: str) -> int:
    """``python -m repro_torch.launch.dryrun --arch A --shape S`` in a
    subprocess, and its exit code: ``launch.serve --dry-run`` and
    ``launch.train --dry-run`` (the dry run holds its process's default
    process group, so it owns its process)."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return subprocess.call(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", arch, "--shape", shape],
        env=dict(os.environ, PYTHONPATH=src))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-weight-stationary", action="store_true",
                    help="paper-faithful baseline decode (batch-sharded; "
                    "weights gathered every step)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import make_production_mesh
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    any_fail = False
    for multi_pod in meshes:
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        tag = "multipod" if multi_pod else "singlepod"
        out_path = _out_path(args.out, tag, args.both_meshes)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        results = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                results = json.load(f)
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"== mesh {shape} ({chips} devices) -> {out_path}", flush=True)
        for arch in archs:
            for shp in shapes:
                key = f"{arch}|{shp}"
                if results.get(key, {}).get("status") == "ok":
                    continue
                results[key] = run_pair(
                    arch, shp, mesh, chips=chips, fsdp=not args.no_fsdp,
                    weight_stationary=not args.no_weight_stationary)
                if results[key]["status"] == "fail":
                    any_fail = True
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
        n_ok = sum(1 for r in results.values() if r["status"] == "ok")
        n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
        n_fail = sum(1 for r in results.values() if r["status"] == "fail")
        print(f"== {tag}: {n_ok} ok / {n_skip} skipped / {n_fail} failed",
              flush=True)
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
