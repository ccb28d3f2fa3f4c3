"""Sharded npz checkpointing for param/optimizer trees.

Port of ``repro.training.checkpoint``, in its layout: leaves flattened to
``path.to.leaf`` keys (sorted) and split across ``shard_{i:05d}.npz``
files capped at ``shard_bytes``, with a ``manifest.json`` recording each
key's shard, dtype and shape, and the step. A bfloat16 leaf is written as
the reference writes one (a 2-byte payload; the manifest names it
``bfloat16``), so either package's checkpoint loads in the other where
the reader can take it (the reference's loader refuses its own bf16
leaves, ROADMAP C5). Reading goes through ``models.convert``, the port's
one reader of that layout.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.api.lvlm import resolve_device
from repro_torch.models.convert import load_checkpoint as _read
from repro_torch.models.convert import params_from_flat


def _flatten(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    else:
        out[".".join(prefix)] = tree
    return out


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype name) of a tensor or array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.dtype("V2")), \
                "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def save_checkpoint(path: str, tree, step: int,
                    shard_bytes: int = 512 * 1024 * 1024) -> Dict:
    os.makedirs(path, exist_ok=True)
    flat, dtypes = {}, {}
    for k, v in _flatten(tree).items():
        flat[k], dtypes[k] = _to_numpy(v)
    shards, cur, cur_bytes = [], {}, 0
    for k, v in flat.items():
        if cur and cur_bytes + v.nbytes > shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += v.nbytes
    if cur:
        shards.append(cur)
    manifest = {"step": step, "num_shards": len(shards),
                "keys": {k: {"shard": i, "dtype": dtypes[k],
                             "shape": list(v.shape)}
                         for i, sh in enumerate(shards)
                         for k, v in sh.items()}}
    for i, sh in enumerate(shards):
        np.savez(os.path.join(path, f"shard_{i:05d}.npz"), **sh)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return manifest


def load_checkpoint(path: str, device=None) -> Tuple[Any, int]:
    """(tree of tensors on ``device``, step) of a checkpoint in the
    reference's layout, bf16 leaves included. ``device`` None is the CUDA
    device (raises without one); pass "cpu" for the CPU."""
    flat, dtypes, step = _read(path)
    return params_from_flat(flat, resolve_device(device), dtypes=dtypes), step
