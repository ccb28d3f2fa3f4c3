"""Weights carried across from the JAX reference.

The reference flattens a parameter tree to ``a.b.c`` -> array keys
(``repro/training/checkpoint.py:_flatten``) and checkpoints it as a
``manifest.json`` plus ``shard_*.npz`` files. Both layouts are the port's
own (same nesting, same stacked [layers, ...] leaves), so conversion is
a re-nesting and a copy to the device; numpy is the only reader.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _to_tensor(arr: np.ndarray, dtype: Optional[str] = None) -> torch.Tensor:
    """numpy -> torch, including bfloat16 arrays (ml_dtypes'
    ``bfloat16``, or the raw 2-byte void numpy loads without ml_dtypes;
    ``dtype`` names the logical type when the array cannot)."""
    name = dtype or arr.dtype.name
    if name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_flat(flat: Dict[str, np.ndarray], device,
                     dtype: Optional[torch.dtype] = None,
                     dtypes: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Flattened reference params -> the port's nested param tree on
    ``device``; floating leaves are cast to ``dtype`` when given.
    ``dtypes`` maps keys to their logical dtype names (from a manifest)."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        t = _to_tensor(np.asarray(arr), (dtypes or {}).get(key))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t.to(device)
    return root


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str],
                                        int]:
    """Read a reference checkpoint (``manifest.json`` + ``shard_*.npz``)
    with numpy alone. Returns (flat arrays, key -> dtype name, step)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for i in range(manifest["num_shards"]):
        with np.load(os.path.join(path, f"shard_{i:05d}.npz")) as z:
            for k in z.files:
                flat[k] = z[k]
    dtypes = {k: v["dtype"] for k, v in manifest["keys"].items()}
    return flat, dtypes, manifest["step"]
