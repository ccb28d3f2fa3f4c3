"""Seeded weights and inputs, made by the benchmark.

The weights fill the program's parameter tree (the shapes and initial
scales of ``Model.param_specs()``) from ``--seed``: every normal leaf is
a view into one flat buffer that a ``torch.Generator`` on the device
fills in one call, in the type the model serves (bf16), then scaled in
place; ones and zeros are filled. Nothing is drawn on the host and no
second copy is made. The plain reference reads the same tensors.

Streams: ``stream(seed, k)`` derives an independent 64-bit seed for each
use (weights, traffic, warm-up, the visual bank, the check's sample), so
one ``--seed`` fixes the whole run.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

WEIGHTS, TRAFFIC, WARMUP, BANK, CHECK = range(5)


def stream(seed: int, k: int) -> int:
    """An independent 63-bit seed for use ``k`` of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), k])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make_params(specs, seed: int, dtype: str, device) -> Dict:
    """The parameter tree of ``specs`` (``ParamSpec``-shaped leaves:
    ``shape``, ``init``, ``scale``, ``dtype``), drawn on ``device``."""
    dt = DTYPES[dtype]
    leaves = list(_leaves(specs))
    normal = [(p, s) for p, s in leaves
              if s.init == "normal" and (s.dtype or dtype) == dtype]
    total = sum(int(np.prod(s.shape)) for _, s in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, dtype=dt, device=device)
    out: Dict = {}
    off = 0
    for path, s in normal:
        n = int(np.prod(s.shape))
        leaf = flat[off:off + n].view(s.shape)
        leaf.mul_(s.scale)
        _set(out, path, leaf)
        off += n
    for path, s in leaves:
        if s.init == "normal" and (s.dtype or dtype) == dtype:
            continue
        ldt = DTYPES[s.dtype or dtype]
        if s.init == "ones":
            _set(out, path, torch.ones(s.shape, dtype=ldt, device=device))
        elif s.init == "zeros":
            _set(out, path, torch.zeros(s.shape, dtype=ldt, device=device))
        else:
            raise ValueError(f"leaf {'/'.join(path)}: init {s.init} in "
                             f"{s.dtype} is not made by the benchmark")
    return out


def visual_bank(seed: int, rows: int, width: int, device) -> np.ndarray:
    """[rows, width] float32 patch embeddings on the host, drawn on the
    device: each request's image is a slice at a seeded offset."""
    if rows <= 0:
        return np.zeros((0, width), np.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream(seed, BANK))
    bank = torch.randn((rows, width), generator=gen, dtype=torch.float32,
                       device=device)
    return bank.cpu().numpy()
