"""AdamW + cosine schedule on nested dicts of tensors.

Port of ``repro.training.optimizer``, the reference's own math rather
than ``torch.optim.AdamW``: decoupled weight decay (Loshchilov & Hutter)
on leaves with ``ndim >= 2`` only, bias-corrected moments in float32
whatever the param dtype (bf16-safe master moments), global-norm
gradient clipping, the update computed in float32 and cast back to the
param's dtype. It runs under ``torch.no_grad()`` and writes the new
values into the given params and moments, the counterpart of the
reference's donated buffers (at qwen2-vl-2b's width the moments are
12 GB, and a second copy would not be freed until the step ends).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3.0e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1.0e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac * lr``
    at ``total_steps`` (float32, as the reference)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in the reference's order (``jax.tree.leaves``: sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """A tree shaped as ``tree`` holding ``leaves`` in ``tree_leaves``'
    order."""
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        return next(it)
    return rebuild(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    with torch.no_grad():
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))


def adamw_init(params) -> Dict[str, Any]:
    """Zero float32 moments shaped (and, for DTensor params, laid out) as
    the params, and step 0 (int32)."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"

    def zeros():
        return tree_unflatten(params, [
            torch.zeros_like(p, dtype=torch.float32,
                             memory_format=torch.contiguous_format)
            for p in leaves])
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(cfg: OptimizerConfig, grads, opt_state, params
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, metrics {grad_norm, lr}); the
    params and moments are updated in place and returned."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0) if cfg.clip_norm \
            else torch.ones((), device=gnorm.device)
        b1, b2 = cfg.betas
        lr = cosine_lr(cfg, step)
        stepf = step.float()
        c1 = 1.0 - b1 ** stepf
        c2 = 1.0 - b2 ** stepf

        def upd(p, g, mu, nu):    # a leaf's float32 temporaries die here
            g = g.float() * scale
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
            pf = p.float()
            if p.ndim >= 2:       # decoupled weight decay on matrices only
                delta = delta + cfg.weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))

        for leaf in zip(tree_leaves(params), tree_leaves(grads),
                        tree_leaves(opt_state["mu"]),
                        tree_leaves(opt_state["nu"])):
            upd(*leaf)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
