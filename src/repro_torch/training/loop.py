"""Training loop: a train step + host loop with checkpoint/resume.

Port of ``repro.training.loop``. The step is eager PyTorch: the loss
(``Model.loss``, each layer rematerialised), its gradients by
``torch.autograd`` (through the flash kernel's backward on the card), and
the reference's AdamW. Same log lines, non-finite check, checkpoint
cadence, resume and returned dict as the reference's ``train_loop``; the
params are initialised with the port's ``Model.init(seed, device)``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.api.lvlm import resolve_device
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticDataConfig, make_batch
from repro_torch.training.optimizer import (OptimizerConfig, adamw_init,
                                            adamw_update, tree_leaves,
                                            tree_unflatten)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_train_step(model, oc: OptimizerConfig, *, remat: bool = True
                    ) -> Callable:
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics).
    The step updates the params and moments in place, as the reference's
    default ``donate=True`` donates their buffers to its jitted step."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, aux = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        params, opt_state, om = adamw_update(oc, grads, opt_state, params)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}, **om}
        return params, opt_state, metrics

    return step


def _batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (integer arrays as int64)."""
    return {k: torch.from_numpy(v).to(device, torch.long if v.dtype.kind == "i"
                                      else None)
            for k, v in batch.items()}


def train_loop(model, *, oc: Optional[OptimizerConfig] = None,
               dc: Optional[SyntheticDataConfig] = None,
               num_steps: int = 50, seed: int = 0,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
               resume: bool = False, log_every: int = 10,
               log_fn: Callable[[str], None] = print, device=None) -> Dict:
    """End-to-end host loop on synthetic data. Returns final metrics.
    ``device`` None is the CUDA device (raises without one)."""
    device = resolve_device(device)
    oc = oc or OptimizerConfig(total_steps=num_steps)
    dc = dc or SyntheticDataConfig()
    start = 0
    if resume and ckpt_dir:
        tree, start = load_checkpoint(ckpt_dir, device)
        params, opt_state = tree["params"], tree["opt_state"]
        opt_state["step"] = opt_state["step"].to(torch.int32)
    else:
        params = model.init(seed, device)
        opt_state = adamw_init(params)
    step_fn = make_train_step(model, oc)

    losses = []
    t0 = time.time()
    for step in range(start, num_steps):
        batch = _batch_to(make_batch(model.cfg, dc, step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss at step {step}")
        if log_every and (step % log_every == 0 or step == num_steps - 1):
            log_fn(f"step {step:5d}  loss {loss:.4f}  "
                   f"gnorm {float(metrics['grad_norm']):.3f}  "
                   f"lr {float(metrics['lr']):.2e}")
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir,
                            {"params": params, "opt_state": opt_state},
                            step + 1)
    wall = time.time() - t0
    out = {"first_loss": losses[0] if losses else float("nan"),
           "final_loss": losses[-1] if losses else float("nan"),
           "steps": max(num_steps - start, 0), "wall_s": wall,
           "loss_curve": losses}
    if ckpt_dir and ckpt_every:
        save_checkpoint(ckpt_dir, {"params": params, "opt_state": opt_state},
                        num_steps)
    out["params"] = params
    out["opt_state"] = opt_state
    return out
