"""Training driver.

Port of ``repro.launch.train``: the same flags plus ``--device`` (the
CUDA device unless told otherwise), and ``main`` takes ``argv``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
        --smoke --steps 100 --batch 8 --seq 64

``--smoke`` runs the reduced config; without it the full config trains
on the device (one card holds qwen2-vl-2b's 1.5 B params with float32
moments; the big configs need the sharding the port does not have yet).
``--dry-run`` traces train_4k under the production mesh: it runs
``python -m repro_torch.launch.dryrun --arch A --shape train_4k`` in a
subprocess and returns its exit code.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.dryrun import delegate as dry_run
from repro_torch.models.registry import build
from repro_torch.training import (OptimizerConfig, SyntheticDataConfig,
                                  train_loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config on the device")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (smaller = faster smoke)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace train_4k under the production mesh "
                         "(python -m repro_torch.launch.dryrun)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda)")
    args = ap.parse_args(argv)

    if args.dry_run:
        # delegated: the dry run owns its process (its process group)
        return dry_run(args.arch, "train_4k")

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.vocab:
        cfg = cfg.with_(vocab_size=args.vocab)
    model = build(cfg)
    out = train_loop(
        model,
        oc=OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps),
        dc=SyntheticDataConfig(batch=args.batch, seq_len=args.seq),
        num_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, resume=args.resume, device=args.device)
    print(f"done: loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"in {out['steps']} steps ({out['wall_s']:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
