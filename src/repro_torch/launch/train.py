"""Training launcher: the counterpart of `repro.launch.train` for the dense
decoder.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      [--shape train_4k] [--reduced] --steps 100 [--lr 3e-4] [--warmup 50] \
      [--explicit-dp] [--bucket-bytes N] [--compress-bits {0,8}] [--device cuda]

  torchrun --nproc_per_node N -m repro_torch.launch.train ... --explicit-dp

Under `torchrun` it joins the process group from the environment (NCCL on
the card, gloo with `--device cpu`). Alone it makes a one-rank group in
memory. A `cuda` run without a card raises.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys

import torch
import torch.distributed as dist

from ..configs.base import SHAPES, get_config, list_configs, shape_applicable
from ..models.model import resolve_device
from ..optim import OptConfig
from ..runtime.train import Trainer, TrainConfig


def init_group(device: torch.device) -> None:
    """Join the process group: from torchrun's environment when it set one,
    else a one-rank group in memory."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, timeout=datetime.timedelta(minutes=10))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--explicit-dp", action="store_true",
                    help="data-parallel step over the process group with the bucket "
                         "codec's gradient wire")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="gradient bucket size for --explicit-dp (default 4 MiB; "
                         "0 = per-tensor)")
    ap.add_argument("--compress-bits", type=int, default=0, choices=[0, 8],
                    help="8 = int8 error-feedback wire for --explicit-dp, 0 = fp32 wire")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) runs the kernels; "cpu" the plain versions')
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    if args.reduced:
        shape = shape.reduced()
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise SystemExit(why)
    if shape.kind != "train":
        raise SystemExit(f"--shape {args.shape} is a {shape.kind} shape; use launch.serve")
    device = resolve_device(args.device)

    init_group(device)
    try:
        if dist.get_world_size() > 1 and not args.explicit_dp:
            raise SystemExit("several ranks need --explicit-dp")
        trainer = Trainer(
            cfg, shape,
            OptConfig(peak_lr=args.lr, warmup_steps=args.warmup, decay_steps=args.steps),
            TrainConfig(steps=args.steps, log_every=10, explicit_dp=args.explicit_dp,
                        bucket_bytes=args.bucket_bytes, compress_bits=args.compress_bits),
            device=device)
        result = trainer.run()
        losses = [m["loss"] for m in result["metrics"]]
        if losses and dist.get_rank() == 0:
            print(f"done: step {result['final_step']}, loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, {result['final_devices']} rank(s) on {device}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
