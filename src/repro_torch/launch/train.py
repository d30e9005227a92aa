"""Training launcher: the counterpart of `repro.launch.train` for the dense
decoder.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      [--shape train_4k] [--reduced] --steps 100 [--lr 3e-4] [--warmup 50] \
      [--microbatches M] [--explicit-dp] [--bucket-bytes N] [--compress-bits {0,8}] \
      [--overlap] [--zero] [--ckpt-dir D] [--ckpt-every K] [--resume] [--device cuda]

  torchrun --nproc_per_node N -m repro_torch.launch.train ... --explicit-dp

Under `torchrun` it joins the process group from the environment (NCCL on
the card, gloo with `--device cpu`). Alone it makes a one-rank group in
memory. A `cuda` run without a card raises. `--overlap` and `--zero` imply
`--explicit-dp`. The `done:` line gives the median host time of the steps
after the first (the first pays the library's and the allocator's set-up).
"""
from __future__ import annotations

import argparse
import datetime
import os
import statistics
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
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--ckpt-dir", default="artifacts/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true",
                    help="start from the latest checkpoint in --ckpt-dir, if there is one")
    ap.add_argument("--explicit-dp", action="store_true",
                    help="data-parallel step over the process group with the bucket "
                         "codec's gradient wire")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="gradient bucket size for --explicit-dp (default 4 MiB; "
                         "0 = per-tensor)")
    ap.add_argument("--compress-bits", type=int, default=0, choices=[0, 8],
                    help="8 = int8 error-feedback wire for --explicit-dp, 0 = fp32 wire; "
                         "with --zero, the int8 all-gather leg")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap schedule (implies --explicit-dp): reverse-layer-order "
                         "buckets issued one after another; with --microbatches each "
                         "microbatch's reductions overlap the next backward")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO sharded optimizer (implies --explicit-dp): reduce-scatter the "
                         "packed gradient carrier, fused AdamW over each rank's shard (fp32 "
                         "m/v sharded), all-gather the updated params at the wire dtype")
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
    explicit = args.explicit_dp or args.overlap or args.zero

    init_group(device)
    try:
        if dist.get_world_size() > 1 and not explicit:
            raise SystemExit("several ranks need --explicit-dp")
        trainer = Trainer(
            cfg, shape,
            OptConfig(peak_lr=args.lr, warmup_steps=args.warmup, decay_steps=args.steps),
            TrainConfig(steps=args.steps, microbatches=args.microbatches,
                        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir, log_every=10,
                        explicit_dp=explicit, bucket_bytes=args.bucket_bytes,
                        compress_bits=args.compress_bits, overlap=args.overlap,
                        zero=args.zero),
            device=device)
        result = trainer.run(resume=args.resume)
        rows = result["metrics"]
        if rows and dist.get_rank() == 0:
            later = [r["time_s"] * 1e3 for r in rows[1:]]
            step_ms = f"{statistics.median(later):.3f} ms" if later else "not measured"
            print(f"done: step {result['final_step']}, loss {rows[0]['loss']:.4f} -> "
                  f"{rows[-1]['loss']:.4f}, {result['final_devices']} rank(s) on {device}, "
                  f"median host time per step after the first {step_ms}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
