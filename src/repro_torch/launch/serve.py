"""Serving launcher on one card (batched prefill + decode).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m [--reduced] \
      --batch 4 --prompt-len 16 --new-tokens 32 [--device cuda]
"""
from __future__ import annotations

import argparse
import sys

from ..configs.base import get_config, list_configs
from ..runtime.serve import BatchedServer, throughput_report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the default) runs the kernels; "cpu" the plain versions')
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    max_seq = args.prompt_len + args.new_tokens + 8
    server = BatchedServer(cfg, max_seq=max_seq, batch_size=args.batch, device=args.device)
    rep = throughput_report(server, prompt_len=args.prompt_len,
                            new_tokens=args.new_tokens)
    print(f"{cfg.name} on {server.device}: {rep['tokens_per_s']:.1f} tok/s "
          f"(batch {rep['batch']}, {rep['new_tokens']} new, {rep['wall_s']:.2f}s; "
          f"prefill {rep['prefill_s'] * 1e3:.2f} ms, "
          f"decode {rep['decode_s_per_token'] * 1e3:.2f} ms/token)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
