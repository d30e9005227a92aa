"""AdamW with cosine schedule and global-norm clipping: the counterpart of
`repro.optim.adamw`.

Every op is the JAX function's, in the same order and in fp32, so equal
inputs give equal bits on the CPU: no fused or foreach kernels. The step
counter is an int32 tensor, as in the JAX state. Two scalars can still differ
by an ulp from XLA's: the cosine of the schedule (after warmup) and the
global norm, whose sum of squares XLA reduces in another order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..models.model import flat_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to `peak_lr`, then cosine decay to `min_lr`; fp32."""
    warm = cfg.peak_lr * torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict[str, Any]:
    """fp32 zeros for both moments, shaped as the params, and step 0."""
    dev = flat_leaves(params)[0].device
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": _tree_map(zeros32, params), "v": _tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_opt_state(params) -> Dict[str, Any]:
    """`init_opt_state`'s shapes and dtypes as meta tensors (a checkpoint's
    restore target)."""
    meta32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"m": _tree_map(meta32, params), "v": _tree_map(meta32, params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(square(leaf)) in fp32, leaves added
    one by one from zero, in `jax.tree.leaves` order, as Python's `sum` does
    in the JAX function."""
    total = 0
    for leaf in flat_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def apply_updates(params, grads, state, cfg: OptConfig) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params in their own dtypes, new state, metrics).
    Functional, as in the JAX package: nothing given is modified."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    # a true division (a Python float over a tensor would take a reciprocal)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.clip_norm) / (gnorm + 1e-9), 1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = _tree_map(lambda p, g, m, v: upd(p.detach(), g, m, v),
                    params, grads, state["m"], state["v"])
    pick = lambda i: _tree_map(lambda o: o[i], out) if isinstance(out, dict) else out[i]
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics
