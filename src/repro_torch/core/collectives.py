"""The collective registry and its "xla" entries on `torch.distributed`: the
counterpart of the registry in `repro.core.collectives`.

The JAX package registers every algorithm under (kind, name) and its planner
ranks the entries; `"xla"` is the platform library's own collective, the
*CCL analog of the paper. Here that entry is `torch.distributed` itself:
NCCL on the card, gloo on the CPU. The repo's own ring, tree and
Rabenseifner schedules (point to point) are not ported yet.

Where the JAX function takes a mesh axis name, these take a process group
(None is the default group). `all_reduce` reduces in place and returns its
argument: JAX returns a new array, and reducing the carrier's rows in place
keeps one carrier in device memory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """Registry entry: fn(x, group). The JAX entry's dispatch constraints
    (power-of-two-only schedules, multi-axis variants) come with the repo's
    own algorithms; the library's entries need none."""

    name: str
    kind: str                 # all_reduce | reduce_scatter | all_gather
    fn: Callable


_REGISTRY: Dict[str, Dict[str, CollectiveSpec]] = {}


def register(kind: str, name: str):
    """Decorator registering a collective implementation under (kind, name)."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(kind, {})[name] = CollectiveSpec(name, kind, fn)
        return fn

    return deco


def registered(kind: str) -> Dict[str, CollectiveSpec]:
    return dict(_REGISTRY.get(kind, {}))


def get_collective(kind: str, name: str) -> CollectiveSpec:
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        raise KeyError(f"no {kind!r} collective named {name!r}; "
                       f"registered: {sorted(_REGISTRY.get(kind, {}))}") from None


@register("all_reduce", "xla")
def xla_all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The *CCL analog: the library's sum all-reduce, in place on `x`."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@register("reduce_scatter", "xla")
def xla_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The library's reduce-scatter: the flat buffer is zero-padded to a
    multiple of the group size and this rank gets its chunk of the sum,
    len = padded_size / n (the JAX entry's contract)."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter(out, list(flat.chunk(n)), op=dist.ReduceOp.SUM, group=group)
    return out


@register("all_gather", "xla")
def xla_all_gather(chunk: torch.Tensor, group=None) -> torch.Tensor:
    """The library's all-gather: (n,) + chunk.shape."""
    parts = [torch.empty_like(chunk) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, chunk.contiguous(), group=group)
    return torch.stack(parts)
