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
keeps one carrier in device memory. With `async_op=True` an entry returns a
`Pending` whose `wait()` gives the result: the overlap schedule issues a
bucket's collective and waits for it later, as the JAX scan leaves the
collective's completion to XLA's scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """Registry entry: fn(x, group, async_op=False). The JAX entry's dispatch
    constraints (power-of-two-only schedules, multi-axis variants) come with
    the repo's own algorithms; the library's entries need none."""

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


@dataclasses.dataclass
class Pending:
    """A collective in flight (`async_op=True`): `wait()` waits for its
    library calls and returns its result. On the card the wait orders the
    current stream after the collective's; it does not block the host."""

    works: List
    finish: Callable[[], torch.Tensor]

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.finish()


def pending_or_result(works, finish, async_op: bool):
    """A `Pending` of `finish()` after `works` when `async_op`, else its result."""
    pending = Pending(list(works), finish)
    return pending if async_op else pending.wait()


@register("all_reduce", "xla")
def xla_all_reduce(x: torch.Tensor, group=None, async_op: bool = False):
    """The *CCL analog: the library's sum all-reduce, in place on `x`."""
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group, async_op=True)
    return pending_or_result([work], lambda: x, async_op)


@register("reduce_scatter", "xla")
def xla_reduce_scatter(x: torch.Tensor, group=None, async_op: bool = False):
    """The library's reduce-scatter: the flat buffer is zero-padded to a
    multiple of the group size and this rank gets its chunk of the sum,
    len = padded_size / n (the JAX entry's contract)."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = flat.new_empty(flat.numel() // n)
    work = dist.reduce_scatter_tensor(out, flat.contiguous(), op=dist.ReduceOp.SUM,
                                      group=group, async_op=True)
    return pending_or_result([work], lambda: out, async_op)


@register("all_gather", "xla")
def xla_all_gather(chunk: torch.Tensor, group=None, async_op: bool = False):
    """The library's all-gather: (n,) + chunk.shape, in rank order."""
    n = dist.get_world_size(group)
    flat = chunk.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    work = dist.all_gather_into_tensor(out, flat, group=group, async_op=True)
    return pending_or_result([work], lambda: out.reshape((n, *chunk.shape)), async_op)
