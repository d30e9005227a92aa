"""Checkpointing: atomic, async, shard-spec checked; the counterpart of
`repro.checkpoint.manager`, in the same on-disk layout, so a checkpoint of
either package restores into the other.

  * layout: <dir>/step_<N>/ with one `leaf_<i>.npy` per leaf and
    `manifest.json` (step, time, extra metadata, and per leaf its name,
    shape, dtype and shard spec). Leaves are in `jax.tree.flatten` order
    (sorted keys at every level) and named by their key paths, so
    `{"params": ..., "opt": ...}` gives "opt/m", "opt/step", "opt/v",
    "params/emb", ...; bf16 is stored as a uint16 view with dtype
    "bfloat16", as the JAX manager stores it;
  * atomicity: written to step_<N>.tmp, then renamed: a crash mid-write
    never corrupts the latest checkpoint;
  * async: `save(..., blocking=False)` copies the tensors to host memory on
    the caller's thread, then writes on a background thread; an error there
    surfaces at the next `wait()`;
  * retention: the last `keep` checkpoints are kept.

One process writes. Under several ranks the trainer gathers what is sharded
and saves from rank 0 (`runtime.train.Trainer.save`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in `jax.tree_util.tree_flatten_with_path` order."""
    if not isinstance(tree, dict):
        return [(prefix or "leaf", tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += _flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree_like, leaves: List[Any]):
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) for k in sorted(t)} if isinstance(t, dict) else next(it)

    return build(tree_like)


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    # a copy even on the CPU: the trainer updates its tensors in place while
    # an async write is still reading the snapshot
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: Optional[Dict] = None, blocking: bool = True,
             specs: Optional[Dict[str, str]] = None) -> None:
        """Snapshot `tree` (nested dicts of tensors) at `step`.

        `specs` maps leaf names (e.g. ``"opt/m"``) to a shard-spec string
        recorded in the manifest's ``shard`` field, e.g. the ZeRO step's
        ``"zero-carrier:data"`` for carrier-sharded moments. The arrays written
        are the full (gathered) values; the spec is layout metadata that
        `restore` checks, so a sharded checkpoint never loads silently into a
        replicated trainer or the reverse.
        """
        self.wait()  # one async save in flight at a time
        specs = specs or {}
        # the host copy is taken now; training may go on while it is written
        host = [(name,) + _to_host(t) for name, t in _flatten_with_paths(tree)]
        manifest = {
            "step": int(step),
            "time": time.time(),
            "extra": extra or {},
            "leaves": [{"name": n, "shape": list(a.shape), "dtype": dt, "shard": specs.get(n)}
                       for n, a, dt in host],
        }

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (_name, arr, _dt) in enumerate(host):
                np.save(tmp / f"leaf_{i}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # surfaced on the next wait()
                    self._last_error = e
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise RuntimeError(f"async checkpoint write failed: {err}")

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp"):
                continue
            if not (p / "manifest.json").exists():
                continue  # incomplete
            steps.append(int(p.name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, tree_like, step: Optional[int] = None, device=None,
                specs: Optional[Dict[str, str]] = None) -> Tuple[Any, Dict]:
        """Restore into the structure of `tree_like`, whose leaves (tensors,
        meta tensors included) give each leaf's shape and dtype. The leaves
        are put on `device` (the CPU when None): the JAX restore's
        `shardings`, on one device.

        `specs` declares which leaves the caller expects to be shard-laid-out
        (the same name -> spec mapping as `save`). A mismatch against the
        manifest raises before any leaf is loaded: restoring a ZeRO
        carrier-sharded checkpoint into a replicated trainer (or the reverse)
        would reinterpret optimizer moments under the wrong layout, not just
        the wrong shape."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = _flatten_with_paths(tree_like)
        specs = specs or {}
        saved_specs = {m["name"]: m.get("shard") for m in manifest["leaves"] if m.get("shard")}
        if saved_specs and not specs:
            raise ValueError(
                f"checkpoint step_{step} carries shard-laid-out leaves "
                f"{sorted(saved_specs)} (specs {sorted(set(saved_specs.values()))}) "
                f"but the restore target expects replicated state — a ZeRO "
                f"(zero=True) checkpoint cannot restore into a replicated "
                f"trainer; rebuild with zero=True or re-save replicated")
        if specs and not saved_specs:
            raise ValueError(
                f"restore target expects shard-laid-out leaves "
                f"{sorted(specs)} but checkpoint step_{step} holds replicated "
                f"state — a replicated checkpoint cannot restore into a ZeRO "
                f"(zero=True) trainer; rebuild without zero or re-save sharded")
        for name in sorted(set(specs) | set(saved_specs)):
            want, got = specs.get(name), saved_specs.get(name)
            if got != want:
                raise ValueError(
                    f"leaf {name}: checkpoint shard spec {got!r} != expected "
                    f"{want!r} — sharded layouts must match exactly (same DP "
                    f"axes and carrier geometry) to restore")
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, target structure "
                f"{len(leaves)} — incompatible trees")
        out = []
        for i, (meta, (name, like)) in enumerate(zip(manifest["leaves"], leaves)):
            t = _from_host(np.load(d / f"leaf_{i}.npy"), meta["dtype"])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"leaf {name}: checkpoint shape {tuple(t.shape)} != "
                                 f"target {tuple(like.shape)}")
            out.append(t.to(device=device or "cpu", dtype=like.dtype))
        return _unflatten(tree_like, out), manifest["extra"]

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if not p.name.endswith(".tmp") and (p / "manifest.json").exists())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
