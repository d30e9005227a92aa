"""Training loop: the counterpart of `repro.runtime.train`'s `TrainConfig` and
`Trainer`, with checkpoints and without the recovery machinery.

  trainer = Trainer(cfg, shape, OptConfig(...), TrainConfig(explicit_dp=True))
  result = trainer.run()          # {"final_step", "metrics", "final_devices"}
  result = trainer.run(resume=True)   # from the latest checkpoint in ckpt_dir

The explicit-DP path runs over the default process group (the JAX mesh's
data axis), which the caller initializes: NCCL on the card, gloo on the CPU
(`launch.train` does it, alone or under `torchrun`). Without explicit DP the
step runs in one process with no collectives. Batches are
`data.SyntheticLM`'s, the JAX trainer's arrays.

Checkpoints (`checkpoint.CheckpointManager`) are saved every `ckpt_every`
steps and at the end of `run`, in the JAX package's layout: rank 0 writes,
and under ZeRO it writes the whole (n_buckets, padded) moments, gathered
from every rank's column block; a restore gives each rank its block back.

Fault injection, the drift guard, straggler actions and bounded retry are
not ported yet: their fields exist and raise if set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig, ShapeConfig
from ..core import collectives as coll
from ..data.pipeline import SyntheticLM
from ..models.model import PARAM_DTYPE, Model
from ..optim import adamw
from . import steps as rsteps


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    microbatches: int = 1
    ckpt_every: int = 20
    ckpt_dir: str = "artifacts/ckpt"
    ckpt_async: bool = True
    log_every: int = 10
    # explicit-DP path: params replicated, batch rows split over the process
    # group, gradients packed, reduced and unpacked by the bucket codec
    explicit_dp: bool = False
    bucket_bytes: Optional[int] = None    # None = 4 MiB, 0 = per-tensor
    compress_bits: int = 0                # 8 = int8 error-feedback wire
    # overlap schedule: reverse-layer-order buckets issued one after another;
    # with microbatches > 1 a microbatch's reductions overlap the next backward
    overlap: bool = False
    # ZeRO: reduce-scatter the packed carrier, fused AdamW (K5) on each rank's
    # column block (fp32 m/v sharded), all-gather the params at the wire dtype
    zero: bool = False
    dcn_axis: Optional[str] = None
    # not ported yet: setting any of these raises
    straggler_action: Optional[str] = None
    faults: Optional[object] = None
    guard: bool = False
    max_retries: int = 0


_NOT_PORTED = {"straggler_action": None, "faults": None, "guard": False, "max_retries": 0}


class Trainer:
    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 opt: Optional[adamw.OptConfig] = None,
                 train_cfg: Optional[TrainConfig] = None, data=None, *,
                 device="cuda", dtype: torch.dtype = PARAM_DTYPE):
        self.model_cfg = model_cfg
        self.shape = shape
        self.opt = opt or adamw.OptConfig()
        self.cfg = train_cfg or TrainConfig()
        set_fields = [f for f, unset in _NOT_PORTED.items() if getattr(self.cfg, f) != unset]
        if set_fields:
            raise NotImplementedError(f"TrainConfig {set_fields}: faults, the guard, straggler "
                                      f"actions and retry are not ported yet")
        self.data = data or SyntheticLM(model_cfg, shape)
        self.model = Model(model_cfg, device=device, dtype=dtype)
        self.device = self.model.device
        self.ckpt = CheckpointManager(self.cfg.ckpt_dir)
        self.metrics_log: list = []
        self._build()

    def _build(self):
        c = self.cfg
        if not c.explicit_dp:
            if c.zero or c.overlap:
                raise ValueError("zero and overlap need the explicit-DP path (explicit_dp=True)")
            self._dp_step = None
            self.step_fn = rsteps.build_train_step(self.model, self.opt, c.microbatches)
            return
        if not dist.is_initialized():
            raise ValueError("explicit_dp needs an initialized process group "
                             "(torch.distributed.init_process_group)")
        if c.microbatches > 1 and not c.overlap:
            raise ValueError("explicit-DP gradient accumulation is implemented "
                             "by the overlap schedule; pass overlap=True "
                             "(launch.train --overlap) with microbatches "
                             f"({c.microbatches} requested)")
        dp_step = rsteps.build_explicit_dp_step(
            self.model, self.opt, compress_bits=c.compress_bits, bucket_bytes=c.bucket_bytes,
            dcn_axis=c.dcn_axis, overlap=c.overlap, microbatches=c.microbatches, zero=c.zero)
        self._dp_step = dp_step
        self._dp_err = None

        def step_fn(params, opt_state, batch):
            if self._dp_err is None:
                # carrier-shaped under bucketed compression, per-leaf otherwise
                self._dp_err = dp_step.init_error_state(params)
            params, opt_state, metrics, self._dp_err = dp_step(
                params, opt_state, batch, self._dp_err)
            return params, opt_state, metrics

        self.step_fn = step_fn

    def init_state(self, seed: int = 0):
        """Random params from `seed` (every rank draws the same) and fresh
        AdamW state: under ZeRO this rank's column block of the
        carrier-sharded moments."""
        self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        params = self.model.params.as_dict()
        if self._zero:
            return params, self._dp_step.init_opt_state(params)
        return params, adamw.init_opt_state(params)

    @property
    def _zero(self) -> bool:
        return self._dp_step is not None and self._dp_step.zero

    @staticmethod
    def _rank() -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    def run(self, params=None, opt_state=None, start_step: int = 0,
            resume: bool = False) -> Dict:
        """The step loop from `start_step`, or with `resume` from the latest
        checkpoint when there is one; a checkpoint every `ckpt_every` steps
        and one at the end."""
        if resume and self.ckpt.latest_step() is not None:
            params, opt_state, start_step = self.restore()
        if params is None:
            params, opt_state = self.init_state()
        step = start_step
        while step < self.cfg.steps:
            batch = {k: torch.as_tensor(v) for k, v in self.data.batch_at(step).items()}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the device
            dt = time.perf_counter() - t0
            row = {"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "time_s": dt}
            self.metrics_log.append(row)
            if step % self.cfg.log_every == 0 and self._rank() == 0:
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"gnorm {row['grad_norm']:.3f} {dt*1e3:.0f}ms", flush=True)
            step += 1
            if self.cfg.ckpt_every and step % self.cfg.ckpt_every == 0:
                self.save(step, params, opt_state)
        self.save(step, params, opt_state)
        self._wait_ckpt()
        self.params, self.opt_state = params, opt_state
        return {"final_step": step, "metrics": self.metrics_log,
                "final_devices": dist.get_world_size() if self._dp_step is not None else 1}

    # ------------------------------------------------------------ checkpoint
    def _zero_specs(self) -> Optional[Dict[str, str]]:
        """Per-leaf shard-spec metadata of the ZeRO carrier-sharded m and v
        (the checkpoint refuses a sharded <-> replicated cross-restore)."""
        if not self._zero:
            return None
        spec = self._dp_step.opt_shard_spec
        return {"opt/m": spec, "opt/v": spec}

    def _wait_ckpt(self) -> None:
        """Rank 0's write done, and every rank past that point."""
        self.ckpt.wait()
        if dist.is_initialized():
            dist.barrier()

    def save(self, step: int, params, opt_state) -> None:
        """Checkpoint {"params", "opt"} with extra {"step": step}. Under ZeRO
        every rank takes part in gathering the moments' column blocks."""
        if self._zero:
            gather = coll.get_collective("all_gather", "xla").fn

            def full(t):  # (n, nb, shard) column blocks -> (nb, n * shard)
                g = gather(t)
                return g.permute(1, 0, 2).reshape(t.shape[0], -1)
            opt_state = {"m": full(opt_state["m"]), "v": full(opt_state["v"]),
                         "step": opt_state["step"]}
        if self._rank() == 0:
            self.ckpt.save(step, {"params": params, "opt": opt_state}, extra={"step": step},
                           specs=self._zero_specs(), blocking=not self.cfg.ckpt_async)

    def restore(self, step: Optional[int] = None):
        """(params, opt_state, step) from the checkpoint at `step` (the latest
        when None). The params are copied into the model's own; under ZeRO
        each rank keeps its column block of the moments."""
        self._wait_ckpt()
        params = self.model.params.as_dict()
        abstract = self._dp_step.abstract_opt_state(params) if self._dp_step is not None \
            else adamw.abstract_opt_state(params)
        state, extra = self.ckpt.restore({"params": params, "opt": abstract}, step=step,
                                         device=self.device, specs=self._zero_specs())
        self.model.load_params(state["params"])
        opt_state = state["opt"]
        if self._zero:
            n, r = dist.get_world_size(), dist.get_rank()
            shard = lambda t: t[:, r * (t.shape[1] // n):(r + 1) * (t.shape[1] // n)].contiguous()
            opt_state = {"m": shard(opt_state["m"]), "v": shard(opt_state["v"]),
                         "step": opt_state["step"]}
        return params, opt_state, int(extra["step"])
