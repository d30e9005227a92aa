"""Training loop: the counterpart of `repro.runtime.train`'s `TrainConfig` and
`Trainer`, without the recovery machinery.

  trainer = Trainer(cfg, shape, OptConfig(...), TrainConfig(explicit_dp=True))
  result = trainer.run()          # {"final_step", "metrics", "final_devices"}

The explicit-DP path runs over the default process group (the JAX mesh's
data axis), which the caller initializes: NCCL on the card, gloo on the CPU
(`launch.train` does it, alone or under `torchrun`). Without explicit DP the
step runs in one process with no collectives. Batches are
`data.SyntheticLM`'s, the JAX trainer's arrays.

Checkpointing, fault injection, the drift guard, straggler actions and
bounded retry are not ported yet: their fields exist and raise if set.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import SyntheticLM
from ..models.model import PARAM_DTYPE, Model
from ..optim import adamw
from . import steps as rsteps


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    microbatches: int = 1
    log_every: int = 10
    # explicit-DP path: params replicated, batch rows split over the process
    # group, gradients packed, reduced and unpacked by the bucket codec
    explicit_dp: bool = False
    bucket_bytes: Optional[int] = None    # None = 4 MiB, 0 = per-tensor
    compress_bits: int = 0                # 8 = int8 error-feedback wire
    overlap: bool = False
    zero: bool = False
    dcn_axis: Optional[str] = None
    # not ported yet: setting any of these raises
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    straggler_action: Optional[str] = None
    faults: Optional[object] = None
    guard: bool = False
    max_retries: int = 0


_NOT_PORTED = {"ckpt_every": 0, "ckpt_dir": None, "straggler_action": None, "faults": None,
               "guard": False, "max_retries": 0}


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
            raise NotImplementedError(f"TrainConfig {set_fields}: checkpointing, faults, the "
                                      f"guard, straggler actions and retry are not ported yet")
        self.data = data or SyntheticLM(model_cfg, shape)
        self.model = Model(model_cfg, device=device, dtype=dtype)
        self.device = self.model.device
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
        AdamW state."""
        self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        params = self.model.params.as_dict()
        return params, adamw.init_opt_state(params)

    def run(self, params=None, opt_state=None, start_step: int = 0) -> Dict:
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
            if step % self.cfg.log_every == 0 and (not dist.is_initialized()
                                                   or dist.get_rank() == 0):
                print(f"step {step:5d} loss {row['loss']:.4f} "
                      f"gnorm {row['grad_norm']:.3f} {dt*1e3:.0f}ms", flush=True)
            step += 1
        self.params, self.opt_state = params, opt_state
        return {"final_step": step, "metrics": self.metrics_log,
                "final_devices": dist.get_world_size() if self._dp_step is not None else 1}
