"""Batched serving on one card: prefill + decode loop with greedy/temperature
sampling. The counterpart of `repro.runtime.serve`.

Requests are served in fixed-size batches (`generate` retires rows on EOS by
masking). The prefill runs the flash-attention kernel in every layer and every
forward pass runs the RMSNorm kernel twice per layer plus once at the end.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import PARAM_DTYPE, Model


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0     # 0 => greedy
    eos_id: int = -1             # -1 => never stop early
    seed: int = 0


class BatchedServer:
    def __init__(self, model_cfg: ModelConfig, max_seq: int, batch_size: int,
                 params=None, *, device="cuda", dtype: torch.dtype = PARAM_DTYPE):
        """params: a nested tree of tensors named as the model's params; None
        draws random ones from a generator seeded with 0."""
        self.cfg = model_cfg
        self.shape = ShapeConfig("serve", max_seq, batch_size, "decode")
        self.model = Model(model_cfg, device=device, dtype=dtype)
        self.device = self.model.device
        if params is None:
            self.model.init(torch.Generator(device=self.device).manual_seed(0))
        else:
            self.model.load_params(params)
        # Host-clock seconds of the last `generate`: to the first token, and after.
        self.last_timing = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}

    def generate(self, prompts: np.ndarray, serve: Optional[ServeConfig] = None) -> np.ndarray:
        """prompts: (B, P) int32. Returns generated ids (B, max_new)."""
        serve = serve or ServeConfig()
        B, P = prompts.shape
        if P + serve.max_new_tokens > self.shape.seq_len:
            raise ValueError(f"prompt {P} + {serve.max_new_tokens} new tokens exceed "
                             f"max_seq {self.shape.seq_len}")
        t0 = time.perf_counter()
        cache = self.model.init_cache(self.shape, batch_size=B)
        logits, cache = self.model.prefill(torch.as_tensor(prompts, device=self.device), cache)
        gen = torch.Generator(device=self.device).manual_seed(serve.seed)
        outs = []
        done = np.zeros((B,), bool)
        tok = self._sample(logits, serve, gen)
        t1 = None
        steps = 0
        for t in range(serve.max_new_tokens):
            outs.append(tok.cpu().numpy())       # waits for the device
            if t1 is None:
                t1 = time.perf_counter()
            if serve.eos_id >= 0:
                done |= outs[-1] == serve.eos_id
                if done.all():
                    break
            logits, cache = self.model.decode(cache, tok, P + t)
            steps += 1
            tok = self._sample(logits, serve, gen)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.last_timing = {"prefill_s": (t1 or t2) - t0, "decode_s": t2 - (t1 or t2),
                            "decode_steps": steps}
        return np.stack(outs, axis=1)

    def _sample(self, logits, serve: ServeConfig, gen: torch.Generator) -> torch.Tensor:
        lg = logits[:, -1].float()
        if serve.temperature <= 0.0:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg / serve.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def throughput_report(server: BatchedServer, prompt_len: int = 32,
                      new_tokens: int = 16) -> dict:
    """Tokens/s for one batch, with the prefill and per-token decode times."""
    B = server.shape.global_batch
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, server.cfg.vocab, (B, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = server.generate(prompts, ServeConfig(max_new_tokens=new_tokens))
    dt = time.perf_counter() - t0
    tm = server.last_timing
    return {"batch": B, "new_tokens": int(out.shape[1]),
            "tokens_per_s": B * out.shape[1] / dt, "wall_s": dt,
            "prefill_s": tm["prefill_s"],
            "decode_s_per_token": tm["decode_s"] / max(tm["decode_steps"], 1)}
