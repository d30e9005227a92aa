"""Deterministic synthetic LM tokens: the counterpart of `DataConfig` and
`SyntheticLM` in `repro.data.pipeline`, copied (numpy only).

Batches are a pure function of (seed, step), and `batch_at` gives the JAX
package's arrays bit for bit, so the two trainers see the same tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class DataConfig:
    seed: int = 1234
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Deterministic random-token batches shaped per (model, shape) pair,
    including the stub modality frontends (VLM patch embeddings, audio
    codebooks)."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 cfg: Optional[DataConfig] = None):
        self.m = model_cfg
        self.shape = shape
        self.cfg = cfg or DataConfig()

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.PCG64(hash((self.cfg.seed, step)) % (2**63)))
        B, S = self.shape.global_batch, self.shape.seq_len
        B_local = B // self.cfg.host_count
        lo = self.cfg.host_index * B_local
        out: Dict[str, np.ndarray] = {}
        if self.m.family == "vlm":
            toks = rng.integers(0, self.m.vocab, (B, S - self.m.n_img_tokens), dtype=np.int32)
            img = rng.standard_normal((B, self.m.n_img_tokens, self.m.d_model), dtype=np.float32)
            out = {"tokens": toks[lo:lo + B_local],
                   "img_embeds": img[lo:lo + B_local].astype(np.float32)}
        elif self.m.n_codebooks:
            toks = rng.integers(0, self.m.vocab, (B, S, self.m.n_codebooks), dtype=np.int32)
            out = {"tokens": toks[lo:lo + B_local]}
        else:
            toks = rng.integers(0, self.m.vocab, (B, S), dtype=np.int32)
            out = {"tokens": toks[lo:lo + B_local]}
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
