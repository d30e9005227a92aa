"""Model facade for the dense decoder on one card: the counterpart of the dense
branch of `repro.models.model.Model`.

  model = Model(cfg, device="cuda").init(torch.Generator("cuda").manual_seed(0))
  loss = model.loss({"tokens": tokens})              # train objective
  cache = model.init_cache(shape, batch_size)
  logits, cache = model.prefill(tokens, cache)       # last position only
  logits, cache = model.decode(cache, tokens, pos)

The model owns its params (an `nn.Module` tree named as the JAX package's
param tree, with `requires_grad` set for training; serving runs under
`no_grad`); `load_params` fills them from such a tree, for example one made
by `convert.params_from_numpy`. `flat_leaves` lists a tree's leaves in the
order `jax.tree.flatten` gives the JAX package's tree.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeConfig
from . import transformer as T

PARAM_DTYPE = T.PARAM_DTYPE
NORM_PARAMS = ("ln1", "ln2", "ln_f")


def flat_leaves(tree: Dict[str, Any]) -> List[Any]:
    """The leaves of a nested dict in `jax.tree.flatten` order: sorted keys at
    every level (for smollm: emb, layers.ln1, ln2, mlp.w1, w2, w3, wk, wo, wq,
    wv, ln_f). The codec table, the bucket boundaries and the int8 error state
    all follow this order; `ParamTree`'s own order is insertion order."""
    out: List[Any] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flat_leaves(v) if isinstance(v, dict) else [v])
    return out


def unflatten_like(tree: Dict[str, Any], leaves: List[Any]) -> Dict[str, Any]:
    """The inverse of `flat_leaves`: `leaves` nested as `tree`."""
    it = iter(leaves)

    def build(d):
        return {k: build(d[k]) if isinstance(d[k], dict) else next(it) for k in sorted(d)}

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class ParamTree(nn.Module):
    """Parameters nested as the JAX package's param tree: `layers.mlp.w1` is
    its `layers/mlp/w1`. `as_dict()` gives the nested dict the model's
    functions read. Every parameter requires grad; serving runs under
    `no_grad`."""

    def __init__(self, shapes: Dict[str, Any], device, dtype):
        super().__init__()
        for name, v in shapes.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v, device, dtype))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(v, device=device, dtype=dtype)))

    def as_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {n: p for n, p in self.named_parameters(recurse=False)}
        out.update({n: m.as_dict() for n, m in self.named_children()})
        return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device="cuda", dtype: torch.dtype = PARAM_DTYPE):
        super().__init__()
        if cfg.family != "dense" or cfg.mlp != "swiglu" or cfg.fused_qkv or cfg.fast_norm:
            raise NotImplementedError(f"{cfg.name}: only the dense swiglu decoder without "
                                      f"the fused_qkv and fast_norm knobs is ported")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = ParamTree(T.dense_param_defs(cfg), self.device, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random params as the JAX package draws them: norms are ones, every
        other weight N(0, 1) / sqrt(d_model) drawn in fp32, in sorted name order.
        The draws are not jax.random's; the distribution is the same."""
        std = 1.0 / self.cfg.d_model ** 0.5
        for name, p in sorted(self.params.named_parameters()):
            if name.rsplit(".", 1)[-1] in NORM_PARAMS:
                p.fill_(1.0)
            else:
                w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                                device=generator.device)
                p.copy_(w * std)
        return self

    @torch.no_grad()
    def load_params(self, tree: Dict[str, Any]) -> "Model":
        """Copy a nested tree of tensors, named and shaped as the params, into them
        (cast to the model's dtype and device)."""
        flat = {}

        def walk(d, prefix=""):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v, prefix + k + ".")
                else:
                    flat[prefix + k] = v

        walk(tree)
        own = dict(self.params.named_parameters())
        if set(flat) != set(own):
            raise ValueError(f"param names differ: missing {sorted(set(own) - set(flat))}, "
                             f"unexpected {sorted(set(flat) - set(own))}")
        for name, p in own.items():
            if tuple(flat[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(flat[name].shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(flat[name])
        return self

    # -------------------------------------------------------------- loss
    def _logits_and_targets(self, batch, params):
        params = self.params.as_dict() if params is None else params
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = T.embed_tokens(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        xh = T.forward(params, x, self.cfg, positions)
        return T.unembed(params, xh[:, :-1], self.cfg), tokens[:, 1:]

    def loss(self, batch: Dict[str, Any], params: Optional[Dict[str, Any]] = None):
        """Mean next-token cross-entropy of `batch["tokens"]` (B, S): the dense
        branch of the JAX package's `Model.loss`, the logits of positions
        [0, S-1) against the tokens at [1, S). `params` defaults to the
        model's own tree."""
        return T.cross_entropy(*self._logits_and_targets(batch, params))

    def token_nll(self, batch: Dict[str, Any], params: Optional[Dict[str, Any]] = None):
        """The loss before its mean: (B, S-1) fp32 per-token NLL."""
        return T.token_nll(*self._logits_and_targets(batch, params))

    # ------------------------------------------------------------ serving
    def abstract_cache(self, shape: ShapeConfig, batch_size: Optional[int] = None):
        """The KV cache as meta tensors. It is PARAM_DTYPE (bf16) whatever the
        params' dtype, as in the JAX package."""
        c = self.cfg
        sh = (c.n_layers, batch_size or shape.global_batch, shape.seq_len, c.n_kv_heads,
              c.head_dim)
        return {n: torch.empty(sh, dtype=PARAM_DTYPE, device="meta") for n in ("k", "v")}

    def init_cache(self, shape: ShapeConfig, batch_size: Optional[int] = None):
        return {n: torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                for n, t in self.abstract_cache(shape, batch_size).items()}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache) -> Tuple[torch.Tensor, Dict]:
        """Forward over a prompt (B, P), filling `cache`. Returns the logits of
        the last position, (B, 1, V), and the cache."""
        tokens = tokens.to(self.device)
        params = self.params.as_dict()
        x = T.embed_tokens(params, tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        xh, cache = T.forward_with_cache(params, x, self.cfg, positions, cache)
        return T.unembed(params, xh[:, -1:], self.cfg), cache

    @torch.no_grad()
    def decode(self, cache, tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
        """One decode step. tokens: (B,); pos: the position they take."""
        tokens = tokens.to(self.device)
        params = self.params.as_dict()
        x = T.embed_tokens(params, tokens[:, None])
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.long, device=self.device)
        xh, cache = T.forward_with_cache(params, x, self.cfg, positions, cache, pos=int(pos))
        return T.unembed(params, xh[:, -1:], self.cfg), cache
