"""Move params from the JAX package into the port, name for name.

  tree = jax.tree.map(np.asarray, jax_params)      # on the JAX side
  params = params_from_numpy(tree, device="cuda")
  model = Model(cfg, device="cuda").load_params(params)

Both packages lay weights out for `x @ W` and stack layers on a leading L
axis, so no leaf is transposed or reshaped.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _leaf(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"       # ml_dtypes' bfloat16, which torch cannot read
    t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))  # a writable copy
    return t.to(device=device, dtype=dtype or (torch.bfloat16 if bf16 else t.dtype))


def params_from_numpy(tree: Dict[str, Any], device, dtype: Optional[torch.dtype] = None):
    """A nested dict of numpy arrays -> the same nesting of tensors on `device`,
    cast to `dtype` if given (else each leaf keeps its own dtype)."""
    return {k: params_from_numpy(v, device, dtype) if isinstance(v, dict) else _leaf(v, device, dtype)
            for k, v in tree.items()}
