"""Carry weights across from the JAX reference.

The reference keeps its parameters as a pytree with the layers stacked on
a leading ``L`` axis (``repro/models/transformer.py``: ``init`` vmaps the
layer init).  :func:`params_from_jax` takes that tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameters — one dict per layer — on ``device``.  bfloat16 arrays arrive
as ``ml_dtypes.bfloat16``; their bits are reinterpreted, never rounded.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.uint16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return tensor_from_numpy(x, device)


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Reference dense-model params (stacked layers) -> port params
    (``{"embed", "layers": [per-layer dict, ...], "norm_f"}``)."""
    stacked = tree["layers"]
    n_layers = int(np.asarray(
        next(iter(next(iter(stacked.values())).values()))).shape[0])

    def layer(tree_l, i):
        if isinstance(tree_l, dict):
            return {k: layer(v, i) for k, v in tree_l.items()}
        return tensor_from_numpy(np.asarray(tree_l)[i], device)

    return {
        "embed": _tree(tree["embed"], device),
        "layers": [layer(stacked, i) for i in range(n_layers)],
        "norm_f": _tree(tree["norm_f"], device),
    }
