"""Carry weights across from the JAX reference.

The reference keeps its parameters as a pytree with repeated blocks
stacked on leading axes (``repro/models/transformer.py``: ``init`` vmaps
the layer init).  :func:`params_from_jax` takes that tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameters — one dict per block — on ``device``.  bfloat16 arrays
arrive as ``ml_dtypes.bfloat16``; their bits are reinterpreted, never
rounded.  :func:`axes_from_jax` splits the reference's logical-axes tree
(``api.param_logical_axes()``) the same way.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.distributed.sharding import is_axes


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


def _take(tree, i):
    """Entry ``i`` of a numpy tree stacked on its leading axis."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _blocks(tree) -> List[Any]:
    """A stacked numpy tree -> its entries, one per block."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [_take(tree, i) for i in range(np.asarray(leaf).shape[0])]


def params_from_jax(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Reference params -> port params, by family (told apart by the
    tree's keys).  Every leaf keeps its dtype (the MoE router stays
    float32 beside a bfloat16 expert bank).

    * dense / MoE / vision: ``layers`` (L, ...) -> ``{"embed", "layers":
      [per-layer dict, ...], "norm_f"}`` (a vision tree is a dense tree);
    * encoder-decoder: ``enc`` / ``dec`` (L, ...) -> a list of block dicts
      each, ``norm_enc`` as it is;
    * hybrid: ``mamba`` (g, attn_every, ...) -> one list of block dicts per
      group, ``mamba_tail`` (tail, ...) -> a list of block dicts,
      ``shared_attn`` as it is;
    * xLSTM: ``mlstm`` / ``slstm`` (pairs, ...) -> a list of block dicts
      each."""
    out = {"embed": _tree(tree["embed"], device),
           "norm_f": _tree(tree["norm_f"], device)}
    for name in ("layers", "mamba_tail", "mlstm", "slstm", "enc", "dec"):
        if name in tree:
            out[name] = [_tree(b, device) for b in _blocks(tree[name])]
    if "norm_enc" in tree:
        out["norm_enc"] = _tree(tree["norm_enc"], device)
    if "mamba" in tree:
        out["mamba"] = [[_tree(b, device) for b in _blocks(group)]
                        for group in _blocks(tree["mamba"])]
        out["shared_attn"] = _tree(tree["shared_attn"], device)
    return out


def _unstack_axes(tree, n_lead: int):
    """A stacked axes tree with its ``n_lead`` leading (block) axes
    dropped from every leaf."""
    if is_axes(tree):
        return tree[n_lead:]
    return {k: _unstack_axes(v, n_lead) for k, v in tree.items()}


def _lead_dims(tree, n: int) -> tuple:
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return tuple(leaf.shape[:n])


def axes_from_jax(axes: Dict[str, Any], params: Dict[str, Any]
                  ) -> Dict[str, Any]:
    """The reference's logical-axes tree -> the port's, split as
    :func:`params_from_jax` splits the params: a stacked ``(None, *axes)``
    leaf becomes ``axes`` on each block (hybrid's ``mamba`` loses two
    leading axes, one list per group).  ``params`` is the reference's
    params tree (arrays or ``jax.ShapeDtypeStruct`` s), read only for its
    block counts."""
    out = {"embed": axes["embed"], "norm_f": axes["norm_f"]}
    for name in ("layers", "mamba_tail", "mlstm", "slstm", "enc", "dec"):
        if name in axes:
            (n,) = _lead_dims(params[name], 1)
            out[name] = [_unstack_axes(axes[name], 1) for _ in range(n)]
    if "norm_enc" in axes:
        out["norm_enc"] = axes["norm_enc"]
    if "mamba" in axes:
        g, per = _lead_dims(params["mamba"], 2)
        out["mamba"] = [[_unstack_axes(axes["mamba"], 2)
                         for _ in range(per)] for _ in range(g)]
        out["shared_attn"] = axes["shared_attn"]
    return out
