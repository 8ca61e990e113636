"""Carry the reference's weights (and optimizer state) into the port.

:func:`params_from_jax` takes the JAX package's parameter tree as nested
dicts/lists of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns the port's parameters.  The reference stacks each layer group on a
leading axis (``repro/models/model.py:layer_groups``): ``groups[g]["b<j>"]``
holds block j of every repeat of group g.  The port keeps one dict per
layer, so the stacked axis is unstacked here in the reference's layer order
(repeat i of a group runs its blocks b0, b1, ... in turn: RecurrentGemma's
rglru, rglru, attn superblock, then its remainder).  A frontend's
projection (``params["frontend"]``) is carried as it is, and a MoE
block's FFN (``router``, ``w_gate``, ``w_up``, ``w_down`` and, with a
shared expert, ``shared``) is unstacked like every other leaf.  Every leaf
keeps the reference's dtype: a bf16 model's weights stay bf16 and its fp32
leaves (Mamba's ``dt_bias``, ``log_neg_A`` and ``D``; RG-LRU's
``log_lambda``; a MoE router) stay fp32.  :func:`tree_from_jax` does the
same for any tree shaped like the params (gradients), and
:func:`opt_state_from_jax` for the optimizers' state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":             # numpy has no bf16: go by bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))          # owned, writable copy
    return t.to(device=device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def tree_from_jax(tree, device="cuda") -> dict:
    """A tree shaped like the reference's params (the params, their
    gradients, an optimizer's per-leaf state) → the port's layout: the
    stacked layer groups unstacked into one dict a layer, every array in
    its own dtype on ``device``.  A leaf may itself be a dict of arrays
    (Adafactor's {"vr", "vc"}), each unstacked alike."""
    out_layers = []
    for gp in tree["groups"]:
        n = np.asarray(_first_leaf(gp)).shape[0]
        for i in range(n):
            for j in range(len(gp)):
                out_layers.append(_map(gp[f"b{j}"],
                                       lambda a, i=i: _tensor(a[i], device)))
    out = {
        "embed": _map(tree["embed"], lambda a: _tensor(a, device)),
        "final_norm": _map(tree["final_norm"],
                           lambda a: _tensor(a, device)),
        "layers": out_layers,
    }
    if "frontend" in tree:
        out["frontend"] = _map(tree["frontend"],
                               lambda a: _tensor(a, device))
    return out


def params_from_jax(tree, device="cuda") -> dict:
    """The reference's params → the port's, on ``device``, each array in its
    own dtype, with the serving copy ``embed_f32``."""
    params = tree_from_jax(tree, device)
    params["embed_f32"] = layers.unembed_table(params["embed"])
    return params


def opt_state_from_jax(state, device="cuda") -> dict:
    """The reference's optimizer state → the port's: AdamW's {"m", "v",
    "count"} or Adafactor's {"v", "count"} (each leaf of "v" a {"vr",
    "vc"} or {"v"} dict), the trees unstacked as :func:`tree_from_jax`
    does, ``count`` an int32 scalar."""
    out = {k: tree_from_jax(v, device) for k, v in state.items()
           if k != "count"}
    out["count"] = _tensor(state["count"], device)
    return out
