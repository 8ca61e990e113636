"""Checkpointing with async save and atomic commit — the port of
``repro/checkpoint/checkpoint.py``.

Layout:  <dir>/step_<N>/
            arrays/<flat-key>.npy     one file per leaf of the tree
            MANIFEST.json             leaf shapes and dtypes + the step
The arrays are written into ``step_<N>.tmp``, the directory is renamed into
place, and the manifest is written last: its presence is the commit point,
so a save that dies half way is never restored.  A tree is nested dicts,
lists and tuples of tensors; its leaves are keyed by their path (dict keys,
``#i`` for sequence indices, joined by ``__``).  numpy has no bfloat16 or
float8: those leaves are stored as their bit patterns (uint16, uint8) with
the logical dtype in the manifest, as the reference stores them.
:func:`restore` places each leaf on the template leaf's device in its dtype.
The reference's reshard-on-load onto another mesh waits for multi-GPU
(ROADMAP A10).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

_SEP = "__"

# numpy can't hold bf16 / fp8: store bit patterns + the logical dtype
_BITCAST = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16"),
            torch.float8_e4m3fn: (torch.uint8, np.uint8, "float8_e4m3fn"),
            torch.float8_e5m2: (torch.uint8, np.uint8, "float8_e5m2")}
_LOGICAL = {name: (dt, view) for dt, (view, _, name) in _BITCAST.items()}


def _to_storable(t: torch.Tensor):
    """(numpy array, logical dtype name) of a host tensor."""
    if t.dtype in _BITCAST:
        view, npdt, name = _BITCAST[t.dtype]
        return t.view(view).numpy().view(npdt), name
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def _from_storable(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a)                       # owned, C order, shape kept
    if dtype in _LOGICAL:
        logical, view = _LOGICAL[dtype]
        bits = a.view(np.int16) if view == torch.int16 else a
        return torch.from_numpy(bits).view(logical)
    return torch.from_numpy(a)


def _flatten(tree, pre: str = "") -> dict:
    """{flat key: leaf} in the tree's order."""
    def key(k):
        return pre + _SEP + k if pre else k
    if isinstance(tree, dict):
        return {fk: v for k, sub in tree.items()
                for fk, v in _flatten(sub, key(str(k))).items()}
    if isinstance(tree, (list, tuple)):
        return {fk: v for i, sub in enumerate(tree)
                for fk, v in _flatten(sub, key(f"#{i}")).items()}
    return {pre: tree}


def _unflatten_into(template, arrays: dict, pre: str = ""):
    def key(k):
        return pre + _SEP + k if pre else k
    if isinstance(template, dict):
        return {k: _unflatten_into(v, arrays, key(str(k)))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, arrays, key(f"#{i}"))
                              for i, v in enumerate(template))
    if pre not in arrays:
        raise KeyError(f"checkpoint missing leaf {pre}")
    return arrays[pre].to(device=template.device, dtype=template.dtype)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Write the checkpoint of ``step``.  The leaves are copied to the host
    first (after a ``torch.cuda.synchronize()`` where any lives on the
    card), so the caller may update them at once; with ``blocking=False``
    the files are written on a background thread, which is returned:
    ``join()`` it before reading the checkpoint or exiting."""
    flat = _flatten(tree)
    if any(t.is_cuda for t in flat.values()):
        torch.cuda.synchronize()
    host = {k: t.detach().to("cpu", copy=True) for k, t in flat.items()}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        arr_dir = os.path.join(tmp, "arrays")
        os.makedirs(arr_dir, exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, t in host.items():
            stored, dtype = _to_storable(t)
            np.save(os.path.join(arr_dir, k + ".npy"), stored)
            manifest["leaves"][k] = {"shape": list(t.shape), "dtype": dtype}
        os.replace(tmp, final)                   # atomic rename ...
        with open(os.path.join(final, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)               # ... manifest last: commit

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=False)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    """The newest committed checkpoint (manifest present)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "MANIFEST.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, template):
    """Load the checkpoint of ``step`` into the structure of ``template``,
    each leaf on the template leaf's device in its dtype.  Returns (tree,
    step)."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "MANIFEST.json")) as f:
        manifest = json.load(f)
    arrays = {}
    for k, meta in manifest["leaves"].items():
        a = np.load(os.path.join(final, "arrays", k + ".npy"))
        arrays[k] = _from_storable(a, meta["dtype"])
    return _unflatten_into(template, arrays), manifest["step"]


def gc_old(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(s for s in (
        int(m.group(1)) for m in (re.fullmatch(r"step_(\d+)", n)
                                  for n in os.listdir(ckpt_dir)) if m))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
