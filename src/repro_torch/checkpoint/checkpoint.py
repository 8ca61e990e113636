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

Under a mesh (``launch.mesh.use_mesh``) the trees may hold this rank's
pieces (``rules.Placed``: the sharded trainer's params and optimizer
state).  :func:`save` gathers them whole first (``rules.gather_placed``,
a collective every rank calls), so a checkpoint always holds whole
leaves, and only global rank 0 writes, blocking, before a barrier.
:func:`restore` reads the whole leaves and cuts each placed template's
pieces by its specs on the current mesh, which may differ from the
mesh that saved it (the reference's reshard-on-load).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import rules

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


def _placed_mesh():
    mesh = mesh_mod.get_mesh()
    if mesh is None:
        raise ValueError("a tree of placed pieces outside a mesh: save and "
                         "restore it under launch.mesh.use_mesh")
    return mesh


def _whole(tree):
    """``tree`` with each placed subtree gathered whole."""
    if isinstance(tree, rules.Placed):
        mesh = _placed_mesh()
        if tree.mesh_shape != mesh.shape:
            raise ValueError(f"pieces placed for {tree.mesh_shape} under "
                             f"the mesh {mesh.shape}")
        return rules.gather_placed(tree, mesh)
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole(v) for v in tree)
    return tree


def _unflatten_into(template, arrays: dict, pre: str = ""):
    def key(k):
        return pre + _SEP + k if pre else k
    if isinstance(template, rules.Placed):
        return rules.Placed(
            _cut_into(dict(template), template.specs, arrays, pre,
                      _placed_mesh()),
            template.mesh_shape, template.specs, template.profile)
    if isinstance(template, dict):
        return {k: _unflatten_into(v, arrays, key(str(k)))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, arrays, key(f"#{i}"))
                              for i, v in enumerate(template))
    if pre not in arrays:
        raise KeyError(f"checkpoint missing leaf {pre}")
    return arrays[pre].to(device=template.device, dtype=template.dtype)


def _cut_into(template, specs, arrays: dict, pre: str, mesh):
    """A placed template's pieces from the whole ``arrays``: each leaf
    cut by its spec on ``mesh``."""
    def key(k):
        return pre + _SEP + k if pre else k
    if isinstance(template, dict):
        return {k: _cut_into(v, specs[k], arrays, key(str(k)), mesh)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_cut_into(v, specs[i], arrays, key(f"#{i}"),
                                        mesh)
                              for i, v in enumerate(template))
    if pre not in arrays:
        raise KeyError(f"checkpoint missing leaf {pre}")
    whole = arrays[pre]
    want = rules.local_shape(whole.shape, specs, mesh)
    if want != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {pre} {tuple(whole.shape)} cut "
                         f"by {specs} on {mesh.shape} is {want}, the "
                         f"template's piece {tuple(template.shape)}")
    return rules.local_rows(whole, specs, mesh).to(
        device=template.device, dtype=template.dtype, copy=True)


def save(ckpt_dir: str, step: int, tree, *, blocking: bool = True):
    """Write the checkpoint of ``step``.  The leaves are copied to the host
    first (after a ``torch.cuda.synchronize()`` where any lives on the
    card), so the caller may update them at once; with ``blocking=False``
    the files are written on a background thread, which is returned:
    ``join()`` it before reading the checkpoint or exiting."""
    ranked = mesh_mod.get_mesh() is not None and dist.is_initialized()
    flat = _flatten(_whole(tree))
    if any(t.is_cuda for t in flat.values()):
        torch.cuda.synchronize()
    if ranked and dist.get_rank() != 0:
        dist.barrier()                 # rank 0 has written the checkpoint
        return None
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

    if blocking or ranked:
        _write()
        if ranked:
            dist.barrier()
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
