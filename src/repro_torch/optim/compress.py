"""Gradient compression for cross-node reductions — the port of
``repro/optim/compress.py``.

int8 per-chunk-scaled quantization:
    q = round(g / s),  s = max|g_chunk| / 127 + 1e-30   (256-element chunks)
The codes and scales are bitwise the reference's.  Beside the quantizer,
its round trip, the residual's initial state and the stateless tree round
trip that ``TrainConfig.compress_grads`` applies, the collectives that
carry the codes over a mesh axis: :func:`compressed_psum` and the
error-feedback step :func:`pod_reduce_with_feedback`.  On the wire are
what the reference's docstring names, int8 codes and fp32 scales: each
rank all-gathers them over the axis, dequantizes every rank's and sums
them in rank order, so every rank holds the same bits (``launch.mesh.
moved`` counts the codes' and scales' bytes under "all_gather").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.optimizers import (stack_plan, tree_at, tree_leaves,
                                          tree_map)

CHUNK = 256


def _pad_to_chunks(x):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % CHUNK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, CHUNK), pad


def quantize(g):
    """g: any shape, fp32 or bf16 -> (int8 codes [n, CHUNK], fp32 scales
    [n])."""
    chunks, _ = _pad_to_chunks(g.float())
    scale = torch.amax(torch.abs(chunks), dim=1) / 127.0 + 1e-30
    q = torch.clamp(torch.round(chunks / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q, scale, shape):
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compress_decompress(g):
    """The round trip the wire would carry."""
    q, s = quantize(g)
    return dequantize(q, s, tuple(g.shape))


def _sum_codes(q, scale, shape, mesh, axis: str):
    """The sum over ``axis`` of every rank's dequantized (q, scale): the
    codes and scales all-gathered, dequantized and added in rank order
    (fp32; the same bits on every rank)."""
    qs = mesh_mod.all_gather(q[None], mesh, axis)
    ss = mesh_mod.all_gather(scale[None], mesh, axis)
    total = dequantize(qs[0], ss[0], shape)
    for r in range(1, qs.shape[0]):
        total = total + dequantize(qs[r], ss[r], shape)
    return total


def compressed_psum(x, mesh, axis: str):
    """The all-reduce over ``axis`` of ``mesh`` carrying int8 codes and
    fp32 scales: the sum over the ranks of dequant(quant(x_i)), fp32.
    Without the axis (no mesh, or one rank on it) the rank's own
    dequant(quant(x))."""
    q, s = quantize(x)
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return dequantize(q, s, tuple(x.shape))
    return _sum_codes(q, s, tuple(x.shape), mesh, axis)


def pod_reduce_with_feedback(grads, residual, axis: str = "pod"):
    """One error-feedback compression step for a gradient tree about to
    cross ``axis``: each leaf plus its residual is quantized, the new
    residual is what the codes miss, and the codes' mean over ``axis`` of
    the current mesh (``launch.mesh.use_mesh``) is the reduced gradient,
    in the leaf's dtype.  Without a mesh, or on a mesh without ``axis``,
    the leaf's own dequantized codes (the reference's local-only
    fallback).  Returns (reduced grads, new residual)."""
    mesh = mesh_mod.get_mesh()

    def one(g, r):
        g32 = g.float() + r
        q, s = quantize(g32)
        deq = dequantize(q, s, tuple(g32.shape))
        new_r = g32 - deq
        if mesh is not None and axis in mesh.axis_names:
            if mesh.shape[axis] > 1:
                deq = _sum_codes(q, s, tuple(g32.shape), mesh, axis)
            deq = deq / mesh.shape[axis]
        return deq.to(g.dtype), new_r
    pairs = iter([one(g, r) for g, r in zip(
        tree_leaves(grads), tree_leaves(residual), strict=True)])
    pairs = tree_map(lambda _: next(pairs), grads)
    return (tree_map(lambda _, p: p[0], grads, pairs),
            tree_map(lambda _, p: p[1], grads, pairs))


def init_residual(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compress_tree_for_pod_reduce(grads, stacks=None):
    """Every leaf through :func:`compress_decompress` (fp32 out), as the
    reference's train step applies it with ``compress_grads``.  The
    reference quantizes each stacked leaf whole, so its 256-element chunks
    run across the layers of a stack: ``stacks`` (``model.layer_stacks``)
    names them, and each stack's leaves are quantized as one flat array in
    layer order, which keeps the codes bitwise the reference's."""
    out = tree_map(lambda g: g, grads)
    for paths in stack_plan(grads, stacks):
        leaves = [tree_at(grads, p) for p in paths]
        flat = compress_decompress(torch.cat([g.reshape(-1)
                                              for g in leaves]))
        for p, part in zip(paths, flat.split([g.numel() for g in leaves]),
                           strict=True):
            _put(out, p, part.reshape(tree_at(grads, p).shape))
    return out


def _put(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value
