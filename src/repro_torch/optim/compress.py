"""Gradient compression for cross-node reductions — the port of
``repro/optim/compress.py``.

int8 per-chunk-scaled quantization:
    q = round(g / s),  s = max|g_chunk| / 127 + 1e-30   (256-element chunks)
The codes and scales are bitwise the reference's.  The error-feedback
collectives (``compressed_psum``, ``pod_reduce_with_feedback``) reduce over
a mesh axis, which waits for multi-GPU (ROADMAP A10); here are the
quantizer, its round trip, the residual's initial state and the stateless
tree round trip that ``TrainConfig.compress_grads`` applies.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import stack_plan, tree_at, tree_map

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
