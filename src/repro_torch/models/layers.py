"""Shared neural layers — the port of ``repro/models/layers.py``: norms,
rope, the GLU MLP, embedding.  Plain functions over parameter dicts; the
``init_*`` functions draw from an explicit ``torch.Generator``."""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


@contextlib.contextmanager
def no_tf32():
    """fp32 products without TF32 inside (the reference's fp32 products are
    full fp32)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def init_dense(gen, d_in: int, d_out: int, dtype, device):
    std = d_in ** -0.5
    w = torch.randn(d_in, d_out, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)


# cuBLAS picks a product's kernel (its tiles, its split of K) by the row
# count, and a row's bits follow the kernel: a decode step's row would get
# other bits in a batch of 2 than in one of 8.  So on CUDA a product of
# fewer than ROW_TILE rows runs over ROW_TILE rows (ROADMAP section C, C2).
ROW_TILE = 16


def _pads(x) -> bool:
    """Whether a product over x's rows runs at ROW_TILE rows: on CUDA
    only, where cuBLAS picks the kernel; CPU products run as they are."""
    return x.is_cuda


@functools.lru_cache(maxsize=None)
def _zero_rows(shape: tuple, dtype, device):
    """ROW_TILE zero rows of one shape, made once (the padding's source,
    so padding is one copy: ``torch.cat``)."""
    return torch.zeros((ROW_TILE, *shape), dtype=dtype, device=device)


def fixed_rows(x, f):
    """f(x) for an f that maps x [n, ...] row by row along dim 0.  An x
    of fewer than ROW_TILE rows is zero-padded to ROW_TILE rows first and
    f's result cut back to n, so each row's bits do not depend on n."""
    n = x.shape[0]
    if n >= ROW_TILE or not _pads(x):
        return f(x)
    zeros = _zero_rows(tuple(x.shape[1:]), x.dtype, x.device)
    return f(torch.cat((x, zeros[n:])))[:n]


def _rows_product(x, f):
    """f(x) for x [..., K] and a product f over its rows, the rows taken
    together as :func:`fixed_rows` takes them."""
    n = x.numel() // x.shape[-1]
    if n >= ROW_TILE or not _pads(x):
        return f(x)
    y = fixed_rows(x.reshape(n, x.shape[-1]), f)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def dense(x, w):
    return _rows_product(x, lambda a: a @ w)


# ---------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, positions, theta: float):
    """positions: [...]; returns (sin, cos) of shape positions.shape + (head_dim/2,)."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions[..., None].float() * freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim] or [..., seq, head_dim]; positions
    broadcastable to x's seq axis.  Rotates (x[:half], x[half:]) pairs —
    neox style."""
    half = x.shape[-1] // 2
    sin, cos = rope_frequencies(x.shape[-1], positions, theta)
    if x.dim() == sin.dim() + 1:      # [..., seq, heads, dim] vs [..., seq, half]
        sin, cos = sin[..., None, :], cos[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP (GLU)
def init_mlp(gen, d_model: int, d_ff: int, dtype, device):
    return {
        "w_gate": init_dense(gen, d_model, d_ff, dtype, device),
        "w_up": init_dense(gen, d_model, d_ff, dtype, device),
        "w_down": init_dense(gen, d_ff, d_model, dtype, device),
    }


def mlp(params, x):
    h = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
    return dense(h, params["w_down"])


# ---------------------------------------------------------------- Embedding
def init_embed(gen, vocab: int, d_model: int, dtype, device):
    w = torch.randn(vocab, d_model, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def embed(table, tokens):
    return table[tokens.long()]


def unembed_table(table):
    """The fp32 unembedding table: the embedding upcast exactly, once per
    model (the full-vocab upcast is 129280 x 7168 at DeepSeek's width)."""
    return table.float()


def unembed(table_f32, x):
    """Tied unembedding with fp32 logits; ``table_f32`` from
    :func:`unembed_table`."""
    return _rows_product(x, lambda a: a.float() @ table_f32.T)
