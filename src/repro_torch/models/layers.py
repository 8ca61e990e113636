"""Shared neural layers — the port of ``repro/models/layers.py``: norms,
rope, the GLU MLP, embedding.  Plain functions over parameter dicts; the
``init_*`` functions draw from an explicit ``torch.Generator``, each leaf
through :func:`leaf` (under :func:`placing` a leaf is cut to this rank's
piece as soon as it is drawn).

Tensor parallelism: under a mesh a weight may be this rank's piece of the
whole (``sharding.rules.place_params``).  :func:`dense_col` gathers a
column piece's outputs over `model`, :func:`dense_row` sums a row piece's
partial products over `model` (fp32, rounded once); :func:`embed` and
:func:`unembed` take a vocab piece of the table.  Each compares the
piece's width with the whole one its caller names and runs no collective
when they agree, so outside a mesh the products are unchanged.

Training under a mesh (``place_params(profile="train")``): a weight
whose spec names `data` is gathered over `data` where a block starts
(:func:`unshard`), giving its serve-profile piece, so the products above
run unchanged; the gather's backward reduce-scatters, which is the
data-parallel sum of its gradient.  The collectives carry gradients by
the convention of ``launch.mesh`` (its module doc): a value every `model`
rank holds alike passes :func:`enter_model` where it feeds work that
differs by rank (the rank's heads, experts or channels), whose backward
sums the ranks' partial gradients; column pieces' products take their
input through :func:`tp_columns`, which adds those partial gradients in
fp32.  A row piece's product is summed over `model` (:func:`dense_row`)
in training as in serving: Megatron's partial sums, as the reference's
sharded step computes those contractions.  :func:`vocab_nll` is the
cross-entropy over a vocab piece of the logits, which are never
gathered.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_mod


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


# (fn, part, path) while a placed init draws: fn(path, leaf, whole) -> the
# rank's piece, part(path, shape) -> the slices of it (see placing)
_PLACER: contextvars.ContextVar = contextvars.ContextVar("placer",
                                                         default=None)


@contextlib.contextmanager
def placing(fn, part):
    """Within the block each leaf an ``init_*`` function draws is replaced
    by ``fn(path, leaf, None)`` as soon as it is drawn (``path`` as
    :func:`leaf_scope` builds it, e.g. "layers/0/mix/w_uq").  A leaf
    drawn in parts keeps only the slices ``part(path, shape)`` names
    (:func:`leaf_part`) and is then passed as ``fn(path, piece, shape)``,
    ``shape`` the whole leaf's."""
    token = _PLACER.set((fn, part, ()))
    try:
        yield
    finally:
        _PLACER.reset(token)


@contextlib.contextmanager
def leaf_scope(name):
    """Prefix the paths of the leaves drawn within the block with
    ``name``."""
    cur = _PLACER.get()
    token = None if cur is None else _PLACER.set(
        (*cur[:2], cur[2] + (str(name),)))
    try:
        yield
    finally:
        if token is not None:
            _PLACER.reset(token)


def leaf(name: str, t, whole: tuple | None = None):
    """A freshly drawn parameter leaf: ``t``, or under :func:`placing` the
    placer's piece of it.  ``whole``: ``t`` is already the piece
    :func:`leaf_part` named of a leaf of that shape."""
    cur = _PLACER.get()
    return t if cur is None else cur[0]("/".join(cur[2] + (name,)), t,
                                        whole)


def leaf_part(name: str, shape: tuple) -> tuple:
    """The slices (one a dim) of the leaf ``name`` of ``shape`` that this
    rank keeps: under :func:`placing` its piece, else the whole.  A leaf
    drawn in parts keeps only these and passes them to :func:`leaf` with
    ``whole=shape``."""
    cur = _PLACER.get()
    if cur is None:
        return tuple(slice(0, d) for d in shape)
    return cur[1]("/".join(cur[2] + (name,)), tuple(shape))


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


def gather_model(t, whole: int, dim: int = -1):
    """``t``, this rank's piece of ``whole`` entries along ``dim`` (columns,
    heads): the pieces gathered over `model` in rank order (``t`` itself
    when it holds them all).  Its gradient is the rank's slice."""
    if t.shape[dim] == whole:
        return t
    return mesh_mod.gather(t, mesh_mod.get_mesh(), "model", dim=dim % t.dim())


def model_offset(n: int, whole: int) -> int:
    """The first of this rank's ``n`` of ``whole`` entries cut over
    `model` (0 when it holds them all)."""
    return 0 if n == whole else mesh_mod.get_mesh().coord("model") * n


def enter_model(t, cut: bool):
    """``t``, held alike by every `model` rank, as the input of work that
    differs by rank (``cut``): ``launch.mesh.enter`` over `model`, whose
    backward sums the partial gradients; ``t`` itself where nothing is
    cut or no gradient is recorded."""
    return mesh_mod.enter(t, mesh_mod.get_mesh(), "model") if cut else t


def model_part(t, n: int, whole: int, dim: int = -1):
    """This rank's ``n`` of the ``whole`` entries of ``t`` along ``dim``
    (a vector or activation every `model` rank holds alike, read at the
    rank's offset: Mamba's and RG-LRU's channels); ``t`` itself when
    ``n == whole``.  The gradient of ``t`` comes back whole on every
    rank."""
    if n == whole:
        return t
    return enter_model(t, True).narrow(dim, model_offset(n, whole), n)


def _training(x) -> bool:
    """Whether autograd records a use of ``x``, of a narrower dtype than
    fp32: a bf16 training step."""
    return torch.is_grad_enabled() and x.dtype != torch.float32 and \
        x.requires_grad


def tp_input(x, cut: bool):
    """``x``, held alike by every `model` rank, as the input of work that
    differs by rank (``cut``): entered (:func:`enter_model`), upcast to
    fp32 first in a bf16 training step (:func:`_training`), so the ranks'
    partial gradients are added in fp32; ``x`` itself where nothing is
    cut."""
    if not cut:
        return x
    return enter_model(x.float() if _training(x) else x, True)


class _Columns(torch.autograd.Function):
    """x @ w for each column piece w of products whose input x every
    `model` rank holds alike: the forward is :func:`dense`, the product
    serving and the whole step compute for those columns; the backward
    adds the input's partial gradients of every product in fp32 (TF32
    off), sums them over `model` and rounds once, and gives each weight
    autograd's x^T g in x's dtype."""

    @staticmethod
    def forward(ctx, x, mesh, *ws):
        ctx.mesh = mesh
        ctx.save_for_backward(x, *ws)
        return tuple(dense(x, w) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        dx, dws = None, []
        with no_tf32():
            for g, w in zip(gs, ws, strict=True):
                g2 = g.reshape(-1, g.shape[-1])
                part = g2.float() @ w.float().T
                dx = part if dx is None else dx + part
                dws.append(x2.T @ g2.to(x.dtype))
        with mesh_mod.counted_as("backward"):
            dx = mesh_mod.all_reduce_sum(dx, ctx.mesh, "model")
        return dx.to(x.dtype).reshape(x.shape), None, *dws


def tp_columns(x, ws, cut: bool) -> tuple:
    """x @ w for each of ``ws``, column pieces of products whose input
    ``x`` every `model` rank holds alike (``cut``: the pieces differ by
    rank): under a recorded gradient :class:`_Columns`, one all-reduce of
    the input's gradient for all of them; else :func:`dense` each."""
    if cut and torch.is_grad_enabled() and (
            x.requires_grad or any(w.requires_grad for w in ws)):
        return _Columns.apply(x, mesh_mod.get_mesh(), *ws)
    return tuple(dense(x, w) for w in ws)


def dense_col(x, w, whole: int):
    """x @ W for this rank's column piece ``w`` of W [K, whole]: the
    product's columns gathered over `model`."""
    return gather_model(tp_columns(x, (w,), w.shape[1] != whole)[0], whole)


def reduce_rows(y, w, whole: int):
    """``y`` = a @ w for this rank's row piece ``w`` of W [whole, N] (a
    the matching columns): the partial products summed over `model`, in
    fp32 and rounded once (``y`` itself when ``w`` is whole)."""
    if w.shape[0] == whole:
        return y
    return mesh_mod.reduce_sum(y, mesh_mod.get_mesh(), "model")


def dense_row(x, w, whole: int):
    """x @ W for this rank's row piece ``w`` of W [whole, N] and x the
    matching columns: the partial products summed over `model`."""
    return reduce_rows(dense(x, w), w, whole)


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
        "w_gate": leaf("w_gate", init_dense(gen, d_model, d_ff, dtype,
                                            device)),
        "w_up": leaf("w_up", init_dense(gen, d_model, d_ff, dtype, device)),
        "w_down": leaf("w_down", init_dense(gen, d_ff, d_model, dtype,
                                            device)),
    }


def mlp(params, x, d_ff: int | None = None):
    """The GLU MLP.  Under tensor parallelism w_gate / w_up are column
    pieces and w_down the matching row piece of a ``d_ff``-wide MLP: the
    partial outputs are summed over `model` (``d_ff`` None: the rank's
    partial is returned as it is, for a caller that sums it later and has
    passed ``x`` through :func:`enter_model` itself)."""
    if d_ff is None:
        h = F.silu(dense(x, params["w_gate"])) * dense(x, params["w_up"])
        return dense(h, params["w_down"])
    g, u = tp_columns(x, (params["w_gate"], params["w_up"]),
                      params["w_gate"].shape[1] != d_ff)
    return dense_row(F.silu(g) * u, params["w_down"], d_ff)


# ---------------------------------------------------------------- Embedding
def init_embed(gen, vocab: int, d_model: int, dtype, device):
    w = torch.randn(vocab, d_model, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)      # in place: one fp32 table at a time


def embed(table, tokens, vocab: int | None = None):
    """Rows of ``table`` for ``tokens``.  A vocab piece (``table`` of fewer
    than ``vocab`` rows: this rank's rows [r·n, (r+1)·n) over `model`)
    looks up the tokens it holds, zeros elsewhere, and the pieces are
    summed over `model`: one non-zero term a row, so the sum is exact."""
    if vocab is None or table.shape[0] == vocab:
        return table[tokens.long()]
    mesh = mesh_mod.get_mesh()
    n = table.shape[0]
    local = tokens.long() - mesh.coord("model") * n
    own = (local >= 0) & (local < n)
    rows = torch.where(own[..., None], table[local.clamp(0, n - 1)], 0)
    return mesh_mod.reduce_sum(rows, mesh, "model")


def unembed_table(table):
    """The fp32 unembedding table: the embedding upcast exactly, once per
    model (the full-vocab upcast is 129280 x 7168 at DeepSeek's width)."""
    return table.float()


def unembed(table_f32, x, vocab: int | None = None):
    """Tied unembedding with fp32 logits; ``table_f32`` from
    :func:`unembed_table`.  A vocab piece's logits (its columns) are
    gathered over `model` into all ``vocab`` columns."""
    y = _rows_product(x, lambda a: a.float() @ table_f32.T)
    return y if vocab is None else gather_model(y, vocab)


def vocab_nll(table, x, targets, vocab: int):
    """Per-token cross-entropy of the tied unembedding: -log softmax(x ·
    tableᵀ)[target] for x [..., D] and targets [...], the logits fp32
    (``table`` upcast in the graph).  A vocab piece of the table (this
    rank's rows [r·n, (r+1)·n) over `model`) gives the rank's piece of
    the logits, never gathered: their max and the sum of their exps are
    reduced over `model`, and the rank that holds a target gives its
    logit."""
    n = table.shape[0]
    cut = n != vocab
    logits = _rows_product(enter_model(x.float(), cut),
                           lambda a: a @ table.float().T)
    if not cut:
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lp, -1, targets[..., None].long())[..., 0]
    mesh = mesh_mod.get_mesh()
    m = logits.detach().amax(dim=-1, keepdim=True)
    mesh_mod.all_reduce(m, torch.distributed.ReduceOp.MAX, mesh, "model")
    se = mesh_mod.reduce_sum(torch.exp(logits - m).sum(dim=-1), mesh,
                             "model")
    local = targets.long() - mesh.coord("model") * n
    own = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])
    target = mesh_mod.reduce_sum(torch.where(own, picked[..., 0], 0.0), mesh,
                                 "model")
    return m[..., 0] + torch.log(se) - target


def unshard(params, specs, mesh):
    """A block's (or the top level's) weights as the serve-profile pieces
    its products take: each leaf whose spec names `data` gathered over
    `data` along that dim (``launch.mesh.gather``: its backward
    reduce-scatters the gradient over `data`).  ``specs`` is the dict of
    specs matching ``params`` (a ``rules.Placed``'s); ``params`` itself
    where nothing names `data` or no specs are given."""
    if specs is None or mesh is None or mesh.shape.get("data", 1) == 1:
        return params
    if isinstance(params, dict):
        return {k: unshard(v, specs[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [unshard(v, s, mesh) for v, s in zip(params, specs,
                                                    strict=True)]
    for dim, entry in enumerate(specs):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "data" in axes:
            if axes != ("data",):
                raise NotImplementedError(
                    f"a spec entry {entry} naming `data` with other axes")
            params = mesh_mod.gather(params, mesh, "data", dim)
    return params
