"""Meshes over ``torch.distributed`` — the port of ``repro/launch/mesh.py``
and of the two ``repro/compat.py`` helpers the mesh branches read
(``set_mesh``, here :func:`use_mesh`, and :func:`get_mesh`).

A :class:`Mesh` names its axes and their extents as the reference's
``jax.sharding.Mesh`` does (``axis_names``, ``shape[name]``), which is all
the sharding rules (:mod:`repro_torch.sharding.rules`) read.
:func:`make_production_mesh` returns only that description (it never
builds 256 ranks); :func:`make_host_mesh` also builds a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised process
group, whose per-axis groups the collectives below run on.  Each rank holds
its own piece of every sharded tensor, so where the reference's shard_map
hands a function its block, the port's tensors are those blocks already.

Backends, chosen by the caller of :func:`init_ranks` (nothing here swaps
one for another): ``"nccl"`` with rank r on ``cuda:r``; ``"gloo"`` on the
CPU; ``"gloo"`` with every rank on one card (``cuda:0``), the ranks then
sharing that card.  On gloo the collectives run on host copies of CUDA
tensors, on every call: gloo's CUDA support does not cover every
collective, so the helpers stage through the host whatever the op.
:data:`moved` counts the bytes each kind of collective returned to this
rank, which the mesh phases report a step.  :func:`all_to_all` exchanges
a MoE layer's expert slots between the `data` ranks in serving and
carries no gradient.

Collectives with gradients (the sharded train step): :func:`gather`,
:func:`reduce_sum`, :func:`scatter_sum` and :func:`enter` are autograd
Functions over the staged helpers.  Their adjoints keep one convention,
that of the step's loss: it is the sum of the data ranks' losses (each
data rank holds its rows' share of the batch mean), and every `model`
rank of a data row holds that row's loss once.  So over an axis of
:data:`SUMMED_AXES` (`data`, `pod`) an adjoint sums what the ranks hold:
a gather's backward reduce-scatters, an all-reduce's all-reduces.  Over
`model` it does not: a gather's backward is the rank's slice, an
all-reduce's the identity, since every rank holds the whole gradient of a
value the ranks hold alike.  Where such a value feeds work that differs
by rank (a column piece's product, the rank's heads, experts or
channels), :func:`enter` marks it: the identity forward, an all-reduce of
the partial gradients backward (Megatron's f; :func:`reduce_sum` over
`model` is its g).  A reduce-scatter's backward is an all-gather under
either convention.  Each call's bytes are counted in :data:`moved`, under
"<op>" in the forward, "<op>:remat" in a checkpointed block's recompute
(a forward run inside the backward pass), "<op>:backward", and
"<op>:<phase>" within :func:`counted_as` (the train step's gradient
sums and global norm: "grads").
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import math
import multiprocessing
import time

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300


class Mesh:
    """Axis names and extents (``shape[name]``), and for a mesh over live
    ranks its ``DeviceMesh``, backend and this rank's device."""

    def __init__(self, axis_names, extents, *, device_mesh=None,
                 backend: str | None = None, device=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, extents, strict=True))
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            raise ValueError("a mesh description has no ranks")
        return self.device_mesh.get_local_rank(axis)

    def index(self, axes) -> int:
        """This rank's index over ``axes`` taken together, the first axis
        the slowest (the order a spec entry's tuple names them in)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coord(a)
        return idx

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend}, "
                f"device={self.device})")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, as a description: one pod is 256
    chips as (data=16, model=16); two pods are (pod=2, data=16, model=16),
    the pod axis composing with data for the batch."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device="cuda", shape=None) -> Mesh:
    """A ("data", "model") mesh over the initialised process group, of
    ``shape`` (default the reference's (world, 1)); rank r sits at
    (r // model, r % model).  ``device`` is this rank's device (a card, or
    "cpu"), set by :func:`init_ranks`."""
    n = dist.get_world_size()
    shape = tuple(shape or (n, 1))
    if math.prod(shape) != n:
        raise ValueError(f"mesh {shape} over {n} ranks")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(device.type, torch.arange(n).reshape(shape),
                    mesh_dim_names=("data", "model"))
    return Mesh(("data", "model"), shape, device_mesh=dm,
                backend=dist.get_backend(), device=device)


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current mesh for the block (``jax.set_mesh``)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_mesh() -> Mesh | None:
    """The current mesh, or None outside :func:`use_mesh`."""
    return _MESH.get()


# ------------------------------------------------------------- collectives
def _staged(t, mesh: Mesh):
    """The tensor a collective runs on: a host copy of a CUDA tensor on
    gloo (every call), else ``t`` itself."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def _count(op: str, t) -> None:
    """Add a collective's payload (bytes of the rank's result) to
    :data:`moved`, keyed by its phase (the module doc)."""
    phase = _PHASE.get()
    if phase is None and torch._C._current_graph_task_id() != -1:
        phase = "remat"                 # a forward inside the backward pass
    if phase is not None:
        op += ":" + phase
    moved[op] = moved.get(op, 0) + t.numel() * t.element_size()


# bytes each collective moved on this rank since the caller last zeroed
# it (the rank's result of each call: the reduced buffer, the gathered
# tensor, the scattered piece, the exchanged parts), keyed by "all_reduce"
# / "all_gather" / "reduce_scatter" / "all_to_all" and the phase suffixes
# of the module doc
moved: dict = {}
# the phase a collective's bytes are counted under (None: the forward's,
# or the remat's inside the backward pass)
_PHASE: contextvars.ContextVar = contextvars.ContextVar("phase",
                                                        default=None)


def all_reduce(t, op, mesh: Mesh, axis: str):
    """In-place all-reduce of ``t`` over ``axis`` (``op`` a
    ``dist.ReduceOp``).  Returns ``t``."""
    s = _staged(t, mesh)
    dist.all_reduce(s, op=op, group=mesh.group(axis))
    _count("all_reduce", s)
    if s is not t:
        t.copy_(s)
    return t


def _sum_dtype(t):
    """fp32, or ``t``'s dtype where it is wider."""
    return torch.promote_types(t.dtype, torch.float32)


def all_reduce_sum(t, mesh: Mesh, axis: str):
    """The sum of the ranks' ``t`` over ``axis``, added in fp32 (or
    ``t``'s wider dtype) and rounded once to ``t``'s dtype (a new tensor;
    fp32 partials are summed as they are)."""
    s = t.to(_sum_dtype(t))
    if s is t:
        s = t.clone()
    return all_reduce(s, dist.ReduceOp.SUM, mesh, axis).to(t.dtype)


def all_gather(t, mesh: Mesh, axis: str, dim: int = 0):
    """The pieces of ``t`` over ``axis`` concatenated along ``dim`` in
    axis order."""
    s = _staged(t.contiguous(), mesh)
    parts = [torch.empty_like(s) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, s, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim)
    _count("all_gather", out)
    return out.to(t.device)


def reduce_scatter(t, mesh: Mesh, axis: str, dim: int = 0):
    """This rank's part along ``dim`` (the axis-order piece at its
    coordinate) of the sum of the ranks' ``t`` over ``axis``, added in
    fp32 (or ``t``'s wider dtype) and rounded once to ``t``'s dtype."""
    n = mesh.shape[axis]
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split {n} "
                         f"ways over {axis}")
    s = _staged(t.to(_sum_dtype(t)).movedim(dim, 0).contiguous(), mesh)
    out = s.new_empty((s.shape[0] // n, *s.shape[1:]))
    # torch 2.13 names it reduce_scatter_single (reduce_scatter_tensor
    # deprecated); earlier releases have only reduce_scatter_tensor
    op = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    op(out, s, group=mesh.group(axis))
    _count("reduce_scatter", out)
    return out.movedim(0, dim).to(device=t.device,
                                  dtype=t.dtype).contiguous()


def all_to_all(t, mesh: Mesh, axis: str, split_dim: int, concat_dim: int):
    """The all-to-all over ``axis``: ``t`` cut into the axis' extent of
    equal parts along ``split_dim``, part j sent to the rank at coordinate
    j, and the parts this rank gets (one from each rank, in axis order)
    concatenated along ``concat_dim``.  For serving only (a MoE layer's
    experts over `data`, ``models.moe``): a tensor that requires grad
    raises, since the train profile never puts experts over `data`."""
    if t.requires_grad:
        raise NotImplementedError(
            "all_to_all carries no gradient: expert parallelism over `data` "
            "is the serve profile's (ROADMAP A10b.3)")
    n = mesh.shape[axis]
    if t.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                         f"split {n} ways over {axis}")
    s = _staged(t.movedim(split_dim, 0).contiguous(), mesh)
    got = torch.empty_like(s)
    dist.all_to_all_single(got, s, group=mesh.group(axis))
    out = torch.cat([p.movedim(0, split_dim) for p in got.view(
        n, s.shape[0] // n, *s.shape[1:]).unbind(0)], dim=concat_dim)
    _count("all_to_all", out)
    return out.to(t.device)


# ------------------------------------------------- collectives with grads
SUMMED_AXES = ("data", "pod")


def _grad_on(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


@contextlib.contextmanager
def counted_as(phase: str):
    """Count the collectives within the block under ``phase`` in
    :data:`moved`."""
    token = _PHASE.set(phase)
    try:
        yield
    finally:
        _PHASE.reset(token)


def _slice(t, mesh: Mesh, axis: str, dim: int):
    n = t.shape[dim] // mesh.shape[axis]
    return t.narrow(dim, mesh.coord(axis) * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        with counted_as("backward"):
            if axis in SUMMED_AXES:
                g = reduce_scatter(g, mesh, axis, dim)
            else:
                g = _slice(g, mesh, axis, dim).contiguous()
        return g, None, None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis in SUMMED_AXES:
            with counted_as("backward"):
                g = all_reduce_sum(g, ctx.mesh, ctx.axis)
        return g, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return reduce_scatter(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        with counted_as("backward"):
            g = all_gather(g, ctx.mesh, ctx.axis, ctx.dim)
        return g, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with counted_as("backward"):
            return all_reduce_sum(g, ctx.mesh, ctx.axis), None, None


def gather(t, mesh: Mesh, axis: str, dim: int = 0):
    """:func:`all_gather` with a gradient: the rank's slice of it over
    `model`, its reduce-scatter over a summed axis (the module doc)."""
    if _grad_on(t):
        return _Gather.apply(t, mesh, axis, dim)
    return all_gather(t, mesh, axis, dim)


def reduce_sum(t, mesh: Mesh, axis: str):
    """:func:`all_reduce_sum` with a gradient: the identity over `model`,
    an all-reduce over a summed axis (the module doc)."""
    if _grad_on(t):
        return _ReduceSum.apply(t, mesh, axis)
    return all_reduce_sum(t, mesh, axis)


def scatter_sum(t, mesh: Mesh, axis: str, dim: int):
    """:func:`reduce_scatter` with a gradient: its all-gather."""
    if _grad_on(t):
        return _ScatterSum.apply(t, mesh, axis, dim)
    return reduce_scatter(t, mesh, axis, dim)


def enter(t, mesh: Mesh, axis: str = "model"):
    """``t``, a value the ranks over ``axis`` hold alike, about to feed
    work that differs by rank: the identity, whose backward sums the
    ranks' partial gradients over ``axis`` (the module doc).  ``t``
    itself where no gradient is recorded."""
    if _grad_on(t):
        return _Enter.apply(t, mesh, axis)
    return t


def all_reduce_world(t, mesh: Mesh):
    """In-place sum of ``t`` over every axis of ``mesh`` (every rank; no
    gradient).  Returns ``t``."""
    for axis in mesh.axis_names:
        if mesh.shape[axis] > 1:
            all_reduce(t, dist.ReduceOp.SUM, mesh, axis)
    return t


# ------------------------------------------------------------------ ranks
def init_ranks(rank: int, world: int, *, backend: str, init_method: str,
               device: str = "cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group as ``rank`` of ``world`` on ``backend``
    through ``init_method`` (``"file://<path>"``, a FileStore, or
    ``"tcp://localhost:<port>"``), collectives timing out after
    ``timeout_s``.  ``device``: "cpu"; "cuda" puts rank r on ``cuda:r``
    (one card a rank, nccl); "cuda:0" puts every rank on that card.
    Returns this rank's device, made current."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def spawn(fn, world: int, args=(), *, timeout_s: float):
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    spawn start method) and wait for all of them at most ``timeout_s``
    seconds.  Raises if a rank exits with another code than 0 or is still
    running at the limit; every process is gone when this returns."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, *args), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
    failed = {r: p.exitcode for r, p in enumerate(procs)
              if r not in late and p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks exited with codes {failed}; ranks {late} "
                           "were killed while still running")
    if late:
        raise TimeoutError(f"ranks {late} still running after {timeout_s} s")
