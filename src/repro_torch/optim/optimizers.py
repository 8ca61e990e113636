"""Optimizers — the port of ``repro/optim/optimizers.py``: AdamW (bf16
moments by default) and Adafactor (factored second moment), global-norm
clipping and the linear-warmup cosine schedule, as plain functions over the
port's parameter trees (nested dicts and lists of tensors).

The updates write parameters and state in place (the reference donates its
buffers) and return them.  Each leaf is updated on its own in fp32, so the
temporaries are one leaf's, never the model's.  The reference stacks each
layer group's repeats into one leaf; the port keeps one tensor a layer.
Only Adafactor's update clipping reads a whole leaf (the RMS of the update
over every repeat of a block): ``stacks`` (``model.layer_stacks(cfg)``)
says which layers the reference stacks together, and the RMS is taken over
them.

Under a mesh the trees hold this rank's pieces (``rules.Placed``: the
params by ``param_specs(profile="train")``, the state by
``opt_state_specs``, the gradients like the params).  AdamW is
elementwise, so it runs on the pieces as they are.  What reads more than
an element sums over the ranks, each piece counted once (a piece that
``r`` ranks hold alike weighs 1/r): the global norm, Adafactor's
update-clipping RMS, and its factored statistics (the means of g² over
a cut dim, and of ``vr``), all-reduced over the axes that cut the
reduced dim.  Adafactor decides whether to factor on the whole shape.  A
state leaf ``opt_state_specs`` keeps whole where its param is cut (an
unfactored Adafactor ``v``) takes the whole gradient, gathered, and the
rank keeps its piece of the step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import rules


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "bfloat16"      # first-moment storage (adamw)
    v_dtype: str = "bfloat16"      # second-moment storage (adamw)
    # adafactor
    min_dim_size_to_factor: int = 128


# ------------------------------------------------------------------- trees
def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in a fixed order
    (dicts by insertion, sequences by index)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _paths(tree, pre=()) -> list:
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, pre + (k,))]
    return [pre]


def tree_at(tree, path):
    """The subtree of ``tree`` at ``path`` (dict keys and list indices)."""
    for k in path:
        tree = tree[k]
    return tree


def stack_plan(params, stacks=None) -> list:
    """The reference's leaves, each as the list of paths of the port's
    tensors that make it: every top-level leaf alone, and for each stack
    of layers the same path in every layer of it (``stacks=None``: each
    layer its own stack)."""
    plan = [[(k,) + p] for k, v in params.items() if k != "layers"
            for p in _paths(v)]
    layers = params.get("layers", [])
    for stack in stacks or [[i] for i in range(len(layers))]:
        plan += [[("layers", i) + p for i in stack]
                 for p in _paths(layers[stack[0]])]
    return plan


# --------------------------------------------------------------- schedule
def schedule(cfg: OptimizerConfig, step):
    """Linear warmup then cosine decay: the learning rate at ``step`` as an
    fp32 tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def _placed(params):
    """(the current mesh, the spec at each path) where ``params`` is a
    ``rules.Placed`` tree under a mesh, else (None, None)."""
    mesh = mesh_mod.get_mesh()
    if mesh is None or not hasattr(params, "specs"):
        return None, None
    return mesh, params.spec_at


def _path(pa) -> str:
    return "/".join(map(str, pa))


def _world_sum(parts, specs, mesh):
    """The sums over the whole leaves of the per-piece fp32 ``parts``
    (each weighed by 1/replicas of its spec, then summed over every
    rank), as a vector."""
    t = torch.stack([p / rules.replicas(sp, mesh)
                     for p, sp in zip(parts, specs, strict=True)])
    return mesh_mod.all_reduce_world(t, mesh)


def clip_by_global_norm(grads, max_norm: float, *, params=None):
    """(fp32 grads scaled by min(1, max_norm / (norm + 1e-9)), norm), the
    norm the sqrt of every leaf's sum of squares in fp32: each leaf cast
    and scaled on its own.  ``params``: a placed tree under a mesh whose
    specs cut ``grads`` alike; the norm is then the whole tree's."""
    mesh, spec_at = _placed(params)
    if mesh is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in tree_leaves(grads)))
    else:
        pairs = list(rules._leaves_with_path(grads))
        gn = torch.sqrt(_world_sum(
            [torch.sum(torch.square(g.float())) for _, g in pairs],
            [spec_at(pa) for pa, _ in pairs], mesh).sum())
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


# ------------------------------------------------------------------ AdamW
def adamw_init(cfg: OptimizerConfig, params):
    mdt, vdt = getattr(torch, cfg.m_dtype), getattr(torch, cfg.v_dtype)
    dev = tree_leaves(params)[0].device
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=vdt,
                                            device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads, state, params, *,
                 stacks=None):
    """One AdamW step, in place.  Moments are kept in their storage dtype
    and updated in fp32.  Returns (params, state)."""
    del stacks                                   # elementwise: no stacks
    c = state["count"] + 1
    lr = schedule(cfg, c)
    cf = c.to(torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32,
                             device=cf.device) ** cf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32,
                             device=cf.device) ** cf
    for leaf in zip(tree_leaves(grads), tree_leaves(state["m"]),
                    tree_leaves(state["v"]), tree_leaves(params),
                    strict=True):
        for g, m, v, p in _chunks(*leaf):
            g = g.float()
            m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
            del g
            step = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
            m.copy_(m32)
            v.copy_(v32)
            del m32, v32
            step = step + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step)
    state["count"] = c
    return params, state


# elements of a leaf that AdamW updates at once: its fp32 temporaries are
# a few of these, not of the leaf (a vocab piece of the embedding is
# hundreds of millions of elements)
CHUNK = 1 << 24


def _chunks(g, *ts):
    """Matching flat views of ``g`` (read, any layout) and ``ts`` (updated
    in place: contiguous), tensors of one shape, CHUNK elements at a
    time: an elementwise update of each gives the update of the whole,
    bitwise."""
    flat = [g.reshape(-1)] + [t.view(-1) for t in ts]
    n = flat[0].numel()
    for i in range(0, max(n, 1), CHUNK):
        yield tuple(t[i:i + CHUNK] for t in flat)


# -------------------------------------------------------------- Adafactor
def _factored(shape, cfg) -> bool:
    return len(shape) >= 2 and shape[-1] >= cfg.min_dim_size_to_factor \
        and shape[-2] >= cfg.min_dim_size_to_factor


def _mean_over(t, dim: int, entry, mesh, keepdim: bool = False):
    """The mean of ``t`` along ``dim`` of the whole tensor, ``t`` a piece
    whose ``dim`` the spec ``entry`` cuts (None: whole): the piece's mean
    all-reduced over the entry's axes and divided by their extent."""
    m = t.mean(dim=dim, keepdim=keepdim)
    n = 1 if mesh is None else rules.extent(entry, mesh)
    if n == 1:
        return m
    for axis in rules._axes(entry):
        mesh_mod.all_reduce(m, torch.distributed.ReduceOp.SUM, mesh, axis)
    return m / n


def adafactor_init(cfg: OptimizerConfig, params):
    """The factored second moment ({"vr", "vc"}) where :func:`_factored`
    holds for the leaf's shape, else {"v"}, and the count."""
    def one(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape, cfg):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    dev = tree_leaves(params)[0].device
    return {"v": tree_map(one, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adafactor_update(cfg: OptimizerConfig, grads, state, params, *,
                     stacks=None):
    """One Adafactor step, in place (d = 1.0 update clipping over each of
    the reference's stacked leaves: ``stacks``, see the module doc).
    Returns (params, state)."""
    c = state["count"] + 1
    lr = schedule(cfg, c)
    beta2 = 1.0 - c.to(torch.float32) ** -0.8
    mesh, spec_at = _placed(params)

    def step_of(g, v, spec):
        g = g.float()
        if "v" in v and v["v"].shape != g.shape:   # whole v, a cut param
            g = rules.gather_leaf(g, spec, mesh)
            step = step_of(g, v, (None,) * g.dim())
            return rules.local_rows(step, spec, mesh)
        g2 = torch.square(g) + 1e-30
        if "vr" in v:
            rows, cols = (None, None) if spec is None else spec[-2:]
            v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * _mean_over(
                g2, -1, cols, mesh))
            v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * _mean_over(
                g2, -2, rows, mesh))
            vr, vc = v["vr"], v["vc"]
            denom = (vr / _mean_over(vr, -1, rows, mesh, keepdim=True)
                     )[..., None] * vc[..., None, :]
            return g * torch.rsqrt(denom + 1e-30)
        v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
        return g * torch.rsqrt(v["v"] + 1e-30)

    for paths in stack_plan(params, stacks):
        specs = [None if mesh is None else spec_at(_path(pa)) for pa in paths]
        steps = [step_of(tree_at(grads, pa), tree_at(state["v"], pa), sp)
                 for pa, sp in zip(paths, specs, strict=True)]
        if mesh is None:
            ms = torch.stack([torch.mean(torch.square(s))
                              for s in steps]).mean()
        else:
            n = math.prod(_whole_shape(tree_at(params, paths[0]).shape,
                                       specs[0], mesh))
            ms = (_world_sum([torch.sum(torch.square(s)) for s in steps],
                             specs, mesh) / n).mean()
        rms = torch.sqrt(ms + 1e-30)
        for s, pa in zip(steps, paths, strict=True):
            p = tree_at(params, pa)
            s = s / torch.clamp(rms, min=1.0)
            s = s + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * s)
    state["count"] = c
    return params, state


# ------------------------------------------------------------------ facade
def opt_init(cfg: OptimizerConfig, params):
    """The optimizer's initial state.  For a placed tree under a mesh,
    this rank's pieces of the whole tree's state, cut by
    ``opt_state_specs`` (a ``rules.Placed``; Adafactor factors by the
    whole shapes; no whole state is made)."""
    init = adafactor_init if cfg.name == "adafactor" else adamw_init
    mesh, _ = _placed(params)
    if mesh is None:
        return init(cfg, params)
    whole = rules._tree_map_with_path(lambda path, p: torch.empty(
        _whole_shape(p.shape, params.spec_at(path), mesh), dtype=p.dtype,
        device="meta"), params)
    meta = init(cfg, whole)
    specs = rules.opt_state_specs(meta, mesh)
    flat = dict(rules._leaves_with_path(specs, leaf_type=rules.P))
    dev = tree_leaves(params)[0].device
    pieces = rules._tree_map_with_path(lambda path, t: torch.zeros(
        rules.local_shape(t.shape, flat[path], mesh), dtype=t.dtype,
        device=dev), meta)
    return rules.Placed(pieces, mesh.shape, specs, "opt_state")


def _whole_shape(shape, spec, mesh) -> tuple:
    return tuple(d * rules.extent(e, mesh) for d, e in zip(
        shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def opt_update(cfg: OptimizerConfig, grads, state, params, *, stacks=None):
    """One step of ``cfg.name``, in place; ``stacks`` as
    :func:`adafactor_update` takes it.  Returns (params, state)."""
    fn = adafactor_update if cfg.name == "adafactor" else adamw_update
    return fn(cfg, grads, state, params, stacks=stacks)
