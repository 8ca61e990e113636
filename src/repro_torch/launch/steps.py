"""train_step / serve_step factories — the port of
``repro/launch/steps.py``.  Gradient accumulation walks ``n_micro``
microbatches and sums their gradients in bf16, as the reference's scan
does; the metrics are summed in fp32.  Remat is per block
(``models.model``).

Under a mesh (``launch.mesh.use_mesh``, the params and optimizer state
placed for it: ``train.build_state``, or ``rules.place_params(...,
profile="train")`` and ``rules.place_opt_state``) the train step is this
rank's part of the reference's sharded step: its batch rows, its pieces
of the weights and state, the collectives the placement needs forward
and backward, and the whole batch's metrics and global norm.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import rules


@dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = field(
        default_factory=opt.OptimizerConfig)
    n_micro: int = 1              # gradient-accumulation microbatches
    compress_grads: bool = False  # int8 round trip of every gradient


def grads_of(params, cfg, batch):
    """(grads, metrics) of ``model.loss_fn``: the gradient of every leaf
    of ``params`` in its dtype (zeros where the loss does not reach it, as
    ``jax.grad`` gives), the metrics as detached fp32 scalars.  Under a
    mesh (``params`` placed for it, ``batch`` this rank's rows:
    ``model.rank_batch``) each gradient is the rank's piece of the
    whole step's: a leaf whose spec names no batch axis holds the rank's
    share of it, which is all-reduced over those axes here (a leaf cut
    over `data` had its share reduce-scattered by its gather's backward);
    the grads come back placed like ``params``."""
    leaves = opt.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(params, cfg, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(gs, leaves, strict=True))
    grads = opt.tree_map(lambda _: next(it), params)
    mesh = mesh_mod.get_mesh()
    if mesh is not None:
        grads = _sum_shares(grads, params, mesh)
    return grads, {k: v.detach().float() for k, v in metrics.items()}


def _sum_shares(grads, params, mesh):
    """``grads`` with each leaf whose spec names no batch axis summed over
    the batch axes (fp32, rounded once), placed like ``params``."""
    axes = [a for a in rules.batch_axes(mesh) if mesh.shape[a] > 1]
    specs = getattr(params, "specs", None)
    flat = {} if specs is None else dict(
        rules._leaves_with_path(specs, leaf_type=rules.P))

    def one(path, g):
        named = {a for e in flat.get(path, ()) for a in rules._axes(e)}
        for a in axes:
            if a not in named:
                g = mesh_mod.all_reduce_sum(g, mesh, a)
        return g
    with torch.no_grad(), mesh_mod.counted_as("grads"):
        out = rules._tree_map_with_path(one, grads)
    if specs is None:
        return out
    return rules.Placed(out, mesh.shape, specs, params.profile)


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics), updating params and opt_state in place (the
    reference donates them).  Microbatching splits the batch's leading dim
    into ``n_micro`` chunks (under a mesh each rank then takes its rows of
    each chunk, so a chunk holds the rows the reference's does).  ``metrics`` holds "nll", the aux losses and
    "grad_norm" (before clipping).  ``params`` are the trainer's: without
    the serving copy ``embed_f32``."""
    stacks = model.layer_stacks(cfg)

    def train_step(params, opt_state, batch, step):
        del step                                  # the optimizer counts
        if "embed_f32" in params:
            raise ValueError("train_step: params hold the serving copy "
                             "embed_f32, which the update would leave "
                             "stale; train without it (train.build_state)")
        mesh = mesh_mod.get_mesh()
        n = tcfg.n_micro
        micro = [batch] if n == 1 else [
            {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n)]
        if mesh is not None:       # the rank's rows of each microbatch
            micro = [model.rank_batch(mb, mesh, exact=True) for mb in micro]
        if n > 1:
            grads = opt.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.bfloat16, device=p.device), params)
            metrics = None
            for mb in micro:
                g, m = grads_of(params, cfg, mb)
                grads = opt.tree_map(
                    lambda a, b: a + b.to(a.dtype) / n, grads, g)
                del g
                metrics = {k: (metrics[k] if metrics else
                               torch.zeros_like(v)) + v / n
                           for k, v in m.items()}
        else:
            grads, metrics = grads_of(params, cfg, micro[0])

        if tcfg.compress_grads:
            grads = _compress(grads, params, stacks, mesh)

        with mesh_mod.counted_as("grads"):
            grads, gnorm = opt.clip_by_global_norm(
                grads, tcfg.optimizer.clip_norm, params=params)
        params, opt_state = opt.opt_update(tcfg.optimizer, grads, opt_state,
                                           params, stacks=stacks)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def _compress(grads, params, stacks, mesh):
    """The int8 round trip of every gradient (``compress_grads``).  Under
    a mesh the reference quantizes the whole stacked leaves, so the
    pieces are gathered, round-tripped whole and cut again: the codes are
    the unsharded step's."""
    from repro_torch.optim.compress import compress_tree_for_pod_reduce
    if mesh is None or not hasattr(params, "specs"):
        return compress_tree_for_pod_reduce(grads, stacks)
    whole = compress_tree_for_pod_reduce(
        rules.gather_placed(grads, mesh, params.specs), stacks)
    flat = dict(rules._leaves_with_path(params.specs, leaf_type=rules.P))
    return rules._tree_map_with_path(
        lambda path, g: rules.local_rows(g, flat[path], mesh), whole)


def make_serve_step(cfg, *, mode: str = "etap"):
    """serve_step(params, cache, tokens, pos) -> (logits, cache): one
    decode token against the dense cache (the paper's workload).  Under
    ``launch.mesh.use_mesh`` the params are the rank's pieces
    (``rules.place_params``, or ``model.init`` under the mesh), the cache
    is the rank's piece and the logits are the rank's batch rows
    (:func:`gather_rows` gathers them)."""
    spec = AttnSpec(mode=mode)

    def serve_step(params, cache, tokens, pos):
        return model.decode_step(params, cfg, cache, tokens, pos, spec=spec)
    return serve_step


def gather_rows(logits, mesh, batch: int):
    """The whole batch's rows (``batch`` of them) of a rank's result under
    ``mesh``, gathered over the batch axis in rank order: ``logits``
    itself where ``rules.cache_specs`` leaves the batch whole (``batch``
    does not divide, or one data rank)."""
    axes = rules._fit(rules.batch_axes(mesh), batch, mesh)
    if axes is None or mesh.shape[axes] == 1:
        return logits
    return mesh_mod.all_gather(logits, mesh, axes)


def make_prefill_step(cfg, max_len: int):
    """prefill_step(params, batch) -> (last logits, cache, pos): the
    prompt through ``model.prefill``.  Under ``launch.mesh.use_mesh`` with
    placed params, the rank's batch rows' logits and its piece of the
    cache as ``model.init_cache`` places it."""
    def prefill_step(params, batch):
        return model.prefill(params, cfg, batch, max_len=max_len)
    return prefill_step
