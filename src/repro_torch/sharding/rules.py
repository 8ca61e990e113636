"""Sharding rules: parameter path -> spec, plus input and cache specs — the
port of ``repro/sharding/rules.py``.

Policy (DESIGN.md §5):
 - batch dims ride ("pod", "data") (pod only on the multi-pod mesh);
 - TP: head / ff / expert / vocab dims ride "model";
 - FSDP: the complementary big dim of each weight rides "data";
 - an axis is applied only if the dim divides by its mesh extent
   (best-effort: e.g. smollm's 15 heads stay unsharded on a 16-way TP).

The specs key off the port's trees, whose leaves carry no stacked layer
dim: one dict a layer (``params["layers"][i]``), one cache dict a layer
with [B, S, latent] / [B, S, K, hd] attention caches.  Each spec equals the
reference's for the same leaf with the reference's leading layer entry
dropped (paths map through ``models/convert.py``'s unstacking).  A
:class:`P` is a tuple of entries (None, an axis name, or a tuple of axis
names), as ``jax.sharding.PartitionSpec`` is.  :func:`local_rows` cuts a
rank's piece of a tensor by a spec (:func:`local_slices` names it); the reference's ``constrain`` has no
counterpart, since the port holds rank-local tensors.  :func:`place_params`
(either profile) and :func:`place_opt_state` cut whole trees into a
rank's pieces (a :class:`Placed` tree recording its mesh, specs and
profile), and :func:`gather_placed` gathers them whole again.
"""
from __future__ import annotations

import re

import torch

from repro_torch.launch import mesh as mesh_mod


class P(tuple):
    """A partition spec: one entry a dim (None = whole); a one-axis tuple
    entry is kept as the axis name, as PartitionSpec keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


BATCH = ("pod", "data")   # generic batch-dim axes (pod dropped on one pod)

# decode caches with S >= this are sequence-sharded over `model` (the
# partial-softmax decode of core.etap.seq_sharded_decode); smaller caches
# (local windows, tests) stay batch-sharded.  cache_specs and the decode
# branches both read it through seq_shardable, so they never disagree.
SEQ_SHARD_MIN_S = 8192


def seq_shardable(S: int, mesh) -> bool:
    """Whether a cache of S rows (the whole sequence, not a rank's piece)
    is sequence-sharded over ``model`` on ``mesh``."""
    names = getattr(mesh, "axis_names", ()) if mesh is not None else ()
    return ("model" in names and S % mesh.shape["model"] == 0
            and S >= SEQ_SHARD_MIN_S)


def _fit(spec_entry, dim: int, mesh):
    """Drop mesh axes that don't divide ``dim``."""
    if spec_entry is None:
        return None
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    kept = []
    size = 1
    for a in axes:
        if a not in mesh.axis_names:
            continue
        ext = mesh.shape[a]
        if dim % (size * ext) == 0:
            kept.append(a)
            size *= ext
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


# path regex -> raw spec (per trailing dims)
_RULES = [
    (r"embed$",                    ("model", None)),            # [V, D]
    (r"frontend/proj$",            ("data", "model")),
    (r"(w_q|w_uq)$",               ("data", "model")),
    (r"(w_k|w_v)$",                ("data", "model")),
    (r"w_o$",                      ("model", "data")),
    (r"(w_dq|w_dkv)$",             ("data", "model")),
    (r"(w_uk|w_uv)$",              (None, "model")),            # [kv_lora, H*hd]
    (r"(w_gate|w_up|w_in|w_x)$",   ("data", "model")),          # [D, F]
    (r"(w_down|w_out)$",           ("model", "data")),          # [F, D]
    (r"router$",                   ("data", None)),
    (r"ffn/w_gate$",               ("model", "data", None)),    # MoE [E, D, F] (EP)
    (r"ffn/w_up$",                 ("model", "data", None)),
    (r"ffn/w_down$",               ("model", None, "data")),
    (r"w_bcdt$",                   ("model", None)),            # [d_inner, ...]
    (r"w_dt$",                     (None, "model")),
    (r"(conv_w|conv_b|dt_bias|D)$", (None,)),
    (r"log_neg_A$",                ("model", None)),
    (r"(w_a|w_i)$",                ("model", None)),            # lru [W, W]
    (r"(norm|scale|bias|log_lambda|q_norm|k_norm|kv_norm)", (None,)),
]
# NOTE: order matters — first match wins; MoE expert weights are matched by
# the `ffn/...` entries *before* the generic w_gate/w_down rules because the
# generic rules assume 2-D weights; see _spec_for.


def _spec_for(path: str, ndim: int, mesh, shape) -> P:
    raw: tuple | None = None
    # 3-D (stacked-expert) weights need the MoE rules; check those first.
    for pat, spec in _RULES:
        if pat.startswith("ffn/") and re.search(pat, path) and ndim == 3:
            raw = spec
            break
    if raw is None:
        for pat, spec in _RULES:
            if re.search(pat, path):
                raw = spec
                break
    if raw is None:
        raw = (None,) * ndim
    lead = ndim - len(raw)
    if lead < 0:          # param has fewer dims than rule (e.g. reduced cfg)
        raw = raw[-ndim:] if ndim else ()
        lead = 0
    entries = [None] * lead + [
        _fit(s, shape[lead + i], mesh) for i, s in enumerate(raw)]
    return P(*entries)


def _tree_map_with_path(fn, tree, path=()):
    """``fn("a/b/0/c", leaf)`` over the tensors of a tree of dicts and
    lists; a new tree of the same structure (None for a leaf that is no
    tensor)."""
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if not isinstance(tree, torch.Tensor):
        return None
    return fn("/".join(path), tree)


def leaf_spec(path: str, leaf, mesh, *, profile: str = "train") -> P:
    """The spec of one parameter leaf at ``path`` ("layers/3/mix/w_uq")
    under ``profile``, as :func:`param_specs` gives it."""
    if path == "embed_f32":
        path = "embed"
    nd, shape = leaf.dim(), tuple(leaf.shape)
    if profile == "serve" and nd == 3 and \
            re.search(r"ffn/(w_gate|w_up|w_down)$", path):
        # serving MoE layout: EP over `data`, intra-expert TP over
        # `model` — every expert shard lives on exactly one device row,
        # nothing is re-gathered per decode step.
        if path.endswith("w_down"):       # [E, F, D]
            return P(_fit("data", shape[0], mesh),
                     _fit("model", shape[1], mesh), None)
        return P(_fit("data", shape[0], mesh), None,
                 _fit("model", shape[2], mesh))
    spec = _spec_for(path, nd, mesh, shape)
    if profile == "serve":
        spec = P(*[_strip_data(e) for e in spec])
    return spec


def param_specs(params, mesh, *, profile: str = "train"):
    """Spec tree matching ``params`` (the serving copy ``embed_f32`` takes
    ``embed``'s spec).

    profile="train": TP over `model` + FSDP over `data` (weights gathered
    per layer, reduce-scattered grads) — the memory-optimal training layout.
    profile="serve": TP/EP only — weights replicated across `data`; decoding
    must NOT re-gather FSDP shards every token (§Perf iteration S1)."""
    return _tree_map_with_path(
        lambda path, leaf: leaf_spec(path, leaf, mesh, profile=profile),
        params)


def _strip_data(entry):
    if entry is None:
        return None
    axes = entry if isinstance(entry, tuple) else (entry,)
    kept = tuple(a for a in axes if a not in ("data", "pod"))
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def opt_state_specs(opt_state, mesh):
    """Optimizer-state specs: moments shard like their params (path-based
    rules still match since state paths embed the param name); Adafactor's
    factored stats drop the reduced dim's entry; `count` is replicated."""
    def one(path, leaf):
        nd, shape = leaf.dim(), tuple(leaf.shape)
        if path.endswith("count"):
            return P()
        if path.endswith("/vr"):          # mean over last dim of the param
            s = _spec_for(path[:-3], nd + 1, mesh, shape + (10 ** 9,))
            return P(*s[:-1])
        if path.endswith("/vc"):          # mean over second-to-last dim
            fake = shape[:-1] + (10 ** 9,) + shape[-1:]
            s = _spec_for(path[:-3], nd + 1, mesh, fake)
            return P(*(s[:-2] + s[-1:]))
        return _spec_for(path, nd, mesh, shape)
    return _tree_map_with_path(one, opt_state)


# ----------------------------------------------------------- activations/io
def data_spec(mesh, ndim: int) -> P:
    """[B, ...] batch-sharded."""
    return P(batch_axes(mesh), *([None] * (ndim - 1)))


def cache_specs(cache, mesh):
    """Dense serving caches (one dict a layer): the batch dim sharded over
    (pod, data) — best-effort (B = 1 falls back toward replication); a
    full-attention KV cache [B, S, K, hd] and the MLA latent [B, S, latent]
    (no head dim — the paper's scenario) sequence-sharded over `model`
    where :func:`seq_shardable`; a Mamba state [B, d_inner, N] over
    `model` on d_inner, an RG-LRU state [B, W] on W; a conv window [B,
    k-1, W] batch-only."""
    b = batch_axes(mesh)

    def one(path, leaf):
        nd, shape = leaf.dim(), tuple(leaf.shape)
        bfit = _fit(b, shape[0], mesh) if nd >= 1 else None
        if nd == 4:       # [B, S, K, hd]
            s = "model" if seq_shardable(shape[1], mesh) else None
            return P(bfit, s, None, None)
        if nd == 3:       # [B, S, latent] or [B, d_inner, N]
            if path.endswith("h"):           # mamba state [B, d_inner, N]
                return P(bfit, _fit("model", shape[1], mesh), None)
            s = "model" if seq_shardable(shape[1], mesh) else None
            return P(bfit, s, None)
        if nd == 2:       # [B, W]
            return P(bfit, _fit("model", shape[1], mesh))
        return P(*([None] * nd))
    return _tree_map_with_path(one, cache)


def seq_sharded(layer_cache, key: str, mesh) -> bool:
    """Whether a dense layer cache holds this rank's sequence slice of
    ``layer_cache[key]``: the whole cache's row count S (``"seq_rows"``,
    which ``models.model.init_cache`` / ``shard_cache`` record beside a
    sharded slice; else the tensor's own rows) is :func:`seq_shardable`
    on ``mesh``.  A rank's tensor holds only S/n rows, so the decision
    reads S, never its shape alone.  A slice outside its mesh, or a whole
    cache where the mesh shards it, raises."""
    rows = layer_cache.get("seq_rows", layer_cache[key].shape[1])
    sharded = seq_shardable(rows, mesh)
    if sharded != ("seq_rows" in layer_cache):
        raise ValueError(
            f"a cache of {rows} rows is {'' if sharded else 'not '}"
            f"sequence-sharded on {mesh}, but this one is "
            f"{'a slice' if 'seq_rows' in layer_cache else 'whole'}: build "
            "it with model.init_cache / shard_cache under the mesh")
    return sharded


def local_rows(t, spec, mesh):
    """This rank's piece of ``t`` under ``spec``: each dim that an entry
    names is cut into the entry's axes' total extent of equal parts, and
    the part at this rank's index over those axes is kept (a view; ``t``
    itself where no entry cuts).  A dim the parts do not divide raises."""
    for dim, part in enumerate(local_slices(t.shape, spec, mesh)):
        if part.stop - part.start != t.shape[dim]:
            t = t.narrow(dim, part.start, part.stop - part.start)
    return t


def local_slices(shape, spec, mesh) -> tuple:
    """The part of a tensor of ``shape`` that :func:`local_rows` keeps
    under ``spec``: one slice a dim (the whole dim where no entry cuts
    it)."""
    out = []
    for dim, d in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        n = extent(entry, mesh)
        if n == 1:
            out.append(slice(0, d))
            continue
        if d % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"{n} ways over {_axes(entry)}")
        start = mesh.index(_axes(entry)) * (d // n)
        out.append(slice(start, start + d // n))
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of a rank's piece of a tensor of ``shape`` under
    ``spec``."""
    return tuple(d // extent(e, mesh) for d, e in zip(
        shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


# ------------------------------------------------------- placed parameters
def extent(entry, mesh) -> int:
    """How many pieces a spec entry cuts its dim into on ``mesh``."""
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Placed(dict):
    """A tree holding this rank's pieces (parameters, their gradients, or
    optimizer state): ``mesh_shape`` is the mesh's {axis: extent} it was
    cut for, ``specs`` the spec tree that cut it (each leaf's spec on the
    whole tensor) and ``profile`` the ``param_specs`` profile ("serve",
    "train"; "opt_state" for optimizer state placed by
    :func:`opt_state_specs`)."""

    def __init__(self, tree, mesh_shape: dict, specs, profile: str = "serve"):
        super().__init__(tree)
        self.mesh_shape = dict(mesh_shape)
        self.specs = specs
        self.profile = profile

    def spec_at(self, path: str):
        """The spec of the leaf at ``path`` ("layers/0/mix/w_q")."""
        t = self.specs
        for k in path.split("/"):
            t = t[int(k)] if isinstance(t, list) else t[k]
        return t


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def place_leaf(path: str, t, mesh, *, profile: str = "serve"):
    """(this rank's piece of the leaf ``t`` at ``path`` under its
    ``profile`` spec on ``mesh``, as a contiguous copy, the spec)."""
    spec = leaf_spec(path, t, mesh, profile=profile)
    return _cut(t, spec, mesh), spec


def _cut(t, spec, mesh):
    piece = local_rows(t, spec, mesh)
    if piece is t:
        return t
    return piece.clone(memory_format=torch.contiguous_format)


def place_params(params, mesh, *, profile: str = "serve") -> Placed:
    """This rank's pieces of a whole parameter tree, each leaf cut by its
    ``param_specs(..., profile)`` spec on ``mesh`` (:func:`local_rows`, a
    contiguous copy; a leaf the spec leaves whole is kept as it is), with
    the mesh's shape, the specs and the profile recorded on the result.
    ``profile="train"`` keeps the `data` entries (FSDP): a layer gathers
    them over `data` where it uses them (``models.layers.unshard``).  The
    serve profile cuts a MoE layer's expert stacks [E, D, F] / [E, F, D]
    over `data` (E, expert parallelism) and `model` (F); the train
    profile cuts E over `model`."""
    if profile not in ("serve", "train"):
        raise ValueError(f"profile {profile!r}")
    specs = param_specs(params, mesh, profile=profile)
    pieces = _tree_map_with_path(
        lambda path, t: place_leaf(path, t, mesh, profile=profile)[0],
        params)
    return Placed(pieces, mesh.shape, specs, profile)


def place_opt_state(state, mesh) -> Placed:
    """This rank's pieces of a whole optimizer state (AdamW's {"m", "v",
    "count"}, Adafactor's {"v", "count"}), each leaf cut by its
    :func:`opt_state_specs` spec on ``mesh``; ``count`` stays whole."""
    specs = opt_state_specs(state, mesh)
    flat = dict(_leaves_with_path(specs, leaf_type=P))
    pieces = _tree_map_with_path(
        lambda path, t: _cut(t, flat[path], mesh), state)
    return Placed(pieces, mesh.shape, specs, "opt_state")


def _leaves_with_path(tree, path=(), leaf_type=torch.Tensor):
    if isinstance(tree, leaf_type):
        yield "/".join(path), tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),), leaf_type)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (str(i),), leaf_type)


def gather_leaf(t, spec, mesh):
    """The whole tensor of which ``t`` is this rank's piece under ``spec``
    (the inverse of :func:`local_rows`: each cut dim gathered over its
    axes, the last-named first), with no gradient."""
    for dim, entry in enumerate(spec):
        for axis in reversed(_axes(entry)):
            if mesh.shape[axis] > 1:
                t = mesh_mod.all_gather(t, mesh, axis, dim)
    return t


def gather_placed(tree, mesh, specs=None) -> dict:
    """The whole tree of a :class:`Placed` one (or of ``tree`` cut by
    ``specs``): every leaf gathered by :func:`gather_leaf` on every rank,
    in the tree's order (a collective: every rank calls it).  A plain
    dict; a whole leaf is kept as it is."""
    specs = specs if specs is not None else tree.specs
    flat = dict(_leaves_with_path(specs, leaf_type=P))
    with torch.no_grad():
        return _tree_map_with_path(
            lambda path, t: gather_leaf(t, flat[path], mesh), tree)


def cuts(spec, mesh) -> bool:
    """Whether ``spec`` cuts any dim on ``mesh``."""
    return any(extent(e, mesh) > 1 for e in spec)


def replicas(spec, mesh) -> int:
    """How many ranks of ``mesh`` hold the same piece under ``spec``."""
    n = mesh.size
    for e in spec:
        n //= extent(e, mesh)
    return n


def check_placed(params, mesh) -> None:
    """Raise unless ``params`` fits ``mesh`` (None: no mesh): a tree
    :func:`place_params` cut for another mesh shape, or a whole tree where
    the serve specs on ``mesh`` would cut a leaf, raises ``ValueError``
    (as :func:`seq_sharded` refuses a whole cache where the mesh shards
    it)."""
    placed = getattr(params, "mesh_shape", None)
    want = getattr(mesh, "shape", None)
    if placed is not None:
        if placed != want:
            raise ValueError(f"the weights were placed for mesh {placed}, "
                             f"the current mesh is {want}")
        return
    if mesh is None:
        return
    for path, t in _leaves_with_path(params):
        spec = leaf_spec(path, t, mesh, profile="serve")
        if cuts(spec, mesh):
            raise ValueError(
                f"whole weights on mesh {mesh.shape}, whose serve spec "
                f"{spec} cuts {path} {tuple(t.shape)}: place them with "
                "rules.place_params or model.init under the mesh")
