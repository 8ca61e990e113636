"""The port's sharding rules (``repro_torch/sharding/rules.py``) against the
reference's (``repro/sharding/rules.py``), entry for entry.

Every arch, reduced and full, on fake (2, 4), (16, 16) and (2, 16, 16)
meshes: ``param_specs`` in both profiles, ``opt_state_specs`` of AdamW and
Adafactor, ``cache_specs`` of dense caches at several (B, S), and the
small helpers.  The reference's trees come from ``jax.eval_shape``; the
port's are meta tensors laid out by the unstacking of
``models/convert.py`` (one dict a layer, repeat i of a group running its
blocks in turn), and each reference spec loses its leading layer entry.
No process group: the meshes are descriptions.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.launch import mesh as M
from repro_torch.models import model
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import rules

MESHES = [M.Mesh(("data", "model"), (2, 4)),
          M.Mesh(("data", "model"), (16, 16)),
          M.make_production_mesh(multi_pod=True)]
CACHE_SHAPES = ((32, 8192), (16, 16384), (1, 8192), (32, 512), (3, 8200))


def _is_spec(x):
    return isinstance(x, (PartitionSpec, tuple))


def _repeats(tree):
    """The repeat count of each stacked group of a reference tree."""
    out = []
    for g in tree["groups"] if isinstance(tree, dict) else tree:
        leaf = g["b0"]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out.append(leaf.shape[0])
    return out


def _unstack_groups(groups, reps, fn):
    """A reference group list → one entry a layer, in the port's order,
    each leaf through ``fn(leaf)`` (its layer entry or dim dropped)."""
    layers = []
    for g, n in zip(groups, reps, strict=True):
        for i in range(n):
            for j in range(len(g)):
                layers.append(jax.tree.map(functools.partial(fn, i=i),
                                           g[f"b{j}"], is_leaf=_is_spec))
    return layers


def _port_tree(tree, reps, fn):
    out = {k: jax.tree.map(functools.partial(fn, i=None), v,
                           is_leaf=_is_spec)
           for k, v in tree.items() if k != "groups"}
    out["layers"] = _unstack_groups(tree["groups"], reps, fn)
    return out


def _meta(a, i):
    return torch.empty(a.shape if i is None else a.shape[1:], device="meta")


def _spec(s, i):
    return tuple(s) if i is None else tuple(s)[1:]


def _flat(tree):
    return [(jax.tree_util.keystr(kp), tuple(v)) for kp, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]]


def _leaf_shapes(tree, path=""):
    """[(path, shape)] of the tensors of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaf_shapes(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaf_shapes(v, f"{path}/{i}")]
    return [(path, tuple(tree.shape))]


def _shapes(arch, full):
    jcfg = jget_config(arch) if full else jreduced(jget_config(arch))
    ps = jax.eval_shape(functools.partial(jmodel.init, cfg=jcfg),
                        jax.random.PRNGKey(0))
    reps = _repeats(ps)
    return jcfg, ps, reps, _port_tree(ps, reps, _meta)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, full):
    """param_specs (train and serve) equal the reference's on every leaf,
    ``embed_f32`` takes ``embed``'s, and the unstacked tree is the port's
    own (paths and shapes of ``model.init``, reduced configs)."""
    _, ps, reps, tree = _shapes(arch, full)
    if not full:
        own = model.init(reduced(get_config(arch)), seed=0, device="cpu")
        del own["embed_f32"]
        assert sorted(_leaf_shapes(own)) == sorted(_leaf_shapes(tree))
    tree["embed_f32"] = tree["embed"]
    for mesh in MESHES:
        for profile in ("train", "serve"):
            want = _port_tree(jrules.param_specs(ps, mesh, profile=profile),
                              reps, _spec)
            got = rules.param_specs(tree, mesh, profile=profile)
            assert got.pop("embed_f32") == got["embed"]
            assert _flat(got) == _flat(want), (mesh, profile)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_match_reference(arch, name):
    """opt_state_specs of the port's optimizer state (meta tensors from
    ``opt_init``) equal the reference's, full and reduced."""
    for full in (False, True):
        _, ps, reps, tree = _shapes(arch, full)
        jstate = jax.eval_shape(functools.partial(
            jopt.opt_init, jopt.OptimizerConfig(name=name)), ps)
        state = opt.opt_init(opt.OptimizerConfig(name=name), tree)
        for mesh in MESHES:
            js = jrules.opt_state_specs(jstate, mesh)
            want = {k: tuple(v) if k == "count" else
                    _port_tree(v, reps, _spec) for k, v in js.items()}
            got = rules.opt_state_specs(state, mesh)
            assert _flat(got) == _flat(want), (full, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    """cache_specs of the port's per-layer caches ([B, S, latent], [B, S,
    K, hd], Mamba / RG-LRU states) equal the reference's stacked ones with
    the layer entry dropped: S-sharded from SEQ_SHARD_MIN_S, batch-fitted,
    full and reduced."""
    for full in (False, True):
        jcfg = jget_config(arch) if full else jreduced(jget_config(arch))
        cfg = get_config(arch) if full else reduced(get_config(arch))
        for B, S in CACHE_SHAPES:
            jc = jax.eval_shape(lambda jcfg=jcfg, B=B, S=S:
                                jmodel.init_cache(jcfg, B, S))
            cache = model.init_cache(cfg, B, S, device="meta")
            reps = _repeats(jc)
            for mesh in MESHES:
                want = _unstack_groups(jrules.cache_specs(jc, mesh), reps,
                                       _spec)
                got = rules.cache_specs(cache, mesh)
                assert _flat(got) == _flat(want), (full, B, S, mesh)


def test_helpers_match_reference():
    """batch_axes, data_spec, _fit, seq_shardable and the constants, on
    every mesh."""
    assert rules.SEQ_SHARD_MIN_S == jrules.SEQ_SHARD_MIN_S == 8192
    assert rules.BATCH == jrules.BATCH
    for mesh in MESHES:
        assert rules.batch_axes(mesh) == jrules.batch_axes(mesh)
        for nd in (1, 2, 4):
            assert tuple(rules.data_spec(mesh, nd)) == \
                tuple(jrules.data_spec(mesh, nd))
        for entry in ("model", "data", ("pod", "data"), ("data", "model"),
                      None, ("pod",)):
            for dim in (1, 2, 8, 15, 16, 64, 256, 512, 8192):
                assert rules._fit(entry, dim, mesh) == \
                    jrules._fit(entry, dim, mesh), (entry, dim, mesh)
        for S in (64, 8191, 8192, 8200, 8208, 16384, 65536):
            assert rules.seq_shardable(S, mesh) == \
                jrules.seq_shardable(S, mesh), (S, mesh)
    assert not rules.seq_shardable(65536, None)


def test_production_mesh_shapes():
    """make_production_mesh: the reference's shapes and axis names, as a
    description (no ranks)."""
    one, two = M.make_production_mesh(), M.make_production_mesh(
        multi_pod=True)
    assert one.axis_names == ("data", "model")
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.axis_names == ("pod", "data", "model")
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="no ranks"):
        one.coord("model")


def test_use_mesh_nests_and_restores():
    """get_mesh is None outside use_mesh, the innermost mesh inside, and
    restored on exit (an exception included)."""
    a, b = MESHES[0], MESHES[1]
    assert M.get_mesh() is None
    with M.use_mesh(a):
        assert M.get_mesh() is a
        with pytest.raises(KeyError), M.use_mesh(b):
            assert M.get_mesh() is b
            raise KeyError
        assert M.get_mesh() is a
    assert M.get_mesh() is None


class _Placed(M.Mesh):
    """A mesh description with this rank at fixed coordinates."""

    def __init__(self, axis_names, extents, coords):
        super().__init__(axis_names, extents)
        self.coords = dict(zip(axis_names, coords, strict=True))

    def coord(self, axis):
        return self.coords[axis]


def test_local_rows_cuts_by_spec():
    """local_rows: the rank's piece along every dim a spec names, a tuple
    entry indexed first-axis-slowest; local_shape agrees; a dim that does
    not split raises."""
    t = torch.arange(8 * 12 * 3).reshape(8, 12, 3)
    mesh = _Placed(("pod", "data", "model"), (2, 2, 3), (1, 0, 2))
    spec = rules.P(("pod", "data"), "model", None)
    piece = rules.local_rows(t, spec, mesh)
    assert torch.equal(piece, t[4:6, 8:12])
    assert rules.local_shape(t.shape, spec, mesh) == tuple(piece.shape)
    assert torch.equal(rules.local_rows(t, rules.P(None, None), mesh), t)
    with pytest.raises(ValueError, match="does not split"):
        rules.local_rows(t, rules.P(None, None, "pod"), mesh)
