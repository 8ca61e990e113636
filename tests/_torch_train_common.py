"""Shared setup of the port's training tests (``tests/test_torch_train*``):
reduced configs of both packages, the reference's weights carried into the
port, batches from ``make_batch`` and a leaf-by-leaf comparison of trees in
the port's layout."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.models.convert import tree_from_jax
from repro_torch.optim.optimizers import tree_leaves


def configs(arch, **kw):
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


def weights(jcfg, seed=0):
    """The reference's init (compiled: eager init dispatches op by op), and
    the same weights in the port's layout (without the serving copy
    ``embed_f32``, as the trainer keeps them)."""
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(seed),
                                                  jcfg)
    return jp, tree_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def batches(cfg, B, S, step=0, seed=3):
    """One step's batch of the data pipeline for both packages."""
    nb = make_batch(cfg, DataConfig(seed=seed, global_batch=B, seq_len=S),
                    step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            to_device(cfg, nb, "cpu"))


def port_tree(jtree):
    return tree_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")


def assert_trees_close(got, want, rel, what=""):
    """Every leaf of ``got`` (port layout) within ``rel`` x the leaf's
    max |want| of ``want`` (the reference's tree, converted)."""
    gl, wl = tree_leaves(got), tree_leaves(port_tree(want)
                                            if "groups" in want else want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl, strict=True)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        a, b = a.double(), b.double()
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        assert err <= rel * scale + 1e-12, (what, i, tuple(a.shape), err,
                                            scale)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


__all__ = ["configs", "weights", "batches", "assert_trees_close", "port_tree",
           "to_np", "torch"]
