"""The port's training loss and gradients against ``jax.grad`` of the
reference, for half of ``ARCH_IDS`` (``test_torch_train_grads_b.py`` has the
rest): the counterpart of ``tests/test_archs.py``'s train step.

Reduced configs (2 layers, fp32, CPU), the reference's weights carried
into the port, one ``make_batch`` batch (B 2 x S 16).  The port's
``model.loss_fn`` (its total loss and each metric) within 1e-5 of the
reference's, and every gradient leaf, the reference's converted with
``tree_from_jax``, within 2e-5 of that leaf's max |value| (the same fp32
operations summed in other orders; about 2e-6 is seen).  The tied
embedding's gradient holds both the lookup's and the unembedding's parts:
``loss_fn`` upcasts ``params["embed"]`` in the graph, so a stale
``embed_f32`` would show here.  With ``remat`` the gradients are bitwise
those without it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_train_common import assert_trees_close, batches, configs, weights
from repro.models import model as jmodel
from repro_torch.launch.steps import grads_of
from repro_torch.models import model
from repro_torch.optim.optimizers import tree_leaves

LOSS_TOL = 1e-5
GRAD_REL = 2e-5
ARCHS = ["deepseek_r1_671b", "recurrentgemma_9b", "qwen3_8b",
         "stablelm_1_6b", "granite_20b"]


def check_arch(arch, remat_too=False):
    jcfg, cfg = configs(arch)
    jp, tp = weights(jcfg)
    jb, tb = batches(cfg, 2, 16)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    loss, _ = model.loss_fn(tp, cfg, tb)
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    g, m = grads_of(tp, cfg, tb)
    for k, v in jm.items():
        assert abs(float(m[k]) - float(v)) <= LOSS_TOL, k
    assert_trees_close(g, jg, GRAD_REL, arch)
    assert float(torch.stack([x.abs().sum() for x in tree_leaves(g)]).sum()) > 0
    if remat_too:
        g2, m2 = grads_of(tp, dataclasses.replace(cfg, remat=True), tb)
        for a, b in zip(tree_leaves(g), tree_leaves(g2), strict=True):
            assert torch.equal(a, b)
        assert all(torch.equal(m[k], m2[k]) for k in m)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_arch(arch, remat_too=arch in ("deepseek_r1_671b",
                                        "recurrentgemma_9b"))


def test_embed_gradient_reaches_the_table():
    """The unembedding's share of the tied table's gradient: with the
    lookup's removed (the embedding read through a detached copy), the
    rest is the logits' gradient, which must be non-zero and reach
    ``params["embed"]`` whether or not the serving copy ``embed_f32`` is
    present (it is never read)."""
    _, cfg = configs("qwen3_8b")
    _, tp = weights(configs("qwen3_8b")[0])
    _, tb = batches(cfg, 2, 16)
    g, _ = grads_of(tp, cfg, tb)
    served = dict(tp, embed_f32=torch.full_like(tp["embed"], float("nan"),
                                                dtype=torch.float32))
    g2, _ = grads_of(served, cfg, tb)
    assert torch.equal(g["embed"], g2["embed"])
    rows = torch.zeros(cfg.vocab_size, dtype=torch.bool)
    rows[tb["tokens"].reshape(-1).long()] = True
    assert float(g["embed"][~rows].abs().max()) > 0     # unembedding only
    assert np.isfinite(float(g["embed"].abs().sum()))
