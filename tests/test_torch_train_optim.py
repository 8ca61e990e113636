"""The port's optimizers, schedule, clipping, gradient compression and data
pipeline against the reference (``repro/optim``, ``repro/data``).

AdamW (bf16 moments) and Adafactor (factored at ``min_dim_size_to_factor``
8, so the reduced widths factor) run 1 and 3 steps from the same state on
the reference's gradients of reduced SmolLM-360M, whose two layers are one
stacked group (n = 2): parameters within 1e-6 of each leaf's max |value|
(elementwise fp32 arithmetic in the same order; the schedule's cosine may
differ by an ulp), the fp32 state within 1e-5 of its max, the bf16 moments
within one bf16 ulp (2^-7 of the max).  Adafactor's update clipping takes
the RMS over the reference's stacked leaf (``model.layer_stacks``); per
layer it gives other parameters, which the test shows.  After 3 steps
the parameters are held within 2^-6 of the largest update the reference
made (a bf16 moment may round to its neighbour where the global norms
differ in their last bits).  ``schedule`` and
``clip_by_global_norm`` within 1e-6 relative; the int8 codes and scales
of ``compress`` bitwise, the tree's over the stacked leaves too; ``make_batch`` bitwise (tokens, fp32 embeddings,
and the bf16 embeddings of a full config against ml_dtypes' rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import batches, configs, port_tree, to_np, weights
from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import model as jmodel
from repro.optim import compress as jcomp
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.models import model
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import compress
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import tree_leaves

PARAM_REL = 1e-6
STATE_REL = 1e-5
BF16_REL = 2 ** -7
# after 3 steps: the two global norms differ in their last bits (other
# summation orders), so a bf16 moment may round to its neighbour and move
# that element's later updates by about 2^-8: allowed 2^-6 of the largest
# update the reference made
UPDATE_REL = 2 ** -6


def _pairs(got, want):
    """Matching leaves of two trees, dicts matched by key (the reference's
    trees come with sorted keys)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        return [p for k in want for p in _pairs(got[k], want[k])]
    if isinstance(want, (list, tuple)):
        return [p for a, b in zip(got, want, strict=True)
                for p in _pairs(a, b)]
    return [(got, want)]


def _close(got, want, rel, scale_of=None):
    """Each leaf within ``rel`` x max |want| (or of the matching leaf of
    ``scale_of``)."""
    scales = [b for _, b in _pairs(scale_of, scale_of)] if scale_of \
        else None
    for i, (a, b) in enumerate(_pairs(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        a, b = a.double(), b.double()
        err = float((a - b).abs().max()) if a.numel() else 0.0
        ref = scales[i].double() if scales else b
        assert err <= rel * float(ref.abs().max()) + 1e-12, (err, a.shape)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs("smollm_360m")
    jp, _ = weights(jcfg)
    jb, _ = batches(cfg, 2, 16)
    jg, _ = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, jcfg, b),
                             has_aux=True))(jp, jb)
    return jcfg, cfg, jp, jg


def _run(name, setup, steps, stacks="groups"):
    jcfg, cfg, jp, jg = setup
    ocfg = jopt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                                total_steps=10, min_dim_size_to_factor=8)
    pcfg = opt.OptimizerConfig(name=name, lr=1e-2, warmup_steps=2,
                               total_steps=10, min_dim_size_to_factor=8)
    jstate = jopt.opt_init(ocfg, jp)
    params, grads = port_tree(jp), port_tree(jg)
    state = opt.opt_init(pcfg, params)
    _close(state, opt_state_from_jax(to_np(jstate), "cpu"), 0.0)
    stack_arg = model.layer_stacks(cfg) if stacks == "groups" else None
    for _ in range(steps):
        g, _ = jopt.clip_by_global_norm(jg, 1.0)
        jp_new, jstate = jopt.opt_update(ocfg, g, jstate, jp)
        jp = jp_new
        g, _ = opt.clip_by_global_norm(grads, 1.0)
        params, state = opt.opt_update(pcfg, g, state, params,
                                       stacks=stack_arg)
    return params, state, port_tree(jp), opt_state_from_jax(to_np(jstate),
                                                            "cpu")


def _close_params(params, jparams, setup, steps):
    if steps == 1:
        _close(params, jparams, PARAM_REL)
        return
    p0 = port_tree(setup[2])
    update = {k: v for k, v in _diff(jparams, p0).items()}
    _close(params, jparams, UPDATE_REL, scale_of=update)


def _diff(a, b):
    if isinstance(a, dict):
        return {k: _diff(a[k], b[k]) for k in a}
    if isinstance(a, list):
        return [_diff(x, y) for x, y in zip(a, b, strict=True)]
    return a - b


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_reference(setup, steps):
    params, state, jparams, jstate = _run("adamw", setup, steps)
    _close_params(params, jparams, setup, steps)
    _close(state["m"], jstate["m"], BF16_REL)
    _close(state["v"], jstate["v"], BF16_REL)
    assert int(state["count"]) == int(jstate["count"]) == steps
    assert tree_leaves(state["m"])[0].dtype == torch.bfloat16


@pytest.mark.parametrize("steps", [1, 3])
def test_adafactor_matches_reference(setup, steps):
    params, state, jparams, jstate = _run("adafactor", setup, steps)
    _close_params(params, jparams, setup, steps)
    _close(state["v"], jstate["v"], STATE_REL)
    assert int(state["count"]) == steps
    assert "vr" in state["v"]["layers"][0]["ffn"]["w_gate"]


def test_adafactor_clips_over_the_stacked_group(setup):
    """SmolLM's two layers are one stacked leaf in the reference: the RMS
    of the update is taken over both.  Per layer (stacks=None) some leaf
    comes out otherwise."""
    _, cfg, _, _ = setup
    assert model.layer_stacks(cfg) == [[0, 1]]
    grouped, _, jparams, _ = _run("adafactor", setup, 1)
    per_layer, _, _, _ = _run("adafactor", setup, 1, stacks=None)
    _close(grouped, jparams, PARAM_REL)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(grouped), tree_leaves(per_layer)))


def test_layer_stacks_follow_the_reference_plan():
    """RecurrentGemma's superblock (rglru, rglru, attn) x n plus its
    remainder, and DeepSeek's dense run then MoE run."""
    cfg = dataclasses.replace(get_config("recurrentgemma_9b"), num_layers=8)
    assert model.layer_stacks(cfg) == [[0, 3], [1, 4], [2, 5], [6], [7]]
    cfg = dataclasses.replace(get_config("deepseek_r1_671b"), num_layers=5)
    assert model.layer_stacks(cfg) == [[0, 1, 2], [3, 4]]


def test_schedule_and_clip_match_reference(setup):
    _, _, _, jg = setup
    jc = jopt.OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=20)
    pc = opt.OptimizerConfig(lr=3e-4, warmup_steps=5, total_steps=20)
    for step in range(0, 25):
        want = float(jopt.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = float(opt.schedule(pc, torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * abs(want) + 1e-12, step
    for max_norm in (1.0, 1e3):
        jcl, jn = jopt.clip_by_global_norm(jg, max_norm)
        cl, n = opt.clip_by_global_norm(port_tree(jg), max_norm)
        assert abs(float(n) - float(jn)) <= 1e-6 * float(jn)
        _close(cl, port_tree(jcl), 1e-6)
        assert all(x.dtype == torch.float32 for x in tree_leaves(cl))


@pytest.mark.parametrize("shape,dtype", [((333,), np.float32),
                                         ((5, 130), np.float32),
                                         ((4, 256), "bfloat16"),
                                         ((7,), np.float32)])
def test_compress_codes_bitwise(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    g32 = (rng.normal(size=shape) * 10).astype(np.float32)
    if dtype == "bfloat16":
        jg = jnp.asarray(g32, jnp.bfloat16)
        tg = torch.from_numpy(g32).to(torch.bfloat16)
    else:
        jg, tg = jnp.asarray(g32), torch.from_numpy(g32)
    jq, js = jcomp.quantize(jg)
    q, s = compress.quantize(tg)
    assert q.dtype == torch.int8 and q.shape[1] == compress.CHUNK
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    out = compress.compress_decompress(tg)
    np.testing.assert_array_equal(
        out.numpy().view(np.uint32),
        np.asarray(jcomp.compress_decompress(jg)).view(np.uint32))
    assert tuple(out.shape) == shape


def test_compress_tree_and_residual(setup):
    """The tree round trip over the reference's stacked leaves, bitwise."""
    _, _, _, jg = setup
    stacks = model.layer_stacks(setup[1])
    got = compress.compress_tree_for_pod_reduce(port_tree(jg), stacks)
    want = port_tree(jcomp.compress_tree_for_pod_reduce(jg))
    for a, b in _pairs(got, want):
        assert torch.equal(a, b)
    # per layer, a norm scale of 64 values is a chunk of its own; the
    # reference's stacked [2, 64] leaf shares one chunk between the layers
    alone = compress.compress_tree_for_pod_reduce(port_tree(jg))
    assert any(not torch.equal(a, b) for a, b in _pairs(alone, got))
    res = compress.init_residual(got)
    assert all(float(r.abs().sum()) == 0 and r.dtype == torch.float32
               for r in tree_leaves(res))


@pytest.mark.parametrize("arch", ["smollm_360m", "musicgen_large"])
def test_make_batch_bitwise(arch):
    jcfg, cfg = configs(arch)
    data = pipeline.DataConfig(seed=5, global_batch=4, seq_len=12)
    jdata = jpipe.DataConfig(seed=5, global_batch=4, seq_len=12)
    for step in (0, 7):
        for lo, hi in ((0, None), (1, 3)):
            got = pipeline.make_batch(cfg, data, step, lo=lo, hi=hi)
            want = jpipe.make_batch(jcfg, jdata, step, lo=lo, hi=hi)
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], np.asarray(want[k]))
                assert got[k].dtype == np.asarray(want[k]).dtype
    shapes = {k: s.shape for k, s in jpipe.batch_struct(jcfg, jdata).items()}
    assert {k: v[0] for k, v in pipeline.batch_struct(cfg, data).items()} \
        == shapes


def test_bf16_embeddings_round_as_the_reference():
    """A full (bf16) config's frontend embeddings: the port's to_device
    bits equal the reference's ml_dtypes bfloat16 array's."""
    cfg = get_config("musicgen_large")
    jcfg = jget_config("musicgen_large")
    data = pipeline.DataConfig(seed=2, global_batch=2, seq_len=4)
    want = jpipe.make_batch(jcfg, jpipe.DataConfig(seed=2, global_batch=2,
                                                   seq_len=4), 3)
    got = pipeline.to_device(cfg, pipeline.make_batch(cfg, data, 3), "cpu")
    assert got["embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["embeds"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(want["embeds"]).view(np.uint16))
    assert got["targets"].dtype == torch.int32


def test_prefetcher_yields_the_pipeline_batches():
    _, cfg = configs("smollm_360m")
    data = pipeline.DataConfig(seed=1, global_batch=2, seq_len=8)
    pf = pipeline.Prefetcher(cfg, data, "cpu", start_step=3, depth=2)
    try:
        for want_step, (step, batch) in zip(range(3, 7), pf):
            assert step == want_step
            np.testing.assert_array_equal(
                batch["tokens"].numpy(),
                pipeline.make_batch(cfg, data, step)["tokens"])
    finally:
        pf.close()
