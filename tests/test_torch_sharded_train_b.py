"""The sharded train step (ROADMAP A10b.2), continued from
``test_torch_sharded_train.py`` (its docstring gives the setup and the
tolerances, ``_torch_sharded_train_common.py`` the checks): DeepSeek-R1
(an MLA dense layer and a MoE layer with a shared expert, the experts
over `model`) and RecurrentGemma-9B (two RG-LRU layers, their channels
over `model`) against the port's unsharded step and JAX's; beyond the
reference, two consecutive DeepSeek steps (the second reads the placed
optimizer state, then a checkpoint round trip), and Adafactor for
DeepSeek with ``min_dim_size_to_factor`` 16, so that factored ``vr`` /
``vc`` on cut dims occur at the reduced widths.

Also: JAX's sharded step for DeepSeek, built as
``tests/test_sharding.py:76-110`` builds it (a subprocess with 8 fake
devices, the params placed by ``rules.param_shardings`` and the state by
``opt_state_specs`` on the (2, 4) mesh), against the port's sharded step:
nll within 1e-5 relative, every param within 1e-5 absolute; and on the
ranks each collective's gradient against its adjoint under
``launch.mesh``'s convention (float64, within 1e-12), with the
backward's bytes counted apart.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

import _torch_sharded_train_common as common
from repro_torch.models.convert import tree_from_jax

ARCHS = ["deepseek_r1_671b", "recurrentgemma_9b"]
CASES = {arch: (arch, {}, 1, {"grads": True, "init_check": True})
         for arch in ARCHS}
CASES.update({
    "deepseek-2-steps": ("deepseek_r1_671b", {}, 2, {"ckpt": True}),
    "deepseek-adafactor": ("deepseek_r1_671b", {"optimizer": {
        "name": "adafactor", "min_dim_size_to_factor": 16}}, 2, {}),
})

_JAX_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import get_config, reduced
    from repro.models import model
    from repro.sharding import rules
    from repro.launch.steps import TrainConfig, make_train_step
    from repro.optim import optimizers as opt

    cfg = reduced(get_config("deepseek_r1_671b"))
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = model.init(jax.random.PRNGKey(0), cfg)
    tcfg = TrainConfig(optimizer=opt.OptimizerConfig(lr=%(lr)r))
    opt_state = opt.opt_init(tcfg.optimizer, params)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (8, 32),
                                          0, cfg.vocab_size)}
    with jax.set_mesh(mesh):
        p_shard = rules.param_shardings(params, mesh)
        o_shard = jax.tree.map(lambda s: NamedSharding(mesh, s),
                               rules.opt_state_specs(opt_state, mesh))
        step = jax.jit(make_train_step(cfg, tcfg),
                       in_shardings=(p_shard, o_shard, None, None),
                       out_shardings=(p_shard, o_shard, None))
        p_new, _, m = step(params, opt_state, batch, 0)
    np.savez(sys.argv[1] + "/jax_sharded.npz",
             *[np.asarray(x, np.float32) for x in jax.tree.leaves(p_new)])
    print(json.dumps({"nll": float(m["nll"])}))
""") % dict(lr=common.LR)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharded_train_b")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    sub = subprocess.Popen([sys.executable, "-c", _JAX_SHARDED, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        out = common.run(work, CASES, extra_items=("adjoints",))
        stdout, stderr = sub.communicate(timeout=300)
    finally:
        if sub.poll() is None:
            sub.kill()
            sub.wait()
    assert sub.returncode == 0, stderr[-3000:]
    jcfg, jp, _ = common.jax_inputs("deepseek_r1_671b")
    leaves = list(np.load(work / "jax_sharded.npz").values())
    sharded = tree_from_jax(jax.tree.unflatten(jax.tree.structure(jp),
                                               leaves), device="cpu")
    return (*out, (sharded, json.loads(stdout.strip().splitlines()[-1])[
        "nll"]))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_unsharded(runs, name):
    ranks, _, ref, _, _ = runs
    flips = common.check_steps(ranks[name], ref[name], name, CASES[name][2])
    print(f"{name}: {flips} stored bf16 moment elements rounded the other "
          "way")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_unsharded(runs, arch):
    ranks, _, ref, _, _ = runs
    common.check_grads(ranks[arch], ref[arch], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(runs, arch):
    ranks, _, _, jax_out, _ = runs
    common.check_jax(ranks[arch], *jax_out[arch], arch)


def test_sharded_step_matches_jax_sharded(runs):
    """The port's sharded DeepSeek step against JAX's sharded step on 8
    fake devices: nll within 1e-5 relative, params within 1e-5."""
    ranks, _, _, _, (params, nll) = runs
    common.check_jax(ranks["deepseek_r1_671b"], params, nll,
                     "jax sharded")


@pytest.mark.parametrize("arch", ARCHS)
def test_placement(runs, arch):
    _, checks, _, _, _ = runs
    common.check_placement(checks, arch)


def test_checkpoint_round_trip(runs):
    """checkpoint.save of the placed (params, state) under the mesh writes
    whole leaves, and restore into a placed template gives every rank's
    pieces back bitwise."""
    _, checks, _, _, _ = runs
    for rank in checks:
        c = rank["deepseek-2-steps"]
        assert c["whole_on_disk"] and c["restored"]


@pytest.mark.parametrize("what", [
    "gather/model", "gather/data", "reduce_sum/model", "reduce_sum/data",
    "scatter_sum/model", "enter/model"])
def test_collective_adjoints(runs, what):
    """Each collective's gradient on every rank equals its adjoint under
    the convention (over `data` the adjoint sums: a gather's backward
    reduce-scatters; over `model` a gather's is the slice, an
    all-reduce's the identity, ``enter``'s an all-reduce), and a gather's
    backward bytes are counted under ":backward"."""
    _, checks, _, _, _ = runs
    for rank in checks:
        c = rank["adjoints"]
        assert c[what]
        assert c["moved"] == {"all_gather": 16 * 3 * 8,
                              "reduce_scatter:backward": 8 * 3 * 8}
