"""One whole train step of the port (``launch/steps.py:make_train_step``)
against the reference's ``make_train_step`` (compiled with ``jax.jit``)
from the same weights, optimizer state and batch: reduced SmolLM-360M and
DeepSeek-R1 (its MoE layer's aux losses in the loss) with AdamW, SmolLM
with Adafactor and with the int8 gradient round trip (``compress_grads``).
The metrics within 1e-5 (the grad norm 1e-5 relative); each parameter
leaf within 2^-6 of the largest change the reference's step made to it,
with AdamW's eps at 1e-6 (see ``EPS``).
"""
import jax
import pytest

from _torch_train_common import batches, configs, port_tree, to_np, weights
from repro.launch import steps as jsteps
from repro.optim import optimizers as jopt
from repro_torch.launch import steps
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import tree_leaves, tree_map

METRIC_TOL = 1e-5
UPDATE_REL = 2 ** -6
# AdamW's first step is lr g / (|g| + eps): where |g| is near eps it moves
# by lr |dg| / eps for a gradient difference dg.  The packages' gradients
# differ by about 1e-10 absolute (summation order), which at eps 1e-8 moves
# such an element by 1% of lr; at 1e-6 by 0.01%.
EPS = 1e-6


def _tcfgs(name="adamw", compress=False, lr=1e-3):
    kw = dict(name=name, lr=lr, warmup_steps=2, total_steps=50, eps=EPS)
    return (jsteps.TrainConfig(optimizer=jopt.OptimizerConfig(**kw),
                               compress_grads=compress),
            steps.TrainConfig(optimizer=opt.OptimizerConfig(**kw),
                              compress_grads=compress))


@pytest.mark.parametrize("arch,name,compress", [
    ("smollm_360m", "adamw", False), ("smollm_360m", "adafactor", False),
    ("smollm_360m", "adamw", True), ("deepseek_r1_671b", "adamw", False)])
def test_train_step_matches_reference(arch, name, compress):
    jcfg, cfg = configs(arch)
    jp, tp = weights(jcfg)
    jb, tb = batches(cfg, 2, 16)
    jt, tt = _tcfgs(name, compress=compress)
    jstate = jopt.opt_init(jt.optimizer, jp)
    state = opt_state_from_jax(to_np(jstate), "cpu")
    jp2, _, jm = jax.jit(jsteps.make_train_step(jcfg, jt))(jp, jstate, jb,
                                                           0)
    p0 = tree_map(lambda t: t.clone(), tp)
    tp2, state2, m = steps.make_train_step(cfg, tt)(tp, state, tb, 0)
    assert tp2 is tp and int(state2["count"]) == 1      # in place
    for key in ("nll", "load_balance", "router_z"):
        assert abs(float(m[key]) - float(jm[key])) <= METRIC_TOL, key
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        METRIC_TOL * float(jm["grad_norm"])
    want, start = tree_leaves(port_tree(jp2)), tree_leaves(p0)
    for a, b, a0 in zip(tree_leaves(tp2), want, start, strict=True):
        err = float((a - b).abs().max())
        assert err <= UPDATE_REL * float((b - a0).abs().max()) + 1e-12, \
            (arch, tuple(a.shape), err)


