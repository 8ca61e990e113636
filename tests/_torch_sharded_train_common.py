"""Shared setup of the sharded train step's tests
(``tests/test_torch_sharded_train*.py``): the reference test's inputs for
an arch (``tests/test_sharding.py:76-110``), the train configs of both
packages, the port's unsharded runs, the 8-rank spawn
(``_torch_sharded_train_worker.py``) beside JAX's unsharded steps, and the
checks the test files hold the results to (their tolerances in the
files' docstrings)."""
import contextlib
import dataclasses
import functools
import threading

import jax
import numpy as np
import torch

import _torch_sharded_train_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as M
from repro_torch.launch import steps
from repro_torch.models import layers, model, rglru
from repro_torch.models.convert import params_from_jax, tree_from_jax
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import rules

METRIC_REL = 1e-5
PARAM_ATOL = 1e-5
GRAD_REL = 2e-5
STATE_REL = 1e-5
BF16_ULP = 2 ** -7             # one bf16 ulp of a leaf's largest element
LR = 1e-3
SPAWN_S = 120


def tcfgs(kw):
    """(the reference's, the port's) TrainConfig of a case's keywords."""
    o = dict(lr=LR, **kw.get("optimizer", {}))
    rest = {k: v for k, v in kw.items() if k != "optimizer"}
    return (jsteps.TrainConfig(optimizer=jopt.OptimizerConfig(**o), **rest),
            steps.TrainConfig(optimizer=opt.OptimizerConfig(**o), **rest))


def jax_inputs(arch):
    """The reference test's inputs: (jax config, jax params, tokens)."""
    jcfg = jreduced(jget_config(arch))
    jp = jax.jit(functools.partial(jmodel.init, cfg=jcfg))(
        jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                              jcfg.vocab_size)
    return jcfg, jp, toks


def case_cfg(arch, extra):
    """A case's port config: ``reduced``, with the case's "cfg_kw"
    changes (dtype, remat)."""
    return dataclasses.replace(reduced(get_config(arch)),
                               **extra.get("cfg_kw", {}))


def case_params(cfg, params):
    """A copy of ``params`` in the dtypes of the port's own init of
    ``cfg`` (a bf16 case: the reference's fp32 weights rounded to bf16
    where the port holds bf16)."""
    want = dict(rules._leaves_with_path(model.init(cfg, seed=0,
                                                   device="cpu")))
    return rules._tree_map_with_path(
        lambda path, t: t.to(want[path].dtype, copy=True), params)


def unsharded(case, params, toks):
    """The port's unsharded run of a case from ``params``: its grads
    (grads_of) and the params, state and metrics after each step, on one
    thread as each rank runs (MKL's bf16 products change bits with the
    thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _unsharded(case, params, toks)
    finally:
        torch.set_num_threads(threads)


def _unsharded(case, params, toks):
    arch, kw, n, extra = case
    cfg = case_cfg(arch, extra)
    _, tcfg = tcfgs(kw)
    out = {"steps": []}
    if extra.get("floor"):    # a bf16 case: its floor runs
        plain = dict(extra, floor=False)
        with split_rows(worker.MESH[1]):
            out["floors"] = [_unsharded((arch, kw, n, plain), params,
                                        toks)]
        out["floors"].append(_unsharded((arch, dict(kw, n_micro=2), n,
                                         plain), params, toks))
    params = case_params(cfg, params)
    batch = {"tokens": toks}
    if extra.get("grads"):
        out["grads"], out["grads_metrics"] = steps.grads_of(params, cfg,
                                                            batch)
    state = opt.opt_init(tcfg.optimizer, params)
    step = steps.make_train_step(cfg, tcfg)
    for i in range(n):
        params, state, m = step(params, state, batch, i)
        out["steps"].append({
            "params": opt.tree_map(torch.clone, params),
            "state": opt.tree_map(torch.clone, state),
            "metrics": {k: float(v) for k, v in m.items()}})
    return out


@contextlib.contextmanager
def split_rows(n: int):
    """Within the block, each row product of a whole weight
    (``layers.dense_row``, and RG-LRU's gate products) is computed as
    ``n`` `model` ranks compute it: the products of n pieces of its K
    dim, summed in fp32 and rounded once.  The unsharded step under it is
    a floor of a bf16 case: a summation order that the reference's sharded
    step uses."""
    row, gate = layers.dense_row, rglru._gate_in

    def parts(x, w):
        k = w.shape[0] // n
        return sum(layers.dense(x[..., i * k:(i + 1) * k],
                                w[i * k:(i + 1) * k]).float()
                   for i in range(n)).to(x.dtype)
    layers.dense_row = lambda x, w, whole: parts(x, w) if (
        w.shape[0] == whole and whole % n == 0) else row(x, w, whole)
    rglru._gate_in = lambda x, w: parts(x, w) if (
        w.shape[0] == w.shape[1] and w.shape[0] % n == 0) else gate(x, w)
    try:
        yield
    finally:
        layers.dense_row, rglru._gate_in = row, gate


def run(work, cases: dict, extra_items=(), with_jax: bool = True):
    """The 8 ranks over ``cases`` (name -> (arch, train config keywords,
    steps, what else the ranks run)) and ``extra_items`` (worker items
    that take no case), run on a thread beside (``with_jax``) JAX's
    unsharded step of each arch in this process, then the port's
    unsharded runs.  Returns (the ranks' whole results, their checks, the
    unsharded results, JAX's {arch: (params after the step, nll)})."""
    archs = sorted({c[0] for c in cases.values()})
    jin, base = {}, {}
    for arch in archs:
        jin[arch] = jax_inputs(arch)
        p = params_from_jax(jax.tree.map(np.asarray, jin[arch][1]),
                            device="cpu")
        del p["embed_f32"]
        base[arch] = (p, torch.from_numpy(np.array(jin[arch][2])).to(
            torch.int32))
    inputs = {}
    for name, (arch, kw, n, extra) in cases.items():
        cfg = case_cfg(arch, extra)
        inputs[name] = dict(cfg=cfg, params=case_params(cfg, base[arch][0]),
                            tokens=base[arch][1], tcfg=tcfgs(kw)[1],
                            steps=n, **extra)
        (work / name).mkdir()
    torch.save(inputs, work / "inputs.pt")
    failed = []

    def ranks():
        try:
            M.spawn(worker.main, 8, (str(work), [*cases, *extra_items]),
                    timeout_s=SPAWN_S)
        except Exception as e:           # raised in the test's thread
            failed.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()
    jax_out = {}
    try:
        for arch, (jcfg, jp, toks) in jin.items() if with_jax else ():
            jt, _ = tcfgs({})
            jp2, _, jm = jax.jit(jsteps.make_train_step(jcfg, jt))(
                jp, jopt.opt_init(jt.optimizer, jp), {"tokens": toks}, 0)
            jax_out[arch] = (tree_from_jax(jax.tree.map(np.asarray, jp2),
                                           device="cpu"), float(jm["nll"]))
        ref = {name: unsharded(case, *base[case[0]])
               for name, case in cases.items()}
    finally:
        thread.join()
    if failed:
        raise failed[0]
    out = torch.load(work / "out.pt", weights_only=False)
    checks = [torch.load(work / f"rank{r}.pt", weights_only=False)
              for r in range(8)]
    return out, checks, ref, jax_out


def _close_rel(a, b, rel, what):
    assert abs(a - b) <= rel * abs(b) + 1e-12, (what, a, b)


# with compress_grads a gradient element whose int8 code rounds the other
# way moves by one step of its 256-element chunk, at most 1/127 of the
# leaf's largest |g|: m by at most 1/127 and v by 2/127 of their largest,
# plus one bf16 ulp
INT8_STEP = 2 / 127 + BF16_ULP


def check_steps(got, want, name, n, moment_rel=BF16_ULP):
    """Each step's metrics, gathered params and gathered state against the
    unsharded run's (bf16 moments within ``moment_rel`` of the leaf's
    largest element).  Returns the count of stored bf16 moment elements
    that rounded the other way."""
    got, want = got["steps"], want["steps"]
    assert len(got) == len(want) == n
    flips = 0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        for k in ("nll", "load_balance", "router_z", "grad_norm"):
            _close_rel(g["metrics"][k], w["metrics"][k], METRIC_REL,
                       (name, i, k))
        for (path, a), b in zip(rules._leaves_with_path(g["params"]),
                                opt.tree_leaves(w["params"]), strict=True):
            assert a.shape == b.shape, (name, path)
            err = float((a.double() - b.double()).abs().max())
            assert err <= PARAM_ATOL, (name, i, path, err)
        for (path, a), b in zip(rules._leaves_with_path(g["state"]),
                                opt.tree_leaves(w["state"]), strict=True):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, path)
            if a.dtype == torch.bfloat16:     # AdamW's moments
                err = float((a.float() - b.float()).abs().max())
                assert err <= moment_rel * float(b.float().abs().max()), \
                    (name, i, path, err)
                flips += int((a != b).sum())
            elif a.dtype == torch.int32:      # the count
                assert torch.equal(a, b), (name, path)
            else:                             # Adafactor's fp32 stats
                err = float((a - b).abs().max())
                assert err <= STATE_REL * float(b.abs().max()) + 1e-30, \
                    (name, i, path, err)
    return flips


def check_grads(got, want, name):
    """The sharded grads_of's metrics and gathered gradients against the
    unsharded ones."""
    for k in ("nll", "load_balance", "router_z"):
        _close_rel(float(got["grads_metrics"][k]),
                   float(want["grads_metrics"][k]), METRIC_REL, (name, k))
    for (path, a), b in zip(rules._leaves_with_path(got["grads"]),
                            opt.tree_leaves(want["grads"]), strict=True):
        assert a.shape == b.shape, path
        err = float((a.double() - b.double()).abs().max())
        assert err <= GRAD_REL * float(b.abs().max()) + 1e-12, (name, path,
                                                                err)


# a bf16 case: each reading (relative L2 per leaf, relative per metric)
# within the larger of its limit and twice its floor, the floor being the
# larger of the same readings of the unsharded step under split_rows and
# at n_micro 2 (the tolerances in test_torch_sharded_train_c.py's
# docstring)
BF16_GRAD_REL = 1e-2
BF16_METRIC_REL = 1e-3


def rel_l2(a, b, base=None) -> float:
    """|a - b| / |b - base| (``base`` None: |b|), in fp64."""
    d = b.double() - (0 if base is None else base.double())
    return float((a.double() - b.double()).norm() / d.norm().clamp_min(
        1e-300))


def check_bf16(got, want, name) -> dict:
    """A bf16 case's sharded grads_of and step against the unsharded ones:
    the metrics, the gradients and the optimizer state (per leaf), each
    reading gated at max(limit, 2 x its floor); every param within one
    bf16 ulp of the unsharded step's plus 2 lr (the first AdamW step moves
    a param by at most lr (1 + 2^-7): it may round the other way, or its
    gradient's sign may flip).  Returns the readings closest to their
    gates and the count of param elements that differ."""
    worst = {}

    def gate(what, reading, fls, limit):
        fl = max(fls)
        bound = max(limit, 2 * fl)
        assert reading <= bound, (name, what, reading, fl)
        kind = what[0]
        if kind not in worst or reading / bound > worst[kind][1] / worst[
                kind][3]:
            worst[kind] = (what, reading, fl, bound)

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)
    floors = want["floors"]
    for k in ("nll", "load_balance", "router_z"):
        w = float(want["grads_metrics"][k])
        gate(("metric", k), rel(float(got["grads_metrics"][k]), w),
             [rel(float(f["grads_metrics"][k]), w) for f in floors],
             BF16_METRIC_REL)
    w = want["steps"][0]["metrics"]["grad_norm"]
    gate(("metric", "grad_norm"), rel(got["steps"][0]["metrics"][
        "grad_norm"], w), [rel(f["steps"][0]["metrics"]["grad_norm"], w)
                           for f in floors], BF16_METRIC_REL)
    fg = [opt.tree_leaves(f["grads"]) for f in floors]
    for i, ((path, a), b) in enumerate(zip(rules._leaves_with_path(
            got["grads"]), opt.tree_leaves(want["grads"]), strict=True)):
        gate(("grad", path), rel_l2(a, b), [rel_l2(f[i], b) for f in fg],
             BF16_GRAD_REL)
    fs = [opt.tree_leaves(f["steps"][0]["state"]) for f in floors]
    for i, ((path, a), b) in enumerate(zip(rules._leaves_with_path(
            got["steps"][0]["state"]), opt.tree_leaves(want["steps"][0][
                "state"]), strict=True)):
        if a.is_floating_point():
            gate(("state", path), rel_l2(a, b), [rel_l2(f[i], b) for f in fs],
                 BF16_GRAD_REL)
        else:                             # the count
            assert torch.equal(a, b), (name, path)
    flips = 0
    for (path, a), b in zip(rules._leaves_with_path(got["steps"][0][
            "params"]), opt.tree_leaves(want["steps"][0]["params"]),
            strict=True):
        bound = bf16_ulp(b) + 2 * LR * (1 + BF16_ULP)
        err = (a.double() - b.double()).abs()
        assert bool((err <= bound).all()), (name, path, float(err.max()))
        flips += int((a != b).sum())
    worst["params"] = (("params", "elements that differ"), flips, 0, 1)
    return worst


def bf16_ulp(t):
    """The spacing of bf16 values at each element of ``t`` (fp64; at 0 the
    spacing of the smallest normal)."""
    _, e = torch.frexp(t.double().abs().clamp_min(2.0 ** -126))
    return torch.pow(2.0, (e - 8).double())
    return worst


def check_jax(got, jax_params, jax_nll, name):
    """A sharded step's nll and gathered params against JAX's."""
    _close_rel(got["steps"][0]["metrics"]["nll"], jax_nll, METRIC_REL, name)
    for (path, a), b in zip(rules._leaves_with_path(got["steps"][0][
            "params"]), opt.tree_leaves(jax_params), strict=True):
        err = float((a.double() - b.double()).abs().max())
        assert err <= PARAM_ATOL, (name, path, err)


def check_placement(checks, name):
    for rank in checks:
        c = rank[name]
        assert c["params_shapes"] and c["n_cut"] > 0
        assert c["state_shapes"]
        assert c["init_same"]
