"""The port's fault-tolerance runtime and fault drills against the JAX
package.

The state machines (heartbeats, straggler flags, the periodic failure
schedule, the remesh plan) must make the reference's decisions and emit its
``ft/*`` counters on the same inputs.  A ``--fault-rate`` drill of the
port's serve loop, on weights converted from the reference's, must give
the outputs of the run without faults and of JAX's drill, with JAX's
counters exactly.  A chunk resumed after a prefix-cache hit or restore
(``prefill_chunk(n_cached=...)``) must give a full chunk's bits without
writing the rows the pool already holds.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.runtime import fault_tolerance as jft
from repro.runtime import telemetry as jtelemetry
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import paged_cache, telemetry


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("timeout,seed", itertools.product(
    (0.5, 1.0, 1.5, 3.0), (0, 1, 2)))
def test_heartbeats_equal_reference(timeout, seed):
    """Beats from three workers at drawn times: alive() / dead() after
    every event and the ft/heartbeats counter equal the reference's."""
    rng = np.random.default_rng(seed)
    clocks, regs, hbs = [], [], []
    for mod, tel in ((ft, telemetry), (jft, jtelemetry)):
        clock, reg = _Clock(), tel.MetricsRegistry()
        clocks.append(clock)
        regs.append(reg)
        hbs.append(mod.HeartbeatRegistry(timeout_s=timeout, clock=clock,
                                         metrics=reg))
    for _ in range(40):
        dt = float(rng.choice([0.25, 0.5, 1.0, 2.0]))
        worker = f"w{int(rng.integers(3))}"
        beat = rng.random() < 0.6
        for clock, hb in zip(clocks, hbs, strict=True):
            clock.t += dt
            if beat:
                hb.beat(worker)
        assert hbs[0].alive() == hbs[1].alive()
        assert hbs[0].dead() == hbs[1].dead()
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.parametrize("window,z,seed", itertools.product(
    (4, 8, 16), (2.0, 4.0), (0, 3)))
def test_straggler_flags_equal_reference(window, z, seed):
    """Per-worker step times with one slow worker: the flagged stragglers
    and the ft/* counters and step-time histograms equal the reference's."""
    rng = np.random.default_rng(seed)
    regs = [telemetry.MetricsRegistry(), jtelemetry.MetricsRegistry()]
    dets = [ft.StragglerDetector(window, z, metrics=regs[0]),
            jft.StragglerDetector(window, z, metrics=regs[1])]
    for step in range(24):
        for w in range(5):
            t = float(rng.normal(0.1, 0.005)) * (3.0 if w == 4 else 1.0)
            for d in dets:
                d.record(f"host{w}", t)
        if step % 3 == 2:
            assert dets[0].stragglers() == dets[1].stragglers()
    assert dets[0].stragglers() == dets[1].stragglers()
    assert regs[0].snapshot() == regs[1].snapshot()


@pytest.mark.parametrize("rate", [1.0, 0.5, 0.3, 0.2, 0.1, 0.05, 0.02, 0.013,
                                  1e-3])
def test_from_rate_schedules_equal_reference(rate):
    """The periodic schedule: the same steps fail, and check() raises and
    counts on exactly those steps."""
    got = ft.FailureInjector.from_rate(rate, horizon=5000,
                                       metrics=telemetry.MetricsRegistry())
    want = jft.FailureInjector.from_rate(rate, horizon=5000,
                                         metrics=jtelemetry.MetricsRegistry())
    assert set(got.fail_at_steps) == set(want.fail_at_steps)
    for step in range(400):
        outcomes = []
        for inj, err in ((got, ft.WorkerFailure), (want, jft.WorkerFailure)):
            try:
                inj.check(step)
                outcomes.append(False)
            except err:
                outcomes.append(True)
        assert outcomes[0] == outcomes[1], step
    assert got.metrics.snapshot() == want.metrics.snapshot()


def test_from_rate_refuses_rates_outside_unit_interval():
    for rate in (0.0, -0.5, 1.5):
        with pytest.raises(AssertionError):
            ft.FailureInjector.from_rate(rate)


@pytest.mark.parametrize("mp", [1, 2, 4, 8, 16])
def test_plan_remesh_equal_reference(mp):
    for hosts, chips in itertools.product(range(0, 9), (1, 4, 8)):
        assert ft.plan_remesh(hosts, chips, mp) == \
            jft.plan_remesh(hosts, chips, mp)


# --------------------------------------------- resumed chunks (n_cached)
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "fp8"])
def test_prefill_chunk_n_cached(kv_dtype):
    """A chunk run from its grid point with its first rows already in the
    pools gives the full chunk's logits bitwise and leaves the pools as the
    full chunk left them, on the latent pool and on its code pools."""
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    params = model.init(cfg, seed=0, device="cpu")
    layout = paged_cache.layout_for(1, 32, 4)
    table = torch.arange(1, layout.max_blocks + 1, dtype=torch.int32)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    cache = model.init_paged_cache(cfg, layout, kv_dtype=kv_dtype,
                                   device="cpu")
    for s in (0, 8, 16):
        want, cache = model.prefill_chunk(params, cfg, cache,
                                          toks[:, s:s + 8], table,
                                          torch.tensor([s], dtype=torch.int32))
    rows = [{k: paged_cache.raw(v).clone() for k, v in lc.items()}
            for lc in cache]
    got, cache = model.prefill_chunk(params, cfg, cache, toks[:, 16:24],
                                     table,
                                     torch.tensor([16], dtype=torch.int32),
                                     n_cached=6)
    assert torch.equal(got, want)
    for lc, before in zip(cache, rows, strict=True):
        for key in lc:
            assert torch.equal(paged_cache.raw(lc[key]), before[key]), key


def test_prefill_chunk_n_cached_skips_the_writes():
    """The rows before ``n_cached`` are not written: a marked value in one
    of them survives the call, a row after them is rewritten."""
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    params = model.init(cfg, seed=0, device="cpu")
    layout = paged_cache.layout_for(1, 16, 4)
    table = torch.arange(1, layout.max_blocks + 1, dtype=torch.int32)[None]
    toks = torch.randint(0, cfg.vocab_size, (1, 8),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    cache = model.init_paged_cache(cfg, layout, device="cpu")
    for lc in cache:
        lc["c"].fill_(7.0)
    _, cache = model.prefill_chunk(params, cfg, cache, toks, table,
                                   torch.tensor([0], dtype=torch.int32),
                                   n_cached=5)
    for lc in cache:
        rows = paged_cache.gather_blocks(lc["c"], table)[0]
        assert torch.all(rows[:5] == 7.0)
        assert not torch.any(rows[5:8] == 7.0)


# ------------------------------------------------ fault drills against JAX
BASE = ["--reduced", "--batch", "2", "--prompt", "24", "--gen", "8",
        "--requests", "4", "--page-size", "8", "--prefill-chunk", "8",
        "--cache-layout", "paged", "--paranoia", "1"]
DRILL_COUNTERS = ("ft/injected_faults", "ft/heartbeats", "sched/failures",
                  "serve/worker_restarts", "serve/ticks",
                  "serve/replayed_tokens", "sched/restores_recompute",
                  "serve/decode_steps", "serve/prefill_chunks")


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                               moe=None)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params_from_jax(tree, device="cpu")


@pytest.mark.parametrize("extra,faults", [
    (["--fault-rate", "0.05"], True),
    (["--kv-dtype", "int8", "--fault-rate", "0.05"], False),
    (["--kv-dtype", "int8", "--fault-rate", "0.1"], True)],
    ids=["fp-0.05", "int8-0.05", "int8-0.1"])
def test_fault_drill_equals_clean_run_and_jax(setup, extra, faults):
    """The reference scheduler test's drill flags: the port's drill
    finishes every request with the outputs of its run without faults and
    of JAX's drill, and its drill counters equal JAX's exactly.  At 0.05
    the int8 pool's wider batch finishes before the first fault tick (the
    reference's own int8 leg injects nothing); at 0.1 it is failed too,
    so restores re-quantize rows."""
    jcfg, cfg, params = setup
    clean_flags = [f for f in extra if f not in ("--fault-rate", "0.05",
                                                  "0.1")]
    want = jserve.run_paged(jserve.parse_args(BASE + extra), jcfg)
    got = serve.run_paged(serve.parse_args(BASE + extra + ["--device",
                                                           "cpu"]),
                          cfg, params=params, device="cpu")
    clean = serve.run_paged(serve.parse_args(BASE + clean_flags
                                             + ["--device", "cpu"]),
                            cfg, params=params, device="cpu")
    assert got["outputs"] == clean["outputs"] == want["outputs"]
    assert len(got["outputs"]) == 4
    gc, wc = got["metrics"]["counters"], want["metrics"]["counters"]
    for key in DRILL_COUNTERS:
        assert gc.get(key, 0) == wc.get(key, 0), key
    assert got["worker_restarts"] == want["worker_restarts"]
    assert got["replayed_tokens"] == want["replayed_tokens"]
    c = gc
    assert c.get("ft/injected_faults", 0) == c.get("sched/failures", 0) \
        == c["serve/worker_restarts"] == got["worker_restarts"]
    assert c["ft/heartbeats"] == c["serve/ticks"]
    if faults:
        assert c["ft/injected_faults"] > 0 and c["serve/replayed_tokens"] > 0
    else:
        assert c.get("ft/injected_faults", 0) == 0
