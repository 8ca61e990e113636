"""The port's continuous-batching serve loop against the JAX serve loop, in
both attention modes, and the serve flags.

Both loops get the same weights (the reference's ``model.init``, converted)
and the same flags on the reduced DeepSeek config without MoE (fp32, CPU):
the greedy outputs must be EQUAL, token for token.  Inside the port, the
prefix cache on and off give bitwise-equal outputs.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax

FLAGS = ["--reduced", "--batch", "2", "--prompt", "24", "--gen", "4",
         "--requests", "4", "--page-size", "8", "--prefill-chunk", "8",
         "--shared-prefix", "16"]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jreduced(jget_config("deepseek_r1_671b")),
                               moe=None)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, params_from_jax(tree, device="cpu")


def _port(cfg, params, flags):
    return serve.run_paged(serve.parse_args(flags + ["--device", "cpu"]), cfg,
                           params=params, device="cpu")


@pytest.mark.parametrize("extra", [
    [], ["--kv-splits", "2"], ["--mode", "standard"],
    ["--mode", "standard", "--kv-splits", "2"], ["--kv-dtype", "int8"],
    ["--kv-dtype", "fp8"], ["--kv-dtype", "int8", "--kv-splits", "2"],
    ["--page-size", "4", "--shared-prefix", "14"],
    ["--batch", "1", "--page-size", "4", "--shared-prefix", "14",
     "--kv-dtype", "int8"]],
    ids=["auto-splits", "kv-splits-2", "standard", "standard-kv-splits-2",
         "int8", "fp8", "int8-kv-splits-2", "prefix-off-grid",
         "prefix-off-grid-int8"])
def test_outputs_equal_jax_serve(setup, extra):
    """Same weights, same flags: the port's greedy outputs equal the JAX
    loop's (default XLA path).  ``--kv-splits 2`` runs the split path;
    ``--mode standard`` the untransposed baseline on the gathered pool;
    ``--kv-dtype`` the quantized pools, sized to the fp pool's bytes (the
    same batch slots as the reference's); a shared prefix of 14 tokens
    over pages of 4 puts prefix-cache hits off the chunk grid (the port
    resumes from the grid point, recomputing the cached rows; the
    reference runs a shorter chunk): the same tokens and counters."""
    jcfg, cfg, params = setup
    want = jserve.run_paged(jserve.parse_args(FLAGS + extra), jcfg)
    got = _port(cfg, params, FLAGS + extra)
    if "--shared-prefix" in extra:
        assert got["prefix"]["hits"] > 0
        per_hit = got["prefill_tokens_saved"] // got["prefix"]["hits"]
        assert per_hit % 8, "hits on the chunk grid"
    assert got["outputs"] == want["outputs"]
    assert len(got["outputs"]) == 4
    for key in ("tokens_served", "prefill_tokens", "prefill_tokens_saved",
                "prefill_chunks", "steps", "batch_slots", "kv_dtype"):
        assert got[key] == want[key], key


def test_prefix_cache_on_off_bitwise(setup):
    """Inside the port: the prefix cache changes how prompts are served
    (blocks shared, prefill skipped), never what is generated."""
    _, cfg, params = setup
    flags = FLAGS[:FLAGS.index("--batch")] + ["--batch", "1"] + \
        FLAGS[FLAGS.index("--batch") + 2:]
    on = _port(cfg, params, flags)
    off = _port(cfg, params, flags + ["--no-prefix-cache"])
    assert on["outputs"] == off["outputs"]
    assert on["prefix"]["hits"] > 0 and on["prefill_tokens_saved"] > 0
    assert on["prefill_tokens"] + on["prefill_tokens_saved"] == \
        off["prefill_tokens"]


def test_requests_equal_reference_stream():
    """_make_requests draws the reference's tokens from the same seed,
    including priorities and arrivals."""
    flags = FLAGS + ["--priority-classes", "3", "--arrival-rate", "0.5"]
    got = serve._make_requests(serve.parse_args(flags + ["--device", "cpu"]),
                               256)
    want = jserve._make_requests(jserve.parse_args(flags), 256)
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g["prompt"], np.asarray(w["prompt"]))
        assert {k: g[k] for k in ("id", "gen", "priority", "arrival")} == \
            {k: w[k] for k in ("id", "gen", "priority", "arrival")}


CONTENDED = ["--reduced", "--batch", "2", "--prompt", "24", "--gen", "8",
             "--requests", "6", "--page-size", "8", "--prefill-chunk", "8",
             "--priority-classes", "3", "--arrival-rate", "0.25", "--trace",
             "burst", "--burst-size", "3", "--retry-backoff", "4",
             "--paranoia", "1"]


def test_preemption_swap_and_recompute_match_uncontended(setup):
    """The reference's contended burst trace (6 requests through 2 slots,
    three priority classes): both evacuation modes preempt, finish every
    request, and deliver the uncontended run's outputs bitwise."""
    _, cfg, params = setup
    calm = _port(cfg, params, CONTENDED[:2] + ["8"] + CONTENDED[3:])
    assert calm["sched"]["preemptions"] == 0
    for mode in ("swap", "recompute"):
        busy = _port(cfg, params, CONTENDED + ["--preemption", mode])
        assert busy["sched"]["preemptions"] > 0, mode
        assert len(busy["outputs"]) == 6
        assert busy["outputs"] == calm["outputs"], mode


A6_BASE = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt", "24",
           "--gen", "4", "--requests", "4", "--page-size", "8",
           "--prefill-chunk", "8"]
A6_FLAGS = ("--fault-rate", "--trace-out", "--metrics-out",
            "--profile-kernels")


@pytest.mark.parametrize("flag", [
    ["--arch", "qwen3_8b", "--kv-dtype", "fp8", "--metrics-out", "m.json"],
    ["--fault-rate", "0.1"], ["--trace-out", "t.json"],
    ["--metrics-out", "m.json"], ["--profile-kernels", "2"]])
def test_a6_flags_served(flag, tmp_path):
    """The flags of fault drills and telemetry export, refused until they
    were ported (these five flag sets were the cases of
    test_unported_flags_refused), parse and serve on the paged layout: the
    outputs are those of the same run without them, and every file asked
    for is written."""
    flag = [str(tmp_path / f) if f.endswith(".json") else f for f in flag]
    args = serve.parse_args(A6_BASE + flag)
    assert args.cache_layout == "paged"
    off = []
    for f, v in zip(flag[::2], flag[1::2], strict=True):
        if f not in A6_FLAGS:
            off += [f, v]
    want = serve.run(serve.parse_args(A6_BASE + off))
    got = serve.run(args)
    assert got["outputs"] == want["outputs"]
    assert len(got["outputs"]) == 4
    for path in (f for f in flag if f.endswith(".json")):
        assert json.load(open(path))


@pytest.mark.parametrize("flag,words", [
    (["--trace-buffer", "0"], "--trace-buffer must be >= 1"),
    (["--profile-kernels", "-1"], "--profile-kernels must be >= 0")])
def test_a6_value_refusals_match_reference(flag, words, capsys):
    """A trace ring of no events and a negative sampling period are refused
    with the reference's words."""
    with pytest.raises(SystemExit):
        jserve.parse_args(flag)
    assert words in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu"] + flag)
    assert words in capsys.readouterr().err


@pytest.mark.parametrize("rate", ["-0.1", "1.5"])
def test_fault_rate_outside_unit_interval_refused(rate, capsys):
    """A fault rate is a probability a tick: outside [0, 1] is refused
    (the reference's ``FailureInjector.from_rate`` asserts (0, 1])."""
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--fault-rate", rate])
    assert "--fault-rate must be in [0, 1]" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["--mode", "standard", "--kv-dtype", "int8", "--spec-tokens", "2"],
    ["--spec-tokens", "2"]])
def test_spec_flags_served(setup, flag):
    """--spec-tokens, refused until speculative decoding was ported (the
    two flag sets were cases of the refusal test of unported flags), parses and
    serves: the outputs and token count are the spec-off run's."""
    _, cfg, params = setup
    args = serve.parse_args(["--device", "cpu"] + flag)
    assert args.spec_tokens == 2
    off = [f for f in flag if f not in ("--spec-tokens", "2")]
    want = _port(cfg, params, FLAGS + off)
    got = _port(cfg, params, FLAGS + flag)
    assert got["outputs"] == want["outputs"]
    assert got["tokens_served"] == want["tokens_served"]
    assert got["spec"]["k"] == 2 and got["spec"]["steps"] > 0


@pytest.mark.parametrize("flag", [
    ["--spec-tokens", "2"], ["--trace-out", "t.json"],
    ["--profile-kernels", "2"]])
def test_dense_layout_refuses_paged_only_flags(flag, capsys):
    """The reference's refusals: these flags need the paged layout."""
    with pytest.raises(SystemExit):
        serve.parse_args(["--device", "cpu", "--cache-layout", "dense"]
                         + flag)
    assert "--cache-layout paged" in capsys.readouterr().err


def test_dense_and_standard_flags_served():
    args = serve.parse_args(["--cache-layout", "dense", "--mode", "standard"])
    assert (args.cache_layout, args.mode) == ("dense", "standard")


def test_layers_flag_cuts_depth_only():
    args = serve.parse_args(["--layers", "3"])
    cfg = serve.config_for(args)
    full = get_config("deepseek_r1_671b")
    assert cfg == dataclasses.replace(full, num_layers=3)
    assert args.device == "cuda"
