"""Expert parallelism over `data` in serving (ROADMAP A10b.3), and the
compressed reduce and per-rank batches (A10b.4), against the JAX package.

One spawn of 4 gloo ranks on the CPU for the module
(``_torch_expert_parallel_worker.py``; the group meets through a FileStore
in the test's directory), and one JAX subprocess with 8 fake host devices
(``--xla_force_host_platform_device_count=8``) that places the reference's
weights by ``rules.param_shardings(..., profile="serve")`` with
``jax.device_put``, jits ``make_prefill_step`` and ``make_serve_step`` over
them on 4 of its devices, and runs ``compressed_psum`` and
``pod_reduce_with_feedback`` under ``shard_map`` over 4.  The port's ranks
take the same weights through ``params_from_jax`` and
``rules.place_params``.  Checked, for reduced DeepSeek-R1 with its MoE
layer (4 experts, top-2) on (2, 2) and (4, 1), where the serve profile
puts the experts over `data`:

- a 24-token prompt prefilled under the mesh, then 4 greedy steps: the
  prefill's and every step's gathered logits within 2e-5 of the
  reference's, the tokens equal, the prefill's experts exchanged by
  all-to-all and the steps' rows gathered and reduce-scattered;
- every placed leaf's shape is ``rules.local_shape`` of its spec (E/n
  experts a rank), and the placed ``init`` is bitwise ``place_params`` of
  the whole one;
- ``moe_ffn`` with 16 experts and a router biased so that one expert's
  pairs exceed its capacity: the full sequence (groups over `data`) and
  the decode group (tokens over `data`, and whole) within 2e-5 of the
  unsharded ``moe_ffn`` (``tests/test_torch_moe.py`` holds that one to
  JAX's), drops included;
- ``compressed_psum`` and ``pod_reduce_with_feedback`` over `data` = 4:
  within 1e-6 of the reference's ``psum`` arithmetic, bitwise the same on
  every rank, the gathers moving int8 codes and fp32 scales; without a
  mesh the error feedback's accumulation tracks the true gradient;
- ``device_batch``: bitwise ``local_rows`` of the whole batch on each
  rank, tokens and a frontend's embeddings.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_expert_parallel_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as M
from repro_torch.models import model, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import compress
from repro_torch.sharding import rules

TOL = dict(atol=2e-5, rtol=2e-5)
B, PROMPT, STEPS = 4, 24, 4
SPAWN_S = 120
MOE_E, MOE_G, MOE_S, MOE_B = 16, 4, 16, 16    # the capacity-bound case

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import functools, json
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    import repro.sharding.rules as rules
    from repro.configs import get_config, reduced
    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models import model
    from repro.optim import compress

    work = sys.argv[1]
    meshes = json.loads(open(work + "/meshes.json").read())
    arrays = dict(np.load(work + "/arrays.npz"))
    out = {}
    cfg = reduced(get_config("deepseek_r1_671b"))
    params = jax.jit(functools.partial(model.init, cfg=cfg))(
        jax.random.PRNGKey(0))
    out["wsum"] = np.array(sum(float(np.abs(np.asarray(x, np.float64)).sum())
                               for x in jax.tree.leaves(params)))
    toks = jnp.asarray(arrays["toks"][:, :%(prompt)d])
    for shape in meshes:
        mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        with jax.set_mesh(mesh):
            placed = jax.device_put(params, rules.param_shardings(
                params, mesh, profile="serve"))
            tag = "%%dx%%d" %% tuple(shape)
            logits, cache, pos = jax.jit(make_prefill_step(cfg, %(max_len)d))(
                placed, {"tokens": toks})
            out[tag + "/prefill"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            step = jax.jit(make_serve_step(cfg))
            for i in range(%(steps)d):
                logits, cache = step(placed, cache, tok, int(pos) + i)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                out[tag + "/logits/%%d" %% i] = np.asarray(logits)
                out[tag + "/tokens/%%d" %% i] = np.asarray(tok)

    mesh = jax.make_mesh((4,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,),
                         devices=jax.devices()[:4])
    spec = P("data")
    with jax.set_mesh(mesh):
        psum = jax.jit(jax.shard_map(
            lambda x: compress.compressed_psum(x[0], "data")[None],
            mesh=mesh, in_specs=spec, out_specs=spec))
        out["psum"] = np.asarray(psum(jnp.asarray(arrays["x"])))

        def feedback(w, b, rw, rb):
            g, r = compress.pod_reduce_with_feedback(
                {"w": w[0], "b": b[0]}, {"w": rw[0], "b": rb[0]},
                axis="data")
            return g["w"][None], g["b"][None], r["w"][None], r["b"][None]
        got = jax.jit(jax.shard_map(feedback, mesh=mesh, in_specs=(spec,) * 4,
                                    out_specs=(spec,) * 4))(
            *(jnp.asarray(arrays[k]) for k in ("w", "b", "rw", "rb")))
        for k, v in zip(("g/w", "g/b", "r/w", "r/b"), got):
            out[k] = np.asarray(v)
    np.savez(work + "/jax_out.npz", **out)
    print("done")
""") % dict(prompt=PROMPT, steps=STEPS, max_len=worker.MAX_LEN)


def _capacity_case():
    """Reduced DeepSeek-R1's MoE layer at 16 experts, top-2, capacity
    factor 1, its router biased towards expert 3 (the tokens share a
    direction u, and expert 3's router column leans on u), so that more
    than C of every group's pairs choose it on both paths.  The weights
    are the port's seeded draw; x is seeded numpy."""
    cfg = reduced(get_config("deepseek_r1_671b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=MOE_E, capacity_factor=1.0))
    ffn = moe.init_moe(torch.Generator().manual_seed(7), cfg, torch.float32,
                       "cpu")
    u = torch.full((cfg.d_model,), cfg.d_model ** -0.5)
    ffn["router"][:, 3] += 3 * u
    rng = np.random.default_rng(9)
    x_seq = torch.from_numpy(rng.standard_normal(
        (MOE_G, MOE_S, cfg.d_model), dtype=np.float32)) + 2 * u
    x_dec = torch.from_numpy(rng.standard_normal(
        (1, MOE_B, cfg.d_model), dtype=np.float32)) + 2 * u
    for x, dropless in ((x_seq, False), (x_dec, True)):
        C = moe.capacity(cfg, x.shape[1], dropless)
        _, _, _, idx = moe.route(ffn, cfg, x)
        assert C < x.shape[1] and bool(((idx == 3).sum((1, 2)) > C).all())
    return dict(cfg=cfg, ffn=ffn, x_seq=x_seq, x_dec=x_dec)


def _compress_arrays(rng):
    return {"x": rng.normal(size=(4, 333)).astype(np.float32) * 10,
            "w": rng.normal(size=(4, 64, 7)).astype(np.float32),
            "b": rng.normal(size=(4, 300)).astype(np.float32) * 3,
            "rw": rng.normal(size=(4, 64, 7)).astype(np.float32) * 1e-2,
            "rb": rng.normal(size=(4, 300)).astype(np.float32) * 1e-2}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the 4 port ranks, run side by side.  Returns
    (the ranks' outputs, the reference's arrays, the weights' sum, the
    inputs)."""
    work = tmp_path_factory.mktemp("expert_parallel")
    rng = np.random.default_rng(3)
    arrays = {"toks": rng.integers(0, 256, size=(B, PROMPT)).astype(
        np.int32), **_compress_arrays(rng)}
    np.savez(work / "arrays.npz", **arrays)
    (work / "meshes.json").write_text(json.dumps(worker.MESHES))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        jcfg = jreduced(jget_config("deepseek_r1_671b"))
        cfg = reduced(get_config("deepseek_r1_671b"))
        tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
            jmodel.init, cfg=jcfg))(jax.random.PRNGKey(0)))
        wsum = sum(float(np.abs(x.astype(np.float64)).sum())
                   for x in jax.tree.leaves(tree))
        t = {k: torch.from_numpy(v) for k, v in arrays.items()}
        inputs = {
            "deepseek": dict(params=params_from_jax(tree, device="cpu"),
                             cfg=cfg, toks=t["toks"], prompt=PROMPT,
                             steps=STEPS),
            "moe": _capacity_case(),
            "batch_cfgs": {"deepseek": cfg,
                           "musicgen": reduced(get_config("musicgen_large"))},
            "compress": {"x": t["x"], "grads": {"w": t["w"], "b": t["b"]},
                         "residual": {"w": t["rw"], "b": t["rb"]}}}
        torch.save(inputs, work / "inputs.pt")
        M.spawn(worker.main, 4, (str(work),), timeout_s=SPAWN_S)
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return ranks, dict(np.load(work / "jax_out.npz")), wsum, inputs


SHAPES = worker.MESHES
IDS = ["%dx%d" % s for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_serve_matches_reference(runs, shape):
    """make_prefill_step and make_serve_step under the mesh on the placed
    weights (E/n_data experts a rank): every rank's gathered prefill and
    step logits within 2e-5 of the reference's serve steps over
    param_shardings(profile="serve"), the greedy tokens equal; the prefill
    exchanged the experts' slots by all-to-all and the steps gathered and
    reduce-scattered their rows over `data`."""
    ranks, ref, wsum, _ = runs
    assert float(ref["wsum"]) == wsum                    # the same weights
    tag = "%dx%d" % shape
    for out in ranks:
        got = out[shape]
        assert got["experts"] == 4 // shape[0]
        np.testing.assert_allclose(got["serve"]["prefill"],
                                   ref[tag + "/prefill"], **TOL)
        for i in range(STEPS):
            np.testing.assert_allclose(got["serve"]["logits"][i],
                                       ref[f"{tag}/logits/{i}"], **TOL)
            np.testing.assert_array_equal(got["serve"]["tokens"][i],
                                          ref[f"{tag}/tokens/{i}"])
        assert {"all_to_all", "reduce_scatter"} <= set(got["moved"])


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_placement(runs, shape):
    """Every rank's leaf shapes are rules.local_shape of their serve spec
    (the expert stacks cut over `data`, and over `model` on F), the placed
    init is bitwise place_params of the whole init, and the vocab-parallel
    lookup is bitwise the whole table's."""
    ranks, *_ = runs
    for out in ranks:
        c = out[shape]["checks"]
        assert c["shapes_ok"] and c["init_same"] and c["embed_same"], c
        assert c["n_cut"] >= 3


@pytest.mark.parametrize("leg", ["seq", "decode", "decode-whole"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_capacity_bound_moe(runs, shape, leg):
    """moe_ffn with E/n_data experts a rank on a case whose expert 3 takes
    more pairs than its capacity: the full sequence's groups cut over
    `data` (the all-to-all path), the decode group's tokens cut over
    `data` (gather, reduce-scatter) and held whole (all-reduce), each
    within 2e-5 of the unsharded moe_ffn, the earlier pairs winning."""
    ranks, *_ = runs
    for out in ranks:
        got = out[shape]["moe"]
        assert got["experts"] == MOE_E // shape[0]
        assert got[leg] <= 2e-5, (leg, got)


def test_compressed_psum(runs):
    """compressed_psum over `data` = 4: within 1e-6 of the reference's
    shard_map psum of the dequantized codes, bitwise the same on every
    rank, and the gathers' bytes those of int8 codes and fp32 scales."""
    ranks, ref, _, inputs = runs
    got = [out["compress"]["psum"] for out in ranks]
    for g in got:
        assert g.dtype == torch.float32 and torch.equal(g, got[0])
    np.testing.assert_allclose(got[0], ref["psum"][0], atol=1e-6, rtol=1e-6)
    n = inputs["compress"]["x"].shape[1]
    chunks = -(-n // compress.CHUNK)
    for out in ranks:
        assert out["compress"]["moved"] == {
            "all_gather": 4 * chunks * compress.CHUNK + 4 * chunks * 4}


def test_pod_reduce_with_feedback(runs):
    """pod_reduce_with_feedback over `data` = 4: the reduced grads (the
    codes' mean) and each rank's new residual within 1e-6 of the
    reference's under shard_map, the reduced grads bitwise the same on
    every rank."""
    ranks, ref, *_ = runs
    for r, out in enumerate(ranks):
        c = out["compress"]
        for k in ("w", "b"):
            assert torch.equal(c["reduced"][k], ranks[0]["compress"][
                "reduced"][k])
            np.testing.assert_allclose(c["reduced"][k], ref[f"g/{k}"][r],
                                       atol=1e-6, rtol=1e-6)
            np.testing.assert_allclose(c["residual"][k], ref[f"r/{k}"][r],
                                       atol=1e-6, rtol=1e-6)


def test_error_feedback_without_mesh():
    """Without a mesh pod_reduce_with_feedback is the local round trip
    with its residual carried: over 50 steps the transmitted mean tracks
    the true gradient (tests/test_runtime.py's accumulation), and a mesh
    without the axis leaves it local."""
    rng = np.random.default_rng(1)
    g_true = torch.from_numpy(rng.normal(size=(64, 7)).astype(np.float32))
    residual = compress.init_residual({"w": g_true})["w"]
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        out, residual = compress.pod_reduce_with_feedback(
            {"w": g_true}, {"w": residual})
        out, residual = out["w"], residual["w"]
        acc = acc + out
    np.testing.assert_allclose(acc / 50, g_true, atol=2e-3)
    with M.use_mesh(M.Mesh(("data", "model"), (1, 1))):
        local, _ = compress.pod_reduce_with_feedback(
            {"w": g_true}, {"w": torch.zeros_like(g_true)})
    assert torch.equal(local["w"], compress.compress_decompress(g_true))
    assert torch.equal(compress.compressed_psum(g_true, None, "pod"),
                       compress.compress_decompress(g_true))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_device_batch(runs, shape):
    """device_batch under the mesh is bitwise local_rows of the whole
    batch (rules.data_spec) on every rank, for tokens and for a
    frontend's embeddings in the model's dtype."""
    ranks, *_ = runs
    for out in ranks:
        assert out[shape]["batches"] == {"deepseek": True, "musicgen": True}


def test_placed_init_draws_only_the_rank_experts(monkeypatch):
    """Under a mesh the expert stacks are drawn in blocks of
    moe._INIT_BLOCK experts and only the rank's part is kept: no tensor
    of a whole stack's size is made, and the result is bitwise
    place_params of the whole init, at 2 experts a block (several blocks
    a rank)."""
    monkeypatch.setattr(moe, "_INIT_BLOCK", 2)
    cfg = reduced(get_config("deepseek_r1_671b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8))
    whole = model.init(cfg, seed=0, device="cpu")
    stack = whole["layers"][1]["ffn"]["w_gate"]
    mesh = M.Mesh(("data", "model"), (2, 2))
    mesh.coord = lambda axis: 1
    made = []
    empty = torch.empty

    def spy(*shape, **kw):
        if kw.get("device") != "meta":      # a spec's shape, not a tensor
            made.append(tuple(shape[0]) if len(shape) == 1 and isinstance(
                shape[0], (tuple, list, torch.Size)) else shape)
        return empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", spy)
    with M.use_mesh(mesh):
        got = model.init(cfg, seed=0, device="cpu")
    monkeypatch.undo()
    assert tuple(stack.shape) not in made
    assert (4, cfg.d_model, 64) in made
    want = rules.place_params(whole, mesh)
    for (p, a), (q, b) in zip(rules._leaves_with_path(want),
                              rules._leaves_with_path(got), strict=True):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b), p
    assert got.specs == want.specs
