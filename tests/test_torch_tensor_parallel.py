"""Tensor-parallel serving (ROADMAP A10b.1) against the JAX package.

One spawn of 4 gloo ranks on the CPU for the module
(``_torch_tensor_parallel_worker.py``; the group meets through a FileStore
in the test's directory), and one JAX subprocess with 8 fake host devices
(``--xla_force_host_platform_device_count=8``) that places the reference's
weights by ``rules.param_shardings(..., profile="serve")`` with
``jax.device_put`` and jits ``make_prefill_step`` and ``make_serve_step``
over them on 4 of its devices.  Both set ``SEQ_SHARD_MIN_S = 64``.  The
port's ranks take the same weights through ``params_from_jax`` and
``rules.place_params``.  Checked, for reduced DeepSeek-R1 (an MLA dense
layer and a MoE layer) on (1, 4), its all-dense variant on (2, 2) and
reduced Qwen3-8B (8 heads, 4 kv heads) on (1, 4) and (2, 2):

- a 24-token prompt prefilled under the mesh, then 4 greedy steps, into a
  48-row cache (unsharded) and a 64-row one (sequence-sharded): the
  prefill's and every step's gathered logits within 2e-5 of the
  reference's, the tokens equal;
- every placed leaf's shape is ``rules.local_shape`` of its spec, the
  placed ``init`` is bitwise ``place_params`` of the whole one, and the
  vocab-parallel lookup is bitwise the whole table's;
- in this process: the CUDA branch (``device_of`` / ``build.library``
  faked) reaches K5 and K9 once a call with the rank's H/n heads on a
  one-rank stand-in for a rank of (1, 4); and the refusals (a tree placed
  for another mesh or a whole tree where the mesh cuts, a rule that cuts
  a head, a Mamba / RG-LRU cache under `model`), beside what the sharded
  train step lifted (the train profile, loss_fn under a mesh, Mamba /
  RG-LRU weights under `model`) and expert parallelism lifted (experts
  over `data` placed, drawn and run).
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

import _torch_tensor_parallel_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.core import mla
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import build, launch
from repro_torch.kernels.etap import etap as K
from repro_torch.kernels.flash_prefill import flash_prefill as FP
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.launch import mesh as M
from repro_torch.models import attention, model
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding import rules

TOL = dict(atol=2e-5, rtol=2e-5)
B, PROMPT, STEPS = 4, 24, 4
# name -> (arch, reduced() keywords, all-dense variant, meshes (data, model))
CASES = {"deepseek": ("deepseek_r1_671b", {}, False, ((1, 4),)),
         "deepseek-dense": ("deepseek_r1_671b", {}, True, ((2, 2),)),
         "qwen": ("qwen3_8b", {"heads": 8, "kv_heads": 4}, False,
                  ((1, 4), (2, 2)))}
RUNS = [(name, shape) for name, c in CASES.items() for shape in c[3]]
SPAWN_S = 120

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, functools, json
    import numpy as np
    import jax, jax.numpy as jnp
    import repro.sharding.rules as rules
    rules.SEQ_SHARD_MIN_S = %(min_s)d
    from repro.configs import get_config, reduced
    from repro.launch.steps import make_prefill_step, make_serve_step
    from repro.models import model

    work = sys.argv[1]
    cases = json.loads(open(work + "/cases.json").read())
    max_lens = json.loads(open(work + "/max_lens.json").read())
    toks_all = dict(np.load(work + "/toks.npz"))
    out = {}
    for name, (arch, kw, dense, meshes) in cases.items():
        cfg = reduced(get_config(arch), **kw)
        if dense:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, first_dense_layers=cfg.num_layers))
        params = jax.jit(functools.partial(model.init, cfg=cfg))(
            jax.random.PRNGKey(0))
        out["wsum/" + name] = np.array(sum(
            float(np.abs(np.asarray(x, np.float64)).sum())
            for x in jax.tree.leaves(params)))
        toks = jnp.asarray(toks_all[name][:, :%(prompt)d])
        for shape in meshes:
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2,
                                 devices=jax.devices()[:4])
            with jax.set_mesh(mesh):
                placed = jax.device_put(params, rules.param_shardings(
                    params, mesh, profile="serve"))
                step = jax.jit(make_serve_step(cfg))
                for kind, max_len in max_lens.items():
                    tag = "%%s/%%dx%%d/%%s" %% (name, *shape, kind)
                    logits, cache, pos = jax.jit(make_prefill_step(
                        cfg, max_len))(placed, {"tokens": toks})
                    out[tag + "/prefill"] = np.asarray(logits)
                    tok = jnp.argmax(logits, -1).astype(jnp.int32)
                    for i in range(%(steps)d):
                        logits, cache = step(placed, cache, tok,
                                             int(pos) + i)
                        tok = jnp.argmax(logits, -1).astype(jnp.int32)
                        out[tag + "/logits/%%d" %% i] = np.asarray(logits)
                        out[tag + "/tokens/%%d" %% i] = np.asarray(tok)
    np.savez(work + "/jax_out.npz", **out)
    print("done")
""") % dict(min_s=worker.MIN_S, prompt=PROMPT, steps=STEPS)


def _dense(cfg):
    """``cfg`` with every MoE layer a dense MLP (either package's)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=cfg.num_layers))


def _configs(name):
    arch, kw, dense, _ = CASES[name]
    jcfg, cfg = jreduced(jget_config(arch), **kw), reduced(get_config(arch),
                                                           **kw)
    return (_dense(jcfg), _dense(cfg)) if dense else (jcfg, cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the 4 port ranks, run side by side.  Returns
    (the ranks' outputs, the reference's arrays, the weights' sums)."""
    work = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(3)
    toks = {name: rng.integers(0, 256, size=(B, PROMPT)).astype(np.int32)
            for name in CASES}
    np.savez(work / "toks.npz", **toks)
    (work / "cases.json").write_text(json.dumps(CASES))
    (work / "max_lens.json").write_text(json.dumps(worker.MAX_LENS))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        inputs, wsum = {}, {}
        for name, (_, _, _, meshes) in CASES.items():
            jcfg, cfg = _configs(name)
            tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
                jmodel.init, cfg=jcfg))(jax.random.PRNGKey(0)))
            wsum[name] = sum(float(np.abs(x.astype(np.float64)).sum())
                             for x in jax.tree.leaves(tree))
            inputs[name] = dict(params=params_from_jax(tree, device="cpu"),
                                cfg=cfg, toks=torch.from_numpy(toks[name]),
                                prompt=PROMPT, steps=STEPS, meshes=meshes)
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
    return ranks, dict(np.load(work / "jax_out.npz")), wsum


def _ids(runs_):
    return ["%s-%dx%d" % (n, *s) for n, s in runs_]


@pytest.mark.parametrize("kind", list(worker.MAX_LENS))
@pytest.mark.parametrize("name,shape", RUNS, ids=_ids(RUNS))
def test_serve_matches_reference(runs, name, shape, kind):
    """make_prefill_step and make_serve_step under the mesh on the placed
    weights: every rank's gathered prefill and step logits within 2e-5 of
    the reference's serve steps over param_shardings(profile="serve"), the
    greedy tokens equal; the cache sequence-sharded iff it has
    SEQ_SHARD_MIN_S rows."""
    ranks, ref, wsum = runs
    assert float(ref[f"wsum/{name}"]) == wsum[name]      # the same weights
    tag = "%s/%dx%d/%s" % (name, *shape, kind)
    for out in ranks:
        got = out[(name, shape)][kind]
        assert got["sharded"] == (worker.MAX_LENS[kind] >= worker.MIN_S)
        np.testing.assert_allclose(got["prefill"], ref[tag + "/prefill"],
                                   **TOL)
        for i in range(STEPS):
            np.testing.assert_allclose(got["logits"][i],
                                       ref[f"{tag}/logits/{i}"], **TOL)
            np.testing.assert_array_equal(got["tokens"][i],
                                          ref[f"{tag}/tokens/{i}"])


@pytest.mark.parametrize("name,shape", RUNS, ids=_ids(RUNS))
def test_placement(runs, name, shape):
    """On every rank: each placed leaf has ``rules.local_shape`` of its
    whole shape under its serve spec (so no rank holds a whole weight its
    spec cuts, and the mesh cuts some), the placed ``init`` is bitwise
    ``place_params`` of the whole ``init``, and the vocab-parallel
    embedding is bitwise the whole table's lookup."""
    ranks, _, _ = runs
    for out in ranks:
        checks = out[(name, shape)]["checks"]
        assert checks["shapes_ok"] and checks["n_cut"] > 0
        assert checks["init_same"]
        assert checks["embed_same"]


# ------------------------------------------------- in this process: fakes
class _Rank(M.Mesh):
    """Rank 1 of a (1, 4) mesh on its own: its coordinates, and
    collectives that keep the shapes (a gather repeats this rank's piece,
    a sum returns it)."""

    def __init__(self):
        super().__init__(("data", "model"), (1, 4))

    def coord(self, axis):
        return 1 if axis == "model" else 0


@pytest.fixture
def one_rank(monkeypatch):
    monkeypatch.setattr(M, "all_gather", lambda t, mesh, axis, dim=0:
                        torch.cat([t] * mesh.shape[axis], dim=dim))
    monkeypatch.setattr(M, "all_reduce_sum", lambda t, mesh, axis: t.clone())
    return _Rank()


class _Cuda(str):
    type = "cuda"


class _FakeLib:
    """The kernel library as K5's and K9's wrappers see it: the width
    queries, and the entries recording their calls."""

    def __init__(self, dense, prefill):
        self.dense, self.prefill, self.calls = dense, prefill, []

    @staticmethod
    def _widths(widths, buf):
        for i, (a, b) in enumerate(widths):
            buf[2 * i], buf[2 * i + 1] = a, b
        return len(widths)

    def etap_dense_widths(self, buf, cap):
        return self._widths(self.dense, buf)

    def flash_prefill_widths(self, buf, cap):
        return self._widths(self.prefill, buf)

    def etap_decode_dense(self, *args):
        self.calls.append(("K5", args))
        return 0

    def flash_prefill(self, *args):
        self.calls.append(("K9", args))
        return 0


@pytest.fixture
def fake_card(monkeypatch, one_rank):
    """K5's and K9's CUDA branches on CPU tensors (their plain versions
    raise), with the one-rank mesh's collectives; attention's prefill
    routed to K9's wrapper, as CUDA operands route it."""
    monkeypatch.setattr(K, "device_of", lambda *t: _Cuda("cpu"))
    monkeypatch.setattr(FP, "device_of", lambda *t: torch.device("cuda"))
    for mod in (K, FP, launch):
        monkeypatch.setattr(mod, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")
    monkeypatch.setattr(K, "etap_decode_dense_plain", no_fallback)
    monkeypatch.setattr(FP, "flash_prefill_plain", no_fallback)

    def through_k9(q, k, v, *, scale, q_block=512):
        return prefill_ops.flash_prefill(q, k, v, spec=AttnSpec(scale=scale))
    for mod in (attention, mla):
        monkeypatch.setattr(mod, "causal_attention", through_k9)

    def use(dense, prefill):
        lib = _FakeLib(dense, prefill)
        launch.dense_widths.cache_clear()
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    yield use
    launch.dense_widths.cache_clear()


@pytest.mark.parametrize("arch", ["deepseek_r1_671b", "qwen3_8b"],
                         ids=["mla", "gqa"])
def test_cuda_branch_at_local_heads(fake_card, one_rank, arch):
    """A rank's layer under tensor parallelism launches K9 (prefill) and
    K5 (one decode step, one split) once each, with its H/n heads: K9's q
    holds H/4 heads (G kept for GQA), K5's grouped rows hold the rank's
    heads (MLA: B rows of H/4 latent columns; GQA: B·K/4 rows of G
    columns, the cache read in place at the rank's kv-head offset)."""
    kw = {"heads": 8, "kv_heads": 4} if arch == "qwen3_8b" else {"heads": 8}
    cfg = dataclasses.replace(reduced(get_config(arch), **kw),
                              dtype="bfloat16")
    whole = model.init(cfg, seed=0, device="cpu")
    params = rules.place_params(whole, one_rank)
    lp = params["layers"][0]["mix"]
    if cfg.mla is not None:
        m = cfg.mla
        lib = fake_card([(m.latent_dim, m.kv_lora_rank)],
                        [(m.qk_head_dim, m.v_head_dim)])
        train, decode = mla.mla_train, mla.mla_decode
    else:
        hd = cfg.resolved_head_dim
        lib = fake_card([(hd, hd)], [(hd, hd)])
        train, decode = attention.attention_train, attention.attention_decode
    Bq, S = 2, 16
    x = torch.randn(Bq, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).bfloat16()
    pos = torch.arange(S, dtype=torch.int32)[None].expand(Bq, S)
    with M.use_mesh(one_rank):
        _, rows = train(lp, cfg, x, pos, return_cache=True)
    ((what, args),) = lib.calls
    assert what == "K9"
    H = cfg.num_heads // 4
    if cfg.mla is not None:
        assert args[-9:-6] == (Bq, S, H)            # q [B, S, H/n, D]
        cache = {"c": torch.nn.functional.pad(rows["c"], (0, 0, 0, 8))}
    else:
        assert args[-9:-5] == (Bq, S, H, cfg.num_kv_heads // 4)  # G kept
        assert rows["k"].shape[2] == cfg.num_kv_heads   # every kv head
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
                 for k, v in rows.items()}
    lib.calls.clear()
    before = K.etap_decode_dense.launches
    with M.use_mesh(one_rank):
        decode(lp, cfg, x[:, 0], cache, S, spec=AttnSpec(kv_splits=1))
    assert K.etap_decode_dense.launches == before + 1
    ((what, args),) = lib.calls
    assert what == "K5"
    if cfg.mla is not None:
        assert args[9] == 1                               # kvh: the latent
        assert args[1] == cache["c"].data_ptr()           # in place
    else:
        Kl = cfg.num_kv_heads // 4
        assert args[9] == Kl                              # the rank's kv
        kc = cache["k"]                                   # heads, in place
        assert args[1] == kc.data_ptr() + Kl * kc.stride(2) * \
            kc.element_size()


def test_refusals(monkeypatch, one_rank):
    """Not yet ported, each raising NotImplementedError naming its ROADMAP
    item, with no fallback to whole weights: a rule that cuts a head
    (A10b.1); a Mamba / RG-LRU serving cache under `model` (A10b.5).  A
    tree placed for another mesh, and a whole tree where the mesh cuts a
    leaf, raise ValueError.  What the sharded train step (A10b.2) lifted
    runs: place_params by the train profile, loss_fn under a mesh (the
    one-rank stand-in's collectives), and Mamba / RG-LRU weights placed
    under `model` (the placed init).  What expert parallelism (A10b.3)
    lifted runs: experts over `data` in place_params on (2, 2), in the
    placed init, and in moe_ffn on two of four experts under a (2, 1)
    stand-in (its `data` all-reduce the identity), equal to the whole
    moe_ffn's where the rank's experts take every route."""
    mesh14 = M.Mesh(("data", "model"), (1, 4))
    mesh22 = M.Mesh(("data", "model"), (2, 2))
    for m in (mesh14, mesh22):
        m.coord = lambda axis: 0
    ds = reduced(get_config("deepseek_r1_671b"))
    whole = model.init(ds, seed=0, device="cpu")
    train = rules.place_params(whole, mesh22, profile="train")
    assert train.profile == "train" and \
        train["layers"][0]["mix"]["w_uq"].shape == (16, 48)
    serve = rules.place_params(whole, mesh22)
    assert serve["layers"][1]["ffn"]["w_gate"].shape == (2, 64, 64)
    with M.use_mesh(mesh22):
        placed = model.init(ds, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        rules._leaves_with_path(placed), rules._leaves_with_path(serve),
        strict=True))
    from repro_torch.models import moe
    ffn = dict(whole["layers"][1]["ffn"])
    mesh21 = M.Mesh(("data", "model"), (2, 1))
    mesh21.coord = lambda axis: 0
    piece = rules.place_params({"ffn": ffn}, mesh21)["ffn"]
    assert piece["w_gate"].shape[0] == 2
    ffn["router"] = ffn["router"].clone()
    ffn["router"][:, 2:] = -1e4          # every route to experts 0 and 1
    piece["router"] = ffn["router"]
    x = torch.randn(1, 2, ds.d_model, generator=torch.Generator(
        ).manual_seed(0))
    monkeypatch.setattr(M, "all_reduce", lambda t, op, mesh, axis: t)
    with M.use_mesh(mesh21):
        got, _ = moe.moe_ffn(piece, ds, x, dropless=True,
                             expert_axis="data")
    assert torch.allclose(got, moe.moe_ffn(ffn, ds, x, dropless=True)[0],
                          atol=1e-6)
    # a head cut: 2 kv heads of width 16 in 8-column pieces
    qwen = reduced(get_config("qwen3_8b"), kv_heads=2)
    placed = rules.place_params(model.init(qwen, seed=0, device="cpu"),
                                mesh14)
    with M.use_mesh(mesh14):
        for fn in (lambda: model.init(qwen, seed=0, device="cpu"),
                   lambda: model.decode_step(
                       placed, qwen, [], torch.zeros(2, dtype=torch.int32),
                       0)):
            with pytest.raises(NotImplementedError, match="cuts a head.*"
                               "A10b"):
                fn()
    for arch in ("falcon_mamba_7b", "recurrentgemma_9b"):
        cfg = reduced(get_config(arch))
        with M.use_mesh(mesh14):
            pieces = model.init(cfg, seed=0, device="cpu")
            with pytest.raises(NotImplementedError, match="A10b.5"):
                model.prefill(pieces, cfg, torch.zeros(
                    2, 8, dtype=torch.int32), 16)
    # a tree for another mesh; a whole tree where the mesh cuts
    placed = rules.place_params(whole, mesh14)
    other = M.Mesh(("data", "model"), (1, 2))
    toks = torch.zeros(2, 8, dtype=torch.int32)
    with M.use_mesh(other), pytest.raises(ValueError, match="placed for"):
        model.prefill(placed, ds, toks, 16)
    with M.use_mesh(mesh14), pytest.raises(ValueError, match="whole"):
        model.prefill(whole, ds, toks, 16)
    with M.use_mesh(one_rank):
        loss, metrics = model.loss_fn(rules.place_params(
            whole, one_rank, profile="train"), ds, {"tokens": toks})
    assert loss.shape == () and bool(torch.isfinite(loss))
    assert set(metrics) == {"nll", "load_balance", "router_z"}


def test_whole_weights_where_nothing_is_cut():
    """A mesh whose serve specs cut no leaf (model 1, no MoE) takes the
    whole tree: the check passes, and place_params records the mesh with
    every leaf kept as it is."""
    cfg = reduced(get_config("qwen3_8b"))
    whole = model.init(cfg, seed=0, device="cpu")
    mesh = M.Mesh(("data", "model"), (2, 1))
    rules.check_placed(whole, mesh)
    placed = rules.place_params(whole, mesh)
    assert placed.mesh_shape == {"data": 2, "model": 1}
    assert placed["layers"][0]["mix"]["w_q"] is whole["layers"][0]["mix"][
        "w_q"]
    rules.check_placed(placed, mesh)
