"""Sequence-sharded decode (ROADMAP A10a) against the JAX package.

One spawn of 4 gloo ranks on the CPU for the module
(``_torch_seq_sharded_worker.py``; the group meets through a FileStore in
the test's directory, not a TCP port), and one JAX subprocess with 8 fake
host devices (``--xla_force_host_platform_device_count=8``, as
``tests/test_sharding.py`` runs its meshes); both set ``SEQ_SHARD_MIN_S =
64`` in their own processes and run the meshes (1, 4) and (2, 2) (data,
model), the JAX side on 4 of its 8 devices.  Checked:

- the two primitives at the reference test's shapes (B 2, H 8, L 48, S
  128, dv 32, pos 77; GQA K 4, G 2, hd 16), each rank on its batch rows
  and its S slice: outputs within 1e-5 fp32 of the reference's
  ``seq_sharded_decode`` / ``seq_sharded_gqa_decode``, caches bitwise (at
  pos 77 on (1, 4) the last slice holds no position);
- ``make_serve_step`` under the mesh for reduced DeepSeek-R1 (an MLA dense
  layer and a MoE layer; on (2, 2), where the serve placement would put
  the experts over `data`, its all-dense variant) and reduced Qwen3-8B (8
  heads, 4 kv heads: G 2, each kv head whole on a `model` rank of 4) on
  the reference's weights (``params_from_jax``), placed for the
  mesh (``rules.place_params``): 4 greedy steps after a 40-token prompt
  into a 128-row cache, logits within 2e-5 of the reference's
  ``decode_step`` under its mesh, tokens equal, each rank's cache rows
  within 2e-5 of the reference's rows;
- the unsharded branch under a mesh (a 48-row cache, below the minimum);
- in this process: the CUDA branch (``device_of`` / ``build.library``
  patched, as ``tests/test_torch_decode_launch.py`` fakes them) reaches
  the K6 wrapper once a rank and call, an unbuilt width raises with no
  fallback; the A10b refusals (a Mamba state over ``model``, a paged
  pool).
"""
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

import _torch_seq_sharded_worker as worker
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced
from repro_torch.core import etap
from repro_torch.kernels import build, launch
from repro_torch.kernels.etap import etap as K
from repro_torch.launch import mesh as M
from repro_torch.models import model
from repro_torch.models.convert import params_from_jax
from repro_torch.sharding import rules

TOL = dict(atol=2e-5, rtol=2e-5)
PRIM_TOL = dict(atol=1e-5, rtol=0)
PROMPT, MAX_LEN, STEPS = 40, 128, 4
# name -> (arch, reduced() keywords, cache rows)
SERVE = {"deepseek": ("deepseek_r1_671b", {}, MAX_LEN),
         "qwen": ("qwen3_8b", {"heads": 8, "kv_heads": 4}, MAX_LEN),
         "deepseek-short": ("deepseek_r1_671b", {}, 48)}
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
    from repro.core import etap
    from repro.launch.steps import make_serve_step
    from repro.models import model

    work = sys.argv[1]
    inp = dict(np.load(work + "/jax_inputs.npz"))
    serve = json.loads(open(work + "/serve.json").read())
    out = {}

    def unstack(cache):
        layers = []
        for g in cache:
            n = jax.tree.leaves(g)[0].shape[0]
            for i in range(n):
                for j in range(len(g)):
                    layers.append({k: np.asarray(v[i])
                                   for k, v in g[f"b{j}"].items()})
        return layers

    weights, inits = {}, {}
    for name, (arch, kw, max_len) in serve.items():
        base = reduced(get_config(arch), **kw)
        variants = {"": base}
        if base.moe is not None:          # its all-dense variant
            variants["dense"] = dataclasses.replace(base, moe=dataclasses
                .replace(base.moe, first_dense_layers=base.num_layers))
        for var, cfg in variants.items():
            key = json.dumps([arch, kw, var])
            if key not in inits:
                inits[key] = jax.jit(functools.partial(model.init, cfg=cfg))(
                    jax.random.PRNGKey(0))
            params = inits[key]
            toks = inp["toks/" + name]
            _, cache, pos = jax.jit(
                lambda p, t: model.prefill(p, cfg, {"tokens": t}, max_len))(
                params, jnp.asarray(toks[:, :%(prompt)d]))
            pos = int(pos)
            weights[(name, var)] = (cfg, jax.tree.map(np.asarray, params),
                                    jax.tree.map(np.asarray, cache), pos,
                                    toks)
            out["wsum/" + name + var] = np.array(sum(
                float(np.abs(np.asarray(x, np.float64)).sum())
                for x in jax.tree.leaves(params)))

    for shape in ((1, 4), (2, 2)):
        tag = "%%dx%%d" %% shape
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        with jax.set_mesh(mesh):
            pos = jnp.asarray(int(inp["pos"]), jnp.int32)
            o, c = jax.jit(functools.partial(
                etap.seq_sharded_decode, dv=int(inp["dv"]), scale=0.1,
                block=16))(inp["q"], inp["cache"], inp["new_row"], pos)
            og, kc, vc = jax.jit(functools.partial(
                etap.seq_sharded_gqa_decode, scale=0.1, block=16))(
                inp["q4"], inp["kc"], inp["vc"], inp["nk"], inp["nv"], pos)
            for k, v in dict(mla_o=o, mla_cache=c, gqa_o=og, gqa_k=kc,
                             gqa_v=vc).items():
                out[f"{tag}/prim/{k}"] = np.asarray(v)
            for name in serve:
                # a MoE model runs all-dense where data > 1
                var = "dense" if shape[0] > 1 and \
                    (name, "dense") in weights else ""
                cfg, params, cache, pos, toks = weights[(name, var)]
                step = jax.jit(make_serve_step(cfg))
                tok = toks[:, %(prompt)d]
                for i in range(%(steps)d):
                    logits, cache = step(params, cache, tok, pos + i)
                    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
                    out[f"{tag}/{name}/logits/{i}"] = np.asarray(logits)
                    out[f"{tag}/{name}/tokens/{i}"] = tok
                for li, layer in enumerate(unstack(cache)):
                    for k, v in layer.items():
                        out[f"{tag}/{name}/cache/{li}/{k}"] = v
    np.savez(work + "/jax_out.npz", **out)
    print("done")
""") % dict(min_s=worker.MIN_S, prompt=PROMPT, steps=STEPS)


def _prim_inputs():
    """The reference test's operands (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    B, H, L, S, dv = 2, 8, 48, 128, 32
    K_, G, hd = 4, 2, 16

    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return dict(q=f(B, H, L), cache=f(B, S, L), new_row=f(B, L),
                q4=f(B, K_, G, hd), kc=f(B, S, K_, hd), vc=f(B, S, K_, hd),
                nk=f(B, K_, hd), nv=f(B, K_, hd), pos=77, dv=dv)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and the 4 port ranks, run side by side.  Returns
    (the ranks' outputs, the reference's arrays, the weights' sums)."""
    work = tmp_path_factory.mktemp("seq_sharded")
    prim = _prim_inputs()
    rng = np.random.default_rng(1)
    toks = {name: rng.integers(0, 256, size=(2, PROMPT + 1)).astype(np.int32)
            for name in SERVE}
    np.savez(work / "jax_inputs.npz", **prim,
             **{f"toks/{n}": t for n, t in toks.items()})
    (work / "serve.json").write_text(json.dumps(SERVE))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _JAX, str(work)],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    try:
        serve, wsum, trees = {}, {}, {}
        for name, (arch, kw, max_len) in SERVE.items():
            jcfg = jreduced(jget_config(arch), **kw)
            cfg = reduced(get_config(arch), **kw)
            variants = {"": (jcfg, cfg)}
            if cfg.moe is not None:
                variants["dense"] = (worker.dense_variant(jcfg),
                                     worker.dense_variant(cfg))
            for var, (jc, c) in variants.items():
                key = json.dumps([arch, kw, var])
                if key not in trees:
                    trees[key] = jax.tree.map(np.asarray, jax.jit(
                        functools.partial(jmodel.init, cfg=jc))(
                        jax.random.PRNGKey(0)))
                wsum[name + var] = sum(
                    float(np.abs(x.astype(np.float64)).sum())
                    for x in jax.tree.leaves(trees[key]))
                variants[var] = (params_from_jax(trees[key], device="cpu"),
                                 c)
            params, c = variants[""]
            serve[name] = dict(
                params=params, cfg=c, dense=variants.get("dense"),
                toks=torch.from_numpy(toks[name]), prompt=PROMPT,
                max_len=max_len, steps=STEPS)
        torch.save(dict(prim={k: torch.from_numpy(v) if isinstance(
            v, np.ndarray) else v for k, v in prim.items()}, serve=serve),
            work / "inputs.pt")
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


def _rows(a, coord, shape, *dims):
    """The piece of a whole array that rank ``coord`` (data, model) of a
    ``shape`` mesh holds: dims[0] split over data, dims[1] (if given) over
    model."""
    for dim, (c, n) in zip(dims, zip(coord, shape)):
        size = a.shape[dim] // n
        a = np.take(a, range(c * size, (c + 1) * size), axis=dim)
    return a


@pytest.mark.parametrize("shape", worker.MESHES, ids=["1x4", "2x2"])
def test_primitives_match_reference(runs, shape):
    """seq_sharded_decode and seq_sharded_gqa_decode on each rank's piece:
    its output rows within 1e-5 of the reference's, its cache slice
    bitwise; on (1, 4) the last slice holds no position yet."""
    ranks, ref, _ = runs
    tag = "%dx%d" % shape
    lengths = []
    for out in ranks:
        got, coord = out[shape]["prim"], out[shape]["coord"]
        B = ref[f"{tag}/prim/mla_o"].shape[0]
        H = got["gqa_o"].shape[1]
        np.testing.assert_allclose(
            got["mla_o"], _rows(ref[f"{tag}/prim/mla_o"], coord, shape, 0),
            **PRIM_TOL)
        np.testing.assert_array_equal(
            got["mla_cache"],
            _rows(ref[f"{tag}/prim/mla_cache"], coord, shape, 0, 1))
        gqa = ref[f"{tag}/prim/gqa_o"].reshape(B, H, -1)
        np.testing.assert_allclose(got["gqa_o"],
                                   _rows(gqa, coord, shape, 0), **PRIM_TOL)
        for k in ("gqa_k", "gqa_v"):
            np.testing.assert_array_equal(
                got[k], _rows(ref[f"{tag}/prim/{k}"], coord, shape, 0, 1))
        lengths.append(int(got["lengths"][0]))
    if shape == (1, 4):
        assert lengths == [32, 32, 14, 0]


@pytest.mark.parametrize("name", list(SERVE))
@pytest.mark.parametrize("shape", worker.MESHES, ids=["1x4", "2x2"])
def test_serve_step_matches_reference(runs, shape, name):
    """make_serve_step under the mesh: every rank's gathered logits within
    2e-5 of the reference's decode_step under its mesh at each of 4 greedy
    steps, the tokens equal, each rank's cache rows within 2e-5 of the
    reference's rows (its batch rows and, where sequence-sharded, its S
    slice, recorded beside the slice as "seq_rows")."""
    ranks, ref, wsum = runs
    for var in ("", "dense"):                             # the same weights
        if name + var in wsum:
            assert float(ref[f"wsum/{name}{var}"]) == wsum[name + var]
    tag = "%dx%d" % shape
    sharded = SERVE[name][2] >= worker.MIN_S
    for out in ranks:
        got, coord = out[shape][name], out[shape]["coord"]
        for i in range(STEPS):
            np.testing.assert_allclose(got["logits"][i],
                                       ref[f"{tag}/{name}/logits/{i}"],
                                       **TOL)
            np.testing.assert_array_equal(got["tokens"][i],
                                          ref[f"{tag}/{name}/tokens/{i}"])
        for li, layer in enumerate(got["cache"]):
            assert ("seq_rows" in layer) == sharded
            for key, t in layer.items():
                if key == "seq_rows":
                    assert t == SERVE[name][2]
                    continue
                dims = (0, 1) if sharded else (0,)
                np.testing.assert_allclose(
                    t, _rows(ref[f"{tag}/{name}/cache/{li}/{key}"], coord,
                             shape, *dims), **TOL)


# ------------------------------------------------- in this process: fakes
class _Placed(M.Mesh):
    """A one-rank mesh description whose collectives are the identity (the
    reduction over one rank)."""

    def __init__(self):
        super().__init__(("data", "model"), (1, 1))

    def coord(self, axis):
        return 0


class _FakeLib:
    """The kernel library as K6's wrapper sees it: the width query and the
    K6 entry, recording its calls."""

    def __init__(self, widths):
        self.widths, self.calls = widths, []

    def etap_dense_widths(self, buf, cap):
        for i, (dk, dv) in enumerate(self.widths):
            buf[2 * i], buf[2 * i + 1] = dk, dv
        return len(self.widths)

    def etap_partial_dense(self, *args):
        self.calls.append(args)
        return 0


class _Cuda(str):
    type = "cuda"


@pytest.fixture
def fake_card(monkeypatch):
    """K6's CUDA branch on CPU tensors, a one-rank mesh current, and every
    plain version of K5 / K6 raising."""
    monkeypatch.setattr(rules, "SEQ_SHARD_MIN_S", 64)
    monkeypatch.setattr(M, "all_reduce", lambda t, op, mesh, axis: t)
    monkeypatch.setattr(K, "device_of", lambda *t: _Cuda("cpu"))
    monkeypatch.setattr(launch, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")
    for name in ("etap_partial_dense_plain", "etap_decode_dense_plain"):
        monkeypatch.setattr(K, name, no_fallback)

    def use(widths):
        lib = _FakeLib(widths)
        launch.dense_widths.cache_clear()
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    with M.use_mesh(_Placed()):
        yield use
    launch.dense_widths.cache_clear()


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).bfloat16()


@pytest.mark.parametrize("gqa", [False, True], ids=["mla", "gqa"])
def test_cuda_branch_reaches_k6(fake_card, gqa):
    """On CUDA operands the rank's local partial is K6's launch: one call
    of the library's entry a decode, counted on the wrapper, the slice's
    own rows (S/n, no copy of the cache), the length clamped to the
    slice."""
    lib = fake_card([(576, 512), (128, 128)])
    before = K.etap_partial_dense.launches
    if gqa:
        kc, vc = _bf16(2, 256, 2, 128), _bf16(2, 256, 2, 128, seed=1)
        etap.seq_sharded_gqa_decode(_bf16(2, 8, 128, seed=2), kc, vc,
                                    _bf16(2, 2, 128, seed=3),
                                    _bf16(2, 2, 128, seed=4), 100,
                                    scale=0.1)
        cache = kc
    else:
        cache = _bf16(2, 256, 576)
        etap.seq_sharded_decode(_bf16(2, 16, 576, seed=2), cache,
                                _bf16(2, 576, seed=3), 100, dv=512,
                                scale=0.1)
    assert K.etap_partial_dense.launches == before + 1
    (args,) = lib.calls
    assert args[1] == cache.data_ptr()            # the slice, in place
    assert args[7] == 256                         # its S


@pytest.mark.parametrize("gqa", [False, True], ids=["mla", "gqa"])
def test_cuda_branch_unbuilt_width_raises(fake_card, gqa):
    """A width the library was not built for raises, with no plain
    fallback."""
    lib = fake_card([(64, 64), (256, 256)])
    with pytest.raises(NotImplementedError, match="Dk, Dv"):
        if gqa:
            etap.seq_sharded_gqa_decode(
                _bf16(2, 8, 128), _bf16(2, 256, 2, 128),
                _bf16(2, 256, 2, 128), _bf16(2, 2, 128), _bf16(2, 2, 128),
                100, scale=0.1)
        else:
            etap.seq_sharded_decode(_bf16(2, 16, 576), _bf16(2, 256, 576),
                                    _bf16(2, 576), 100, dv=512, scale=0.1)
    assert not lib.calls


def test_merge_weight_of_an_empty_slice_is_zero():
    """A slice with no position yet has m = NEG_INF: its weight is exactly
    0 in both modes; equal stats weigh exactly 1."""
    from repro_torch.kernels import softmax_state as ss
    m = torch.tensor([ss.NEG_INF, 3.0, -7.0])
    m_g = torch.tensor([5.0, 3.0, 2.0])
    for mode in ss.MODES:
        w = ss.merge_weights(m, m_g, mode=mode)
        assert w[0] == 0 and w[1] == 1
    assert ss.merge_weights(m, m_g, mode="amla")[2] == 2.0 ** -9


def test_a10b_refusals(monkeypatch):
    """Under a mesh with model > 1: a Mamba state that cache_specs splits
    over `model` and an RG-LRU state are not yet ported (A10b), in
    init_cache and shard_cache; a paged pool neither.  With model 1 the
    Mamba cache is batch-split only."""
    mesh = M.Mesh(("data", "model"), (1, 4))
    for arch in ("falcon_mamba_7b", "recurrentgemma_9b"):
        cfg = reduced(get_config(arch))
        whole = model.init_cache(cfg, 2, 64, device="cpu")
        with M.use_mesh(mesh):
            with pytest.raises(NotImplementedError, match="A10b"):
                model.init_cache(cfg, 2, 64, device="cpu")
        with pytest.raises(NotImplementedError, match="A10b"):
            model.shard_cache(whole, mesh)
    cfg = reduced(get_config("deepseek_r1_671b"))
    with M.use_mesh(mesh), pytest.raises(NotImplementedError, match="A10b"):
        model.init_paged_cache(cfg, None)
    with M.use_mesh(M.Mesh(("data", "model"), (2, 1))):
        cache = model.init_cache(reduced(get_config("falcon_mamba_7b")), 4,
                                 64, device="cpu")
    assert all(layer["h"].shape[0] == 2 and "seq_rows" not in layer
               for layer in cache)


def test_whole_cache_under_sharding_mesh_raises(monkeypatch):
    """A whole cache handed to decode where the mesh sequence-shards it
    (and a slice outside its mesh) raises instead of decoding the wrong
    rows."""
    monkeypatch.setattr(rules, "SEQ_SHARD_MIN_S", 64)
    layer = {"c": torch.zeros(2, 128, 8)}
    with pytest.raises(ValueError, match="whole"):
        rules.seq_sharded(layer, "c", M.Mesh(("data", "model"), (1, 4)))
    with pytest.raises(ValueError, match="a slice"):
        rules.seq_sharded({"c": torch.zeros(2, 32, 8), "seq_rows": 128},
                          "c", None)
    assert not rules.seq_sharded(layer, "c", None)
