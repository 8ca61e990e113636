"""The sharded train step (ROADMAP A10b.2) against the port's unsharded
step and the JAX package's: SmolLM-360M, DBRX-132B and Falcon-Mamba-7B
(DeepSeek-R1 and RecurrentGemma-9B: ``test_torch_sharded_train_b.py``;
remat and bf16: ``test_torch_sharded_train_c.py``).

One spawn of 8 gloo ranks on the CPU for the module
(``_torch_sharded_train_worker.py``, a FileStore in the test's directory)
on the (data, model) = (2, 4) mesh of ``tests/test_sharding.py:76-125``,
with its inputs for each arch: ``reduced(get_config(arch))``, the
reference's ``model.init(PRNGKey(0))`` carried across by
``params_from_jax``, tokens ``jax.random.randint(PRNGKey(1), (8, 32), 0,
V)``, AdamW at lr 1e-3.  The ranks place the weights by
``param_specs(profile="train")`` and the state by ``opt_state_specs`` and
run ``grads_of`` and ``make_train_step`` under the mesh; the results are
gathered whole.  Beyond the reference: ``n_micro`` 2 for DBRX (each
microbatch holds the reference's rows, each rank its rows of it), and
SmolLM with ``compress_grads`` (the int8 round trip of the whole stacked
gradients, gathered and cut again).

Held (``_torch_sharded_train_common.py``), against the port's unsharded
step on the same weights in this process:
- nll, load_balance, router_z and grad_norm within 1e-5 relative;
- every gathered param within 1e-5 absolute (a stored bf16 moment that
  rounds the other way moves the next step's param by at most lr·2^-7,
  under that bound at lr 1e-3; such elements are counted and printed);
- the gathered bf16 moments within one bf16 ulp of the leaf's largest
  element (2^-7 of its max |value|: an element near zero, a sum that
  cancels, may round the other way by more than its own ulp; with
  ``compress_grads`` within one int8 step of the gradient's chunk more:
  ``_torch_sharded_train_common.INT8_STEP``);
- the gathered gradients of the sharded ``grads_of`` within 2e-5 of each
  leaf's max |value|.
Against JAX's unsharded ``make_train_step`` under ``jax.jit`` (in this
process, while the ranks run): nll within 1e-5 relative, params within
1e-5 absolute (the reference's own gate, ``tests/test_sharding.py:124``,
is nll 1e-3 and params 5e-2).  Placement: every rank's leaf and state
shapes are ``rules.local_shape`` of their specs, the placed state is
bitwise ``rules.place_opt_state`` of the whole one, and the placed
train-profile ``init`` (and ``train.build_state`` under the mesh) is
bitwise ``place_params`` of the whole one.
"""
import pytest

import _torch_sharded_train_common as common
from repro_torch.configs import get_config, reduced
from repro_torch.launch import mesh as M
from repro_torch.sharding import rules

ARCHS = ["smollm_360m", "dbrx_132b", "falcon_mamba_7b"]
# name -> (arch, train config keywords, steps, what else the ranks run)
CASES = {arch: (arch, {}, 1, {"grads": True, "init_check": True})
         for arch in ARCHS}
CASES["dbrx-n_micro-2"] = ("dbrx_132b", {"n_micro": 2}, 1, {})
CASES["smollm-compress"] = ("smollm_360m", {"compress_grads": True}, 1, {})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run(tmp_path_factory.mktemp("sharded_train"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_unsharded(runs, name):
    ranks, _, ref, _ = runs
    flips = common.check_steps(
        ranks[name], ref[name], name, CASES[name][2],
        common.INT8_STEP if "compress" in name else common.BF16_ULP)
    print(f"{name}: {flips} stored bf16 moment elements rounded the other "
          "way")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_unsharded(runs, arch):
    ranks, _, ref, _ = runs
    common.check_grads(ranks[arch], ref[arch], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_jax(runs, arch):
    ranks, _, _, jax_out = runs
    common.check_jax(ranks[arch], *jax_out[arch], arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_placement(runs, arch):
    _, checks, _, _ = runs
    common.check_placement(checks, arch)


def test_placed_pieces_outside_their_mesh_raise(tmp_path):
    """A placed tree saved with no mesh, or under another mesh's shape,
    raises instead of writing a piece as if it were the whole."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.models import model
    cfg = reduced(get_config("smollm_360m"))
    mesh = M.Mesh(("data", "model"), (2, 4))
    mesh.coord = lambda axis: 0
    placed = rules.place_params(model.init(cfg, seed=0, device="cpu"), mesh,
                                profile="train")
    with pytest.raises(ValueError, match="outside a mesh"):
        ckpt.save(str(tmp_path / "a"), 1, placed)
    other = M.Mesh(("data", "model"), (1, 8))
    with M.use_mesh(other), pytest.raises(ValueError, match="placed for"):
        ckpt.save(str(tmp_path / "b"), 1, placed)
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("requires_grad", [False, True])
def test_row_product_sums_partials(monkeypatch, requires_grad):
    """A bf16 row piece's product is the rank's partial product summed
    over `model`, in a training step (autograd recording it) as in
    serving: no gather of the pieces."""
    import torch

    from repro_torch.models import layers
    calls = []

    def gather(t, mesh, axis, dim=0):
        calls.append("gather")
        return torch.cat([t] * mesh.shape[axis], dim=dim)

    def reduce_sum(t, mesh, axis):
        calls.append(("reduce_sum", axis))
        return t.clone()
    monkeypatch.setattr(M, "gather", gather)
    monkeypatch.setattr(M, "reduce_sum", reduce_sum)
    mesh = M.Mesh(("data", "model"), (1, 4))
    x = torch.randn(2, 16, 8).bfloat16().requires_grad_(requires_grad)
    w = torch.randn(8, 32).bfloat16().requires_grad_(requires_grad)
    with M.use_mesh(mesh), torch.enable_grad():
        y = layers.dense_row(x, w, 32)
    assert y.shape == (2, 16, 32)
    assert calls == [("reduce_sum", "model")]
    assert torch.equal(y, x @ w)


def test_moe_aux_over_every_batch_axis(monkeypatch):
    """On a (pod, data, model) mesh with pod and data both > 1 the MoE aux
    losses reduce over both batch axes: with every rank holding the same
    rows (the collectives faked as sums of equal terms) each rank's share
    is 1/4 of the unsharded statistic."""
    import dataclasses

    import torch

    from repro_torch.models import model, moe
    calls = []

    def summed(t, mesh, axis):
        calls.append(axis)
        return t * mesh.shape[axis]
    monkeypatch.setattr(M, "reduce_sum", summed)
    monkeypatch.setattr(M, "all_reduce_sum", summed)
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              num_layers=2)
    lp = model.init(cfg, seed=0, device="cpu")["layers"][1]["ffn"]
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator(
        ).manual_seed(0))
    _, whole = moe.moe_ffn(lp, cfg, x)
    mesh = M.Mesh(("pod", "data", "model"), (2, 2, 1))
    with M.use_mesh(mesh):
        _, share = moe.moe_ffn(lp, cfg, x, batch_axes=("pod", "data"))
    assert calls == ["pod", "pod", "data", "data"]
    for k in ("load_balance", "router_z"):
        assert torch.allclose(4 * share[k], whole[k], rtol=1e-6), k
