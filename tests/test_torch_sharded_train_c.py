"""The sharded train step (ROADMAP A10b.2) with remat and in bf16,
continued from ``test_torch_sharded_train.py`` (its docstring gives the
setup, ``_torch_sharded_train_common.py`` the checks): the branches that
``reduced`` configs (fp32, no remat) leave out, run under the (2, 4) mesh
on 8 gloo ranks and held against the port's unsharded step on the same
weights.

- Remat (``dataclasses.replace(cfg, remat=True)``) for DeepSeek-R1 (MLA
  and a MoE layer with its experts over `model`), DBRX-132B, Falcon-
  Mamba-7B and RecurrentGemma-9B, fp32: each checkpointed block gathers
  its `data` pieces and runs its collectives again in the recompute.
  Held at the fp32 tolerances of ``test_torch_sharded_train.py``
  (metrics 1e-5 relative, params 1e-5 absolute, moments one bf16 ulp of
  the leaf's largest element, gradients 2e-5 of each leaf's largest).
- bf16 with remat for DeepSeek-R1 and RecurrentGemma-9B (the reference's
  fp32 weights rounded to the port's bf16 leaves), AdamW updating 1000
  elements at a time (``optimizers.CHUNK``; 16M on the card), so most
  leaves are updated in several pieces.  A bf16 step's bits depend on
  the order of its sums: each rank's row product is rounded to bf16
  before the pieces are summed over `model`, which moves later layers'
  activations by an ulp here and there, and a MoE token near a tie may
  take another expert.  So each reading is held, as the card's sharded
  train phase holds its readings, within the larger of a limit and twice
  its floor: the larger of the same reading of the unsharded step whose
  row products are split into 4 K pieces summed in fp32
  (``common.split_rows``, the reference's sharded summation order) and of
  the unsharded step at n_micro 2, each against the plain unsharded step.
  The limits: metrics (nll, load_balance, router_z, grad_norm) 1e-3
  relative; each leaf's gradient and each stored optimizer moment 1e-2
  relative L2.  The floors reach 7.6e-2 (the routed experts' gradients
  of DeepSeek) on the CPU.  Every param lies within one bf16 ulp of the
  unsharded step's plus 2 lr: the step's update (lr 1e-5 at the first
  warmup step) is under half an ulp of most params, so a param can only
  round the other way or move the other way where its gradient's sign
  flips; the count of params that differ is printed.
"""
import pytest

import _torch_sharded_train_common as common

REMAT = {"cfg_kw": {"remat": True}, "grads": True}
BF16 = {"cfg_kw": {"dtype": "bfloat16", "remat": True}, "grads": True,
        "chunk": 1000, "floor": True}
CASES = {
    "deepseek-remat": ("deepseek_r1_671b", {}, 1, REMAT),
    "dbrx-remat": ("dbrx_132b", {}, 1, REMAT),
    "falcon-remat": ("falcon_mamba_7b", {}, 1, REMAT),
    "rgemma-remat": ("recurrentgemma_9b", {}, 1, REMAT),
    "deepseek-bf16": ("deepseek_r1_671b", {}, 1, BF16),
    "rgemma-bf16": ("recurrentgemma_9b", {}, 1, BF16),
}
FP32 = [k for k in CASES if k.endswith("-remat")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return common.run(tmp_path_factory.mktemp("sharded_train_c"), CASES,
                      with_jax=False)


@pytest.mark.parametrize("name", FP32)
def test_remat_step_matches_unsharded(runs, name):
    ranks, _, ref, _ = runs
    flips = common.check_steps(ranks[name], ref[name], name, 1)
    print(f"{name}: {flips} stored bf16 moment elements rounded the other "
          "way")


@pytest.mark.parametrize("name", FP32)
def test_remat_grads_match_unsharded(runs, name):
    ranks, _, ref, _ = runs
    common.check_grads(ranks[name], ref[name], name)


@pytest.mark.parametrize("name", ["deepseek-bf16", "rgemma-bf16"])
def test_bf16_step_within_its_floor(runs, name):
    ranks, _, ref, _ = runs
    for kind, (what, reading, floor, bound) in common.check_bf16(
            ranks[name], ref[name], name).items():
        print(f"{name} {kind}: closest to its gate {what[1]} {reading:.3e} "
              f"(floor {floor:.3e}, gate {bound:.3e})" if kind != "params"
              else f"{name}: {reading} param elements differ")
