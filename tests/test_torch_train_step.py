"""The port's train step (``launch/steps.py``) and K9's gradient against the
reference.

* K9 with a gradient (``flash_prefill_grad``: the forward K9's plain
  version on the CPU, the backward ``flash_prefill_backward``) against
  ``jax.grad`` of the reference's ``causal_attention`` (the masked product
  it trains through), GQA (G 2) and MLA-shaped (D 24, Dv 16), fp32 within
  1e-5 of each gradient's max |value| and bf16 within 2^-7 of it (one bf16
  ulp); the backward is deterministic and does not depend on its query
  block.
* One whole train step against the reference's: see
  ``test_torch_train_step_ref.py``.
* ``n_micro`` 4 against 1 (the reference's tests/test_system.py bounds:
  nll within 1e-2, parameters within 3e-2), and memorisation: 30 steps on
  one batch bring the loss under 0.7 x the first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import batches, configs, weights
from repro.models import attention as jattention
from repro_torch.kernels.flash_prefill import flash_prefill as FP
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.launch import steps
from repro_torch.optim import optimizers as opt
from repro_torch.optim.optimizers import tree_leaves

F32_REL = 1e-5
BF16_REL = 2 ** -7


def _qkv(B, S, H, K, D, Dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                      (B, S, H, Dv))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 2, 16, 16),
                                   (1, 48, 4, 4, 24, 16)])
def test_k9_gradient_matches_jax(shape, dtype):
    B, S, H, K, D, Dv = shape
    q, k, v, do = _qkv(*shape, seed=S + H)
    scale = D ** -0.5
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))

    def jloss(a, b, c):
        o = jattention.causal_attention(a, b, c, scale=scale, q_block=16)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))
    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = prefill_ops.flash_prefill_grad(tq, tk, tv,
                                         spec=AttnSpec(scale=scale))
    with torch.no_grad():
        assert torch.equal(out, FP.flash_prefill(tq, tk, tv, scale=scale))
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(do).to(tdt))
    rel = F32_REL if dtype == "float32" else BF16_REL
    for name, a, b in zip("qkv", got, want, strict=True):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        err = float(np.abs(a.float().numpy() - b).max())
        assert err <= rel * float(np.abs(b).max()), (name, err)


def test_k9_backward_deterministic_and_blockwise():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(2, 64, 6, 2, 16, 8, 9))
    one = FP.flash_prefill_backward(q, k, v, do, scale=0.25)
    again = FP.flash_prefill_backward(q, k, v, do, scale=0.25)
    blocks = FP.flash_prefill_backward(q, k, v, do, scale=0.25, q_block=16)
    ragged = FP.flash_prefill_backward(q, k, v, do, scale=0.25, q_block=24)
    for a, b, c, d in zip(one, again, blocks, ragged, strict=True):
        assert torch.equal(a, b)
        torch.testing.assert_close(c, a, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(d, a, rtol=1e-5, atol=1e-6)


def _tcfg(name="adamw", n_micro=1, lr=1e-3):
    return steps.TrainConfig(optimizer=opt.OptimizerConfig(
        name=name, lr=lr, warmup_steps=2, total_steps=50), n_micro=n_micro)


def test_n_micro_4_matches_1():
    jcfg, cfg = configs("smollm_360m")
    _, tp = weights(jcfg)
    _, tb = batches(cfg, 8, 32)
    outs = {}
    for n in (1, 4):
        tt = _tcfg(n_micro=n)
        params = opt.tree_map(torch.clone, tp)
        state = opt.opt_init(tt.optimizer, params)
        p2, _, m = steps.make_train_step(cfg, tt)(params, state, tb, 0)
        outs[n] = (tree_leaves(p2), float(m["nll"]))
    assert abs(outs[1][1] - outs[4][1]) < 1e-2
    for a, b in zip(outs[1][0], outs[4][0], strict=True):
        torch.testing.assert_close(a, b, atol=3e-2, rtol=0)


def test_training_reduces_loss_on_learnable_data():
    """Memorisation, as the reference's tests/test_system.py asks."""
    jcfg, cfg = configs("smollm_360m")
    _, params = weights(jcfg)
    tt = _tcfg()
    state = opt.opt_init(tt.optimizer, params)
    step_fn = steps.make_train_step(cfg, tt)
    _, batch = batches(cfg, 4, 32, seed=1)
    first = None
    for s in range(30):
        params, state, m = step_fn(params, state, batch, s)
        first = first or float(m["nll"])
    assert float(m["nll"]) < first * 0.7, (first, float(m["nll"]))


def test_serve_and_prefill_steps_are_thin():
    jcfg, cfg = configs("qwen3_8b")
    _, tp = weights(jcfg)
    from repro_torch.models import layers, model
    params = dict(tp, embed_f32=layers.unembed_table(tp["embed"]))
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32)
    last, cache, pos = steps.make_prefill_step(cfg, 12)(params,
                                                       {"tokens": tokens})
    want, _, _ = model.prefill(params, cfg, {"tokens": tokens}, max_len=12)
    assert torch.equal(last, want) and pos == 8
    for mode in ("etap", "standard"):
        logits, _ = steps.make_serve_step(cfg, mode=mode)(
            params, [dict(c) for c in cache], tokens[:, -1], pos)
        assert logits.shape == (2, cfg.vocab_size)
        assert torch.isfinite(logits).all()


def test_remat_config_trains_the_same():
    """A step with cfg.remat (every block under torch.utils.checkpoint)
    gives bitwise the parameters of one without."""
    jcfg, cfg = configs("deepseek_r1_671b")
    _, tp = weights(jcfg)
    _, tb = batches(cfg, 2, 16)
    outs = []
    for remat in (False, True):
        tt = _tcfg()
        params = opt.tree_map(torch.clone, tp)
        state = opt.opt_init(tt.optimizer, params)
        c = dataclasses.replace(cfg, remat=remat)
        steps.make_train_step(c, tt)(params, state, tb, 0)
        outs.append(tree_leaves(params))
    assert all(torch.equal(a, b) for a, b in zip(*outs, strict=True))


def test_remat_only_where_autograd_records(monkeypatch):
    """With cfg.remat a block runs under torch.utils.checkpoint only when
    autograd records it: every block in ``grads_of``, none in a forward
    over parameters that require no grad (serving), grad mode on."""
    from repro_torch.models import model
    jcfg, cfg = configs("deepseek_r1_671b")
    _, tp = weights(jcfg)
    _, tb = batches(cfg, 2, 16)
    cfg = dataclasses.replace(cfg, remat=True)
    calls = []
    real = model.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(model, "checkpoint", counted)
    with torch.enable_grad():
        model.loss_fn(tp, cfg, tb)
    assert calls == []
    steps.grads_of(tp, cfg, tb)
    assert len(calls) == cfg.num_layers


def test_train_step_refuses_the_serving_copy():
    """A stale ``embed_f32`` would be the tied table's trap: the trainer's
    parameters go without it."""
    from repro_torch.models import layers
    jcfg, cfg = configs("smollm_360m")
    _, tp = weights(jcfg)
    _, tb = batches(cfg, 2, 16)
    params = dict(tp, embed_f32=layers.unembed_table(tp["embed"]))
    tt = _tcfg()
    with pytest.raises(ValueError, match="embed_f32"):
        steps.make_train_step(cfg, tt)(params, opt.opt_init(
            tt.optimizer, tp), tb, 0)
