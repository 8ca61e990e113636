"""The port's causal prefill kernel K9 in its plain form against the JAX
package on the same numpy inputs: ``flash_prefill_plain`` and the
``AttnSpec`` entry against ``flash_prefill_pallas`` in interpret mode and
against the direct oracle, in both rescale modes, at G = 1, 2 and 4, D = Dv
and D != Dv (MLA's ratio, 24 / 16 for 192 / 128), block sizes bq != bkv,
the CUDA kernel's 128 x 128 tiles, and a context S that is not a power of
two; prefix invariance at small blocks and at the kernel's tiles; the
wrapper's dispatch without a card (CPU operands run the plain version and
launch nothing; on the CUDA branch an unbuilt width, a non-bf16 operand,
a failed launch or an input that requires grad raises, never falling back);
the width list against every served full-attention model; and the reduced
DeepSeek and Qwen3 prefill with causal attention routed through K9's
entry, against JAX's ``prefill``.

Tolerance: fp32 ``atol = rtol = 1e-5`` for the kernel (the same fp32
arithmetic in another summation order), ``2e-5`` for model logits (as
``tests/test_torch_dense.py``); bf16 outputs within one bf16 ulp of the
reference's (both round fp32 values that differ in summation order only).
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.core.attn_spec import AttnSpec as JSpec
from repro.kernels.flash_prefill import flash_prefill as jfp
from repro.kernels.flash_prefill import ops as jops
from repro.kernels.flash_prefill.ref import causal_attention_ref as jref
from repro.models import model as jmodel
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core import mla
from repro_torch.core.attn_spec import AttnSpec
from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import flash_prefill as FP
from repro_torch.kernels.flash_prefill import ops
from repro_torch.kernels.flash_prefill.ref import causal_attention_ref
from repro_torch.models import attention, model
from repro_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src/repro_torch/kernels/csrc"
TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ["amla", "mul"]
# (B, S, H, K, D, Dv, bq, bkv): G = H / K; the last two at the CUDA
# kernel's tiles (128 query rows, 128 KV rows)
CASES = [
    (2, 48, 2, 2, 16, 16, 16, 24),     # G 1, bq < bkv
    (1, 96, 4, 2, 24, 16, 32, 48),     # G 2, D != Dv (MLA's 3 : 2)
    (1, 64, 8, 2, 16, 16, 32, 16),     # G 4, bq > bkv
    (1, 256, 4, 2, 24, 16, 128, 128),  # G 2, MLA's ratio, two tiles
    (2, 384, 2, 2, 16, 16, 128, 128),  # G 1, three tiles
]
IDS = ["G1", "G2-mla-widths", "G4", "G2-mla-kernel-tiles",
       "G1-kernel-tiles"]


def _inputs(B, S, H, K, D, Dv, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(dtype)
    k = rng.normal(size=(B, S, K, D)).astype(dtype)
    v = rng.normal(size=(B, S, K, Dv)).astype(dtype)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **tol)


# ------------------------------------------------------ plain vs Pallas
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,S,H,K,D,Dv,bq,bkv", CASES, ids=IDS)
def test_plain_matches_pallas(B, S, H, K, D, Dv, bq, bkv, mode):
    """flash_prefill_plain vs flash_prefill_pallas (interpret), the same
    block sizes and rescale mode; both against the direct oracles."""
    q, k, v = _inputs(B, S, H, K, D, Dv)
    ref = jfp.flash_prefill_pallas(*_j(q, k, v), scale=D ** -0.5, bq=bq,
                                   bkv=bkv, interpret=True, rescale=mode)
    out = FP.flash_prefill_plain(*_t(q, k, v), scale=D ** -0.5,
                                 rescale=mode, bq=bq, bkv=bkv)
    assert out.shape == (B, S, H, Dv) and out.dtype == torch.float32
    _close(out, ref)
    _close(out, jref(*_j(q, k, v), scale=D ** -0.5))
    _close(causal_attention_ref(*_t(q, k, v), scale=D ** -0.5),
           jref(*_j(q, k, v), scale=D ** -0.5))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,S,H,K,D,Dv,bq,bkv", CASES, ids=IDS)
def test_ops_entry_matches_jax_ops(B, S, H, K, D, Dv, bq, bkv, mode):
    """The AttnSpec entries: the spec's scale and rescale reach the
    kernel; CPU operands run the plain version."""
    q, k, v = _inputs(B, S, H, K, D, Dv, seed=1)
    ref = jops.flash_prefill(*_j(q, k, v),
                             spec=JSpec(scale=0.3, rescale=mode), bq=bq,
                             bkv=bkv)
    out = ops.flash_prefill(*_t(q, k, v), spec=AttnSpec(scale=0.3,
                                                        rescale=mode),
                            bq=bq, bkv=bkv)
    _close(out, ref)


@pytest.mark.parametrize("mode", MODES)
def test_bf16_within_one_ulp(mode):
    """bf16 q, k, v (G 2, D != Dv): the output takes v's dtype and sits
    within one bf16 ulp of the Pallas kernel's."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _inputs(2, 64, 4, 2, 24, 16, seed=2))
    ref = jfp.flash_prefill_pallas(q, k, v, scale=24 ** -0.5, bq=32, bkv=16,
                                   interpret=True, rescale=mode)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in (q, k, v))
    out = FP.flash_prefill(tq, tk, tv, scale=24 ** -0.5, rescale=mode,
                           bq=32, bkv=16)
    assert out.dtype == torch.bfloat16
    o = out.float().numpy()
    r = np.asarray(ref, np.float32)
    _, e = np.frexp(np.maximum(np.abs(o), np.abs(r)))
    ulp = np.ldexp(1.0, e - 8)          # bf16: 8 significant bits
    assert (np.abs(o - r) <= ulp).all()


@pytest.mark.parametrize("mode", MODES)
def test_unaligned_and_short_contexts(mode):
    """S not a multiple of the blocks (the last blocks short) and S below
    them: the plain version against the oracle."""
    for S, bq, bkv in ((37, 16, 8), (5, 16, 16), (1, 4, 4), (50, 7, 11)):
        q, k, v = _inputs(1, S, 4, 2, 16, 8, seed=S)
        out = FP.flash_prefill_plain(*_t(q, k, v), scale=0.25, rescale=mode,
                                     bq=bq, bkv=bkv)
        _close(out, causal_attention_ref(*_t(q, k, v), scale=0.25))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,bq,bkv,T,ragged", [(96, 32, 16, 64, 53),
                                               (384, 128, 128, 256, 203)],
                         ids=["small-blocks", "kernel-tiles"])
def test_prefix_invariance(S, bq, bkv, T, ragged, mode):
    """Rows [:T] of a length-S call equal a length-T call: bitwise when T
    falls on the block boundaries (the later KV blocks are wholly masked
    for those rows and change nothing), within fp32 tolerance otherwise;
    at small blocks and at the CUDA kernel's 128-row tiles."""
    q, k, v = _t(*_inputs(2, S, 4, 2, 24, 16, seed=3))
    kw = dict(scale=0.2, rescale=mode, bq=bq, bkv=bkv)
    full = FP.flash_prefill_plain(q, k, v, **kw)
    head = FP.flash_prefill_plain(q[:, :T], k[:, :T], v[:, :T], **kw)
    assert torch.equal(full[:, :T], head)
    head = FP.flash_prefill_plain(q[:, :ragged], k[:, :ragged],
                                  v[:, :ragged], **kw)
    _close(full[:, :ragged], head)


# ------------------------------------------------------ dispatch
class _FakeLib:
    """A stand-in for the kernel library: reports ``widths`` and records
    launches, returning ``err``."""

    def __init__(self, widths, err=0):
        self.widths, self.err, self.calls = widths, err, 0

    def flash_prefill_widths(self, buf, cap):
        for i, (d, dv) in enumerate(self.widths[:cap]):
            buf[2 * i], buf[2 * i + 1] = d, dv
        return len(self.widths)

    def flash_prefill(self, *args):
        self.calls += 1
        return self.err


@pytest.fixture
def fake_cuda(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors: device_of says cuda, the
    stream is 0, and the plain version must not be reached."""
    monkeypatch.setattr(FP, "device_of", lambda *t: torch.device("cuda"))
    monkeypatch.setattr(FP, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(FP, "flash_prefill_plain", no_fallback)

    def use(lib):
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    return use


def _bf16(*shape_sets, seed=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        torch.bfloat16) for s in shape_sets]


def test_cpu_operands_run_plain_and_launch_nothing(monkeypatch):
    def no_library():
        raise AssertionError("CPU operands reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    q, k, v = _t(*_inputs(1, 16, 4, 2, 16, 8, seed=5))
    before = FP.flash_prefill.launches
    out = FP.flash_prefill(q, k, v, scale=0.25)
    assert FP.flash_prefill.launches == before
    assert torch.equal(out, FP.flash_prefill_plain(q, k, v, scale=0.25))
    assert torch.equal(ops.flash_prefill(q, k, v, spec=AttnSpec(scale=0.25)),
                       out)


def test_unbuilt_width_raises_not_falls_back(fake_cuda):
    lib = fake_cuda(_FakeLib([(128, 128)]))
    before = FP.flash_prefill.launches
    q, k, v = _bf16((1, 8, 4, 96), (1, 8, 2, 96), (1, 8, 2, 96))
    with pytest.raises(NotImplementedError, match=r"\(Dk, Dv\)"):
        FP.flash_prefill(q, k, v, scale=0.1)
    q, k, v = _bf16((1, 8, 4, 128), (1, 8, 2, 128), (1, 8, 2, 64))
    with pytest.raises(NotImplementedError, match=r"\(Dk, Dv\)"):
        FP.flash_prefill(q, k, v, scale=0.1)
    q, k, v = (x.float() for x in _bf16((1, 8, 4, 128), (1, 8, 2, 128),
                                       (1, 8, 2, 128)))
    with pytest.raises(NotImplementedError, match="bf16"):
        FP.flash_prefill(q, k, v, scale=0.1)
    q, k, v = _bf16((1, 8, 4, 128), (1, 8, 2, 128), (1, 8, 2, 128))
    with pytest.raises(NotImplementedError, match="bf16 v"):
        FP.flash_prefill(q, k, v.float(), scale=0.1)
    strided = v.transpose(-1, -2).contiguous().transpose(-1, -2)
    with pytest.raises(NotImplementedError, match="stride"):
        FP.flash_prefill(q, k, strided, scale=0.1)
    assert lib.calls == 0 and FP.flash_prefill.launches == before


def test_built_width_launches_once_and_failure_raises(fake_cuda):
    q, k, v = _bf16((2, 8, 4, 128), (2, 8, 2, 128), (2, 8, 2, 128))
    lib = fake_cuda(_FakeLib([(128, 128)]))
    before = FP.flash_prefill.launches
    out = FP.flash_prefill(q, k, v, scale=0.1)
    assert out.shape == (2, 8, 4, 128) and out.dtype == torch.bfloat16
    assert lib.calls == 1 and FP.flash_prefill.launches == before + 1
    fake_cuda(_FakeLib([(128, 128)], err=1))
    with pytest.raises(RuntimeError, match="cudaError 1"):
        FP.flash_prefill(q, k, v, scale=0.1)


def test_grad_and_shapes_refused():
    q, k, v = _t(*_inputs(1, 8, 4, 2, 16, 16, seed=6))
    with pytest.raises(NotImplementedError, match="A7"):
        FP.flash_prefill(q.requires_grad_(), k, v, scale=0.1)
    with torch.no_grad():                  # no backward asked for
        FP.flash_prefill(q, k, v, scale=0.1)
    q, k, v = _t(*_inputs(1, 8, 3, 2, 16, 16, seed=6))
    with pytest.raises(ValueError, match="do not agree"):
        FP.flash_prefill(q, k, v, scale=0.1)
    with pytest.raises(ValueError, match="operands on"):
        FP.flash_prefill(q, k.to("meta"), v, scale=0.1)


# ------------------------------------------------------ widths
def _prefill_widths():
    """K9's (D, Dv) list, read from its one place in the CUDA sources."""
    m = re.search(r"using PrefillWidths\s*=\s*Widths<([^>]*)>",
                  (CSRC / "mma_tile.cuh").read_text())
    w = [int(x) for x in m.group(1).split(",")]
    return set(zip(w[::2], w[1::2], strict=True))


def test_every_served_full_attention_width_is_built():
    """Each arch the port serves (cut to its dense layers where it has
    MoE ones) with a full-attention block has its (D, Dv) in K9's list,
    and the list holds no other pair."""
    need = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.moe is not None:
            if not cfg.moe.first_dense_layers:
                continue
            cfg = dataclasses.replace(cfg,
                                      num_layers=cfg.moe.first_dense_layers)
        try:
            model.check_ported(cfg)
        except NotImplementedError:
            continue
        if "attn" not in cfg.layer_kinds() or \
                cfg.attention_kind not in ("full", "mla"):
            continue
        m = cfg.mla
        need[arch] = ((m.qk_head_dim, m.v_head_dim) if m is not None else
                      (cfg.resolved_head_dim,) * 2)
    assert set(need) == {"deepseek_r1_671b", "qwen3_8b", "granite_20b",
                         "smollm_360m", "stablelm_1_6b", "musicgen_large",
                         "llava_next_34b"}
    assert set(need.values()) == _prefill_widths() == {
        (192, 128), (128, 128), (64, 64)}


def test_kernel_source_and_binding_exist():
    assert (CSRC / "flash_prefill.cu").exists()
    for fn in ("flash_prefill", "flash_prefill_widths",
               "flash_prefill_attrs"):
        assert fn in build.SIGNATURES
    assert len(build.SIGNATURES["flash_prefill"]) == 22


# ------------------------------------------------------ the slice
SLICE = ["deepseek_r1_671b", "qwen3_8b"]


@pytest.fixture(scope="module", params=SLICE)
def weights(request):
    arch = request.param
    kw = {"kv_heads": 2} if arch == "qwen3_8b" else {}
    jcfg, cfg = jreduced(jget_config(arch), **kw), reduced(get_config(arch),
                                                           **kw)
    if arch == "deepseek_r1_671b":
        jcfg, cfg = (dataclasses.replace(c, moe=None) for c in (jcfg, cfg))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_prefill_through_k9_matches_jax(weights, monkeypatch):
    """model.prefill with every full-attention layer's causal attention
    routed through K9's entry (its plain version on the CPU, in blocks of
    8 query and 4 KV rows): the last position's logits match JAX's
    prefill, and K9 ran once a layer."""
    jcfg, cfg, jparams, params = weights
    calls = []

    def through_k9(q, k, v, *, scale, q_block=512):
        calls.append(q.shape)
        return ops.flash_prefill(q, k, v, spec=AttnSpec(scale=scale), bq=8,
                                 bkv=4)

    monkeypatch.setattr(attention, "causal_attention", through_k9)
    monkeypatch.setattr(mla, "causal_attention", through_k9)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             size=(2, 12)).astype(np.int32)
    jlogits, _, _ = jmodel.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(toks)}, 16)
    logits, _, pos = model.prefill(params, cfg, torch.from_numpy(toks), 16)
    assert pos == 12 and len(calls) == cfg.num_layers
    if cfg.mla is not None:
        assert calls[0][-1] == cfg.mla.qk_head_dim
    else:
        assert cfg.num_heads // cfg.num_kv_heads == 2
    _close(logits, jlogits, tol=dict(atol=2e-5, rtol=2e-5))
