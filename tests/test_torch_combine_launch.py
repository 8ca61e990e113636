"""K2, the split merge: its two wrappers' CUDA branch faked on the CPU, and
its plain version against the JAX Pallas kernel in interpret mode.

``combine_splits`` (Accᵀ [B, n, Dv, H], the ETAP partials') and
``combine_splits_std`` (Acc [B, n, H, Dv], the baseline's) launch one
kernel of ``kernels/csrc/combine.cu``, templated over the orientation,
through the unchanged C entries ``etap_combine_splits`` and
``etap_combine_splits_rows``.  Here the wrappers see CUDA operands
(``device_of`` says cuda) and a fake library that records each call: each
wrapper launches its entry once with as many arguments as
``build.SIGNATURES`` binds, with B, n, H, Dv, the amla flag and the fp32
flag in place, counted on its wrapper; an output type other than bf16 /
fp32, a Dv that is not a multiple of 32, an Acc that does not match m and a
failed launch raise; and no CUDA call reaches the plain version.  The
kernel's numerics (bitwise the parent's, n = 1 bitwise acc / ℓ, a row alone
bitwise the row in a batch) are held on the card by ``chip_smoke.py``
(``combine_edge_checks``).

The plain version against ``combine_splits_pallas(interpret=True)``: fp32
``atol = rtol = 1e-5`` (both sum in fp32, in other orders), both
orientations and rescale modes, H 1, 3 and 4 (the GQA groups of the split
phases), n 1 and 22, a fully masked split (m = -1e30, ℓ = 0, a finite
garbage Acc) wherever n > 1.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.etap import combine as jcombine
from repro_torch.kernels import build
from repro_torch.kernels.etap import combine as C

CSRC = Path(build.__file__).resolve().parent / "csrc"
ENTRIES = {"combine_splits": "etap_combine_splits",
           "combine_splits_std": "etap_combine_splits_rows"}
MODES = ["amla", "mul"]


class _FakeLib:
    """The kernel library as the wrappers see it: each K2 entry recording
    its arguments and returning ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __getattr__(self, name):
        if name not in ENTRIES.values():
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.err
        return entry


class _Cuda(str):
    """A device that the wrappers take for a card (``type`` cuda) and
    torch allocates on the CPU (the string "cpu")."""
    type = "cuda"


@pytest.fixture
def fake_cuda(monkeypatch):
    """The CUDA branch on CPU tensors: device_of says cuda, the stream is
    0, and both plain versions raise."""
    monkeypatch.setattr(C, "device_of", lambda *t: _Cuda("cpu"))
    monkeypatch.setattr(C, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    for name in ENTRIES:
        monkeypatch.setattr(C, name + "_plain", no_fallback)

    def use(lib):
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    return use


def _stats(B=2, n=3, H=4, Dv=64, rows=False):
    """m, l [B, n, H] and Acc in the wrapper's orientation."""
    g = torch.Generator().manual_seed(0)
    m = torch.randn(B, n, H, generator=g)
    l = torch.rand(B, n, H, generator=g) + 1
    shape = (B, n, H, Dv) if rows else (B, n, Dv, H)
    return m, l, torch.randn(*shape, generator=g)


def _call(name, m, l, acc, **kw):
    return getattr(C, name)(m, l, acc, **kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_launches_its_entry_once(fake_cuda, name, out_dtype, mode):
    """One call: one launch of the wrapper's own entry with as many
    arguments as build.SIGNATURES binds; m, l and Acc's pointers, then B,
    n, H, Dv, the amla flag and the fp32 flag in place; counted on the
    wrapper; O [B, H, Dv] in the asked type."""
    lib = fake_cuda(_FakeLib())
    wrapper = getattr(C, name)
    before = wrapper.launches
    B, n, H, Dv = 2, 22, 3, 96
    m, l, acc = _stats(B, n, H, Dv, rows=name == "combine_splits_std")
    out = _call(name, m, l, acc, out_dtype=out_dtype, rescale=mode)
    assert wrapper.launches == before + 1
    (entry, args), = lib.calls
    assert entry == ENTRIES[name]
    assert len(args) == len(build.SIGNATURES[entry])
    assert args[:3] == (m.data_ptr(), l.data_ptr(), acc.data_ptr())
    assert args[3] == out.data_ptr()
    assert args[4:10] == (B, n, H, Dv, int(mode == "amla"),
                          int(out_dtype == torch.float32))
    assert out.dtype == out_dtype and tuple(out.shape) == (B, H, Dv)


@pytest.mark.parametrize("name", list(ENTRIES))
def test_operands_go_as_contiguous_fp32(fake_cuda, name):
    """bf16 or strided stats reach the kernel as contiguous fp32 copies:
    the pointers passed are those of fp32 tensors, not of the inputs."""
    lib = fake_cuda(_FakeLib())
    m, l, acc = _stats(rows=name == "combine_splits_std")
    mb = m.bfloat16()
    lt = l.transpose(0, 1).contiguous().transpose(0, 1)     # strided
    _call(name, mb, lt, acc, out_dtype=torch.bfloat16, rescale="mul")
    (_, args), = lib.calls
    assert args[0] != mb.data_ptr() and args[1] != lt.data_ptr()
    assert args[2] == acc.data_ptr()


@pytest.mark.parametrize("out_dtype", [torch.float16, torch.int8],
                         ids=["fp16", "int8"])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_other_output_types_raise(fake_cuda, name, out_dtype):
    """The kernel writes bf16 or fp32 only: any other output type raises
    NotImplementedError and launches nothing."""
    lib = fake_cuda(_FakeLib())
    before = getattr(C, name).launches
    with pytest.raises(NotImplementedError, match="writes"):
        _call(name, *_stats(rows=name == "combine_splits_std"),
              out_dtype=out_dtype, rescale="amla")
    assert lib.calls == [] and getattr(C, name).launches == before


@pytest.mark.parametrize("Dv", [48, 100])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_dv_not_a_multiple_of_32_raises(fake_cuda, name, Dv):
    """Dv must be a multiple of 32: otherwise ValueError, no launch."""
    lib = fake_cuda(_FakeLib())
    with pytest.raises(ValueError, match="multiple of 32"):
        _call(name, *_stats(Dv=Dv, rows=name == "combine_splits_std"),
              out_dtype=torch.bfloat16, rescale="amla")
    assert lib.calls == []


@pytest.mark.parametrize("bad", ["n", "H", "B", "orientation"])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_mismatched_acc_raises(fake_cuda, name, bad):
    """An Acc whose batch, split count or heads differ from m's, or one in
    the other orientation, raises ValueError and launches nothing."""
    lib = fake_cuda(_FakeLib())
    rows = name == "combine_splits_std"
    m, l, acc = _stats(B=2, n=3, H=4, Dv=64, rows=rows)
    acc = {"n": lambda: acc[:, :2], "H": lambda: acc[..., :2] if not rows
           else acc[:, :, :2], "B": lambda: acc[:1],
           "orientation": lambda: acc.transpose(2, 3)}[bad]()
    with pytest.raises(ValueError, match="does not match"):
        _call(name, m, l, acc, out_dtype=torch.float32, rescale="mul")
    assert lib.calls == []


@pytest.mark.parametrize("name", list(ENTRIES))
def test_failed_launch_raises(fake_cuda, name):
    """A non-zero cudaError_t from the entry raises; nothing falls back."""
    fake_cuda(_FakeLib(err=700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _call(name, *_stats(rows=name == "combine_splits_std"),
              out_dtype=torch.bfloat16, rescale="amla")


def test_one_kernel_behind_the_unchanged_entries():
    """combine.cu alone defines the two entries and the attrs query, under
    their bindings (11, 11 and 5 arguments), and holds one __global__
    kernel, templated over the orientation."""
    for name, n_args in (("etap_combine_splits", 11),
                         ("etap_combine_splits_rows", 11),
                         ("etap_combine_attrs", 5)):
        defs = [f.name for f in sorted(CSRC.glob("*.cu"))
                if re.search(rf"\bint {name}\(", f.read_text())]
        assert defs == ["combine.cu"], (name, defs)
        assert len(build.SIGNATURES[name]) == n_args
    src = (CSRC / "combine.cu").read_text()
    assert src.count("__global__") == 1
    assert re.search(r"template <bool ROWS, [^>]*>\s*__global__", src)
    assert "atomicAdd" not in src


# ------------------------------------------------ plain K2 against Pallas
def _pallas_case(n, H, B=2, Dv=32, mode="mul", seed=0):
    """Split stats as the partial kernels leave them (numpy, fp32): in amla
    mode integer-valued m; split 1 fully masked (m = -1e30, ℓ = 0, a finite
    garbage Acc) wherever n > 1.  Acc in the [n, H, Dv] orientation."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(B, n, H)).astype(np.float32) * 4
    if mode == "amla":
        m = np.round(m)
    l = (rng.random((B, n, H)) + 1).astype(np.float32)
    acc = rng.normal(size=(B, n, H, Dv)).astype(np.float32)
    if n > 1:
        m[:, 1], l[:, 1] = -1e30, 0.0
        acc[:, 1] = 1e3 * rng.normal(size=(B, H, Dv))
    return m, l, acc


@pytest.mark.parametrize("n", [1, 22])
@pytest.mark.parametrize("H", [1, 3, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("transposed", [True, False], ids=["T", "rows"])
def test_plain_matches_pallas(transposed, mode, H, n):
    """Plain K2 vs combine_splits_pallas(interpret=True) in the same
    orientation, fp32 out."""
    m, l, acc = _pallas_case(n, H, mode=mode)
    if transposed:
        acc = np.ascontiguousarray(acc.transpose(0, 1, 3, 2))
    ref = jcombine.combine_splits_pallas(
        jnp.asarray(m), jnp.asarray(l), jnp.asarray(acc),
        transposed=transposed, out_dtype=jnp.float32, interpret=True,
        rescale=mode)
    fn = C.combine_splits if transposed else C.combine_splits_std
    out = fn(*(torch.from_numpy(x) for x in (m, l, acc)),
             out_dtype=torch.float32, rescale=mode)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("transposed", [True, False], ids=["T", "rows"])
def test_plain_one_split_is_acc_over_l(transposed, mode):
    """With one split the plain merge is bitwise acc / ℓ, in fp32 and after
    the bf16 cast."""
    m, l, acc = (torch.from_numpy(x) for x in _pallas_case(1, 4, mode=mode))
    want = acc[:, 0] / l[:, 0, :, None]
    if transposed:
        acc = acc.transpose(2, 3).contiguous()
    fn = C.combine_splits if transposed else C.combine_splits_std
    for dt in (torch.float32, torch.bfloat16):
        out = fn(m, l, acc, out_dtype=dt, rescale=mode)
        assert torch.equal(out, want.to(dt))
