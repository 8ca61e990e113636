"""The baseline's two bf16 wrappers' CUDA branch, faked on the CPU.

``flash_decode`` (K7) and ``flash_decode_partial`` (K8) launch the Hopper
kernel of ``kernels/csrc/flash_decode_wgmma.cu`` (the heads on wgmma's M, a
TMA ring, warp-specialised) through unchanged C entries.  Here the wrappers
see CUDA operands (``device_of`` says cuda) and a fake library that records
each call: each wrapper launches its C entry once with as many arguments as
``build.SIGNATURES`` binds, counted on its wrapper; the latent's V =
``k[..., :512]`` goes as null (read from K's rows) and a V of its own with
its pointer and strides; a GQA cache [B, S, K, hd] goes in place with kvh =
K, its strides and its own S (no padded copy); a split plan reaches the
kernel as its count and its 64-row tiles a split; a failed launch and an
unbuilt width raise; and no wrapper reaches its plain version.  The
kernel's numerics are held to the plain versions on the card by
``chip_smoke.py``.
"""
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.etap.schedule import dense_split_plan
from repro_torch.kernels.flash_decode import flash_decode as FD

CSRC = Path(build.__file__).resolve().parent / "csrc"
DENSE_WIDTHS = [(576, 512), (128, 128), (64, 64), (256, 256)]
WRAPPERS = ("flash_decode", "flash_decode_partial")
# the arguments after the operand block: out, B, H (K7); m, l, acc, B, H,
# n, tps (K8)
B_AT = {"flash_decode": 15, "flash_decode_partial": 17}


class _FakeLib:
    """The kernel library as the wrappers see it: the width query, and each
    baseline entry recording its arguments."""

    def __init__(self, err=0, widths=DENSE_WIDTHS):
        self.err, self.widths, self.calls = err, widths, []

    def flash_decode_widths(self, buf, cap):
        for i, (dk, dv) in enumerate(self.widths):
            buf[2 * i], buf[2 * i + 1] = dk, dv
        return len(self.widths)

    def __getattr__(self, name):
        if name not in WRAPPERS:
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
    0, and every plain version raises."""
    monkeypatch.setattr(FD, "device_of", lambda *t: _Cuda("cpu"))
    monkeypatch.setattr(launch, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    for name in WRAPPERS:
        monkeypatch.setattr(FD, name + "_plain", no_fallback)

    def use(lib):
        launch.dense_widths.cache_clear()
        monkeypatch.setattr(build, "library", lambda: lib)
        return lib
    yield use
    launch.dense_widths.cache_clear()


def _latent(H=16, S=200, own_v=False):
    """q [B, H, 576] and a dense latent cache [B, S, 576] (S not a multiple
    of 64), V its first 512 columns (a view) or a copy of them."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, H, 576, generator=g).bfloat16()
    k = torch.randn(2, S, 576, generator=g).bfloat16()
    v = k[..., :512].contiguous() if own_v else k[..., :512]
    return q, k, v, torch.tensor([S, 37], dtype=torch.int32)


def _gqa(hd=128, Bo=2, S=200, Kv=4, G=3):
    """q [Bo K, G, hd] and a GQA cache k, v [Bo, S, K, hd] (S not a
    multiple of 64)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(Bo * Kv, G, hd, generator=g).bfloat16()
    k = torch.randn(Bo, S, Kv, hd, generator=g).bfloat16()
    v = torch.randn(Bo, S, Kv, hd, generator=g).bfloat16()
    lengths = torch.full((Bo * Kv,), S, dtype=torch.int32)
    return q, k, v, lengths


def _call(name, q, k, v, lengths, n=2):
    if name == "flash_decode":
        return FD.flash_decode(q, k, v, lengths, scale=0.1)
    return FD.flash_decode_partial(q, k, v, lengths, scale=0.1,
                                   plan=dense_split_plan(k.shape[1], 64, n))


def _operands(dk, dv):
    return _latent() if dk == 576 else _gqa(hd=dk)


@pytest.mark.parametrize("width", DENSE_WIDTHS, ids=str)
@pytest.mark.parametrize("name", WRAPPERS)
def test_launches_its_entry_once(fake_cuda, name, width):
    """One call at each width: one launch of its own C entry, with as many
    arguments as build.SIGNATURES binds, counted on the wrapper; outputs in
    the kernel's shapes and types (K7 bf16 [BG, H, Dv]; K8 fp32 m, l [BG, n,
    H] and acc [BG, n, H, Dv])."""
    lib = fake_cuda(_FakeLib())
    wrapper = getattr(FD, name)
    before = wrapper.launches
    q, k, v, lengths = _operands(*width)
    out = _call(name, q, k, v, lengths)
    assert wrapper.launches == before + 1
    assert [c[0] for c in lib.calls] == [name]
    args = lib.calls[0][1]
    assert len(args) == len(build.SIGNATURES[name])
    assert (args[12], args[13]) == width
    BG, H, Dv = q.shape[0], q.shape[1], width[1]
    if name == "flash_decode":
        assert out.dtype == torch.bfloat16
        assert tuple(out.shape) == (BG, H, Dv)
    else:
        m, l, acc = out
        assert m.dtype == l.dtype == acc.dtype == torch.float32
        assert tuple(m.shape) == tuple(l.shape) == (BG, 2, H)
        assert tuple(acc.shape) == (BG, 2, H, Dv)


@pytest.mark.parametrize("name", WRAPPERS)
def test_latent_fused_v_goes_as_null(fake_cuda, name):
    """The latent's V = k[..., :512] is passed as null (the kernel reads it
    from K's boxes, once), with S unpadded and K's strides."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _latent()
    _call(name, q, k, v, lengths)
    (_, args), = lib.calls
    assert args[1] == k.data_ptr() and args[4] is None
    assert (args[2], args[3]) == (200 * 576, 576)            # kb, ldk
    assert args[7] == 200                                    # S
    assert (args[9], args[10]) == (1, 0)                     # kvh, kh


@pytest.mark.parametrize("name", WRAPPERS)
def test_latent_own_v_goes_with_its_strides(fake_cuda, name):
    """A latent V in rows of its own reaches the kernel with its pointer and
    strides (the kernel's separate-V instance)."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _latent(own_v=True)
    _call(name, q, k, v, lengths)
    (_, args), = lib.calls
    assert args[4] == v.data_ptr()
    assert (args[5], args[6]) == (200 * 512, 512)            # vb, ldv


@pytest.mark.parametrize("hd", [128, 64, 256])
@pytest.mark.parametrize("name", WRAPPERS)
def test_gqa_cache_read_in_place(fake_cuda, name, hd):
    """A GQA cache [B, S, K, hd] goes in place: kvh = K, the kv-head stride
    hd, the row stride K hd, the batch stride S K hd, S = k.shape[1]
    (unpadded), q's B K rows of G heads, and V's own pointer and
    strides."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _gqa(hd=hd)
    _call(name, q, k, v, lengths)
    (got, args), = lib.calls
    assert got == name
    Bo, S, Kv, _ = k.shape
    assert args[1] == k.data_ptr() and args[4] == v.data_ptr()
    assert (args[2], args[3]) == (S * Kv * hd, Kv * hd)      # kb, ldk
    assert (args[5], args[6]) == (S * Kv * hd, Kv * hd)      # vb, ldv
    assert args[7] == S == 200
    assert (args[9], args[10], args[11]) == (Kv, hd, hd)     # kvh, kh, vh
    at = B_AT[name]
    assert (args[at], args[at + 1]) == (Bo * Kv, q.shape[1])


@pytest.mark.parametrize("n", [1, 2, 4])
def test_partial_takes_the_plan_as_splits_of_whole_tiles(fake_cuda, n):
    """K8 takes the plan's split count and its 64-row tiles a split (rows
    past S read as zero, so the kernel walks n tps tiles over S = 200)."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _gqa()
    plan = dense_split_plan(200, 64, n)
    FD.flash_decode_partial(q, k, v, lengths, scale=0.1, plan=plan)
    (_, args), = lib.calls
    at = B_AT["flash_decode_partial"]
    assert args[at + 2] == plan.n_splits == n
    assert args[at + 3] * 64 == plan.nb_per_split * plan.block
    assert args[at + 2] * args[at + 3] * 64 >= 200


@pytest.mark.parametrize("name", WRAPPERS)
def test_failed_launch_raises(fake_cuda, name):
    """A non-zero cudaError_t from the entry raises; nothing falls back."""
    fake_cuda(_FakeLib(err=700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _call(name, *_gqa())


@pytest.mark.parametrize("name", WRAPPERS)
def test_unbuilt_width_raises(fake_cuda, name):
    """A width the library is not built at raises NotImplementedError and
    launches nothing (128 left out of the fake's list here)."""
    lib = fake_cuda(_FakeLib(widths=[(576, 512), (64, 64), (256, 256)]))
    before = getattr(FD, name).launches
    with pytest.raises(NotImplementedError, match="Dk, Dv"):
        _call(name, *_gqa())
    assert lib.calls == []
    assert getattr(FD, name).launches == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_fp32_operands_raise(fake_cuda, name):
    """The kernel takes bf16 q and KV: fp32 ones raise, launching
    nothing."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _gqa()
    with pytest.raises(NotImplementedError, match="bf16"):
        _call(name, q.float(), k.float(), v.float(), lengths)
    assert lib.calls == []


def test_entries_live_in_the_wgmma_source():
    """K7 / K8 over bf16 rows, K7q / K8q over code rows and their queries
    are defined in flash_decode_wgmma.cu alone, under their unchanged
    bindings; the mma.sync body (flash_decode.cu) is gone, and no source
    keeps an mma.sync product."""
    for name in ("flash_decode", "flash_decode_partial",
                 "flash_decode_widths", "flash_decode_attrs",
                 "flash_decode_sepv_attrs", "flash_decode_quant",
                 "flash_decode_partial_quant", "flash_decode_quant_widths",
                 "flash_decode_quant_attrs",
                 "flash_decode_quant_sepv_attrs"):
        defs = [f.name for f in sorted(CSRC.glob("*.cu"))
                if re.search(rf"\bint {name}\(", f.read_text())]
        assert defs == ["flash_decode_wgmma.cu"], (name, defs)
        assert name in build.SIGNATURES
    assert len(build.SIGNATURES["flash_decode"]) == 20
    assert len(build.SIGNATURES["flash_decode_partial"]) == 24
    assert len(build.SIGNATURES["flash_decode_quant"]) == 30
    assert len(build.SIGNATURES["flash_decode_partial_quant"]) == 34
    assert len(build.SIGNATURES["flash_decode_quant_attrs"]) == 6
    assert not (CSRC / "flash_decode.cu").exists()
    assert [f.name for f in sorted(CSRC.iterdir())
            if "mma16816" in f.read_text()] == []
    wg = (CSRC / "flash_decode_wgmma.cu").read_text()
    assert "wgmma_rs_m64n64k16" in wg and "widen_box" in wg
