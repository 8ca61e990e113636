"""The baseline's two wrappers over code rows, their CUDA branch faked on the
CPU.

``flash_decode_quant`` (K7q) and ``flash_decode_partial_quant`` (K8q)
launch the Hopper kernel of ``kernels/csrc/flash_decode_wgmma.cu`` over
int8 / e4m3 codes (the heads on wgmma's M, a TMA ring, warp-specialised, the
codes widened in shared memory) through unchanged C entries.  Here the
wrappers see CUDA operands (``device_of`` says cuda) and a fake library that
records each call: each wrapper launches its C entry once with as many
arguments as ``build.SIGNATURES`` binds, counted on its wrapper, passing the
code type and whether q is fp32; the latent's V = ``codes[..., :512]`` goes
as null with K's pairs, a V of its own with its pointer, strides and pairs;
a GQA code cache [B, S, K, hd] and its pair cache [B, S, K, 2] go in place
with kvh = K, code strides in bytes and pair strides in floats (no copy); a
split plan reaches the kernel as its count and its 64-row tiles a split; an
unbuilt width, a q the kernel does not take and a failed launch raise; and
no wrapper reaches its plain version.  Every case runs over int8 and e4m3
codes, and with bf16 and fp32 q.  The kernel's numerics are held to the
plain versions on the card by ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.etap.schedule import dense_split_plan
from repro_torch.kernels.flash_decode import flash_decode as FD

QUANT_WIDTHS = [(576, 512), (128, 128), (64, 64)]
WRAPPERS = ("flash_decode_quant", "flash_decode_partial_quant")
CODES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
QS = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the arguments after the operand block (14) and the pairs (kz, zb, zh,
# ldz, vz, vzb, vzh, ldvz, code, qf32): out, B, H (K7q); m, l, acc, B, H,
# n, tps (K8q)
CODE_AT = 22
B_AT = {"flash_decode_quant": 25, "flash_decode_partial_quant": 27}


class _FakeLib:
    """The kernel library as the wrappers see it: the width query, and each
    entry over codes recording its arguments."""

    def __init__(self, err=0, widths=QUANT_WIDTHS):
        self.err, self.widths, self.calls = err, widths, []

    def flash_decode_quant_widths(self, buf, cap):
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


def _codes(shape, code, g):
    """Random codes of type ``code`` (int8 or e4m3) with shape ``shape``."""
    x = torch.randn(*shape, generator=g)
    return (x * 40).round().clamp(-127, 127).to(torch.int8) \
        if code == "int8" else x.to(torch.float8_e4m3fn)


def _pairs(shape, g):
    """fp32 (scale, zp) pairs [*shape, 2], scales positive."""
    return torch.stack([torch.rand(*shape, generator=g) + 0.01,
                        torch.randn(*shape, generator=g)], dim=-1)


def _latent(code, qdt, H=16, S=200, own_v=False):
    """q [B, H, 576], a dense latent code cache [B, S, 576] (S not a
    multiple of 64) and its pairs [B, S, 2]; V its first 512 code columns
    (a view, K's pairs) or a copy of them with pairs of their own."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, H, 576, generator=g).to(qdt)
    k, ks = _codes((2, S, 576), code, g), _pairs((2, S), g)
    v, vs = (k[..., :512].contiguous(), ks.clone()) if own_v else \
        (k[..., :512], ks)
    return q, k, v, ks, vs, torch.tensor([S, 37], dtype=torch.int32)


def _gqa(code, qdt, hd=128, Bo=2, S=200, Kv=4, G=3):
    """q [Bo K, G, hd], a GQA code cache k, v [Bo, S, K, hd] (S not a
    multiple of 64) and their pair caches [Bo, S, K, 2]."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(Bo * Kv, G, hd, generator=g).to(qdt)
    k, v = _codes((Bo, S, Kv, hd), code, g), _codes((Bo, S, Kv, hd), code, g)
    ks, vs = _pairs((Bo, S, Kv), g), _pairs((Bo, S, Kv), g)
    lengths = torch.full((Bo * Kv,), S, dtype=torch.int32)
    return q, k, v, ks, vs, lengths


def _operands(dk, code, qdt):
    return _latent(code, qdt) if dk == 576 else _gqa(code, qdt, hd=dk)


def _call(name, q, k, v, ks, vs, lengths, n=2):
    kw = dict(k_sz=ks, v_sz=vs, scale=0.1)
    if name == "flash_decode_quant":
        return FD.flash_decode_quant(q, k, v, lengths, **kw)
    return FD.flash_decode_partial_quant(
        q, k, v, lengths, plan=dense_split_plan(k.shape[1], 64, n), **kw)


@pytest.mark.parametrize("width", QUANT_WIDTHS, ids=str)
@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_launches_its_entry_once(fake_cuda, name, code, qname, width):
    """One call at each width: one launch of its own C entry, with as many
    arguments as build.SIGNATURES binds, the code type (0 int8, 1 e4m3)
    and whether q is fp32, counted on the wrapper; outputs in the kernel's
    shapes and types (K7q fp32 [BG, H, Dv]; K8q fp32 m, l [BG, n, H] and
    acc [BG, n, H, Dv])."""
    lib = fake_cuda(_FakeLib())
    wrapper = getattr(FD, name)
    before = wrapper.launches
    q, k, v, ks, vs, lengths = _operands(width[0], code, QS[qname])
    out = _call(name, q, k, v, ks, vs, lengths)
    assert wrapper.launches == before + 1
    assert [c[0] for c in lib.calls] == [name]
    args = lib.calls[0][1]
    assert len(args) == len(build.SIGNATURES[name])
    assert (args[12], args[13]) == width
    assert (args[CODE_AT], args[CODE_AT + 1]) == (list(CODES).index(code),
                                                  int(qname == "fp32"))
    BG, H, Dv = q.shape[0], q.shape[1], width[1]
    assert (args[B_AT[name]], args[B_AT[name] + 1]) == (BG, H)
    if name == "flash_decode_quant":
        assert out.dtype == torch.float32
        assert tuple(out.shape) == (BG, H, Dv)
    else:
        m, l, acc = out
        assert m.dtype == l.dtype == acc.dtype == torch.float32
        assert tuple(m.shape) == tuple(l.shape) == (BG, 2, H)
        assert tuple(acc.shape) == (BG, 2, H, Dv)


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_latent_fused_v_goes_as_null(fake_cuda, name, code, qname):
    """The latent's V = codes[..., :512] with K's pairs is passed as null
    (the kernel reads it from K's boxes and takes K's pairs), with S
    unpadded, K's byte strides and the pairs' float strides."""
    lib = fake_cuda(_FakeLib())
    q, k, v, ks, vs, lengths = _latent(code, QS[qname])
    _call(name, q, k, v, ks, vs, lengths)
    (_, args), = lib.calls
    assert args[1] == k.data_ptr() and args[4] is None
    assert (args[2], args[3]) == (200 * 576, 576)            # kb, ldk
    assert args[7] == 200                                    # S
    assert (args[9], args[10]) == (1, 0)                     # kvh, kh
    assert args[14] == ks.data_ptr() and args[18] is None    # kz, vz
    assert (args[15], args[17]) == (200 * 2, 2)              # zb, ldz


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_latent_own_v_goes_with_its_strides(fake_cuda, name, code):
    """A latent V in code rows of its own reaches the kernel with its
    pointer, strides and pairs (the kernel's separate-V instance)."""
    lib = fake_cuda(_FakeLib())
    q, k, v, ks, vs, lengths = _latent(code, torch.bfloat16, own_v=True)
    _call(name, q, k, v, ks, vs, lengths)
    (_, args), = lib.calls
    assert args[4] == v.data_ptr()
    assert (args[5], args[6]) == (200 * 512, 512)            # vb, ldv
    assert args[18] == vs.data_ptr()
    assert (args[19], args[21]) == (200 * 2, 2)              # vzb, ldvz


@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_gqa_code_cache_read_in_place(fake_cuda, name, code, qname, hd):
    """A GQA code cache [B, S, K, hd] and its pairs [B, S, K, 2] go in
    place: kvh = K; code strides in bytes (the batch S K hd, the row K hd,
    the kv head hd), pair strides in floats (S K 2, K 2, 2); S unpadded;
    V's own codes and pairs, no copy of either; q's B K rows of G heads."""
    lib = fake_cuda(_FakeLib())
    q, k, v, ks, vs, lengths = _gqa(code, QS[qname], hd=hd)
    _call(name, q, k, v, ks, vs, lengths)
    (got, args), = lib.calls
    assert got == name
    Bo, S, Kv, _ = k.shape
    assert args[0] != 0 and args[1] == k.data_ptr()
    assert args[4] == v.data_ptr()
    assert (args[2], args[3]) == (S * Kv * hd, Kv * hd)      # kb, ldk
    assert (args[5], args[6]) == (S * Kv * hd, Kv * hd)      # vb, ldv
    assert args[7] == S == 200
    assert (args[9], args[10], args[11]) == (Kv, hd, hd)     # kvh, kh, vh
    assert (args[12], args[13]) == (hd, hd)
    assert args[14] == ks.data_ptr() and args[18] == vs.data_ptr()
    assert tuple(args[15:18]) == (S * Kv * 2, 2, Kv * 2)     # zb, zh, ldz
    assert tuple(args[19:22]) == (S * Kv * 2, 2, Kv * 2)     # vzb, vzh, ldvz
    assert (args[B_AT[name]], args[B_AT[name] + 1]) == (Bo * Kv, q.shape[1])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("code", CODES)
def test_partial_takes_the_plan_as_splits_of_whole_tiles(fake_cuda, code, n):
    """K8q takes the plan's split count and its 64-row tiles a split (rows
    past S read as zero, so the kernel walks n tps tiles over S = 200)."""
    lib = fake_cuda(_FakeLib())
    q, k, v, ks, vs, lengths = _gqa(code, torch.float32)
    plan = dense_split_plan(200, 64, n)
    FD.flash_decode_partial_quant(q, k, v, lengths, k_sz=ks, v_sz=vs,
                                  scale=0.1, plan=plan)
    (_, args), = lib.calls
    at = B_AT["flash_decode_partial_quant"]
    assert args[at + 2] == plan.n_splits == n
    assert args[at + 3] * 64 == plan.nb_per_split * plan.block
    assert args[at + 2] * args[at + 3] * 64 >= 200


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_failed_launch_raises(fake_cuda, name, code):
    """A non-zero cudaError_t from the entry raises; nothing falls back."""
    fake_cuda(_FakeLib(err=700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _call(name, *_gqa(code, torch.float32))


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("name", WRAPPERS)
def test_unbuilt_width_raises(fake_cuda, name, qname):
    """A width the library is not built at raises NotImplementedError and
    launches nothing (128 left out of the fake's list here, and 256, which
    QuantDenseWidths does not hold)."""
    lib = fake_cuda(_FakeLib(widths=[(576, 512), (64, 64)]))
    before = getattr(FD, name).launches
    for hd in (128, 256):
        with pytest.raises(NotImplementedError, match="Dk, Dv"):
            _call(name, *_gqa("int8", QS[qname], hd=hd))
    assert lib.calls == []
    assert getattr(FD, name).launches == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_q_type_the_kernel_does_not_take_raises(fake_cuda, name):
    """q in fp16 (the kernel takes bf16 or fp32 q over codes) raises
    NotImplementedError and launches nothing."""
    lib = fake_cuda(_FakeLib())
    before = getattr(FD, name).launches
    with pytest.raises(NotImplementedError, match="bf16 or fp32 q"):
        _call(name, *_gqa("e4m3", torch.float16))
    assert lib.calls == []
    assert getattr(FD, name).launches == before
