"""The six quantized ETAP decode wrappers' CUDA branch, faked on the CPU.

``etap_decode_mla_paged_quant`` (K3q), ``etap_paged_partial_quant`` (K1q),
``etap_decode_dense_quant`` (K5q), ``etap_partial_dense_quant`` (K6q),
``etap_decode_paged_quant`` and ``etap_paged_partial_sepv_quant`` (K3q /
K1q over separate K and V code pools) launch the Hopper kernel of
``kernels/csrc/etap_decode.cuh`` over int8 / e4m3 codes through unchanged
C entries.  Here the wrappers see CUDA operands (``device_of`` says cuda)
and a fake library that records each call: each wrapper launches its C
entry once with as many arguments as ``build.SIGNATURES`` binds, counted on
its wrapper, passing the pools' code type and whether q is fp32; a GQA code
cache [B, S, K, hd] and its pair cache [B, S, K, 2] go in place with kvh =
K, code strides in bytes, pair strides in floats and their own S (no
copy); an unbuilt width, a q the kernels do not take and a failed launch
raise; and no wrapper reaches its plain version.  Every case runs over
int8 and e4m3 codes, and with bf16 and fp32 q.  The kernels' numerics are
held to the plain versions on the card by ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.etap import etap as K
from repro_torch.kernels.etap.schedule import dense_split_plan

DENSE_WIDTHS = [(128, 128), (64, 64)]
SEPV_WIDTHS = [(576, 512), (128, 128)]
PAGED = ("etap_decode_mla_paged_quant", "etap_paged_partial_quant")
DENSE = ("etap_decode_dense_quant", "etap_partial_dense_quant")
SEPV = ("etap_decode_paged_quant", "etap_paged_partial_sepv_quant")
WRAPPERS = PAGED + DENSE + SEPV
SPLITS = ("etap_paged_partial_quant", "etap_partial_dense_quant",
          "etap_paged_partial_sepv_quant")
# where each entry takes the code type (q is fp32 follows it)
CODE_AT = {"etap_decode_mla_paged_quant": 11, "etap_paged_partial_quant": 14,
           "etap_decode_dense_quant": 22, "etap_partial_dense_quant": 22,
           "etap_decode_paged_quant": 15,
           "etap_paged_partial_sepv_quant": 18}
CODES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn}
QS = {"bf16": torch.bfloat16, "fp32": torch.float32}


class _FakeLib:
    """The kernel library as the wrappers see it: the shape and width
    queries, and each quantized decode entry recording its arguments."""

    def __init__(self, err=0, dense=DENSE_WIDTHS, sepv=SEPV_WIDTHS):
        self.err, self.dense, self.sepv, self.calls = err, dense, sepv, []

    def etap_dk(self):
        return 576

    def etap_dv(self):
        return 512

    def etap_page(self):
        return 64

    @staticmethod
    def _widths(pairs, buf):
        for i, (dk, dv) in enumerate(pairs):
            buf[2 * i], buf[2 * i + 1] = dk, dv
        return len(pairs)

    def etap_dense_quant_widths(self, buf, cap):
        return self._widths(self.dense, buf)

    def etap_paged_sepv_widths(self, buf, cap):
        return self._widths(self.sepv, buf)

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
    monkeypatch.setattr(K, "device_of", lambda *t: _Cuda("cpu"))
    monkeypatch.setattr(K, "stream", lambda dev: 0)
    monkeypatch.setattr(launch, "stream", lambda dev: 0)

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    for name in WRAPPERS:
        monkeypatch.setattr(K, name + "_plain", no_fallback)

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


def _paged(code, qdt, dk=576, dv=512, B=2, nb=3):
    """q [B, 16, dk] and a code pool [N, 64, dk] with its pairs, a V pool
    [N, 64, dv] with its own, a table [B, nb] and lengths [B]."""
    g = torch.Generator().manual_seed(0)
    N = 1 + B * nb
    q = torch.randn(B, 16, dk, generator=g).to(qdt)
    pool, sz = _codes((N, 64, dk), code, g), _pairs((N, 64), g)
    vpool, vsz = _codes((N, 64, dv), code, g), _pairs((N, 64), g)
    table = torch.arange(1, N, dtype=torch.int32).reshape(B, nb)
    lengths = torch.tensor([150, 1], dtype=torch.int32)[:B]
    return q, pool, sz, vpool, vsz, table, lengths


def _gqa(code, qdt, hd=128, Bo=2, S=200, Kv=4, G=3):
    """q [Bo K, G, hd], a GQA code cache k, v [Bo, S, K, hd] (S not a
    multiple of 64) and their pair caches [Bo, S, K, 2]."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(Bo * Kv, G, hd, generator=g).to(qdt)
    k, v = _codes((Bo, S, Kv, hd), code, g), _codes((Bo, S, Kv, hd), code, g)
    ks, vs = _pairs((Bo, S, Kv), g), _pairs((Bo, S, Kv), g)
    lengths = torch.full((Bo * Kv,), S, dtype=torch.int32)
    return q, k, v, ks, vs, lengths


def _call(name, code, qdt, **kw):
    """Wrapper ``name`` on the fake card over ``code`` codes with q of
    ``qdt``; returns its result."""
    if name in PAGED:
        q, pool, sz, _, _, table, lengths = _paged(code, qdt)
        extra = {"n_splits": 3} if name in SPLITS else {}
        return getattr(K, name)(q, pool, sz, 512, table, lengths, scale=0.1,
                                **extra, **kw)
    if name in SEPV:
        q, pool, sz, vpool, vsz, table, lengths = _paged(code, qdt)
        extra = {"n_splits": 3} if name in SPLITS else {}
        return getattr(K, name)(q, pool, sz, vpool, vsz, table, lengths,
                                scale=0.1, **extra, **kw)
    q, k, v, ks, vs, lengths = _gqa(code, qdt)
    extra = {"plan": dense_split_plan(200, 64, 2)} if name in SPLITS else {}
    return getattr(K, name)(q, k, v, lengths, k_sz=ks, v_sz=vs, scale=0.1,
                            **extra, **kw)


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_launches_its_entry_once(fake_cuda, name, code, qname):
    """One call: one launch of its own C entry, with as many arguments as
    build.SIGNATURES binds, the pools' code type (0 int8, 1 e4m3) and
    whether q is fp32, counted on the wrapper; outputs in the kernels'
    shapes and types (the paged single passes in q's type, the dense one
    fp32, the splits' stats fp32)."""
    lib = fake_cuda(_FakeLib())
    wrapper = getattr(K, name)
    before = wrapper.launches
    out = _call(name, code, QS[qname])
    assert wrapper.launches == before + 1
    assert [c[0] for c in lib.calls] == [name]
    args = lib.calls[0][1]
    assert len(args) == len(build.SIGNATURES[name])
    at = CODE_AT[name]
    assert (args[at], args[at + 1]) == (list(CODES).index(code),
                                        int(qname == "fp32"))
    if name in SPLITS:
        m, l, acc = out
        n = 2 if name in DENSE else 3
        assert m.dtype == l.dtype == acc.dtype == torch.float32
        assert acc.shape[1] == n and m.shape == l.shape
        assert acc.shape[2] == (128 if name in DENSE else 512)
    else:
        want = torch.float32 if name in DENSE else QS[qname]
        assert out.dtype == want


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", DENSE)
def test_gqa_code_cache_read_in_place(fake_cuda, name, code, qname):
    """A GQA code cache [B, S, K, hd] and its pairs [B, S, K, 2] go in
    place: kvh = K; code strides in bytes (the batch S K hd, the row K hd,
    the kv head hd), pair strides in floats (S K 2, K 2, 2); S unpadded;
    V's own codes and pairs, no copy of either."""
    lib = fake_cuda(_FakeLib())
    q, k, v, ks, vs, lengths = _gqa(code, QS[qname])
    if name == "etap_decode_dense_quant":
        K.etap_decode_dense_quant(q, k, v, lengths, k_sz=ks, v_sz=vs,
                                  scale=0.1)
    else:
        K.etap_partial_dense_quant(q, k, v, lengths, k_sz=ks, v_sz=vs,
                                   scale=0.1,
                                   plan=dense_split_plan(200, 64, 2))
    (got, args), = lib.calls
    assert got == name
    Bo, S, Kv, hd = k.shape
    assert args[1] == k.data_ptr() and args[4] == v.data_ptr()
    assert (args[2], args[3]) == (S * Kv * hd, Kv * hd)      # kb, ldk
    assert (args[5], args[6]) == (S * Kv * hd, Kv * hd)      # vb, ldv
    assert args[7] == S == 200
    assert (args[9], args[10], args[11]) == (Kv, hd, hd)     # kvh, kh, vh
    assert (args[12], args[13]) == (hd, hd)
    assert args[14] == ks.data_ptr() and args[18] == vs.data_ptr()
    assert tuple(args[15:18]) == (S * Kv * 2, 2, Kv * 2)     # zb, zh, ldz
    assert tuple(args[19:22]) == (S * Kv * 2, 2, Kv * 2)     # vzb, vzh, ldvz
    # B rows of G columns: q's [B K, G, hd] (after out, or m, l, acc)
    at = 25 if name == "etap_decode_dense_quant" else 27
    assert (args[at], args[at + 1]) == (Bo * Kv, q.shape[1])


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("name", WRAPPERS)
def test_failed_launch_raises(fake_cuda, name, code):
    """A non-zero cudaError_t from the entry raises; nothing falls back."""
    fake_cuda(_FakeLib(err=700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _call(name, code, torch.float32)


@pytest.mark.parametrize("qname", QS)
@pytest.mark.parametrize("name", WRAPPERS)
def test_unbuilt_width_raises(fake_cuda, name, qname):
    """A width the library is not built at raises NotImplementedError and
    launches nothing: the fused paged entries take the latent only (q and
    pool at 128 here), the dense ones EtapQuantDenseWidths (128 left out
    of the fake's list), the separate-V ones PagedSepWidths (128 left
    out)."""
    lib = fake_cuda(_FakeLib(dense=[(64, 64)], sepv=[(576, 512)]))
    before = getattr(K, name).launches
    qdt = QS[qname]
    if name in PAGED:
        q, pool, sz, _, _, table, lengths = _paged("int8", qdt, dk=128,
                                                   dv=128)
        extra = {"n_splits": 3} if name in SPLITS else {}
        with pytest.raises(NotImplementedError, match="Dk, Dv"):
            getattr(K, name)(q, pool, sz, 128, table, lengths, scale=0.1,
                             **extra)
    elif name in SEPV:
        q, pool, sz, vpool, vsz, table, lengths = _paged("int8", qdt,
                                                         dk=128, dv=128)
        extra = {"n_splits": 3} if name in SPLITS else {}
        with pytest.raises(NotImplementedError, match="PagedSepWidths"):
            getattr(K, name)(q, pool, sz, vpool, vsz, table, lengths,
                             scale=0.1, **extra)
    else:
        with pytest.raises(NotImplementedError, match="Dk, Dv"):
            _call(name, "int8", qdt)
    assert lib.calls == []
    assert getattr(K, name).launches == before


@pytest.mark.parametrize("name", WRAPPERS)
def test_q_type_the_kernels_do_not_take_raises(fake_cuda, name):
    """q in fp16 (the kernels take bf16 or fp32 q over codes) raises
    NotImplementedError and launches nothing."""
    lib = fake_cuda(_FakeLib())
    before = getattr(K, name).launches
    with pytest.raises(NotImplementedError, match="bf16 or fp32 q"):
        _call(name, "e4m3", torch.float16)
    assert lib.calls == []
    assert getattr(K, name).launches == before
