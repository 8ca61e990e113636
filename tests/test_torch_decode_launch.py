"""The four bf16 ETAP decode wrappers' CUDA branch, faked on the CPU.

``etap_decode_mla_paged`` (K3), ``etap_paged_partial`` (K1),
``etap_decode_dense`` with its fused form ``etap_decode_mla_dense`` (K5)
and ``etap_partial_dense`` (K6) launch the Hopper kernel of
``kernels/csrc/etap_decode.cuh`` through unchanged C entries.  Here the
wrappers see CUDA operands (``device_of`` says cuda) and a fake library
that records each call: each wrapper launches its C entry once with as many
arguments as ``build.SIGNATURES`` binds, counted on its wrapper; a GQA
cache [B, S, K, hd] goes in place with kvh = K, its strides and its own S
(no padded copy); a failed launch and an unbuilt width raise; and no
wrapper reaches its plain version.  The kernels' numerics are held to the
plain versions on the card by ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.etap import etap as K
from repro_torch.kernels.etap.schedule import dense_split_plan

DENSE_WIDTHS = [(576, 512), (128, 128), (64, 64), (256, 256)]
WRAPPERS = ("etap_decode_mla_paged", "etap_paged_partial",
            "etap_decode_dense", "etap_partial_dense")


class _FakeLib:
    """The kernel library as the wrappers see it: the shape and width
    queries, and each decode entry recording its arguments."""

    def __init__(self, err=0, widths=DENSE_WIDTHS):
        self.err, self.widths, self.calls = err, widths, []

    def etap_dk(self):
        return 576

    def etap_dv(self):
        return 512

    def etap_page(self):
        return 64

    def etap_dense_widths(self, buf, cap):
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


def _latent(B=2, nb=3):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, 16, 576, generator=g).bfloat16()
    pool = torch.randn(1 + B * nb, 64, 576, generator=g).bfloat16()
    table = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    lengths = torch.tensor([150, 1], dtype=torch.int32)[:B]
    return q, pool, table, lengths


def _gqa(hd=128, Bo=2, S=200, Kv=4, G=3):
    """q [Bo K, G, hd] and a GQA cache k, v [Bo, S, K, hd] (S not a
    multiple of 64)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(Bo * Kv, G, hd, generator=g).bfloat16()
    k = torch.randn(Bo, S, Kv, hd, generator=g).bfloat16()
    v = torch.randn(Bo, S, Kv, hd, generator=g).bfloat16()
    lengths = torch.full((Bo * Kv,), S, dtype=torch.int32)
    return q, k, v, lengths


def _call(name, **kw):
    """Wrapper ``name`` on the fake card; returns its result."""
    if name in ("etap_decode_mla_paged", "etap_paged_partial"):
        q, pool, table, lengths = _latent()
        extra = {"n_splits": 3} if name == "etap_paged_partial" else {}
        return getattr(K, name)(q, pool, 512, table, lengths, scale=0.1,
                                **extra, **kw)
    q, k, v, lengths = _gqa()
    if name == "etap_decode_dense":
        return K.etap_decode_dense(q, k, v, lengths, scale=0.1, **kw)
    return K.etap_partial_dense(q, k, v, lengths, scale=0.1,
                                plan=dense_split_plan(200, 64, 2), **kw)


@pytest.mark.parametrize("name", WRAPPERS)
def test_launches_its_entry_once(fake_cuda, name):
    """One call: one launch of its own C entry, with as many arguments as
    build.SIGNATURES binds, counted on the wrapper; outputs in the kernels'
    shapes and types."""
    lib = fake_cuda(_FakeLib())
    wrapper = getattr(K, name)
    before = wrapper.launches
    out = _call(name)
    assert wrapper.launches == before + 1
    assert [c[0] for c in lib.calls] == [name]
    assert len(lib.calls[0][1]) == len(build.SIGNATURES[name])
    if name in ("etap_paged_partial", "etap_partial_dense"):
        m, l, acc = out
        n = 3 if name == "etap_paged_partial" else 2
        assert m.dtype == l.dtype == acc.dtype == torch.float32
        assert acc.shape[1] == n and m.shape == l.shape
    else:
        assert out.dtype == torch.bfloat16


def test_mla_dense_counts_as_k5_and_passes_v_as_null(fake_cuda):
    """etap_decode_mla_dense is K5 over one latent stream: V = kv[..., :512]
    is passed as null (read from K's rows), counted on etap_decode_dense."""
    lib = fake_cuda(_FakeLib())
    g = torch.Generator().manual_seed(2)
    kv = torch.randn(2, 100, 576, generator=g).bfloat16()
    q = torch.randn(2, 16, 576, generator=g).bfloat16()
    lengths = torch.tensor([100, 37], dtype=torch.int32)
    before = K.etap_decode_dense.launches
    out = K.etap_decode_mla_dense(q, kv, 512, lengths, scale=0.1)
    assert K.etap_decode_dense.launches == before + 1
    (name, args), = lib.calls
    assert name == "etap_decode_dense"
    assert len(args) == len(build.SIGNATURES[name])
    assert args[4] is None                      # v: K's first 512 columns
    assert args[7] == 100                       # S: not padded to 64
    assert (args[12], args[13]) == (576, 512)
    assert tuple(out.shape) == (2, 16, 512)


@pytest.mark.parametrize("name", ["etap_decode_dense", "etap_partial_dense"])
@pytest.mark.parametrize("hd", [128, 64, 256])
def test_gqa_cache_read_in_place(fake_cuda, name, hd):
    """A GQA cache [B, S, K, hd] goes in place: kvh = K, the kv-head stride
    hd, the row stride K hd, the batch stride S K hd, S = k.shape[1]
    (unpadded), q's B K rows, and V's own pointer and strides."""
    lib = fake_cuda(_FakeLib())
    q, k, v, lengths = _gqa(hd=hd)
    if name == "etap_decode_dense":
        K.etap_decode_dense(q, k, v, lengths, scale=0.1)
    else:
        K.etap_partial_dense(q, k, v, lengths, scale=0.1,
                             plan=dense_split_plan(200, 64, 2))
    (got, args), = lib.calls
    assert got == name
    Bo, S, Kv, _ = k.shape
    assert args[1] == k.data_ptr() and args[4] == v.data_ptr()
    assert (args[2], args[3]) == (S * Kv * hd, Kv * hd)      # kb, ldk
    assert (args[5], args[6]) == (S * Kv * hd, Kv * hd)      # vb, ldv
    assert args[7] == S == 200
    assert (args[9], args[10], args[11]) == (Kv, hd, hd)     # kvh, kh, vh
    assert (args[12], args[13]) == (hd, hd)
    # B rows of G columns: q's [B K, G, hd] (after out, or m, l, acc)
    at = 15 if name == "etap_decode_dense" else 17
    assert (args[at], args[at + 1]) == (Bo * Kv, q.shape[1])


@pytest.mark.parametrize("name", WRAPPERS)
def test_failed_launch_raises(fake_cuda, name):
    """A non-zero cudaError_t from the entry raises; nothing falls back."""
    fake_cuda(_FakeLib(err=700))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        _call(name)


@pytest.mark.parametrize("name", WRAPPERS)
def test_unbuilt_width_raises(fake_cuda, name):
    """A width the library is not built at raises NotImplementedError and
    launches nothing: the paged entries take the latent only (q and pool
    at 128 here), the dense ones the library's DenseWidths (128 left out
    of the fake's list here)."""
    lib = fake_cuda(_FakeLib(widths=[(576, 512), (64, 64), (256, 256)]))
    before = getattr(K, name).launches
    g = torch.Generator().manual_seed(3)
    if name in ("etap_decode_mla_paged", "etap_paged_partial"):
        q = torch.randn(2, 16, 128, generator=g).bfloat16()
        pool = torch.randn(5, 64, 128, generator=g).bfloat16()
        table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        lengths = torch.tensor([100, 3], dtype=torch.int32)
        extra = {"n_splits": 2} if name == "etap_paged_partial" else {}
        with pytest.raises(NotImplementedError, match="Dk, Dv"):
            getattr(K, name)(q, pool, 128, table, lengths, scale=0.1, **extra)
    else:
        with pytest.raises(NotImplementedError, match="Dk, Dv"):
            _call(name)
    assert lib.calls == []
    assert getattr(K, name).launches == before
