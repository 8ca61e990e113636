"""Fixed-row products (``models.layers.ROW_TILE``): on CUDA a product of
fewer than ROW_TILE rows runs over ROW_TILE rows, so a decode step's row
keeps its bits whatever the batch (cuBLAS picks its kernel by the row
count; ROADMAP section C, C2).  The CPU keeps its products as they are;
these tests turn the padding on there (``layers._pads``) and check the
values, the shapes, the gradient and the contended serve trace through
it.  On the card ``chip_smoke.py`` checks the bits (its row-bits and C2
phases)."""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import mla
from repro_torch.launch import serve
from repro_torch.models import layers, model

T = layers.ROW_TILE


@pytest.fixture
def padded(monkeypatch):
    """Pad on the CPU too, and record the row count each product saw."""
    seen = []
    real = layers.fixed_rows

    def spy(x, f):
        def g(a):
            seen.append(a.shape[0])
            return f(a)
        return real(x, g)
    monkeypatch.setattr(layers, "_pads", lambda x: True)
    monkeypatch.setattr(layers, "fixed_rows", spy)
    return seen


@pytest.mark.parametrize("lead", [(1,), (3,), (15,), (2, 1), (3, 5), (16,),
                                  (40,), (2, 9)])
def test_dense_and_unembed_pad_short_products(padded, lead):
    """A product of n < ROW_TILE rows runs over ROW_TILE; n >= ROW_TILE
    runs as it is.  Values within 1e-5 of the bare fp32 product (a row's
    sum may run in another order), shapes as the bare product's."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*lead, 24, generator=gen)
    w = torch.randn(24, 40, generator=gen)
    table = torch.randn(50, 24, generator=gen)
    n = x.numel() // 24
    for got, want in ((layers.dense(x, w), x @ w),
                      (layers.unembed(table, x), x @ table.T)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert padded == ([T, T] if n < T else [])


def test_fixed_rows_pads_dim_0(padded):
    """The absorptions' batched einsum: dim 0 padded, the rest kept."""
    gen = torch.Generator().manual_seed(1)
    a = torch.randn(3, 4, 8, generator=gen)
    w = torch.randn(6, 4, 8, generator=gen)

    def uk(t):
        return torch.einsum("bhd,chd->bhc", t, w)
    got = layers.fixed_rows(a, uk)
    assert padded == [T] and got.shape == (3, 4, 6)
    torch.testing.assert_close(got, uk(a), rtol=1e-5, atol=1e-5)


def test_padding_keeps_the_gradient(padded):
    """Gradients through the padded product: x's within 1e-5 of the bare
    product's, the pad rows' dropped."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 24, generator=gen, requires_grad=True)
    w = torch.randn(24, 40, generator=gen, requires_grad=True)
    g = torch.randn(3, 40, generator=gen)
    got = torch.autograd.grad(layers.dense(x, w), (x, w), g)
    want = torch.autograd.grad(x @ w, (x, w), g)
    assert padded == [T]
    for a, b in zip(got, want, strict=True):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_cpu_products_unpadded():
    """Without the patch a CPU product runs over its own rows."""
    x, w = torch.ones(3, 4), torch.ones(4, 5)
    seen = []
    out = layers.fixed_rows(x, lambda a: seen.append(a.shape[0]) or a @ w)
    assert seen == [3] and out.shape == (3, 5)
    assert not layers._pads(x)


C2 = ["--reduced", "--prompt", "24", "--gen", "8", "--requests", "6",
      "--page-size", "8", "--prefill-chunk", "8", "--arrival-rate", "0.25",
      "--trace", "burst", "--burst-size", "3", "--retry-backoff", "4",
      "--paranoia", "1", "--device", "cpu"]


def test_contended_trace_through_fixed_rows(padded, monkeypatch):
    """The reference's contended trace served with every decode product
    padded: swap, recompute and the unpreempted run at batch 2 give the
    calm batch-8 run's outputs bitwise, as ``chip_smoke.py``'s C2 asks on
    the card; the decode steps' products and absorptions ran over
    ROW_TILE rows."""
    cfg = dataclasses.replace(reduced(get_config("deepseek_r1_671b")),
                              moe=None)
    params = model.init(cfg, seed=3, device="cpu")
    absorbed = []
    real = mla._absorbed_out

    def out(params, cfg, o_lat, dtype):
        absorbed.append(o_lat.shape[0])
        return real(params, cfg, o_lat, dtype)
    monkeypatch.setattr(mla, "_absorbed_out", out)

    def run(extra):
        return serve.run_paged(serve.parse_args(C2 + extra), cfg,
                               params=params, device="cpu")
    calm = run(["--batch", "8", "--priority-classes", "3"])
    assert calm["sched"]["preemptions"] == 0 and len(calm["outputs"]) == 6
    for extra in (["--batch", "2"],
                  ["--batch", "2", "--priority-classes", "3",
                   "--preemption", "swap"],
                  ["--batch", "2", "--priority-classes", "3",
                   "--preemption", "recompute"]):
        got = run(extra)
        assert bool(got["sched"]["preemptions"]) == ("--preemption" in extra)
        assert got["outputs"] == calm["outputs"], extra
    assert absorbed and max(absorbed) < T
    assert padded and min(padded) == T
