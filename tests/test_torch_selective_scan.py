"""The port's selective scan (K10) against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both.  On the CPU the
port's wrapper runs its plain version, the sequential recurrence in fp32;
the reference runs its Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and its ``selective_scan_ref``.
Tolerance for y: ``atol = 1e-5``, the reference test's own (the sum over N
in another order).  The final state is the eager multiply-then-add
recurrence, so it is held bitwise to numpy's step-by-step one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.selective_scan.ops import selective_scan as jscan
from repro.kernels.selective_scan.ref import selective_scan_ref as jref
from repro_torch.kernels.selective_scan import ops, scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

SHAPES = [(2, 64, 32, 8, 16, 16),
          (1, 100, 48, 4, 32, 16),        # ragged L: y only
          (2, 256, 128, 16, 64, 64)]
IDS = ["B2-L64-N8", "ragged-L100-D48-N4", "B2-L256-N16"]


def _inputs(B, L, D, N, seed=3):
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.5, 1.0, size=(B, L, D, N)).astype(np.float32)
    dBx = (rng.normal(size=(B, L, D, N)) * 0.1).astype(np.float32)
    c = rng.normal(size=(B, L, N)).astype(np.float32)
    return dA, dBx, c


def _recurrence(dA, dBx):
    h = np.zeros(dA.shape[:1] + dA.shape[2:], np.float32)
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
    return h


@pytest.mark.parametrize("B,L,D,N,ch,db", SHAPES, ids=IDS)
def test_scan_matches_jax(B, L, D, N, ch, db):
    """ops.selective_scan against the reference's Pallas kernel (interpret
    mode) and its plain oracle; h is None exactly where the reference's is,
    and otherwise bitwise the step-by-step recurrence."""
    dA, dBx, c = _inputs(B, L, D, N)
    y, h = ops.selective_scan(*map(torch.from_numpy, (dA, dBx, c)), chunk=ch)
    jy, jh = jscan(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(c),
                   chunk=ch, d_block=db)
    assert y.dtype == torch.float32 and y.shape == (B, L, D)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jref(jnp.asarray(dA), jnp.asarray(dBx),
                                   jnp.asarray(c))), atol=1e-5)
    assert (h is None) == (jh is None) == (L % ch != 0)
    if h is not None:
        np.testing.assert_array_equal(h.numpy(), _recurrence(dA, dBx))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4)


@pytest.mark.parametrize("B,L,D,N,ch,db", SHAPES, ids=IDS)
def test_plain_ref_matches_jax_ref(B, L, D, N, ch, db):
    """The port's plain oracle against the reference's, in fp32 and fp64;
    its state is the recurrence's."""
    dA, dBx, c = _inputs(B, L, D, N, seed=7)
    t = list(map(torch.from_numpy, (dA, dBx, c)))
    y, h = selective_scan_ref(*t, return_state=True)
    want = np.asarray(jref(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(c)))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(h.numpy(), _recurrence(dA, dBx))
    y64 = selective_scan_ref(*t, dtype=torch.float64)
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y64.numpy(), want, atol=1e-5)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    """On CPU tensors the kernel wrapper is its plain version and launches
    nothing; the wrapper returns the state whatever L, ops only on chunk
    multiples."""
    dA, dBx, c = map(torch.from_numpy, _inputs(1, 13, 8, 4))
    before = scan.selective_scan.launches
    y, h = scan.selective_scan(dA, dBx, c)
    py, ph = scan.selective_scan_plain(dA, dBx, c)
    assert scan.selective_scan.launches == before
    assert torch.equal(y, py) and torch.equal(h, ph)
    assert ops.selective_scan(dA, dBx, c, chunk=8)[1] is None
    assert torch.equal(ops.selective_scan(dA, dBx, c, chunk=13)[1], h)
    assert torch.equal(ops.selective_scan(dA, dBx, c, chunk=64)[1], h)


def test_mixed_devices_refused():
    dA, dBx, c = map(torch.from_numpy, _inputs(1, 4, 8, 4))
    with pytest.raises(NotImplementedError, match="meta"):
        scan.selective_scan(dA.to("meta"), dBx.to("meta"), c.to("meta"))
    with pytest.raises(ValueError, match="operands on"):
        scan.selective_scan(dA, dBx.to("meta"), c)
