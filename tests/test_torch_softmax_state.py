"""The port's online-softmax state API against the JAX one, and the
reference's bitwise properties on the exact-arithmetic lattice.

Against JAX (same numpy inputs): fp32 ``atol = rtol = 1e-6`` — the same
elementwise operations, reductions in another order.  On the lattice
(scores in {0, NEG_INF}, small-integer values) every probability is exactly
0 or 1 and every sum exact, so any split geometry or merge order must
finalize bitwise equal, in both modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import softmax_state as jss
from repro_torch.kernels import softmax_state as ss

MODES = list(ss.MODES)
TOL = dict(atol=1e-6, rtol=1e-6)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_bitwise(a, b, msg=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=msg)


def _lattice(S, H, Dv, rng):
    """{0, NEG_INF} scores (row 0 live: no fully masked column) and
    small-integer values."""
    mask = rng.random((S, H)) < 0.5
    mask[0, :] = True
    s = torch.where(torch.from_numpy(mask), 0.0, ss.NEG_INF).float()
    v = torch.from_numpy(rng.integers(-4, 5, size=(S, Dv))).float()
    return s, v


def _state_of(s, v, mode):
    H, Dv = s.shape[1], v.shape[1]
    return ss.update(ss.init((H,), (Dv, H), device="cpu"), s,
                     lambda p: torch.einsum("sv,sh->vh", v, p),
                     axis=0, mode=mode)


def _chunks(rng, S):
    cuts = sorted(rng.choice(np.arange(1, S), size=rng.integers(0, S - 1),
                             replace=False).tolist())
    return list(zip([0] + cuts, cuts + [S], strict=True))


# ----------------------------------------------------------- mode plumbing
def test_constants_match_reference():
    assert ss.NEG_INF == jss.NEG_INF and ss.LOG2E == jss.LOG2E
    assert ss.MODES == jss.MODES


def test_invalid_mode_rejected():
    with pytest.raises(ValueError):
        ss.resolve("bogus")
    with pytest.raises(ValueError):
        ss.set_default_mode("nope")


def test_default_mode_roundtrip():
    prev = ss.default_mode()
    try:
        ss.set_default_mode("mul")
        assert ss.default_mode() == "mul" and ss.resolve(None) == "mul"
        assert ss.resolve("amla") == "amla"
    finally:
        ss.set_default_mode(prev)


def test_rescale_env_default_honoured():
    """REPRO_RESCALE picks the process default at import."""
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    out = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels import "
         "softmax_state as s; print(s.default_mode())"],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 REPRO_RESCALE="mul"),
        text=True, capture_output=True, check=True, cwd=root)
    assert out.stdout.strip() == "mul"


# ----------------------------------------------------- against the JAX API
@pytest.mark.parametrize("mode", MODES)
def test_update_finalize_match_jax(mode):
    """Two chained updates in the Pallas (keepdims) orientation — one with
    masked rows — then finalize, against the reference."""
    rng = np.random.default_rng(0)
    S, H, Dv = 16, 5, 7
    blocks = []
    for i in range(2):
        s = rng.normal(scale=3.0, size=(S, H)).astype(np.float32)
        if i:
            s[S // 2:] = ss.NEG_INF
        blocks.append((s, rng.normal(size=(S, Dv)).astype(np.float32)))
    jstate = jss.init((1, H), (Dv, H))
    tstate = ss.init((1, H), (Dv, H), device="cpu")
    for s, v in blocks:
        jstate = jss.update(jstate, jnp.asarray(s),
                            lambda p, v=v: jnp.asarray(v).T @ p,
                            axis=0, mode=mode)
        tstate = ss.update(tstate, torch.from_numpy(s),
                           lambda p, v=v: torch.from_numpy(v).T @ p,
                           axis=0, mode=mode)
        for t, j in zip(tstate, jstate, strict=True):
            np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)
    np.testing.assert_allclose(np.asarray(ss.finalize(tstate)),
                               np.asarray(jss.finalize(jstate)), **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_merge_splits_and_merge_match_jax(mode):
    rng = np.random.default_rng(1)
    n, H, Dv = 4, 3, 6
    m = rng.normal(scale=4.0, size=(n, H)).astype(np.float32)
    if mode == "amla":
        m = np.ceil(m)
    m[2] = ss.NEG_INF                                   # a masked split
    l = rng.random((n, H)).astype(np.float32) * 10
    l[2] = 0
    acc = rng.normal(size=(n, Dv, H)).astype(np.float32)
    kw = dict(axis=0, mode=mode)
    got = ss.merge_splits(*(torch.from_numpy(x) for x in (m, l, acc)),
                          expand=lambda w: w[:, None, :], **kw)
    want = jss.merge_splits(*(jnp.asarray(x) for x in (m, l, acc)),
                            expand=lambda w: w[:, None, :], **kw)
    for t, j in zip(got, want, strict=True):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)
    a = tuple(torch.from_numpy(x[0]) for x in (m, l, acc))
    b = tuple(torch.from_numpy(x[1]) for x in (m, l, acc))
    ja = tuple(jnp.asarray(x[0]) for x in (m, l, acc))
    jb = tuple(jnp.asarray(x[1]) for x in (m, l, acc))
    for t, j in zip(ss.merge(a, b, mode=mode, expand=lambda w: w[None, :]),
                    jss.merge(ja, jb, mode=mode, expand=lambda w: w[None, :]),
                    strict=True):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **TOL)


# ---------------------------------------------------- lattice properties
@pytest.mark.parametrize("mode", MODES)
def test_chunked_update_bitwise_on_lattice(mode):
    for trial in range(8):
        rng = np.random.default_rng(trial)
        S = int(rng.integers(2, 13))
        s, v = _lattice(S, 3, 2, rng)
        whole = _state_of(s, v, mode)
        state = ss.init((3,), (2, 3), device="cpu")
        for lo, hi in _chunks(rng, S):
            vc = v[lo:hi]
            state = ss.update(state, s[lo:hi],
                              lambda p, vc=vc: torch.einsum("sv,sh->vh",
                                                            vc, p),
                              axis=0, mode=mode)
        _assert_bitwise(ss.finalize(state), ss.finalize(whole),
                        f"mode={mode} trial={trial}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(6))
def test_merge_split_order_invariant_on_lattice(mode, seed):
    """Any split geometry, any merge order (a fold over a permutation, or
    the stacked merge_splits) finalizes bitwise equal to one pass."""
    rng = np.random.default_rng(1000 + seed)
    S = int(rng.integers(2, 13))
    s, v = _lattice(S, 3, 2, rng)
    want = ss.finalize(_state_of(s, v, mode))
    parts = [_state_of(s[lo:hi], v[lo:hi], mode)
             for lo, hi in _chunks(rng, S)]
    order = rng.permutation(len(parts))
    folded = parts[order[0]]
    for i in order[1:]:
        folded = ss.merge(folded, parts[int(i)], mode=mode)
    _assert_bitwise(ss.finalize(folded), want, f"fold {order.tolist()}")
    stacked = [torch.stack(x) for x in zip(*parts, strict=True)]
    merged = ss.merge_splits(*stacked, axis=0, mode=mode,
                             expand=lambda w: w[:, None, :])
    _assert_bitwise(ss.finalize(merged), want, "merge_splits")


@pytest.mark.parametrize("mode", MODES)
def test_merge_associative_commutative_on_lattice(mode):
    for trial in range(8):
        rng = np.random.default_rng(100 + trial)
        a, b, c = [_state_of(*_lattice(int(rng.integers(1, 9)), 3, 2, rng),
                             mode) for _ in range(3)]
        ab_c = ss.merge(ss.merge(a, b, mode=mode), c, mode=mode)
        a_bc = ss.merge(a, ss.merge(b, c, mode=mode), mode=mode)
        for x, y in zip(ab_c, a_bc, strict=True):
            _assert_bitwise(x, y, f"associativity, mode={mode}")
        for x, y in zip(ss.merge(a, b, mode=mode), ss.merge(b, a, mode=mode),
                        strict=True):
            _assert_bitwise(x, y, f"commutativity, mode={mode}")


@pytest.mark.parametrize("mode", MODES)
def test_masked_split_drops_out(mode):
    rng = np.random.default_rng(3)
    real = _state_of(*_lattice(8, 3, 2, rng), mode)
    junk = (torch.full((3,), ss.NEG_INF), torch.zeros(3),
            torch.full((2, 3), 1e20))
    for merged in (ss.merge(real, junk, mode=mode),
                   ss.merge(junk, real, mode=mode)):
        for x, y in zip(merged, real, strict=True):
            _assert_bitwise(x, y, f"masked split leaked, mode={mode}")


def test_merge_upcasts_half_precision_stats():
    rng = np.random.default_rng(4)
    parts = [_state_of(*_lattice(8, 3, 2, rng), "amla") for _ in range(2)]
    stacked = [torch.stack(x) for x in zip(*parts, strict=True)]
    want = ss.merge_splits(*stacked, axis=0, mode="amla",
                           expand=lambda w: w[:, None, :])
    got = ss.merge_splits(*(x.to(torch.bfloat16) for x in stacked), axis=0,
                          mode="amla", expand=lambda w: w[:, None, :])
    for x, y in zip(got, want, strict=True):
        assert x.dtype == torch.float32
        _assert_bitwise(x, y, "bf16 stats changed the merge")


@pytest.mark.parametrize("mode", MODES)
def test_merge_split_order_allclose_general_floats(mode):
    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.normal(scale=3.0, size=(96, 4))).float()
    v = torch.from_numpy(rng.normal(size=(96, 8))).float()
    want = np.asarray(ss.finalize(_state_of(s, v, mode)))
    for trial in range(4):
        parts = [_state_of(s[lo:hi], v[lo:hi], mode)
                 for lo, hi in _chunks(np.random.default_rng(trial), 96)]
        folded = parts[0]
        for p in parts[1:]:
            folded = ss.merge(folded, p, mode=mode)
        np.testing.assert_allclose(np.asarray(ss.finalize(folded)), want,
                                   atol=1e-5, rtol=1e-5)
