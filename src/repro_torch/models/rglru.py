"""RG-LRU recurrent block (RecurrentGemma / Griffin) — the port of
``repro/models/rglru.py``: a GeLU gate branch, and a recurrence branch of a
causal depthwise conv1d (k = 4) followed by the gated linear recurrence
h_t = a_t h_{t-1} + b_t with b_t = sqrt(1 - a_t^2) i_t x_t.  The sequence
form scans the recurrence over the sequence axis; decode is one step of
it.

The reference has no Pallas kernel here (its sequence form is
``jax.lax.associative_scan``), so the port is plain torch.  The sequence
scan is a log-depth Hillis-Steele scan, ceil(log2 S) steps of
(a, b) <- (a_prev a, b_prev a + b) over the whole [B, S, W] tensors, not a
Python loop over S (a 4096-token prompt through RecurrentGemma's 26 RG-LRU
layers would be about 100 k launches).  It sums in another order than the
reference's associative scan: in fp32 the two agree to about 1e-6 of h.

The gate is ``jax.nn.gelu``'s default, the tanh approximation (torch's
default is the exact erf form, 1e-3 away on the gate).  ``log_lambda`` and
the state ``h`` are fp32, as in the reference, whatever the model's
dtype.

Under a mesh whose `model` axis cuts W (``param_specs``: w_x's and
w_gate's columns, w_a's, w_i's and w_out's rows), the sequence form runs
the rank's W channels: w_a and w_i are row pieces, so their products are
partial sums over the rank's input channels, reduce-scattered over
`model` to the rank's output channels; conv_w, conv_b and log_lambda,
whole on every rank, are read at its offset (``layers.model_part``).  A
decode state under such a mesh is ROADMAP A10b.5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers
from repro_torch.models.mamba import softplus

_C = 8.0          # RG-LRU decay sharpness constant (Griffin)
CONV = 4          # the depthwise conv's width


def _width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru(gen, cfg, dtype, device):
    D, W = cfg.d_model, _width(cfg)
    leaf = layers.leaf

    def dense(name, i, o):
        return leaf(name, layers.init_dense(gen, i, o, dtype, device))
    conv_w = torch.randn(CONV, W, generator=gen, dtype=torch.float32,
                         device=device) * 0.1
    return {
        "w_x": dense("w_x", D, W),                # recurrence branch
        "w_gate": dense("w_gate", D, W),          # GeLU gate branch
        "conv_w": leaf("conv_w", conv_w.to(dtype)),
        "conv_b": leaf("conv_b", torch.zeros(W, dtype=dtype, device=device)),
        "w_a": dense("w_a", W, W),                # recurrence gate r_t
        "w_i": dense("w_i", W, W),                # input gate i_t
        # a = exp(-c softplus(lambda) r) starts near 1
        "log_lambda": leaf("log_lambda", torch.linspace(
            0.3, 0.9, W, dtype=torch.float32, device=device)),
        "w_out": dense("w_out", W, D),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gate_in(xw, w):
    """xw @ w for the gate weights [W, W]: under a mesh that cuts W, the
    rank's row piece's partial product reduce-scattered over `model` to
    the rank's output channels."""
    y = layers.dense(xw, w)
    if w.shape[0] == w.shape[1]:
        return y
    mesh = mesh_mod.get_mesh()
    return mesh_mod.scatter_sum(y, mesh, "model", y.dim() - 1)


def _gates(params, xw):
    """xw [..., W] post-conv → (a, b·x) fp32 of h = a h_prev + b x, with
    b = sqrt(1 - a^2) i (the rank's channels under a mesh that cuts W)."""
    r = torch.sigmoid(_gate_in(xw, params["w_a"]).float())
    i = torch.sigmoid(_gate_in(xw, params["w_i"]).float())
    lam = layers.model_part(params["log_lambda"], xw.shape[-1],
                            params["log_lambda"].shape[0])
    log_a = -_C * softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, b * i * xw.float()


def _conv_seq(params, x):
    """Causal depthwise conv1d (k = 4) over x [B, S, W], with its bias
    (the rank's channels of both under a mesh that cuts W)."""
    k, W = params["conv_w"].shape
    conv_w = layers.model_part(params["conv_w"], x.shape[-1], W)
    xp = F.pad(x, (0, 0, k - 1, 0))
    S = x.shape[1]
    return sum(xp[:, i: i + S, :] * conv_w[i] for i in range(k)) + \
        layers.model_part(params["conv_b"], x.shape[-1], W)


def _scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, for a, b [B, S, W]: the
    inclusive scan of (a, b) under (a_l, b_l) . (a_r, b_r) = (a_l a_r,
    b_l a_r + b_r), Hillis-Steele: after the step of stride d each position
    holds the composition of its last 2d terms."""
    d, S = 1, a.shape[1]
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], b[:, :-d],
                                               a[:, d:])], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_seq(params, cfg, x, *, return_state: bool = False):
    """x [B, S, D] → [B, S, D]; with ``return_state`` also the decode state
    {"h": [B, W] fp32, "conv": [B, 3, W]} (the last 3 rows of the
    recurrence branch's projection, zero-padded in front when S < 3).
    Under a mesh that cuts W over `model`, the rank's channels (module
    doc)."""
    W = _width(cfg)
    xin = layers.enter_model(x, params["w_x"].shape[1] != W)
    gate = _gelu(layers.dense(xin, params["w_gate"]))
    xt = layers.dense(xin, params["w_x"])
    a, bx = _gates(params, _conv_seq(params, xt))              # [B,S,W] fp32
    h = _scan(a, bx)
    out = layers.dense_row(h.to(x.dtype) * gate, params["w_out"], W)
    if not return_state:
        return out
    k = params["conv_w"].shape[0]
    tail = xt[:, -(k - 1):, :] if x.shape[1] >= k - 1 else F.pad(
        xt, (0, 0, k - 1 - x.shape[1], 0))
    return out, {"h": h[:, -1].contiguous(),
                 "conv": tail.clone(memory_format=torch.contiguous_format)}


def rglru_decode(params, cfg, x, state):
    """x [B, D] one token; state {"h": [B, W] fp32, "conv": [B, 3, W]}.
    Returns (out [B, D], new state)."""
    gate = _gelu(layers.dense(x, params["w_gate"]))
    xt = layers.dense(x, params["w_x"])                         # [B, W]
    window = torch.cat([state["conv"], xt[:, None, :]], dim=1)  # [B, k, W]
    xw = torch.einsum("bkw,kw->bw", window, params["conv_w"]) + \
        params["conv_b"]
    a, bx = _gates(params, xw)
    h = a * state["h"] + bx
    out = layers.dense(h.to(x.dtype) * gate, params["w_out"])
    return out, {"h": h, "conv": window[:, 1:, :]}


def init_rglru_cache(cfg, batch: int, dtype, device="cuda"):
    W = _width(cfg)
    return {"h": torch.zeros(batch, W, dtype=torch.float32, device=device),
            "conv": torch.zeros(batch, CONV - 1, W, dtype=dtype,
                                device=device)}
