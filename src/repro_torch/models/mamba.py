"""Mamba-1 selective SSM block (falcon-mamba) — the port of
``repro/models/mamba.py``.  The full-sequence path (prefill, forward)
left-pads the sequence to a multiple of the scan chunk, runs the causal
depthwise conv, forms the per-step terms (dA, dBx, C) and scans them with
the selective-scan kernel (K10); decode is a single-step update.

The reference runs its Pallas scan only under ``cfg.use_kernels`` and an
associative scan over chunks otherwise; the port has one route: K10 on the
card, its plain version on the CPU.

Under a mesh whose `model` axis cuts d_inner (``param_specs``: w_in's
columns, w_bcdt's and log_neg_A's rows, w_dt's columns, w_out's rows),
the full-sequence forward runs the rank's d_inner channels: w_in's column
pieces straddle x | z, so its product is gathered and the rank takes its
channels of both halves; w_bcdt's product is a row piece's, summed over
`model`; the vectors every rank holds whole (conv_w, conv_b, dt_bias, D)
are read at the rank's offset (``layers.model_part``).  A decode state
under such a mesh is ROADMAP A10b.5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.models import layers


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def init_mamba(gen, cfg, dtype, device):
    d_inner, dt_rank, N, K = _dims(cfg)
    D = cfg.d_model
    leaf = layers.leaf
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device).expand(d_inner, N)
    conv_w = torch.randn(K, d_inner, generator=gen, dtype=torch.float32,
                         device=device) * 0.1
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": leaf("w_in", layers.init_dense(gen, D, 2 * d_inner, dtype,
                                               device)),
        "conv_w": leaf("conv_w", conv_w.to(dtype)),
        "conv_b": leaf("conv_b", torch.zeros(d_inner, dtype=dtype,
                                             device=device)),
        "w_bcdt": leaf("w_bcdt", layers.init_dense(
            gen, d_inner, dt_rank + 2 * N, dtype, device)),
        "w_dt": leaf("w_dt", layers.init_dense(gen, dt_rank, d_inner, dtype,
                                               device)),
        # softplus ~ small dt
        "dt_bias": leaf("dt_bias", torch.full((d_inner,), -4.0, **f32)),
        # A = -exp(log_neg_A)
        "log_neg_A": leaf("log_neg_A", torch.log(A)),
        "D": leaf("D", torch.ones(d_inner, **f32)),
        "w_out": leaf("w_out", layers.init_dense(gen, d_inner, D, dtype,
                                                 device)),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    threshold (torch's ``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _ssm_inputs(params, cfg, xc):
    """xc: [..., d_inner] post-conv (the rank's channels under a mesh that
    cuts them).  Returns the per-step (dA, dBx, C): recurrence h = dA * h
    + dBx, output y = sum_n C*h + D*x.  dA and dBx are formed in place on
    their first product (the same values, one [..., d_inner, N] fp32
    buffer fewer)."""
    d_inner, dt_rank, N, _ = _dims(cfg)
    dl = xc.shape[-1]
    cut = dl != d_inner
    bcdt = layers.reduce_rows(layers.dense(xc, params["w_bcdt"]),
                              params["w_bcdt"], d_inner)
    bcdt = layers.enter_model(bcdt, cut).float()
    dt_in, B, C = torch.split(bcdt, [dt_rank, N, N], dim=-1)
    dt = softplus(layers.dense(dt_in.to(xc.dtype), params["w_dt"]).float()
                  + layers.model_part(params["dt_bias"], dl, d_inner))
    A = -torch.exp(params["log_neg_A"])                         # [d_inner, N]
    dA = (dt[..., None] * A).exp_()                             # [..., d_inner, N]
    dBx = (dt[..., None] * B[..., None, :]).mul_(xc.float()[..., None])
    return dA, dBx, C


def mamba_seq(params, cfg, x, *, return_state: bool = False):
    """x: [B,S,D] -> [B,S,D]; with ``return_state`` also the decode state
    {"h": [B,d_inner,N] fp32, "conv": [B,K-1,d_inner]}.  Under a mesh
    that cuts d_inner over `model`, the rank's channels (module doc)."""
    d_inner, _, _, K = _dims(cfg)
    dl = params["log_neg_A"].shape[0]     # the rank's channels
    S_in = x.shape[1]
    chunk = min(cfg.ssm.chunk, S_in)
    pad = (-S_in) % chunk                 # left-pad to a chunk multiple: zero
    if pad:                               # inputs leave the zero state unchanged
        x = F.pad(x, (0, 0, pad, 0))
    S = S_in + pad
    xz = layers.dense_col(x, params["w_in"], 2 * d_inner)
    xs, z = (layers.model_part(t, dl, d_inner)
             for t in torch.chunk(xz, 2, dim=-1))
    conv_w = layers.model_part(params["conv_w"], dl, d_inner)
    xp = F.pad(xs, (0, 0, K - 1, 0))      # causal depthwise conv
    xc = sum(xp[:, i: i + S, :] * conv_w[i] for i in range(K))
    xc = F.silu(xc + layers.model_part(params["conv_b"], dl, d_inner))
    dA, dBx, C = _ssm_inputs(params, cfg, xc)
    y, h_last = scan_ops.selective_scan(dA, dBx, C, chunk=chunk)
    del dA, dBx
    y = y + layers.model_part(params["D"], dl, d_inner) * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = layers.dense_row(y, params["w_out"], d_inner)[:, pad:]
    if not return_state:
        return out
    tail = xs[:, -(K - 1):, :] if S >= K - 1 else F.pad(
        xs, (0, 0, K - 1 - S, 0))
    # a copy: a view would keep the whole [B,S,2*d_inner] projection alive
    return out, {"h": h_last,
                 "conv": tail.clone(memory_format=torch.contiguous_format)}


def mamba_decode(params, cfg, x, state):
    """x: [B,D]; state {"h": [B,d_inner,N] fp32, "conv": [B,K-1,d_inner]}.
    Returns (out [B,D], new state)."""
    xz = layers.dense(x, params["w_in"])
    xt, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([state["conv"], xt[:, None, :]], dim=1)
    xc = torch.einsum("bkd,kd->bd", window, params["conv_w"]) + \
        params["conv_b"]
    xc = F.silu(xc)
    dA, dBx, C = _ssm_inputs(params, cfg, xc)                   # [B,d,N]x2,[B,N]
    h = dA * state["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, C) + params["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return layers.dense(y, params["w_out"]), {"h": h,
                                              "conv": window[:, 1:, :]}


def init_mamba_cache(cfg, batch: int, dtype, device="cuda"):
    d_inner, _, N, K = _dims(cfg)
    return {"h": torch.zeros(batch, d_inner, N, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, K - 1, d_inner, dtype=dtype,
                                device=device)}
