"""Mixture-of-Experts FFN with sort-based top-k dispatch — the port of
``repro/models/moe.py``.

Token → slot assignment is a stable argsort over the flat expert ids (no
one-hot [G,S,E,C] dispatch tensor); each expert then takes its C slots
through a gather, runs the GLU on all E × C slots as three batched
products, and the (token, choice) pairs gather their slots' outputs back
and sum them weighted by their gates.  Capacity follows GShard: per group
each expert keeps at most C tokens, earlier (token, choice) pairs win, and
the overflow is dropped.

The reference pins the expert layout for expert parallelism with
``constrain``.  The port serves the experts' intra-expert tensor
parallelism (``param_specs(profile="serve")`` at `data` = 1: every expert
on every rank, w_gate / w_up cut over F's columns and w_down over its
rows): each rank combines its partial expert outputs with the shared
expert's partial and one fp32 all-reduce over `model` sums them.  The
train profile puts the experts over `model` (E/n a rank, F whole): the
routing is the same on every `model` rank, each rank runs its experts'
slots and combines their weighted outputs, and the partial combines are
summed over `model` the same way.  Experts spread over `data` (the serve
profile's expert parallelism) are ROADMAP A10b.3.

Under a mesh whose batch axes (`data`, `pod`) cut the batch's rows
(``batch_axes``), the aux losses are this rank's shares of the whole
batch's: the load-balance statistic is the reference's global one (``me``
and the assignment fractions are means over every group's tokens,
all-reduced over the batch axes, ``me`` with a gradient that reaches
every data rank's router), and a rank's share of it is 1/n of it; the
router-z share is the rank's sum over the whole batch's count.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers

# experts drawn at once by init_moe: 16 x 7168 x 2048 fp32 is 0.94 GB
_INIT_BLOCK = 16


def _experts(gen, E: int, d_in: int, d_out: int, dtype, device):
    """[E, d_in, d_out] unit normals × d_in ** -0.5 in ``dtype``, drawn in
    blocks of experts so that the fp32 draw stays small beside the model."""
    w = torch.empty(E, d_in, d_out, dtype=dtype, device=device)
    for e in range(0, E, _INIT_BLOCK):
        n = min(_INIT_BLOCK, E - e)
        block = torch.randn(n, d_in, d_out, generator=gen,
                            dtype=torch.float32, device=device)
        w[e:e + n] = (block * d_in ** -0.5).to(dtype)
    return w


def init_moe(gen, cfg, dtype, device):
    """The router [D, E] in fp32 whatever ``dtype``; the experts' GLU
    weights w_gate, w_up [E, D, F] and w_down [E, F, D] in ``dtype``; a
    shared expert (a GLU MLP of width F) when the config has one."""
    m = cfg.moe
    D = cfg.d_model
    Fe = m.d_ff_expert or cfg.d_ff
    E = m.num_experts
    leaf = layers.leaf
    router = torch.randn(D, E, generator=gen, dtype=torch.float32,
                         device=device) * D ** -0.5
    p = {
        "router": leaf("router", router),
        "w_gate": leaf("w_gate", _experts(gen, E, D, Fe, dtype, device)),
        "w_up": leaf("w_up", _experts(gen, E, D, Fe, dtype, device)),
        "w_down": leaf("w_down", _experts(gen, E, Fe, D, dtype, device)),
    }
    if m.shared_expert:
        with layers.leaf_scope("shared"):
            p["shared"] = layers.init_mlp(gen, D, Fe, dtype, device)
    return p


def _capacity(tokens_per_group: int, cfg) -> int:
    m = cfg.moe
    c = int(m.top_k * tokens_per_group * m.capacity_factor / m.num_experts)
    return max(4, -(-c // 4) * 4)   # >= 4, rounded up to a multiple of 4


def _assign_slots(idx_k, E: int, C: int):
    """idx_k: [G, S, k] expert choices.  Returns slot_of_choice [G, S*k] in
    [0, E*C] (E*C = dropped) and token_of_slot [G, E*C] in [0, S] (S = an
    empty slot), both int32."""
    G, S, k = idx_k.shape
    T = S * k
    flat_e = idx_k.reshape(G, T).long()
    order = torch.argsort(flat_e, dim=-1, stable=True)            # [G,T]
    sorted_e = torch.gather(flat_e, -1, order)
    # position within expert, in sorted order: i - first index of this expert
    ar = torch.arange(T, device=idx_k.device)
    change = torch.cat([torch.ones(G, 1, dtype=torch.bool,
                                   device=idx_k.device),
                        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=-1)
    first = torch.cummax(torch.where(change, ar[None, :], 0), dim=-1).values
    pos_sorted = ar[None, :] - first                              # [G,T]
    # back to (token, choice) order
    pos = torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    dropped = pos >= C
    slot = torch.where(dropped, E * C, flat_e * C + torch.clamp(pos, max=C - 1))
    # invert: the token feeding each expert slot (S = empty); dropped pairs
    # all write into bucket E*C, sliced off below
    token_of_slot = torch.full((G, E * C + 1), S, dtype=torch.long,
                               device=idx_k.device)
    token_of_slot.scatter_(-1, slot, (ar // k)[None, :].expand(G, T))
    return slot.int(), token_of_slot[:, : E * C].int()


def route(params, cfg, x):
    """The router: fp32 logits [G,S,E] (TF32 off), their softmax gates, and
    the top-k gates and experts [G,S,k], sorted by gate, ties to the lower
    expert (``jax.lax.top_k``'s order; a stable sort keeps it)."""
    with layers.no_tf32():
        logits = torch.matmul(x.float(), params["router"])
    gates = torch.softmax(logits, dim=-1)
    gate_s, idx_s = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    return logits, gates, gate_s[..., :k], idx_s[..., :k]


def capacity(cfg, S: int, dropless: bool) -> int:
    """Slots an expert takes in a group of S tokens: dropless (serving) 4x
    the balanced load, at most S; otherwise the capacity-factor rule."""
    m = cfg.moe
    if dropless:
        # C = S would be truly dropless but runs every expert over every
        # token (E / k times the products) and an E*C*D combine gather
        return min(S, max(m.top_k, 4 * -(-m.top_k * S // m.num_experts)))
    return min(_capacity(S, cfg), max(4, S))


def moe_ffn(params, cfg, x, *, dropless: bool = False,
            batch_axes: tuple = ()):
    """x: [G,S,D] -> (out [G,S,D], aux losses {"load_balance",
    "router_z"}).  ``dropless=True`` (serving): the bounded-overflow
    capacity of :func:`capacity`.  Every expert runs over all of its C
    slots, the empty ones on a zero row, as the reference's einsums do.
    Under tensor parallelism each expert's (and the shared expert's)
    F is this rank's piece, or (the train profile) the rank holds E/n
    whole experts: the partial outputs are combined, added and summed
    over `model` in fp32, rounded once.  ``batch_axes``: the mesh axes
    cutting the rows, whose aux losses are the rank's shares (module
    doc)."""
    m = cfg.moe
    G, S, D = x.shape
    E, k = m.num_experts, m.top_k
    Fe = m.d_ff_expert or cfg.d_ff
    El = params["w_gate"].shape[0]
    mesh = mesh_mod.get_mesh()
    if El != E and (mesh is None or El * mesh.shape.get("model", 1) != E):
        raise NotImplementedError(
            f"{El} of {E} experts on this rank: expert parallelism over "
            "`data` is not yet ported (ROADMAP A10b.3)")
    e0 = layers.model_offset(El, E)
    cut = El != E or params["w_down"].shape[1] != Fe
    C = capacity(cfg, S, dropless)

    logits, gates, gate_k, idx_k = route(params, cfg, x)
    slot, token_of_slot = _assign_slots(idx_k, E, C)              # [G,T],[G,E*C]
    # the rank's experts' inputs, expert-major, [El, G*C, D] (token S ->
    # zero row)
    xin = layers.enter_model(x, cut)
    xpad = torch.cat([xin, xin.new_zeros(G, 1, D)],
                     dim=1).reshape(G * (S + 1), D)
    g_off = torch.arange(G, device=x.device)[:, None]
    src = (token_of_slot.long() + g_off * (S + 1)).view(G, E, C)
    xe = xpad[src[:, e0:e0 + El].transpose(0, 1).reshape(El, G * C)]

    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])                           # [El,G*C,D]

    # combine: per (token, choice) gather its slot's output, weight by gate
    # (a slot of another rank's expert, or dropped, reads the zero row)
    ypad = torch.cat([ye.reshape(El * G * C, D), ye.new_zeros(1, D)])
    s = slot.long()
    mine = (s >= e0 * C) & (s < (e0 + El) * C)
    row = torch.where(mine, (s // C - e0) * (G * C) + g_off * C + s % C,
                      El * G * C)
    yk = ypad[row].view(G, S, k, D)
    out = (yk.float() * layers.enter_model(gate_k, cut)[..., None]).sum(dim=2)
    if cut:                                       # partials over `model`
        shared_cut = m.shared_expert and \
            params["shared"]["w_gate"].shape[1] != Fe
        if shared_cut:
            out = out + layers.mlp(params["shared"], xin).float()
        out = mesh_mod.reduce_sum(out, mesh, "model").to(x.dtype)
        if m.shared_expert and not shared_cut:
            out = out + layers.mlp(params["shared"], x)
    else:
        out = out.to(x.dtype)
        if m.shared_expert:
            out = out + layers.mlp(params["shared"], x)

    # load-balance and router-z losses (Switch / ST-MoE)
    n = math.prod(mesh.shape[a] for a in batch_axes)
    counts = torch.bincount(idx_k.reshape(-1), minlength=E).float()
    if n == 1:
        me = gates.mean(dim=(0, 1))                               # [E]
        assign = counts / (G * S * k)
        z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        return out, {"load_balance": E * torch.sum(me * assign),
                     "router_z": z}
    me = gates.sum(dim=(0, 1)) / (G * S * n)
    for a in batch_axes:
        me = mesh_mod.reduce_sum(me, mesh, a)
        counts = mesh_mod.all_reduce_sum(counts, mesh, a)
    assign = counts / (G * S * k * n)
    z = torch.square(torch.logsumexp(logits, dim=-1)).sum() / (G * S * n)
    return out, {"load_balance": E * torch.sum(me * assign) / n,
                 "router_z": z}
