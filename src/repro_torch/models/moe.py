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
``constrain``; the port holds each rank's pieces and runs the collectives
that layout needs.  At `data` = 1 the serve profile
(``param_specs(profile="serve")``) keeps every expert on every rank, with
w_gate / w_up cut over F's columns and w_down over its rows: each rank
combines its partial expert outputs with the shared expert's partial and
one fp32 all-reduce over `model` sums them.  The train profile puts the
experts over `model` (E/n a rank, F whole): the routing is the same on
every `model` rank, each rank runs its experts' slots and combines their
weighted outputs, and the partial combines are summed over `model` the
same way.

The serve profile at `data` > 1 spreads the experts over `data` (E/n a
rank, each with its F piece over `model`; serving only, no gradient).
Both paths keep the reference's routing, capacity and drops:

- a full sequence (the dense prefill): the groups are the batch rows,
  cut over `data`.  Each rank routes its groups and gathers every
  expert's slots of them expert-major, [E, G·C, D]; an all-to-all over
  `data` hands each rank its experts' slots from every rank's groups,
  [E/n, n·G·C, D], the GLU runs on them, a second all-to-all returns
  the outputs, and the rank combines its groups as above (the
  reference's resharding of ``xe`` / ``ye``, where GSPMD emits an
  all-to-all);
- a decode step: the B tokens are one dropless group, whose routing
  depends on all of it, and their rows are cut over `data`.  The rows
  are gathered over `data`, every rank routes the whole group and runs
  its experts' slots, and one fp32 reduce-scatter over `data` sums the
  ranks' combines and hands each rank its rows.  Where `data` does not
  cut the rows (every rank holds the batch), an fp32 all-reduce takes
  its place.

The shared expert is whole over `data` and cut over `model` as above, and
the F partials are summed over `model` in fp32 after the `data` leg,
rounded once.

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


def _experts(gen, name: str, E: int, d_in: int, d_out: int, dtype, device):
    """The leaf ``name``: [E, d_in, d_out] unit normals × d_in ** -0.5 in
    ``dtype``, drawn in blocks of experts so that the fp32 draw stays
    small beside the model.  Only this rank's part is kept
    (``layers.leaf_part``: under a placed init its experts and its slices
    of them; every block is drawn, so the stream is the whole draw's)."""
    es, rs, cs = layers.leaf_part(name, (E, d_in, d_out))
    w = torch.empty(es.stop - es.start, rs.stop - rs.start,
                    cs.stop - cs.start, dtype=dtype, device=device)
    for e in range(0, E, _INIT_BLOCK):
        n = min(_INIT_BLOCK, E - e)
        block = torch.randn(n, d_in, d_out, generator=gen,
                            dtype=torch.float32, device=device)
        lo, hi = max(e, es.start), min(e + n, es.stop)
        if lo < hi:
            w[lo - es.start:hi - es.start] = (
                block[lo - e:hi - e, rs, cs] * d_in ** -0.5).to(dtype)
    return layers.leaf(name, w, whole=(E, d_in, d_out))


def init_moe(gen, cfg, dtype, device):
    """The router [D, E] in fp32 whatever ``dtype``; the experts' GLU
    weights w_gate, w_up [E, D, F] and w_down [E, F, D] in ``dtype``; a
    shared expert (a GLU MLP of width F) when the config has one."""
    m = cfg.moe
    D = cfg.d_model
    Fe = m.d_ff_expert or cfg.d_ff
    E = m.num_experts
    router = torch.randn(D, E, generator=gen, dtype=torch.float32,
                         device=device) * D ** -0.5
    p = {
        "router": layers.leaf("router", router),
        "w_gate": _experts(gen, "w_gate", E, D, Fe, dtype, device),
        "w_up": _experts(gen, "w_up", E, D, Fe, dtype, device),
        "w_down": _experts(gen, "w_down", E, Fe, D, dtype, device),
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
            batch_axes: tuple = (), expert_axis: str | None = None,
            data_dim: int | None = None):
    """x: [G,S,D] -> (out [G,S,D], aux losses {"load_balance",
    "router_z"}).  ``dropless=True`` (serving): the bounded-overflow
    capacity of :func:`capacity`.  Every expert runs over all of its C
    slots, the empty ones on a zero row, as the reference's einsums do.
    Under tensor parallelism each expert's (and the shared expert's)
    F is this rank's piece, or (the train profile) the rank holds E/n
    whole experts: the partial outputs are combined, added and summed
    over `model` in fp32, rounded once.  ``expert_axis``: the mesh axis
    the expert stacks' E is cut over ("model", the train profile's;
    "data", the serve profile's expert parallelism: module doc), None
    where the rank holds every expert.  ``data_dim`` (experts over
    `data`): the dim of x that the rank's slice over `data` cuts (0 the
    groups, 1 a group's tokens), None where every `data` rank holds all
    of x.  ``batch_axes``: the mesh axes cutting the rows, whose aux
    losses are the rank's shares (module doc)."""
    m = cfg.moe
    E = m.num_experts
    El = params["w_gate"].shape[0]
    mesh = mesh_mod.get_mesh()
    pieces = mesh.shape[expert_axis] if expert_axis and mesh else 1
    if El * pieces != E:
        raise ValueError(f"{El} of {E} experts on this rank with experts "
                         f"over {expert_axis!r} on {mesh}")
    if expert_axis == "data":
        out, logits, gates, idx_k = _over_data(params, cfg, x, dropless,
                                               data_dim, mesh)
        batch_axes = ()               # serving: the rank's own statistics
    else:
        out, logits, gates, idx_k = _local(params, cfg, x, dropless, mesh)

    # load-balance and router-z losses (Switch / ST-MoE)
    n = math.prod(mesh.shape[a] for a in batch_axes)
    counts = torch.bincount(idx_k.reshape(-1), minlength=E).float()
    tokens = gates.shape[0] * gates.shape[1]
    if n == 1:
        me = gates.mean(dim=(0, 1))                               # [E]
        assign = counts / idx_k.numel()
        z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
        return out, {"load_balance": E * torch.sum(me * assign),
                     "router_z": z}
    me = gates.sum(dim=(0, 1)) / (tokens * n)
    for a in batch_axes:
        me = mesh_mod.reduce_sum(me, mesh, a)
        counts = mesh_mod.all_reduce_sum(counts, mesh, a)
    assign = counts / (idx_k.numel() * n)
    z = torch.square(torch.logsumexp(logits, dim=-1)).sum() / (tokens * n)
    return out, {"load_balance": E * torch.sum(me * assign) / n,
                 "router_z": z}


def _glu(params, xe):
    """The experts' GLU over their slots: xe [El, rows, D] -> [El, rows,
    D]."""
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    return torch.bmm(h, params["w_down"])


def _slot_rows(x, token_of_slot, E: int, C: int):
    """The flat rows of x [G,S,D] (with a zero row a group for an empty
    slot) that feed each expert's C slots of each group: [E, G*C] indices
    into :func:`_padded` x, expert-major."""
    G, S, _ = x.shape
    g_off = torch.arange(G, device=x.device)[:, None]
    src = (token_of_slot.long() + g_off * (S + 1)).view(G, E, C)
    return src.transpose(0, 1).reshape(E, G * C)


def _padded(x):
    G, S, D = x.shape
    return torch.cat([x, x.new_zeros(G, 1, D)], dim=1).reshape(
        G * (S + 1), D)


def _combine(ye, slot, gate_k, e0: int, C: int):
    """The (token, choice) pairs' weighted sum of their slots' outputs, in
    fp32: ye [El, G*C, D] holds experts [e0, e0 + El) (expert-major, a
    group's C slots together), slot [G, S*k] each pair's slot (E*C:
    dropped), gate_k [G, S, k].  A pair whose slot is another rank's
    expert, or dropped, reads a zero row."""
    El, D = ye.shape[0], ye.shape[-1]
    G, S, k = gate_k.shape
    ypad = torch.cat([ye.reshape(El * G * C, D), ye.new_zeros(1, D)])
    s = slot.long()
    g_off = torch.arange(G, device=s.device)[:, None]
    mine = (s >= e0 * C) & (s < (e0 + El) * C)
    row = torch.where(mine, (s // C - e0) * (G * C) + g_off * C + s % C,
                      El * G * C)
    yk = ypad[row].view(G, S, k, D)
    return (yk.float() * gate_k[..., None]).sum(dim=2)


def _shared_and_sum(params, cfg, x, xin, out, over_model: bool, mesh):
    """``out`` (the routed experts' fp32 combine, a partial over `model`
    where ``over_model``) plus the shared expert's output, summed over
    `model` in fp32 and rounded once to x's dtype.  ``xin``: x as the
    input of work that differs by `model` rank."""
    m = cfg.moe
    Fe = m.d_ff_expert or cfg.d_ff
    if not over_model:
        out = out.to(x.dtype)
        if m.shared_expert:
            out = out + layers.mlp(params["shared"], x)
        return out
    shared_cut = m.shared_expert and \
        params["shared"]["w_gate"].shape[1] != Fe
    if shared_cut:
        out = out + layers.mlp(params["shared"], xin).float()
    out = mesh_mod.reduce_sum(out, mesh, "model").to(x.dtype)
    if m.shared_expert and not shared_cut:
        out = out + layers.mlp(params["shared"], x)
    return out


def _local(params, cfg, x, dropless: bool, mesh):
    """:func:`moe_ffn` where the rank routes its own rows and holds every
    expert, or (the train profile) E/n of them over `model`: (out,
    logits, gates, experts chosen)."""
    m = cfg.moe
    G, S, D = x.shape
    E = m.num_experts
    Fe = m.d_ff_expert or cfg.d_ff
    El = params["w_gate"].shape[0]
    e0 = layers.model_offset(El, E)
    cut = El != E or params["w_down"].shape[1] != Fe
    C = capacity(cfg, S, dropless)

    logits, gates, gate_k, idx_k = route(params, cfg, x)
    slot, token_of_slot = _assign_slots(idx_k, E, C)              # [G,T],[G,E*C]
    # the rank's experts' inputs, expert-major, [El, G*C, D] (token S ->
    # zero row)
    xin = layers.enter_model(x, cut)
    xe = _padded(xin)[_slot_rows(x, token_of_slot, E, C)[e0:e0 + El]]
    ye = _glu(params, xe)                                         # [El,G*C,D]
    out = _combine(ye, slot, layers.enter_model(gate_k, cut), e0, C)
    return _shared_and_sum(params, cfg, x, xin, out, cut, mesh), logits, \
        gates, idx_k


def _over_data(params, cfg, x, dropless: bool, data_dim, mesh):
    """:func:`moe_ffn` with E/n_data experts a rank (the serve profile's
    expert parallelism, each expert's F over `model`): (out, logits,
    gates, experts chosen of the tokens this rank routed).  Module doc."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in params.values()
            if isinstance(t, torch.Tensor))):
        raise NotImplementedError(
            "experts over `data` serve only; the train profile puts them "
            "over `model` (ROADMAP A10b.3)")
    if mesh.shape.get("pod", 1) > 1:
        raise NotImplementedError(
            f"experts over `data` on {mesh}: a group's tokens spread over "
            "pods are not yet ported (ROADMAP A10b.5)")
    m = cfg.moe
    E = m.num_experts
    Fe = m.d_ff_expert or cfg.d_ff
    El = params["w_gate"].shape[0]
    e0 = mesh.coord("data") * El
    over_model = params["w_down"].shape[1] != Fe
    xg = x if data_dim != 1 else mesh_mod.all_gather(x, mesh, "data", 1)
    G, S, _ = xg.shape
    C = capacity(cfg, S, dropless)

    logits, gates, gate_k, idx_k = route(params, cfg, xg)
    slot, token_of_slot = _assign_slots(idx_k, E, C)
    rows = _slot_rows(xg, token_of_slot, E, C)
    if data_dim == 0:
        # every expert's slots of the rank's groups to the experts' ranks,
        # and their outputs back: [E, G*C, D] <-> [El, n*G*C, D]
        xe = mesh_mod.all_to_all(_padded(xg)[rows], mesh, "data", 0, 1)
        ye = mesh_mod.all_to_all(_glu(params, xe), mesh, "data", 1, 0)
        out = _combine(ye, slot, gate_k, 0, C)
    else:
        # every rank routes the whole group; its experts' share of each
        # token, summed over `data` in fp32
        ye = _glu(params, _padded(xg)[rows[e0:e0 + El]])
        out = _combine(ye, slot, gate_k, e0, C)
        out = mesh_mod.all_reduce_sum(out, mesh, "data") \
            if data_dim is None else \
            mesh_mod.reduce_scatter(out, mesh, "data", 1)
    return _shared_and_sum(params, cfg, x, x, out, over_model, mesh), \
        logits, gates, idx_k
