"""Roofline terms on one NVIDIA H100 SXM — the port of the parts of
``repro/launch/roofline.py`` that read no compiled HLO: the split-KV decode
pipeline's byte and compute terms, and the parameter and FLOP counts of a
config.

H100 SXM constants (NVIDIA's data sheet, dense rates, at the 700 W power
limit; a card set below it runs slower under load):
    peak bf16 compute : 989 TFLOP/s
    HBM bandwidth     : 3.35 TB/s
"""
from __future__ import annotations

PEAK_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores (data sheet)
HBM_BW = 3.35e12               # H100 SXM HBM3 bytes/s (data sheet)


def splitkv_roofline(BG: int, S: int, H: int, Dk: int, Dv: int,
                     n_splits: int, *, kv_itemsize: int = 2,
                     mla_fused: bool = False, num_cores: int | None = None
                     ) -> dict:
    """Roofline terms for the two-phase split-KV decode pipeline: phase 1
    streams the KV cache once and writes per-split fp32 (m, ℓ, Accᵀ) stats;
    phase 2 re-reads the stats and writes O.

    The split count buys parallelism (occupancy factor on the compute term,
    ``BG · n_splits`` work items over ``num_cores``; None = the scheduler's
    ``DEFAULT_CORES``, the figure a CPU tensor is scheduled with) and pays
    for it in stat traffic — the scheduler's STATS_TRAFFIC_BUDGET cap is
    the requirement that ``overhead`` stays ≪ 1 here."""
    if num_cores is None:
        from repro_torch.kernels.etap.schedule import DEFAULT_CORES
        num_cores = DEFAULT_CORES

    q_bytes = BG * H * Dk * kv_itemsize
    kv_bytes = BG * S * (Dk if mla_fused else Dk + Dv) * kv_itemsize
    stat_bytes = BG * n_splits * (2 * H + Dv * H) * 4
    o_bytes = BG * H * Dv * kv_itemsize
    flops = 2.0 * BG * S * H * (Dk + Dv)

    occupancy = min(1.0, BG * n_splits / num_cores)
    t_partial_mem = (q_bytes + kv_bytes + stat_bytes) / HBM_BW
    t_partial_compute = flops / (PEAK_FLOPS * occupancy)
    t_combine = (stat_bytes + o_bytes) / HBM_BW
    t_total = max(t_partial_mem, t_partial_compute) + t_combine
    return {
        "kv_bytes": kv_bytes,
        "stat_bytes": stat_bytes,
        "t_partial_mem": t_partial_mem,
        "t_partial_compute": t_partial_compute,
        "t_combine": t_combine,
        "t_total": t_total,
        "occupancy": occupancy,
        "overhead": (2 * stat_bytes + o_bytes) / max(kv_bytes, 1),
        "bottleneck": ("memory" if t_partial_mem >= t_partial_compute
                       else "compute"),
    }


def model_flops(cfg, cell, n_active_params: int) -> float:
    """6·N·D (train) / 2·N·D (inference fwd) convention, attention excluded.
    ``cell`` is a :class:`repro_torch.configs.base.ShapeCell`: decode
    processes global_batch tokens; train/prefill B·S tokens."""
    tokens = cell.global_batch * (1 if cell.is_decode else cell.seq_len)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active_params * tokens


def active_params(cfg) -> int:
    """Approximate activated parameter count (MoE: top_k of num_experts +
    shared expert; embeddings counted once)."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    total = cfg.vocab_size * D
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn":
            if cfg.attention_kind == "mla":
                m = cfg.mla
                total += D * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * m.qk_head_dim
                total += D * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                total += cfg.num_heads * m.v_head_dim * D
            else:
                total += D * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) \
                    + cfg.num_heads * hd * D
        elif kind == "rglru":
            W = cfg.lru_width or D
            total += 2 * D * W + 2 * W * W + W * D
        elif kind == "ssm":
            di = cfg.ssm.expand * D
            dtr = cfg.ssm.dt_rank or -(-D // 16)
            total += 2 * D * di + di * (dtr + 2 * cfg.ssm.d_state) \
                + dtr * di + di * D
        if kind == "ssm":
            continue
        if cfg.moe_layer(i):
            F = cfg.moe.d_ff_expert or cfg.d_ff
            total += cfg.moe.top_k * 3 * D * F          # activated experts
            if cfg.moe.shared_expert:
                total += 3 * D * F
        elif kind in ("attn", "rglru"):
            total += 3 * D * cfg.d_ff
    return int(total)


def total_params(cfg) -> int:
    """Full parameter count (MoE: all experts)."""
    act = active_params(cfg)
    if cfg.moe is None:
        return act
    F = cfg.moe.d_ff_expert or cfg.d_ff
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.moe_layer(i))
    extra = n_moe * (cfg.moe.num_experts - cfg.moe.top_k) * 3 * cfg.d_model * F
    return act + extra
