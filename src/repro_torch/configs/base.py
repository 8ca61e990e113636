"""Config system: model/architecture configs.

The port's mirror of ``repro/configs/base.py`` with torch dtypes in place of
``jax.numpy``.  Every architecture gets a module in this package exposing
``CONFIG``; ``get_config(name)`` resolves by arch id; ``reduced(cfg)`` shrinks
any config to a CPU-smoke-testable size of the same family.
"""
from __future__ import annotations

import dataclasses
import importlib
from collections.abc import Sequence
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        # absorbed decode operates on [kv_lora_rank + rope] = 576 for DeepSeek.
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0          # expert hidden size (0 -> use model d_ff)
    shared_expert: bool = False   # llama4/deepseek shared expert
    capacity_factor: float = 1.25
    first_dense_layers: int = 0   # deepseek: first k layers are dense
    every_k_layers: int = 1       # 1 = every layer is MoE


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model/16)
    chunk: int = 256              # selective-scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm | mla
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    attention_kind: str = "full"  # full | local | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window_size: int = 2048       # local attention window
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid layer pattern, cycled over num_layers. e.g. ("rglru","rglru","attn")
    block_pattern: Sequence[str] | None = None
    frontend: str | None = None       # "audio" | "vision" stub frontends
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    # RG-LRU width (recurrentgemma); 0 -> d_model
    lru_width: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_kinds(self) -> list:
        """Per-layer temporal-mixing kind."""
        if self.block_pattern:
            pat = list(self.block_pattern)
            return [pat[i % len(pat)] for i in range(self.num_layers)]
        if self.family == "ssm":
            return ["ssm"] * self.num_layers
        return ["attn"] * self.num_layers

    def moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense_layers:
            return False
        return ((i - m.first_dense_layers) % m.every_k_layers) == 0


@dataclass(frozen=True)
class ShapeCell:
    """One input-shape cell: a batch of sequences of one length and one
    kind of step (train | prefill | decode) — what
    :func:`repro_torch.launch.roofline.model_flops` counts tokens over."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


ARCH_IDS = [
    "recurrentgemma_9b",
    "dbrx_132b",
    "llama4_maverick_400b",
    "qwen3_8b",
    "stablelm_1_6b",
    "granite_20b",
    "smollm_360m",
    "musicgen_large",
    "llava_next_34b",
    "falcon_mamba_7b",
    "deepseek_r1_671b",   # the paper's own architecture
]


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            heads: int = 4, kv_heads: int = 0, d_ff: int = 128,
            vocab: int = 256) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family structure."""
    kv = kv_heads or max(1, min(cfg.num_kv_heads, heads))
    changes = dict(
        num_layers=layers, d_model=d_model, num_heads=heads, num_kv_heads=kv,
        d_ff=d_ff, vocab_size=vocab, head_dim=d_model // heads,
        window_size=min(cfg.window_size, 32), remat=False, dtype="float32",
        lru_width=0,
    )
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff_expert=d_ff,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            capacity_factor=8.0)   # effectively dropless for tiny smoke shapes
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=4, chunk=8)
    return dataclasses.replace(cfg, **changes)
