"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    head_dim=128, d_ff=8192, vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192, shared_expert=True),
)
