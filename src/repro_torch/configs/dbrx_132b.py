"""dbrx-132b [moe] — 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=10752, vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
)
