"""deepseek-r1-671b — the paper's own architecture: MLA + MoE 256e top-8.
16 heads/device on a 8-way model split is the exact padding scenario
FlashMLA-ETAP targets. [arXiv:2412.19437]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_r1_671b", family="mla",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    head_dim=128, d_ff=18432, vocab_size=129280,
    attention_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  shared_expert=True, first_dense_layers=3),
)
