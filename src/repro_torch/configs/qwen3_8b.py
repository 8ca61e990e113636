"""qwen3-8b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=12288, vocab_size=151936,
    qk_norm=True, rope_theta=1000000.0,
)
