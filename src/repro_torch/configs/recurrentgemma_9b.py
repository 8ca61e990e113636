"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    head_dim=256, d_ff=12288, vocab_size=256000,
    attention_kind="local", window_size=2048,
    block_pattern=("rglru", "rglru", "attn"),
    lru_width=4096,
)
