"""llava-next-34b [vlm] — anyres tiling; vision frontend stubbed (precomputed
patch embeddings per the brief). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=20480, vocab_size=64000,
    frontend="vision",
)
