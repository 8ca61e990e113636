"""musicgen-large [audio] — decoder-only over EnCodec tokens; frontend stubbed
(precomputed frame embeddings per the brief). [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=2048,
    frontend="audio",
)
