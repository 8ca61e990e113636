"""granite-20b [dense] — llama-arch MQA, code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    head_dim=128, d_ff=24576, vocab_size=49152,
)
