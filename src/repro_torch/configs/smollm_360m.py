"""smollm-360m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm_360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    head_dim=64, d_ff=2560, vocab_size=49152,
)
