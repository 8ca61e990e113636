"""falcon-mamba-7b [ssm] — mamba1 arch, attention-free. The paper's ETAP
technique is inapplicable here (no attention GEMM) — see DESIGN.md
§Arch-applicability. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon_mamba_7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=65024,
    attention_kind="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=4096),
)
