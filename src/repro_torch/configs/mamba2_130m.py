"""mamba2-130m [ssm] — 24L d_model=768 (attention-free) vocab=50280,
ssm_state=128. SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
)
