"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave
(one attention layer per 8-layer block), MoE every 2nd layer.
[arXiv:2403.19887; hf]

Note: published Jamba uses Mamba-1 selective-scan layers; this repo's SSM
layer is the Mamba-2 SSD (chunked dual) form — same state-space family,
matmul-friendly on the MXU (DESIGN.md §2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    rope_theta=0.0,  # jamba attention layers are NoPE
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=24576,
    moe_every=2,
    attn_every=8,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_ngroups=1,
    ssm_conv=4,
    ssm_chunk=256,
)
