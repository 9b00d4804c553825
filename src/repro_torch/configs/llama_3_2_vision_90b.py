"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attn image layers every 5th block.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings of shape (batch, num_patches, vision_dim).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_dim=1280,
    num_patches=1024,
)
