"""whisper-base [audio] — 6L d_model=512 8H (MHA kv=8) d_ff=2048 vocab=51865.
Encoder-decoder; conv frontend STUBBED per the assignment: ``input_specs()``
provides precomputed mel-frame embeddings (batch, audio_ctx, d_model).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions
    is_encoder_decoder=True,
    num_encoder_layers=6,
    audio_ctx=1500,
)
