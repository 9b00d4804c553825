"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per-expert) vocab=151936, MoE 128 experts top-8, QK norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    use_qk_norm=True,
    rope_theta=1_000_000.0,
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    moe_every=1,
)


def tiny(ndev: int = 8, *, layers: int = 1) -> ModelConfig:
    """CI-mesh reduction of this config for the explicit-vs-GSPMD runs.

    One expert (shard) per device, head/kv counts divisible by ``ndev`` for
    the head-parallel (tp) exchange, and ``capacity_factor`` generous
    enough that routing drops nothing — drop order is the one place the
    explicit and GSPMD programs could legitimately diverge. Shared by the
    lm_step_bench whole-model section and tests/dist/test_transformer.py,
    so bench and test exercise the identical model.
    """
    cfg = reduced(CONFIG, layers=layers)
    return replace(
        cfg,
        num_heads=8,
        num_kv_heads=8,
        head_dim=cfg.d_model // 8,
        num_experts=ndev,
        num_experts_per_tok=min(cfg.num_experts_per_tok, ndev),
        capacity_factor=2.0,
    )
