"""Configuration dataclasses for models, input shapes, and runs.

A copy of ``repro/configs/base.py`` (pure Python; the port imports nothing
of ``repro``). Every assigned architecture gets one module in
``repro_torch.configs`` exporting ``CONFIG: ModelConfig``. Shapes are
global (assigned per the task): each (arch x shape) cell is resolved
through :func:`shape_for`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters.

    A single dataclass covers all six families; family-specific fields are
    ignored by families that do not use them (e.g. ``num_experts`` for dense).
    """

    name: str
    family: str  # one of FAMILIES

    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    use_qk_norm: bool = False

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim; 0 -> d_ff
    moe_every: int = 1  # MoE layer every k-th block (jamba: 2)
    shared_expert: bool = False  # llama4-style shared expert alongside routed
    router_jitter: float = 0.0
    capacity_factor: float = 1.25

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0  # N (state size); 0 -> no ssm layers
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (jamba) -------------------------------------------------------
    attn_every: int = 1  # attention layer every k-th block (jamba: 8); SSM otherwise

    # --- cross attention (vlm / enc-dec) --------------------------------------
    cross_attn_every: int = 0  # vlm: cross-attn block every k-th layer
    vision_dim: int = 0  # stub patch-embedding dim (vlm)
    num_patches: int = 0  # stub patch count per image (vlm)

    # --- encoder-decoder (whisper) ---------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    audio_ctx: int = 0  # stub frame count (whisper: 1500)

    # --- numerics ----------------------------------------------------------------
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # -------------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ---- derived ----------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM and hybrid archs only."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string; drives the scan-block structure.

        dense/moe/vlm/audio: all layers homogeneous (vlm adds cross every k).
        hybrid: 'attn' every ``attn_every``-th layer else 'ssm'.
        """
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                # paper arch (jamba): 1 attention layer per attn_every block,
                # positioned mid-block like the published model.
                kinds.append("attn" if (i % self.attn_every) == self.attn_every // 2 else "ssm")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if not self.has_moe:
            return tuple(False for _ in range(self.num_layers))
        return tuple((i % self.moe_every) == (self.moe_every - 1) for i in range(self.num_layers))

    def cross_attn_mask(self) -> Tuple[bool, ...]:
        if not self.cross_attn_every:
            return tuple(False for _ in range(self.num_layers))
        return tuple((i % self.cross_attn_every) == (self.cross_attn_every - 1)
                     for i in range(self.num_layers))

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embedding included."""
        d, h, kv, hd = self.d_model, self.num_heads, self.num_kv_heads, self.head_dim
        n = 0
        kinds = self.layer_kinds()
        moe_mask = self.moe_layer_mask()
        cross_mask = self.cross_attn_mask()
        for i, kind in enumerate(kinds):
            if kind == "attn":
                qkv = d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
                if self.qkv_bias:
                    qkv += (h + 2 * kv) * hd
                n += qkv + 2 * d  # norms
            else:  # ssm
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                # in_proj (x, z, B, C, dt), conv, out_proj, A/D/dt_bias, norm
                bc = 2 * self.ssm_ngroups * self.ssm_state
                n += d * (2 * d_in + bc + nheads) + self.ssm_conv * (d_in + bc) \
                    + d_in * d + 3 * nheads + d
            if moe_mask[i]:
                e = self.num_experts
                k = self.num_experts_per_tok if active_only else e
                n += k * 3 * d * self.moe_d_ff + d * e  # router
                if self.shared_expert:
                    n += 3 * d * self.moe_d_ff
                n += d
            elif kind == "attn" or self.family != "ssm":
                if self.d_ff:
                    n += 3 * d * self.d_ff + d
            if cross_mask[i]:
                vd = self.vision_dim or d
                n += d * (h * hd) + 2 * vd * (kv * hd) + (h * hd) * d + 2 * d
        # embedding + final norm (+ untied head counted once: tied here)
        n += self.padded_vocab() * d + d
        if self.is_encoder_decoder:
            # encoder stack: attn + mlp per layer
            enc = self.num_encoder_layers * (
                d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d + 3 * d * self.d_ff + 3 * d)
            n += enc
        return n


# ---------------------------------------------------------------------------
# Input shapes (assigned; global across archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_train(self) -> bool:
        return self.kind == "train"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def shape_for(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k-token decode requires "
                       "sub-quadratic attention (see DESIGN.md §Arch-applicability)")
    return True, ""


# ---------------------------------------------------------------------------
# Run configuration (training / serving / distribution knobs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RunConfig:
    comm_type: str = "ici_direct"  # 'ici_direct' | 'host_staged' (paper Fig. 1)
    microbatches: int = 1
    remat: str = "full"  # 'none' | 'full' | 'dots' (activation checkpoint policy)
    grad_compression: str = "none"  # 'none' | 'int8_ef'
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    max_grad_norm: float = 1.0
    seed: int = 0
    # fault tolerance
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    # straggler mitigation
    step_deadline_factor: float = 3.0  # flag steps slower than factor x median
    # pipeline parallelism (beyond-paper, over the pod axis)
    pipeline_stages: int = 1


def reduced(cfg: ModelConfig, *, layers: int = 4, d_model: int = 64,
            vocab: int = 512) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    heads = 4
    head_dim = d_model // heads
    kv = min(cfg.num_kv_heads, heads) if cfg.num_kv_heads else heads
    if heads % max(kv, 1):
        kv = heads
    experts = min(cfg.num_experts, 4)
    updates = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv if cfg.num_kv_heads else 0,
        head_dim=head_dim,
        d_ff=d_model * 2 if cfg.d_ff else 0,
        vocab_size=vocab,
        num_experts=experts,
        num_experts_per_tok=min(cfg.num_experts_per_tok, max(experts // 2, 1)) if experts else 0,
        moe_d_ff=d_model * 2 if cfg.num_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=32,
        attn_every=min(cfg.attn_every, max(layers // 2, 1)),
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        vision_dim=32 if cfg.vision_dim else 0,
        num_patches=8 if cfg.num_patches else 0,
        num_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        audio_ctx=16 if cfg.is_encoder_decoder else 0,
        dtype="float32",
        param_dtype="float32",
    )
    return replace(cfg, **updates)
