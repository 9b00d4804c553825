"""Decode state: the dense KV cache of attention layers and the conv and
SSD state of SSM layers.

Port of ``repro/models/kvcache.py::attn_cache_spec`` (:28) and
``ssm_cache_spec`` (:36). The port keeps one dict per layer (a list, not
the reference's stack over super-blocks) and writes into it in place. The
paged page pools and ``PageAllocator`` wait for the paged server (ROADMAP
A13).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import ssm_dims


def attn_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
    }


def ssm_cache_spec(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    """The last K - 1 conv inputs in ``dtype`` and the SSD state in fp32."""
    d_in, H, P, G, N = ssm_dims(cfg)
    return {
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * G * N),
                               dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }
