"""Decode state for attention layers: the dense KV cache.

Port of ``repro/models/kvcache.py::attn_cache_spec`` (:28). The port keeps
one ``{'k', 'v'}`` pair per layer (a list, not the reference's stack over
super-blocks) and writes into it in place. The SSM state, the paged page
pools and ``PageAllocator`` wait for their families and for the paged
server (ROADMAP A11, A13).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig


def attn_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
    }
