"""Gradient compression for the allreduce path: int8 blocks with error
feedback.

Port of ``repro/comm/compression.py``. The quantization residual is carried
across steps so the compressed reduction stays unbiased in the long run;
the payload is int8 with one fp32 scale per block of :data:`BLOCK`
elements. The arithmetic is the reference's, operation for operation:
``torch.round`` rounds half to even as ``jnp.round`` does, the scale is a
division by 127 floored at 1e-30, values are divided by the scale (not
multiplied by a reciprocal) and clipped to [-127, 127].
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.comm.overlap import tree_flatten, tree_unflatten

BLOCK = 256  # elements per quantization block


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8 values (blocks, BLOCK), fp32 per-block scales)."""
    flat, _ = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
               size: int) -> torch.Tensor:
    x = (q.float() * scale[:, None]).reshape(-1)[:size]
    return x.reshape(shape)


def quantize_ef(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """fp32 -> (q, scale, qr, rscale): the quantized payload plus the
    quantized requantization residual carried alongside it (which tightens
    a hop-by-hop lossy ring from O(hops/127) to O(hops/127^2) relative
    error at twice the int8 wire bytes)."""
    flat = x.float()
    q, scale = quantize(flat)
    r = flat - dequantize(q, scale, flat.shape, flat.numel())
    qr, rscale = quantize(r)
    return q, scale, qr, rscale


def dequantize_ef(q: torch.Tensor, scale: torch.Tensor, qr: torch.Tensor,
                  rscale: torch.Tensor, shape, size: int) -> torch.Tensor:
    """Reconstruct payload + residual from the :func:`quantize_ef` wire."""
    return (dequantize(q, scale, shape, size)
            + dequantize(qr, rscale, shape, size))


def compressed_psum(x: torch.Tensor, axis, error: torch.Tensor, *,
                    engine=None, schedule: Optional[str] = None, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allreduce ``x`` (fp32) over ``axis`` with an int8 payload and error
    feedback. Returns (reduced, new_error); ``error`` has ``x``'s shape.

    With ``engine``, the dequantized payload rides the engine's allreduce
    schedule (``schedule`` overrides its choice); ``int8_ef`` is remapped to
    its ``rs_ag`` transport so nothing is quantized twice. Without one it
    rides ``native`` over ``mesh``, the counterpart of the reference's
    ``lax.psum`` (which reads the axis from its enclosing ``shard_map``)."""
    target = x.float() + error.float()
    q, scale = quantize(target)
    sent = dequantize(q, scale, x.shape, x.numel())
    new_error = target - sent
    if engine is None:
        if mesh is None:
            raise ValueError("compressed_psum needs an engine or the mesh "
                             "whose axis it reduces over")
        from repro_torch.comm.engine import CollectiveEngine
        engine, schedule = CollectiveEngine.for_mesh(mesh), "native"
    inner = schedule or engine.schedule_for(
        "allreduce", nbytes=sent.numel() * sent.element_size(), axis=axis)
    if inner == "int8_ef":
        inner = "rs_ag"
    return engine.allreduce(sent, axis, schedule=inner), new_error


def init_error_tree(params) -> object:
    """A zero fp32 error buffer for every leaf of ``params``."""
    leaves, spec = tree_flatten(params)
    return tree_unflatten(spec, [torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                                 for p in leaves])
