"""Mamba-2 SSD (state-space duality) block: the chunked matmul form for
prefill and training, the recurrent step for decode.

Port of ``repro/models/ssm.py``. The chunked dual form (Dao & Gu,
arXiv:2405.21060 §6) computes the selective state-space recurrence as
block-diagonal "attention-like" products within chunks plus a low-rank
recurrence between chunks; the reference's inter-chunk ``lax.scan`` is a
loop over the chunks here, in the same order. Decode is the O(1)-memory
step h' = exp(dt*A) h + dt * (B ⊗ x), y = C·h' + D*x.

Products whose operands the reference takes in fp32
(``preferred_element_type=float32``) run on fp32 operands here. The
intra-chunk decay masks before its exp, where the reference masks after:
the values are the same, and the backward stays finite where the masked
entries overflow (ROADMAP C16); the causal
conv sums its K taps in fp32 in the order k = 0 ... K-1; the gated norm is
``rmsnorm(y * silu(z))`` in the activation dtype.

On a ``tp`` axis wider than 1 that divides the heads (a ``shard`` from
:func:`repro_torch.sharding.make_shard_fn`) each rank holds ``H / tp``
whole heads: the ``d_in`` columns of ``in_x``, ``in_z``, ``conv_x``,
``conv_x_b`` and ``norm`` and the rows of ``out_proj``. ``in_bc``,
``conv_bc`` and ``in_dt``, ``A_log``, ``D``, ``dt_bias`` stay whole, enter
through ``copy_to`` (every rank uses a share of them) and the per-head
ones are narrowed to the local heads. The gated norm sums its squares over
``tp`` and divides by the whole ``d_in``; ``out_proj`` ends in
``reduce_from``. Where ``tp`` does not divide the heads the layer stays
whole on every rank: a difference from the reference's layout, which cuts
``d_in`` inside a head there (:func:`repro_torch.sharding.param_specs`
keeps the weights whole to match).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import partition as PT
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import init_rmsnorm, rmsnorm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, nheads, head_dim P, ngroups G, state N)."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    return d_in, d_in // P, P, cfg.ssm_ngroups, cfg.ssm_state


def heads_held(cfg: ModelConfig, part) -> Tuple[int, int]:
    """(start, count) of the SSM heads a rank holds at placement ``part``:
    its contiguous share where the ``tp`` axis divides the heads, else all
    of them (the layer stays whole)."""
    H = ssm_dims(cfg)[1]
    if part is None or part.tp is None or H % part.tp_n:
        return 0, H
    n = H // part.tp_n
    return part.tp_index * n, n


def _local_groups(t: torch.Tensor, H: int, h0: int, n: int) -> torch.Tensor:
    """The B/C groups (dim 2 of (b, L, G, N)) that heads [h0, h0 + n) of
    H use, head h using group h // (H // G), laid out so that local head
    j uses local group j // (n // G_loc)."""
    rep = H // t.shape[2]
    if n % rep == 0:
        return t.narrow(2, h0 // rep, n // rep)
    if rep % n == 0:
        return t.narrow(2, h0 // rep, 1)
    idx = torch.arange(h0, h0 + n, device=t.device) // rep
    return t.index_select(2, idx)


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def init_ssm(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """The reference's segmented projections (x, z, BC, dt), shapes and
    scales, drawn in fp32 from ``gen`` (the reference draws ``conv_x`` and
    ``conv_bc`` from one key; here each has its own draw). ``dt_bias`` is
    the inverse softplus of a dt log-uniform in [1e-3, 1e-1]."""
    d = cfg.d_model
    d_in, H, P, G, N = ssm_dims(cfg)
    std = 0.02
    u = torch.rand((H,), generator=gen, dtype=torch.float32, device=device)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "in_x": _normal(gen, (d, d_in), std, device),
        "in_z": _normal(gen, (d, d_in), std, device),
        "in_bc": _normal(gen, (d, 2 * G * N), std, device),
        "in_dt": _normal(gen, (d, H), std, device),
        "conv_x": _normal(gen, (cfg.ssm_conv, d_in), std, device),
        "conv_x_b": torch.zeros((d_in,), device=device),
        "conv_bc": _normal(gen, (cfg.ssm_conv, 2 * G * N), std, device),
        "conv_bc_b": torch.zeros((2 * G * N,), device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones((H,), device=device),
        "dt_bias": dt_bias,
        "norm": init_rmsnorm(d_in, device),
        "out_proj": _normal(gen, (d_in, d),
                            std / math.sqrt(2 * cfg.num_layers), device),
    }


# ---------------------------------------------------------------------------
# chunked SSD core
# ---------------------------------------------------------------------------


def _heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Groups -> heads: head h uses group h // rep."""
    return t.repeat_interleave(rep, dim=dim) if rep > 1 else t


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """Chunked SSD. x: (b, L, H, P); dt: (b, L, H); A: (H,) negative;
    B, C: (b, L, G, N), head h using group h // (H // G). Returns
    (y (b, L, H, P) in x's dtype, h_final (b, H, P, N) fp32)."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = chunk
    pad = (-L) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // Q

    xc = x.reshape(b, nc, Q, H, P).float()
    dtc = dt.reshape(b, nc, Q, H).float()
    Bc = B.reshape(b, nc, Q, G, N).float()
    Cc = C.reshape(b, nc, Q, G, N).float()

    dA = dtc * A
    cs = torch.cumsum(dA, dim=2)  # inclusive, within each chunk

    # intra-chunk: scores[b,c,g,q,k] = C_q . B_k; decay exp(cs_q - cs_k)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (b,nc,q,k,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp: past the diagonal cs_q - cs_k > 0 overflows
    # at full size (mamba2-130m's chunks of 256), and the reference's
    # where(mask, exp(diff), 0) then backpropagates 0 * inf = NaN
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  float("-inf")))
    M = _heads(scores, rep, 2) * decay.permute(0, 1, 4, 2, 3) \
        * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", M, xc)

    # chunk states: S_c = sum_k exp(cs_last - cs_k) dt_k x_k B_k
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dtc
    states = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", seg, xc,
                          _heads(Bc, rep, 3))

    # inter-chunk recurrence, chunk by chunk (the reference's scan)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (b, nc, H)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    prev = []
    for c in range(nc):
        prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, H, P, N)

    y_off = torch.einsum("bcqhn,bchpn->bcqhp", _heads(Cc, rep, 3),
                         prev_states)
    y = y + y_off * torch.exp(cs)[..., None]
    y = y.reshape(b, nc * Q, H, P)[:, :L]
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, B, C, h0=None):
    """Oracle: the sequential recurrence over L (slow; tests only)."""
    b, L, H, P = x.shape
    rep = H // B.shape[2]
    Bh, Ch = _heads(B, rep, 2).float(), _heads(C, rep, 2).float()
    h = (torch.zeros((b, H, P, B.shape[3]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(L):
        dt_t = dt[:, t].float()
        g = torch.exp(dt_t * A)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt_t, x[:, t].float(),
                           Bh[:, t])
        h = g[:, :, None, None] * h + upd
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------


def _causal_conv(xBC, w, b, conv_cache=None):
    """Depthwise causal conv. xBC: (B, L, ch); w: (K, ch); the last K - 1
    inputs are the new cache. Sums in fp32, tap by tap from k = 0."""
    K, L = w.shape[0], xBC.shape[1]
    if conv_cache is None:
        pad = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    else:
        pad = conv_cache.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)  # (B, L + K - 1, ch)
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for k in range(K):
        out = out + xp[:, k:k + L].float() * w[k].float()
    out = out + b.float()
    return out.to(xBC.dtype), xp[:, xp.shape[1] - (K - 1):]


def apply_ssm(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
              cache: Optional[dict] = None, pos=None, shard=None):
    """Mamba-2 block. x: (B, S, D) -> (B, S, D); returns (y, cache).

    ``cache`` = {'conv_x', 'conv_bc': (B, K-1, ch), 'state': (B, H, P, N)}
    is written in place (the reference returns a new one). Decode (the
    recurrent step) when ``pos`` is not None and S == 1; otherwise the
    chunked form, from the cache's state when there is a cache. On a
    ``tp`` axis that divides the heads the weights, ``conv_x`` and
    ``state`` are this rank's heads' (:func:`heads_held`) and
    ``conv_bc`` is whole."""
    Bsz, S, D = x.shape
    d_in, H, P, G, N = ssm_dims(cfg)
    dtype = x.dtype
    part = PT.tp_of(shard)
    h0, Hn = heads_held(cfg, part)
    if Hn == H:
        part = None
    in_bc, conv_bc, conv_bc_b = p["in_bc"], p["conv_bc"], p["conv_bc_b"]
    in_dt, A_log, D_skip, dt_bias = p["in_dt"], p["A_log"], p["D"], \
        p["dt_bias"]
    if part is not None:
        mesh, tp = part.mesh, part.tp
        x = PT.copy_to(x, mesh, tp)
        in_bc, conv_bc, conv_bc_b = (PT.copy_to(w, mesh, tp)
                                     for w in (in_bc, conv_bc, conv_bc_b))
        in_dt = PT.copy_to(in_dt, mesh, tp).narrow(1, h0, Hn)
        A_log, D_skip, dt_bias = (PT.copy_to(w, mesh, tp).narrow(0, h0, Hn)
                                  for w in (A_log, D_skip, dt_bias))

    z = torch.matmul(x, p["in_z"].to(dtype))
    xin = torch.matmul(x, p["in_x"].to(dtype))
    bc = torch.matmul(x, in_bc.to(dtype))
    dt_raw = torch.matmul(x, in_dt.to(dtype))

    decode = pos is not None and S == 1
    xin, new_conv_x = _causal_conv(
        xin, p["conv_x"], p["conv_x_b"],
        conv_cache=cache["conv_x"] if (cache and decode) else None)
    bc, new_conv_bc = _causal_conv(
        bc, conv_bc, conv_bc_b,
        conv_cache=cache["conv_bc"] if (cache and decode) else None)
    xin = F.silu(xin)
    bc = F.silu(bc)
    Bm, Cm = bc[..., :G * N], bc[..., G * N:]

    A = -torch.exp(A_log.float())
    dt = F.softplus(dt_raw.float() + dt_bias.float())  # (B, S, Hn)

    xh = xin.reshape(Bsz, S, Hn, P)
    Bh = Bm.reshape(Bsz, S, G, N)
    Ch = Cm.reshape(Bsz, S, G, N)
    if part is not None:
        Bh, Ch = _local_groups(Bh, H, h0, Hn), _local_groups(Ch, H, h0, Hn)

    if decode:
        h = cache["state"].float()
        dt1 = dt[:, 0]
        g = torch.exp(dt1 * A)
        rep = Hn // Bh.shape[2]
        B1 = _heads(Bh[:, 0], rep, 1).float()
        C1 = _heads(Ch[:, 0], rep, 1).float()
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt1, xh[:, 0].float(), B1)
        h = g[:, :, None, None] * h + upd
        y = torch.einsum("bhn,bhpn->bhp", C1, h)[:, None]
        new_state = h
    else:
        h0_state = cache["state"] if cache else None
        y, new_state = ssd_chunked(xh, dt, A, Bh, Ch, cfg.ssm_chunk,
                                   h0=h0_state)

    y = y + xh.float() * D_skip.float()[None, None, :, None]
    y = y.reshape(Bsz, S, Hn * P).to(dtype)

    # gated RMSNorm (mamba2): norm(y * silu(z))
    if part is None:
        y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    else:
        # the squares of every rank's channels, over the whole d_in; their
        # gradient is summed over tp too (each rank normalizes its own
        # channels by the whole sum)
        v = (y * F.silu(z)).float()
        ss = PT.copy_to(PT.reduce_from(v.square().sum(-1, keepdim=True),
                                       mesh, tp), mesh, tp)
        y = (v * torch.rsqrt(ss / d_in + cfg.norm_eps)
             * p["norm"].float()).to(dtype)
    out = torch.matmul(y, p["out_proj"].to(dtype))
    if part is not None:
        out = PT.reduce_from(out, mesh, tp)

    if cache is not None:
        cache["conv_x"].copy_(new_conv_x)
        cache["conv_bc"].copy_(new_conv_bc)
        cache["state"].copy_(new_state)
    return out, cache
