"""Decode state: the dense KV cache of attention layers, the conv and SSD
state of SSM layers, and the paged KV cache of the serving engine.

Port of ``repro/models/kvcache.py``. The port keeps one dict per layer (a
list, not the reference's stack over super-blocks) and writes into it in
place.

The paged cache (``:54-217``) holds one pool of fixed-size pages per layer,
shared by every request; a host-side :class:`PageAllocator` (numpy, as in
the reference) hands pages to requests on admission and recycles them on
completion. Its block table marks "no page" with the sentinel
``num_pages``. The reference's device helpers rely on ``jnp``'s index
modes there: gathers through the sentinel clip, scatters to it drop. Torch
indexing has no such modes (an out-of-range index raises on the CPU and is
a device-side assert on the card), so :func:`gather_pages` clamps
explicitly and :func:`commit_prefill` and :func:`scatter_token` write only
the positions whose page is real.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.ssm import ssm_dims


def attn_cache_spec(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                    device=None, kv_heads=None) -> Dict[str, torch.Tensor]:
    kv, hd = kv_heads or cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype, device=device),
    }


def local_cache_dims(cfg: ModelConfig, batch: int, mesh):
    """(rows, KV heads, SSM heads) of this rank's dense cache on ``mesh``
    for a global ``batch``, in :func:`repro_torch.sharding.cache_specs`'
    layout: the batch over ``dp`` and the KV heads over ``tp`` where they
    divide. Where they do not divide ``tp`` the reference splits the head
    dimension (``kv_fallback='hd'``); the port holds instead the whole
    KV heads its q heads map to (ROADMAP A12, "How the port differs"),
    and whole heads when ``tp`` does not divide the q heads either. The
    SSM heads split over ``tp`` where it divides them
    (:func:`repro_torch.models.ssm.heads_held`), else stay whole."""
    from repro_torch import partition as P
    from repro_torch import sharding as sh
    from repro_torch.models.layers import kv_heads_held
    from repro_torch.models.ssm import heads_held

    rules = sh.rules_for(mesh)
    shape = torch.empty((1, batch, 1, cfg.num_kv_heads, cfg.head_dim),
                        device="meta")
    spec = sh.cache_specs({"k": shape}, rules, mesh)["k"]
    b_n = sh.block_of(mesh, spec.dims[1])[1] if spec.dims[1] else 1
    part = P.placement(sh.make_shard_fn(mesh, rules))
    ssm = heads_held(cfg, part)[1] if cfg.ssm_state else 0
    return batch // b_n, kv_heads_held(cfg, part)[1], ssm


def pool_heads(cfg: ModelConfig, mesh, axis=None):
    """(start, count) of the KV heads this rank's page pool holds on
    ``mesh``. With ``axis`` (the explicit decode) the KV heads split
    contiguously over it, the reference's ``pages_spec`` ``P(None, None,
    None, axis, None)``; without it (the GSPMD decode) they follow
    :func:`repro_torch.models.layers.kv_heads_held` on the mesh's
    placement: split over ``tp`` where it divides them, else the block this
    rank's q heads map to, and all of them on a mesh without a ``tp``
    axis."""
    from repro_torch import partition as P
    from repro_torch import sharding as sh
    from repro_torch.models.layers import kv_heads_held

    KV = cfg.num_kv_heads
    if axis is not None:
        ax = mesh.axis(axis)
        if KV % ax.size:
            raise ValueError(
                f"num_kv_heads={KV} must be divisible by the {axis!r} axis "
                f"size {ax.size} for the paged decode exchange")
        n = KV // ax.size
        return ax.index * n, n
    part = P.placement(sh.make_shard_fn(mesh, sh.rules_for(mesh)))
    return kv_heads_held(cfg, part)


def ssm_cache_spec(cfg: ModelConfig, batch: int, dtype,
                   device=None, heads=None) -> Dict[str, torch.Tensor]:
    """The last K - 1 conv inputs in ``dtype`` and the SSD state in fp32;
    ``heads`` (a rank's share) sizes ``conv_x`` and ``state``, and
    ``conv_bc`` stays whole."""
    d_in, H, P, G, N = ssm_dims(cfg)
    if heads is not None and heads != H:
        d_in, H = heads * P, heads
    return {
        "conv_x": torch.zeros((batch, cfg.ssm_conv - 1, d_in), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, cfg.ssm_conv - 1, 2 * G * N),
                               dtype=dtype, device=device),
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
    }


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------


class OutOfPagesError(RuntimeError):
    """The page pool cannot satisfy an allocation (pages or slots)."""


@dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of the page pool.

    ``page_size``   tokens per page.
    ``num_pages``   pool size, shared by all requests (also the block-table
                    sentinel value: an entry == ``num_pages`` means "no
                    page"; writes to it are dropped).
    ``max_slots``   decode batch width: concurrent requests.
    ``max_seq``     per-request token cap (prompt + generated); bounds the
                    block-table row width.
    """
    page_size: int
    num_pages: int
    max_slots: int
    max_seq: int

    def __post_init__(self):
        if min(self.page_size, self.num_pages,
               self.max_slots, self.max_seq) <= 0:
            raise ValueError(f"non-positive paged-cache geometry: {self}")

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq // self.page_size)


def paged_attn_cache_spec(cfg: ModelConfig, pcfg: PagedCacheConfig, dtype,
                          device=None,
                          kv_heads=None) -> Dict[str, torch.Tensor]:
    """One layer's page pool: k/v pages of (num_pages, page_size, KV,
    hd), ``KV`` being ``kv_heads`` where given (a rank's share)."""
    shape = (pcfg.num_pages, pcfg.page_size, kv_heads or cfg.num_kv_heads,
             cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=dtype, device=device),
            "v_pages": torch.zeros(shape, dtype=dtype, device=device)}


class PageAllocator:
    """Host-side block table + free-list over one page pool.

    A request reserves its worst-case page count up front (``allocate``
    with the prompt + max-new token total), so decode never runs out of
    pages mid-flight: admission control happens once, via
    ``can_allocate``. ``seq_len`` then tracks the filled prefix: ``append``
    advances it one token per decode step, ``release`` recycles the slot
    and its pages.

    The numpy ``block_table`` / ``seq_lens`` are the decode step's inputs
    (:meth:`device_tables`): unallocated entries hold the sentinel
    ``num_pages``, whose writes drop and whose gathers clamp (masked off by
    length).
    """

    def __init__(self, pcfg: PagedCacheConfig):
        self.cfg = pcfg
        self.block_table = np.full(
            (pcfg.max_slots, pcfg.pages_per_slot), pcfg.num_pages, np.int32)
        self.seq_lens = np.zeros((pcfg.max_slots,), np.int32)
        self._capacity = np.zeros((pcfg.max_slots,), np.int32)
        self._free_pages: List[int] = list(range(pcfg.num_pages))
        self._free_slots: List[int] = list(range(pcfg.max_slots))

    def _pages_for(self, total_tokens: int) -> int:
        return -(-total_tokens // self.cfg.page_size)

    @property
    def free_page_count(self) -> int:
        return len(self._free_pages)

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    def can_allocate(self, total_tokens: int) -> bool:
        return (bool(self._free_slots)
                and 0 < total_tokens <= self.cfg.max_seq
                and self._pages_for(total_tokens) <= len(self._free_pages))

    def allocate(self, total_tokens: int) -> int:
        """Reserve a slot + pages for up to ``total_tokens``; returns the
        slot."""
        if total_tokens <= 0 or total_tokens > self.cfg.max_seq:
            raise ValueError(
                f"request of {total_tokens} tokens exceeds max_seq="
                f"{self.cfg.max_seq}")
        npages = self._pages_for(total_tokens)
        if not self._free_slots or npages > len(self._free_pages):
            raise OutOfPagesError(
                f"cannot reserve {npages} pages + 1 slot "
                f"(free: {len(self._free_pages)} pages, "
                f"{len(self._free_slots)} slots)")
        slot = self._free_slots.pop(0)
        for i in range(npages):
            self.block_table[slot, i] = self._free_pages.pop(0)
        self.seq_lens[slot] = 0
        self._capacity[slot] = npages * self.cfg.page_size
        return slot

    def commit(self, slot: int, length: int) -> None:
        """Record ``length`` prefilled tokens for ``slot``."""
        if length > self._capacity[slot]:
            raise ValueError(
                f"slot {slot}: prefill of {length} exceeds reserved "
                f"capacity {int(self._capacity[slot])}")
        self.seq_lens[slot] = length

    def append(self, slot: int, n: int = 1) -> None:
        """Advance ``slot`` by ``n`` decoded tokens."""
        if self.seq_lens[slot] + n > self._capacity[slot]:
            raise OutOfPagesError(
                f"slot {slot}: append past reserved capacity "
                f"{int(self._capacity[slot])}")
        self.seq_lens[slot] += n

    def release(self, slot: int) -> None:
        """Recycle the slot and its pages (block-table row -> sentinel)."""
        row = self.block_table[slot]
        self._free_pages.extend(int(p) for p in row if p < self.cfg.num_pages)
        row[:] = self.cfg.num_pages
        self.seq_lens[slot] = 0
        self._capacity[slot] = 0
        self._free_slots.append(slot)

    def device_tables(self, device=None):
        """(block_table, seq_lens) as int32 tensors on ``device`` for the
        decode step."""
        return (torch.from_numpy(self.block_table.copy()).to(device),
                torch.from_numpy(self.seq_lens.copy()).to(device))


def gather_pages(pages: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """Gather a pool's pages into per-slot contiguous KV.

    ``pages``: (num_pages, page_size, KV, hd); ``block_table``: (B, pmax)
    integers (sentinel entries clamp to the last page, as the reference's
    ``mode="clip"``; callers mask by length). Returns a new (B, pmax *
    page_size, KV, hd) tensor."""
    B, pmax = block_table.shape
    idx = block_table.long().clamp(0, pages.shape[0] - 1).reshape(-1)
    g = pages.index_select(0, idx)
    return g.reshape(B, pmax * pages.shape[1], *pages.shape[2:])


def _real(page_idx: torch.Tensor, off: torch.Tensor, num_pages: int):
    """(positions, pages, offsets) of the entries of ``page_idx`` that name
    a real page (< ``num_pages``): the reference's scatters drop the
    others. One nonzero selects them, so no dropped write is clamped onto
    a page that a real one also writes."""
    keep = (page_idx < num_pages).nonzero()[:, 0]
    return keep, page_idx[keep], off[keep]


def commit_prefill(pages_layers: List[Dict], dense_layers: List[Dict],
                   block_row, length, *, page_size: int,
                   kv_heads=None) -> List[Dict]:
    """Scatter one request's dense prefill cache into its reserved pages,
    in place.

    ``pages_layers``: per layer ``{'k_pages', 'v_pages'}`` (P, ps, KV,
    hd); ``dense_layers``: per layer ``{'k', 'v'}`` (1, S, KV, hd) (a
    batch-1 prefill, possibly padded past ``length``: pad positions drop,
    as do positions whose block-table entry is the sentinel).
    ``block_row``: (pmax,) integers. ``kv_heads`` (start, count) commits
    that slice of the dense cache's KV heads, a rank's share of a pool
    split over ranks (:func:`pool_heads`); None commits them all. Returns
    ``pages_layers``."""
    S = dense_layers[0]["k"].shape[1]
    device = pages_layers[0]["k_pages"].device
    num_pages = pages_layers[0]["k_pages"].shape[0]
    pos = torch.arange(S, device=device)
    row = torch.as_tensor(block_row, device=device).long()
    page_idx = row[(pos // page_size).clamp(max=row.shape[0] - 1)]
    page_idx = torch.where(pos < int(length), page_idx, num_pages)
    keep, page, off = _real(page_idx, pos % page_size, num_pages)
    for pages, dense in zip(pages_layers, dense_layers):
        for pooled, flat in (("k_pages", "k"), ("v_pages", "v")):
            pool = pages[pooled]
            src = dense[flat][0, keep]
            if kv_heads is not None:
                src = src.narrow(1, *kv_heads)
            pool[page, off] = src.to(pool.dtype)
    return pages_layers


def token_slots(block_table: torch.Tensor, lengths: torch.Tensor,
                page_size: int, num_pages: int):
    """Where each decode row's token at ``lengths[b]`` goes: the page of
    block-table column ``lengths // page_size`` (clipped to the row) at
    offset ``lengths % page_size``. Returns (rows, pages, offsets) of the
    rows whose page is real; rows on the sentinel (inactive slots) drop."""
    col = (lengths.long() // page_size).clamp(0, block_table.shape[1] - 1)
    page_idx = block_table.long().gather(1, col[:, None])[:, 0]
    return _real(page_idx, lengths.long() % page_size, num_pages)


def scatter_token(pages: Dict, upd: Dict, slots) -> None:
    """Write one layer's decode token update ``{'k_upd', 'v_upd'}`` (B, 1,
    KV, hd) into its pool in place, at :func:`token_slots`' ``slots``."""
    rows, page, off = slots
    for name, val in upd.items():
        pool = pages[name[0] + "_pages"]
        pool[page, off] = val[rows, 0].to(pool.dtype)
