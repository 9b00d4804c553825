"""PTRANS block-cyclic (de)distribution, shared with HPL.

Port of ``repro/core/ptrans.py:58-87``. Blocks are distributed
block-cyclically over a P x P grid (the paper's PQ scheme, Fig. 3): global
block (I, J) lives on grid rank (I % P, J % P), flattened row-major, at
local tile (I // P, J // P). ``run_ptrans`` arrives with the PTRANS slice
(ROADMAP A5).
"""
from __future__ import annotations

import numpy as np


def distribute_cyclic(mat: np.ndarray, pg: int, b: int) -> np.ndarray:
    """(n, n) -> (pg*pg, m, m) stack of per-device local matrices. Global
    block (I, J) -> device (I%P, J%P), local tile (I//P, J//P)."""
    n = mat.shape[0]
    nb = n // b
    lb = nb // pg
    m = lb * b
    out = np.empty((pg * pg, m, m), mat.dtype)
    for gi in range(nb):
        for gj in range(nb):
            dev = (gi % pg) * pg + (gj % pg)
            li, lj = gi // pg, gj // pg
            out[dev, li * b:(li + 1) * b, lj * b:(lj + 1) * b] = \
                mat[gi * b:(gi + 1) * b, gj * b:(gj + 1) * b]
    return out


def undistribute_cyclic(shards: np.ndarray, pg: int, b: int) -> np.ndarray:
    nshards, m, _ = shards.shape
    lb = m // b
    nb = lb * pg
    n = nb * b
    out = np.empty((n, n), shards.dtype)
    for gi in range(nb):
        for gj in range(nb):
            dev = (gi % pg) * pg + (gj % pg)
            li, lj = gi // pg, gj // pg
            out[gi * b:(gi + 1) * b, gj * b:(gj + 1) * b] = \
                shards[dev, li * b:(li + 1) * b, lj * b:(lj + 1) * b]
    return out
