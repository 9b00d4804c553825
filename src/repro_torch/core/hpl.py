"""HPL / LINPACK — distributed blocked right-looking LU on a 2-D torus
(paper §2.3, Figs. 4-8), ported from ``repro/core/hpl.py``.

HPL-AI ruleset: diagonally-dominant A, no pivoting; only the LU
factorization runs on the devices, the triangular solves run on the host,
and the reported error is the normalized residual
||Ax - b|| / (n * ||b|| * eps).

Per iteration k (paper Fig. 4), on the rank at grid coordinate (r, c):
  1. the (k%P, k%P) rank factorizes the diagonal block  [lu_factor_block]
  2. the packed LU block is broadcast along its grid row and column
     (``CollectiveEngine.bcast``, tag ``hpl.block``)
  3. grid row k%P solves the Top panel (U_kj), grid column k%P the Left
     panel (L_ik)                                       [trsm kernels]
  4. the panels are broadcast down/across the torus (tag ``hpl.panel``)
  5. every rank applies the trailing rank-b update to its local
     matrix, in place                                   [gemm_update]

Where the reference traces one program for all ranks and so computes the
diagonal block and both panels speculatively on every device, ``k`` is a
Python int here: only the owning ranks compute them, and the others hand
the broadcast a buffer of the right shape whose contents are never read.
The masks that restrict the panels to i, j > k stay multiplicative, so the
trailing update needs no selects.

Lookahead (paper Fig. 5/7) — ``lookahead=d`` keeps ``d`` panel sets in
flight: per iteration k, *copies* of the row and column strips that
iteration k+d's panels read are brought up to date first (2d thin GEMMs),
iteration k+d's panels are formed and broadcast, and only then is the bulk
trailing update of iteration k applied. The kernels sum every output
element in one fixed order whatever the operand shapes, so each strip
update equals the full update restricted to the strip bit for bit, and the
factorization equals eager mode bit for bit at every depth, on the card and
on the CPU alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import scipy.linalg
import torch

from repro_torch.comm.autotune import choose_hpl_depth
from repro_torch.comm.callsites import HPL_BLOCK, HPL_PANEL
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.core.models import hpl_flops
from repro_torch.core.ptrans import (distribute_cyclic, from_reference,
                                    to_reference, undistribute_cyclic)
from repro_torch.kernels.ops import (gemm_update, launch_counts,
                                     lu_factor_block, trsm_lower_left,
                                     trsm_upper_right)
from repro_torch.launch.mesh import single_rank_mesh


# ---------------------------------------------------------------------------
# problem generation / validation (host side, like the paper)
# ---------------------------------------------------------------------------


def generate_system(n: int, seed: int = 7) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Diagonally dominant A (HPL-AI rule), x = ones, b = A @ x."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] += n
    x = np.ones((n,), np.float32)
    b = a @ x
    return a, x, b


def solve_from_lu(lu: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host triangular solves L y = b, U x = y from the packed LU. Each
    solve reads only its own triangle of ``lu`` (L's unit diagonal is
    implied), so the two factors need no unpacked copies."""
    y = scipy.linalg.solve_triangular(lu, b, lower=True, unit_diagonal=True)
    return scipy.linalg.solve_triangular(lu, y, lower=False)


def normalized_residual(a: np.ndarray, x: np.ndarray, b: np.ndarray) -> float:
    eps = np.finfo(np.float32).eps
    r = np.max(np.abs(a @ x - b))
    return float(r / (a.shape[0] * np.max(np.abs(b)) * eps))


# ---------------------------------------------------------------------------
# distributed factorization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Local:
    """What one rank knows of the grid (the reference's traced r, c and
    global block indices)."""
    pg: int
    b: int
    r: int
    c: int
    li_global: torch.Tensor   # global block row of each local block row
    lj_global: torch.Tensor   # global block column of each local block col
    engine: CollectiveEngine

    def colmask(self, k: int) -> torch.Tensor:
        return (self.lj_global > k).repeat_interleave(self.b)

    def rowmask(self, k: int) -> torch.Tensor:
        return (self.li_global > k).repeat_interleave(self.b)

    def band(self, k: int) -> slice:
        lk = k // self.pg
        return slice(lk * self.b, (lk + 1) * self.b)


def _panels(k: int, diag, row_panel, col_panel, g: _Local):
    """Factor the diagonal block and form + broadcast iteration ``k``'s U/L
    panels (paper Fig. 4 steps 1-4). ``diag``/``row_panel``/``col_panel``
    are this rank's local strips at local block index k // pg, already
    carrying the first k rank-b updates. Returns (lu_blk, u_panel, l_panel),
    all broadcast grid-wide."""
    pk = k % g.pg
    eng = g.engine

    # 1. diagonal block, on its owner; the others pass their strip as the
    #    buffer the broadcast overwrites
    lu_local = lu_factor_block(diag) if g.r == g.c == pk else diag
    lu_blk = eng.bcast(lu_local, "cols", pk, callsite=HPL_BLOCK)
    lu_blk = eng.bcast(lu_blk, "rows", pk, callsite=HPL_BLOCK)

    # 2. Top panel: U_kj = L_kk^{-1} A_kj on grid row pk, cols j > k
    u_panel = row_panel
    if g.r == pk:
        u_panel = trsm_lower_left(lu_blk, row_panel) * g.colmask(k)[None, :]
    u_panel = eng.bcast(u_panel, "rows", pk, callsite=HPL_PANEL)

    # 3. Left panel: L_ik = A_ik U_kk^{-1} on grid col pk, rows i > k
    l_panel = col_panel
    if g.c == pk:
        l_panel = trsm_upper_right(lu_blk, col_panel) * g.rowmask(k)[:, None]
    l_panel = eng.bcast(l_panel, "cols", pk, callsite=HPL_PANEL)
    return lu_blk, u_panel, l_panel


def _update_writeback(k: int, a, lu_blk, u_panel, l_panel, g: _Local):
    """Apply iteration ``k``'s trailing rank-b update to the full local
    matrix (in place) and write back the factored panels."""
    pk = k % g.pg
    s = g.band(k)

    # 4. trailing update: masks zero the factored rows/cols
    a = gemm_update(a, l_panel, u_panel, alpha=-1.0)

    # 5. write back the factored panels on the ranks that own them
    if g.r == pk:
        row = a[s, :]
        row.copy_(torch.where(g.colmask(k)[None, :], u_panel, row))
    if g.c == pk:
        col = a[:, s]
        col.copy_(torch.where(g.rowmask(k)[:, None], l_panel, col))
    if g.r == g.c == pk:
        a[s, s] = lu_blk
    return a


def _iteration(k: int, a, g: _Local):
    """Eager iteration: factor+broadcast panels for k, then update."""
    s = g.band(k)
    lu_blk, u_panel, l_panel = _panels(k, a[s, s], a[s, :], a[:, s], g)
    return _update_writeback(k, a, lu_blk, u_panel, l_panel, g)


def _strip_panels(kidx: int, a, flight, g: _Local):
    """Form + broadcast iteration ``kidx``'s panels from copies of the thin
    strips of ``a`` it reads, first applying every pending in-flight update
    (the panel sets in ``flight``, oldest first) restricted to those strips
    — 2 thin GEMMs per pending set. ``a`` itself is not touched: the bulk
    updates apply the pending sets to it later."""
    s = g.band(kidx)
    row_strip = a[s, :].clone()
    col_strip = a[:, s].clone()
    for _lu_blk, u_panel, l_panel in flight:
        row_strip = gemm_update(row_strip, l_panel[s, :], u_panel, alpha=-1.0)
        col_strip = gemm_update(col_strip, l_panel, u_panel[:, s], alpha=-1.0)
    return _panels(kidx, col_strip[s, :], row_strip, col_strip, g)


def _iteration_lookahead(k: int, a, flight, g: _Local, *, nb: int, depth: int):
    """Depth-d lookahead iteration (paper Fig. 5/7): ``flight`` holds the
    ``depth`` panel sets of iterations k..k+d-1, already broadcast. Bring
    copies of the strips iteration k+d reads up to date, issue k+d's
    factorization + broadcasts, THEN apply iteration k's bulk update and
    write-back. Near the end k+d is clamped to nb-1; the panels formed there
    are dropped with the flight."""
    kd = min(k + depth, nb - 1)
    nxt = _strip_panels(kd, a, flight, g)
    a = _update_writeback(k, a, *flight[0], g)
    return a, flight[1:] + (nxt,)


def lookahead_depth(lookahead) -> int:
    """Normalize a ``lookahead`` argument to a pipeline depth: False/0 ->
    eager, True -> 1, an int d -> d. Negative depths fail fast."""
    if lookahead is True:
        return 1
    if lookahead is False or lookahead is None:
        return 0
    depth = int(lookahead)
    if depth < 0:
        raise ValueError(f"lookahead depth must be >= 0, got {lookahead!r}")
    return depth


def resolve_lookahead(lookahead, engine: CollectiveEngine, *, b: int,
                      m: int):
    """``lookahead`` as given, or for ``"auto"`` the depth the cost model
    chooses (:func:`repro_torch.comm.autotune.choose_hpl_depth`), with the
    broadcasts priced on what ``engine`` runs (engine-wide overrides,
    HOST_STAGED forcing staged), as the reference's ``run_hpl`` does."""
    if lookahead != "auto":
        return lookahead
    topo = engine.topology
    return choose_hpl_depth(
        b=b, m=m, axes=(topo.axis("rows"), topo.axis("cols")),
        model=engine._model(),
        resolve=lambda op, nbytes, ax, callsite: engine.schedule_for(
            op, nbytes=nbytes, axis=ax.name, callsite=callsite))


def make_factorize(mesh, *, pg: int, nb: int, b: int,
                   comm=CommunicationType.ICI_DIRECT, schedule: str = "auto",
                   lookahead=False, engine: CollectiveEngine = None):
    """The factorization of this rank's local (m, m) matrix, m = nb/pg * b.

    Returns ``fact(a_local) -> lu_local``. ``fact`` first copies its input
    (as the reference's jitted function leaves its argument intact), so it
    can be timed and rerun on the same input. The tensor's device picks the
    kernels: hand-written ones on ``cuda``, plain versions on the CPU.
    ``lookahead`` is a pipeline depth: False/0 eager, True/1 one panel set
    in flight, d >= 2 the depth-d pipeline, ``"auto"`` the cost model's
    depth (:func:`resolve_lookahead`)."""
    engine = engine or CollectiveEngine.for_mesh(mesh, comm, schedule)
    lb = nb // pg
    depth = min(lookahead_depth(resolve_lookahead(lookahead, engine, b=b,
                                                  m=lb * b)), nb)
    r, c = mesh.index("rows"), mesh.index("cols")

    def fact(a_local: torch.Tensor) -> torch.Tensor:
        a = a_local.clone()
        blocks = torch.arange(lb, device=a.device) * pg
        g = _Local(pg=pg, b=b, r=r, c=c, li_global=blocks + r,
                   lj_global=blocks + c, engine=engine)
        if not depth:
            for k in range(nb):
                a = _iteration(k, a, g)
            return a
        # prologue: fill the flight with iterations 0..d-1's panels, each
        # formed from strips carrying the pending earlier in-flight updates
        flight = ()
        for j in range(depth):
            flight += (_strip_panels(min(j, nb - 1), a, flight, g),)
        for k in range(nb):
            a, flight = _iteration_lookahead(k, a, flight, g, nb=nb,
                                             depth=depth)
        return a
    return fact


@register("hpl")
def run_hpl(mesh=None, comm=CommunicationType.ICI_DIRECT, *, n: int = 512,
            b: int = 64, schedule: str = "auto", reps: int = 2,
            validate: bool = True, lookahead=False,
            device=None) -> BenchResult:
    """HPL on the ``pg x pg`` torus ``mesh`` (axes 'rows', 'cols'; None is
    the single-rank 1x1 grid), on ``device`` (default: the card).

    ``lookahead`` is a depth (False/True/int), or ``"auto"`` for the depth
    the cost model chooses (:func:`resolve_lookahead`); ``details`` reports
    the depth that ran. ``details`` carries the reference's keys plus
    ``device`` and ``launches``: the kernel launches of one factorization
    (0 for a kernel that ran as its plain version)."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh()
    pg = mesh.shape["rows"]
    if mesh.shape["cols"] != pg:
        raise ValueError("paper requires a quadratic torus")
    nb = n // b
    if n % b or nb % pg:
        raise ValueError(f"n={n}, b={b} do not tile a {pg}x{pg} grid")
    engine = CollectiveEngine.for_mesh(mesh, comm, schedule)
    m = (nb // pg) * b
    depth = min(lookahead_depth(resolve_lookahead(lookahead, engine, b=b,
                                                  m=m)), nb)

    a, x_true, b_vec = generate_system(n)
    a_loc = from_reference(distribute_cyclic(a, pg, b), device)

    fact = make_factorize(mesh, pg=pg, nb=nb, b=b, engine=engine,
                          lookahead=depth)
    before = launch_counts()
    warmup = 1
    out, t = timeit(fact, a_loc, reps=reps, warmup=warmup)
    launches = {k: (v - before[k]) // (reps + warmup)
                for k, v in launch_counts().items()}

    err = 0.0
    if validate:
        lu = undistribute_cyclic(to_reference(out), pg, b)
        x = solve_from_lu(lu, b_vec)
        err = normalized_residual(a, x, b_vec)

    # resolved provenance: the names the engine runs for both bcast payloads
    # — the b x b diagonal block and the dominant b x m panels
    block_bytes = b * b * 4
    panel_bytes = b * m * 4
    resolved_block = engine.schedule_for("bcast", nbytes=block_bytes,
                                         axis="rows", callsite=HPL_BLOCK)
    resolved = engine.schedule_for("bcast", nbytes=panel_bytes, axis="rows",
                                   callsite=HPL_PANEL)
    return BenchResult(
        name="hpl", metric_name="GFLOP/s", metric=hpl_flops(n) / t / 1e9,
        error=err, times={"best": t},
        details={"n": n, "block": b, "grid": pg, "comm": engine.comm.value,
                 "schedule": resolved,
                 "schedule_block": resolved_block,
                 "schedule_panel": resolved,
                 "schedule_requested": engine.schedule,
                 "bcast_bytes": panel_bytes,
                 "block_bytes": block_bytes,
                 "lookahead": depth > 0,
                 "lookahead_depth": depth,
                 "device": device_name(device),
                 "launches": launches})
