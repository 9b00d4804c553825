"""Train-step factories.

Port of ``repro/train/step.py``. Two step builders mirror the paper's two
``ExecutionImplementation`` s, as in the reference:

* :func:`make_train_step`, the one-rank path (the reference's GSPMD step
  on a mesh whose every axis has size 1): forward and backward through
  autograd, gradient accumulation over ``RunConfig.microbatches`` in the
  reference's batch-major split, the ``RunConfig.remat`` policy, the
  global-norm clip and AdamW;
* :func:`make_dp_train_step_explicit`, the explicit data-parallel step:
  every rank of a :class:`~repro_torch.launch.mesh.ProcessMesh` axis runs
  the step on its rows of the global batch and reduces the gradients by
  hand through the collective engine, ``allreduce_tree`` under the
  ``dp.grads`` callsite, or leaf by leaf with int8 error feedback
  (``RunConfig.grad_compression="int8_ef"``).

The reference's jitted steps donate the state (``donate_argnums``); here
the steps update the state in place, leaf by leaf under ``torch.no_grad``
(:func:`repro_torch.optim.adamw.adamw_update_`), and return it.
Training takes the plain ``attention``, as the reference does: its flash
kernel has no VJP and runs only in prefill.

* :func:`make_whole_model_train_step_explicit`, the explicit whole-model
  step: the forward and backward of every rank's rows with every wire hop
  an engine call, attention through the ``tp`` or ``sp`` hook of
  :mod:`repro_torch.models.parallel`, MoE through the expert-parallel
  layer with the experts sharded over the axis
  (:func:`whole_model_param_specs`, :func:`shard_whole_model_state`), the
  replicated leaves' gradients through ``allreduce_tree``.

Not yet ported, with the GSPMD placement on several ranks (the rest of
ROADMAP A12's second half): ``state_specs``, ``shard_state`` and the
``fsdp`` / ZeRO-1 placement of ``make_train_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch.comm import compression
from repro_torch.comm.callsites import DP_GRADS
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.overlap import tree_flatten, tree_unflatten
from repro_torch.comm.types import comm_type
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import Model, next_token_loss
from repro_torch.models.parallel import make_attn_impl
from repro_torch.models.transformer import tree_map
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update_,
                                     clip_scale, global_norm,
                                     make_lr_schedule)


@dataclass
class TrainState:
    """``params``: the model's weights (a parameter module, gradients on);
    ``opt``: ``{'mu', 'nu'}`` fp32 trees shaped like ``params.tree()`` and
    ``'count'``; ``step``: the int32 step on the host; ``error``: the
    compression error-feedback tree, or None."""
    params: object
    opt: Dict
    step: torch.Tensor
    error: Optional[Dict] = None


def init_train_state(model: Model, seed: int = 0, *,
                     compression_on: bool = False,
                     device=None) -> TrainState:
    """Weights from ``model.init(seed)`` with gradients on, zero moments,
    step 0, and a zero error tree when ``compression_on``."""
    params = model.init(seed, device=device)
    params.requires_grad_(True)
    tree = params.tree()
    return TrainState(params=params, opt=adamw_init(tree),
                      step=torch.zeros((), dtype=torch.int32),
                      error=(compression.init_error_tree(tree)
                             if compression_on else None))


def _adamw(run_cfg: RunConfig, adamw: Optional[AdamWConfig]) -> AdamWConfig:
    return adamw or AdamWConfig(lr=run_cfg.learning_rate,
                                weight_decay=run_cfg.weight_decay,
                                max_grad_norm=run_cfg.max_grad_norm)


def _device(params) -> torch.device:
    return next(params.parameters()).device


def _on(batch: Dict, device, rows: slice = slice(None)) -> Dict:
    return {k: torch.as_tensor(v)[rows].to(device) for k, v in batch.items()}


def _backward(params, loss_fn, batch) -> Tuple[torch.Tensor, list]:
    """The loss and its gradient, one tensor per leaf of
    ``params.tree()`` in tree order (zeros for a weight the loss does not
    reach, as the reference's ``value_and_grad`` gives)."""
    leaves = tree_flatten(params.tree(data=False))[0]
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def _apply_update(state: TrainState, grads: list, adamw: AdamWConfig,
                  schedule: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip by the global norm and take the AdamW step in place; returns
    (grad_norm, lr)."""
    gnorm = global_norm(grads)
    lr = schedule(state.step)
    adamw_update_(grads, state.opt, state.params.tree(data=False), adamw, lr,
                  scale=clip_scale(gnorm, adamw.max_grad_norm))
    state.step = state.step + 1
    return gnorm, lr


# ---------------------------------------------------------------------------
# the one-rank step
# ---------------------------------------------------------------------------


def make_train_step(model: Model, run_cfg: RunConfig, mesh=None, *,
                    adamw: Optional[AdamWConfig] = None,
                    total_steps: int = 10_000) -> Callable:
    """``(state, batch) -> (state, metrics)``, updating ``state`` in place.
    ``mesh`` (default: the one-rank mesh) must have every axis of size 1;
    ``metrics`` holds the fp32 scalars ``loss``, ``grad_norm`` and
    ``lr``."""
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    mesh = mesh if mesh is not None else single_rank_mesh(("x",))
    shard = sh.make_shard_fn(mesh, sh.rules_for(mesh))
    nmicro = max(run_cfg.microbatches, 1)

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, shard=shard,
                                   remat=run_cfg.remat)
        return next_token_loss(logits, batch["tokens"])

    def compute_grads(params, batch):
        device = _device(params)
        if nmicro == 1:
            return _backward(params, loss_fn, _on(batch, device))
        # gradient accumulation over the batch-major split: microbatch k
        # is rows [k * b / n, (k + 1) * b / n), as the reference's reshape
        b = len(batch["tokens"])
        if b % nmicro:
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{nmicro} microbatches")
        m = b // nmicro
        acc_loss, acc = None, None
        for k in range(nmicro):
            loss, grads = _backward(params, loss_fn,
                                    _on(batch, device, slice(k * m,
                                                             (k + 1) * m)))
            if acc is None:
                acc_loss = torch.zeros((), dtype=torch.float32,
                                       device=device)
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=device) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.float() / nmicro)
            acc_loss = acc_loss + loss / nmicro
            del grads
        return acc_loss, acc

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = compute_grads(state.params, batch)
        gnorm, lr = _apply_update(state, grads, adamw, schedule)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# the explicit data-parallel step
# ---------------------------------------------------------------------------

# the tuning-table callsite of the bucketed gradient reduction: a measured
# ``allreduce@dp.grads`` entry wins over the isolated allreduce's
GRADS_CALLSITE = DP_GRADS


def make_dp_train_step_explicit(model: Model, run_cfg: RunConfig, mesh, *,
                                axis: str = "x",
                                adamw: Optional[AdamWConfig] = None,
                                schedule_kind: str = "auto",
                                bucket_bytes: Optional[int] = None,
                                total_steps: int = 10_000,
                                cost_model=None) -> Callable:
    """Data-parallel step with hand-written gradient reduction, run by
    every rank of ``mesh``'s ``axis`` on its own process.

    ``(state, batch) -> (state, metrics)``: ``batch`` is the global batch,
    the same on every rank; rank i trains on rows [i * b / n, (i + 1) * b
    / n), the rows ``shard_map``'s ``P(axis)`` gives it in the reference.
    Its gradients, divided by the rank count, are summed over the axis by
    :meth:`~repro_torch.comm.engine.CollectiveEngine.allreduce_tree` in
    ~``bucket_bytes`` buckets (None: the cost model's size) under the
    ``dp.grads`` callsite, with the registered schedule ``schedule_kind``
    (``"auto"`` resolves per bucket through the cost model, or
    ``cost_model`` when given); the loss through ``engine.allreduce``.
    ``run_cfg.comm_type`` picks ICI_DIRECT or HOST_STAGED.

    With ``run_cfg.grad_compression == "int8_ef"`` the gradients reduce
    leaf by leaf through :func:`repro_torch.comm.compression.
    compressed_psum` (per-leaf error state cannot be bucketed without
    re-blocking the quantizer), riding the engine's schedules, and the
    state's error tree carries the residuals. Every rank then holds the
    same reduced gradients and takes the same AdamW step, so the weights
    stay replicated (bit for bit wherever the schedule gives every rank
    the same bits)."""
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    engine = CollectiveEngine.for_mesh(mesh, comm_type(run_cfg.comm_type),
                                       schedule_kind, cost_model=cost_model)
    compress = run_cfg.grad_compression == "int8_ef"
    ax = mesh.axis(axis)
    ndev = ax.size

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, remat=run_cfg.remat)
        return next_token_loss(logits, batch["tokens"])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rows = len(batch["tokens"])
        if rows % ndev:
            raise ValueError(f"a global batch of {rows} rows does not split "
                             f"over {ndev} ranks")
        b = rows // ndev
        local = _on(batch, _device(state.params),
                    slice(ax.index * b, (ax.index + 1) * b))
        loss, grads = _backward(state.params, loss_fn, local)
        grads = [g.float() / ndev for g in grads]
        if compress:
            errors, spec = tree_flatten(state.error)
            red, new_errors = [], []
            for g, e in zip(grads, errors):
                r, ne = compression.compressed_psum(g, axis, e,
                                                    engine=engine)
                red.append(r)
                new_errors.append(ne)
            state.error = tree_unflatten(spec, new_errors)
        else:
            spec = tree_flatten(state.params.tree())[1]
            red = tree_flatten(engine.allreduce_tree(
                tree_unflatten(spec, grads), axis, bucket_bytes=bucket_bytes,
                callsite=GRADS_CALLSITE))[0]
        del grads
        loss = engine.allreduce(loss / ndev, axis)
        gnorm, lr = _apply_update(state, red, adamw, schedule)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.engine = engine
    return train_step


# ---------------------------------------------------------------------------
# the explicit whole-model step
# ---------------------------------------------------------------------------

# the expert-dimension leaves of a MoE layer's tree (its router and shared
# expert stay whole on every rank)
EXPERT_LEAVES = ("w_gate", "w_in", "w_out")


@dataclass(frozen=True)
class LeafSpec:
    """Where a weight lives under the explicit whole-model step: ``dims``
    names, per leading dimension, the mesh axis it is split over (None:
    whole), the entries of a ``PartitionSpec``; empty for a replicated
    weight."""
    dims: Tuple[Optional[str], ...] = ()

    @property
    def replicated(self) -> bool:
        return not any(self.dims)


def whole_model_param_specs(params, axis: str = "x") -> Dict:
    """The reference's layout of the explicit whole-model step, as a tree
    shaped like ``params.tree()`` (or like ``params``, a tree already):
    every leaf a :class:`LeafSpec`, replicated except each MoE layer's
    expert weights, split over ``axis`` on their expert dimension. The
    reference's ``moe_param_specs(..., scanned=True)`` puts the expert
    dimension after the super-block scan dimension that the port's
    per-layer list replaces, so its ``P(None, axis)`` is ``(axis,)``
    here."""
    tree = params.tree() if isinstance(params, torch.nn.Module) else params
    specs = tree_map(tree, lambda _: LeafSpec())
    for blk, spec in zip(tree["blocks"], specs["blocks"]):
        if "moe" in blk:
            for k in EXPERT_LEAVES:
                spec["moe"][k] = LeafSpec((axis,))
    return specs


def _cut(tree, specs, mesh):
    """``tree`` with each leaf split by its :class:`LeafSpec` cut to this
    rank's contiguous block (a copy, so that the whole leaf can be
    freed)."""
    leaves, spec = tree_flatten(tree)
    out = []
    for t, s in zip(leaves, tree_flatten(specs)[0]):
        for dim, name in enumerate(s.dims):
            if name is not None:
                ax = mesh.axis(name)
                MOE._check_divides(t.shape[dim], ax.size, name)
                n = t.shape[dim] // ax.size
                t = t.narrow(dim, ax.index * n, n).clone()
        out.append(t)
    return tree_unflatten(spec, out)


def shard_whole_model_params(params, mesh, axis: str = "x"):
    """This rank's part of whole weights under
    :func:`whole_model_param_specs` on ``mesh``: a new weight module, with
    gradients on if ``params`` had them."""
    specs = whole_model_param_specs(params, axis)
    cut = type(params)(params.cfg, _cut(params.tree(), specs, mesh))
    return cut.requires_grad_(any(p.requires_grad
                                  for p in params.parameters()))


def shard_whole_model_state(state: TrainState, mesh,
                            axis: str = "x") -> TrainState:
    """This rank's part of a whole ``state`` under
    :func:`whole_model_param_specs` on ``mesh``: the weights and both AdamW
    moments cut alike (the reference's ``shard_map`` in_specs), the
    counters and the error tree as they are."""
    specs = whole_model_param_specs(state.params, axis)
    return TrainState(params=shard_whole_model_params(state.params, mesh,
                                                      axis),
                      opt={"mu": _cut(state.opt["mu"], specs, mesh),
                           "nu": _cut(state.opt["nu"], specs, mesh),
                           "count": state.opt["count"]},
                      step=state.step, error=state.error)


def gather_whole_model_state(state: TrainState, mesh, axis: str = "x",
                             engine: Optional[CollectiveEngine] = None
                             ) -> TrainState:
    """The whole state from every rank's part, the inverse of
    :func:`shard_whole_model_state`: each split leaf is gathered over
    ``axis`` through ``engine.all_to_all_tiles`` (this rank's block repeated
    once per rank, every copy to one rank, concatenated by source), which
    moves bytes only, so the result equals the uncut state bit for bit.
    Every rank of the axis calls it and gets the whole state; the
    replicated leaves are this rank's own."""
    engine = engine or CollectiveEngine.for_mesh(mesh, schedule="auto")
    specs = whole_model_param_specs(state.params, axis)

    def gather(tree):
        leaves, spec = tree_flatten(tree)
        out = []
        for t, s in zip(leaves, tree_flatten(specs)[0]):
            for dim, name in enumerate(s.dims):
                if name is not None:
                    n = mesh.axis(name).size
                    rep = t.detach().unsqueeze(0).expand(n, *t.shape)
                    t = engine.all_to_all_tiles(
                        rep.contiguous(), name, split_axis=0,
                        concat_axis=dim + 1)[0]
            out.append(t)
        return tree_unflatten(spec, out)

    params = state.params
    with torch.no_grad():
        whole = type(params)(params.cfg, gather(params.tree()))
        whole.requires_grad_(any(p.requires_grad
                                 for p in params.parameters()))
        return TrainState(params=whole,
                          opt={"mu": gather(state.opt["mu"]),
                               "nu": gather(state.opt["nu"]),
                               "count": state.opt["count"]},
                          step=state.step, error=state.error)


def make_whole_model_train_step_explicit(
        model: Model, run_cfg: RunConfig, mesh, *, axis: str = "x",
        attn_mode: str = "tp", adamw: Optional[AdamWConfig] = None,
        schedule_kind: str = "auto", nchunks=1,
        bucket_bytes: Optional[int] = None, total_steps: int = 10_000,
        cost_model=None) -> Callable:
    """Whole-model engine-routed step, run by every rank of ``mesh``'s
    ``axis`` on its own process (reference ``train/step.py:292-413``).

    ``(state, batch) -> (state, metrics)`` with ``state`` this rank's part
    (:func:`shard_whole_model_state`) and ``batch`` the global batch; rank
    i trains on rows [i * b / n, (i + 1) * b / n). Every wire hop is an
    engine call under a registered callsite tag:

    * attention through the ``attn_mode`` hook of
      :mod:`repro_torch.models.parallel`: head-parallel (``tp``,
      ``tp.qkv`` / ``tp.out``) or sequence-parallel ring attention
      (``sp``, ``sp.qkv`` / ``sp.kv`` / ``sp.out``);
    * MoE dispatch and combine under ``moe.dispatch`` / ``moe.combine``
      with the experts sharded in the state (``nchunks``, ``"auto"`` too,
      pipelines the capacity strips as in the single-layer path);
    * the replicated leaves' gradients through ``allreduce_tree`` under
      ``dp.grads``, the loss through ``allreduce``.

    Gradients: the residual stream is batch-sharded, so the local backward
    already gives the expert shards' complete gradients (the backward of
    dispatch and combine brings every rank's terms to the owner); they are
    only divided by the rank count, never reduced, while the replicated
    leaves are. The global-norm clip adds the expert shards' sums of
    squares over the ranks first, so the scale and ``grad_norm`` equal the
    one-rank step's. AdamW runs in place, leaf by leaf. Against the
    one-rank :func:`make_train_step` on the global batch the differences
    are reassociation only."""
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        raise ValueError("whole-model explicit step supports decoder-only "
                         "models (encoder-decoder has no explicit path)")
    if run_cfg.grad_compression != "none":
        raise ValueError(
            "whole-model explicit step does not support grad_compression="
            f"{run_cfg.grad_compression!r}: the int8 error-feedback path "
            "reduces leaf-wise and cannot skip the expert-sharded leaves")
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    engine = CollectiveEngine.for_mesh(mesh, comm_type(run_cfg.comm_type),
                                       schedule_kind, cost_model=cost_model)
    ax = mesh.axis(axis)
    ndev = ax.size
    # schedule=None: the hooks take the engine-wide resolution (auto through
    # the cost model, or the engine's explicit schedule_kind)
    attn_impl = make_attn_impl(attn_mode, cfg, mesh, axis=axis, engine=engine)
    moe_impl = (MOE.make_moe_impl(cfg, mesh, axis=axis, engine=engine,
                                  nchunks=nchunks) if cfg.has_moe else None)

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, remat=run_cfg.remat,
                                   attn_impl=attn_impl, moe_impl=moe_impl)
        return next_token_loss(logits, batch["tokens"])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rows = len(batch["tokens"])
        if rows % ndev:
            raise ValueError(f"a global batch of {rows} rows does not split "
                             f"over {ndev} ranks")
        b = rows // ndev
        local = _on(batch, _device(state.params),
                    slice(ax.index * b, (ax.index + 1) * b))
        loss, grads = _backward(state.params, loss_fn, local)
        specs = tree_flatten(whole_model_param_specs(state.params, axis))[0]
        # in place where the gradient is fp32 already: no second copy of it
        grads = [g.div_(ndev) if g.dtype == torch.float32
                 else g.float() / ndev for g in grads]
        rep = [i for i, s in enumerate(specs) if s.replicated]
        shard = [i for i, s in enumerate(specs) if not s.replicated]
        red = engine.allreduce_tree([grads[i] for i in rep], axis,
                                    bucket_bytes=bucket_bytes,
                                    callsite=GRADS_CALLSITE)
        for i, g in zip(rep, red):
            grads[i] = g
        del red
        loss = engine.allreduce(loss / ndev, axis)
        # the replicated leaves are alike on every rank after the
        # reduction, so their sum of squares is local; the expert shards'
        # is summed over the ranks
        sq = sum(torch.sum(torch.square(grads[i])) for i in rep)
        if shard:
            sq = sq + engine.allreduce(
                sum(torch.sum(torch.square(grads[i])) for i in shard), axis)
        gnorm = torch.sqrt(sq)
        lr = schedule(state.step)
        adamw_update_(grads, state.opt, state.params.tree(data=False), adamw,
                      lr, scale=clip_scale(gnorm, adamw.max_grad_norm))
        state.step = state.step + 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.engine = engine
    return train_step
