"""Train-step factories.

Port of ``repro/train/step.py``. Two step builders mirror the paper's two
``ExecutionImplementation`` s, as in the reference:

* :func:`make_train_step`, the GSPMD step (reference ``:88-152``):
  forward and backward through autograd, gradient accumulation over
  ``RunConfig.microbatches`` in the reference's batch-major split, the
  ``RunConfig.remat`` policy, the global-norm clip and AdamW. On a mesh of
  several ranks every rank runs it on its ``batch_specs`` rows with its
  part of the state (:func:`shard_state`, :func:`state_specs`): the
  weights split over ``model`` by name, AdamW's moments also over the dp
  axes (ZeRO-1), and with ``fsdp`` the weights too. The collectives that
  XLA would insert are engine calls on the ``native`` schedule
  (:mod:`repro_torch.partition`);
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
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import partition as P
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
from repro_torch.sharding import LeafSpec


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
# the GSPMD step: one rank, or every rank of a mesh on its part of the state
# ---------------------------------------------------------------------------


def _grads(params, loss_fn, batch, nmicro: int):
    """The loss and the gradients of ``batch`` (on the weights' device),
    accumulated over ``nmicro`` microbatches in the batch-major split."""
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


def make_train_step(model: Model, run_cfg: RunConfig, mesh=None, *,
                    zero1: bool = True, fsdp: bool = False,
                    adamw: Optional[AdamWConfig] = None,
                    total_steps: int = 10_000) -> Callable:
    """``(state, batch) -> (state, metrics)``, updating ``state`` in place;
    ``metrics`` holds the fp32 scalars ``loss``, ``grad_norm`` and
    ``lr``. ``mesh`` defaults to the one-rank mesh.

    On a mesh with an axis wider than 1 every rank calls the step with
    the global batch and its part of the state (:func:`shard_state` with
    the same ``zero1`` and ``fsdp``); see :func:`_make_gspmd_step`."""
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    mesh = mesh if mesh is not None else single_rank_mesh(("x",))
    rules = sh.rules_for(mesh, fsdp=fsdp)
    shard = sh.make_shard_fn(mesh, rules)
    nmicro = max(run_cfg.microbatches, 1)
    if P.placement(shard) is not None:
        return _make_gspmd_step(model, run_cfg, shard, adamw, schedule,
                                nmicro, zero1)

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, shard=shard,
                                   remat=run_cfg.remat)
        return next_token_loss(logits, batch["tokens"])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = _grads(state.params, loss_fn, batch, nmicro)
        gnorm, lr = _apply_update(state, grads, adamw, schedule)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def state_specs(state: TrainState, rules: sh.MeshRules, mesh, *,
                zero1: bool = True) -> TrainState:
    """The :class:`~repro_torch.sharding.LeafSpec` trees of a whole (or
    ``device="meta"``) ``state`` (reference ``train/step.py:68-81``):
    the weights by :func:`~repro_torch.sharding.param_specs`, the moments
    by :func:`~repro_torch.sharding.opt_state_specs`, the counters
    whole."""
    ospec = sh.opt_state_specs(state.params, rules, mesh, zero1=zero1)
    return TrainState(
        params=sh.param_specs(state.params, rules, mesh),
        opt={"mu": ospec, "nu": ospec, "count": LeafSpec()},
        step=LeafSpec(),
        error=(None if state.error is None
               else sh.param_specs(state.error, rules, mesh)))


def _with_params(params, tree):
    cut = type(params)(params.cfg, tree)
    return cut.requires_grad_(any(p.requires_grad
                                  for p in params.parameters()))


def shard_state(state: TrainState, mesh, *, zero1: bool = True,
                fsdp: bool = False) -> TrainState:
    """This rank's part of a whole, host-initialized ``state`` under
    :func:`state_specs` on ``mesh`` (reference ``:155-162``): every leaf
    cut to its block, a new weight module with gradients on if
    ``state``'s had them."""
    rules = sh.rules_for(mesh, fsdp=fsdp)
    specs = state_specs(state, rules, mesh, zero1=zero1)
    return TrainState(
        params=_with_params(state.params, sh.cut(state.params.tree(),
                                                 specs.params, mesh)),
        opt={"mu": sh.cut(state.opt["mu"], specs.opt["mu"], mesh),
             "nu": sh.cut(state.opt["nu"], specs.opt["nu"], mesh),
             "count": state.opt["count"]},
        step=state.step,
        error=(None if state.error is None
               else sh.cut(state.error, specs.error, mesh)))


def _dp_dim(spec: LeafSpec, dp) -> Optional[int]:
    """The dimension ``spec`` splits over the dp axes, or None."""
    for d, e in enumerate(spec):
        if e == dp:
            return d
    return None


def _gather_leaf(t: torch.Tensor, spec: LeafSpec, mesh) -> torch.Tensor:
    for d, e in enumerate(spec):
        if e is not None:
            t = P.gather(t, mesh, e, d, source=None)
    return t


def _gathered(tree, specs, mesh):
    leaves, struct = tree_flatten(tree)
    return tree_unflatten(struct, [_gather_leaf(t.detach(), s, mesh)
                                   for t, s in zip(leaves, specs)])


def _whole_specs(model: Model, mesh, fsdp: bool, zero1: bool = True):
    rules = sh.rules_for(mesh, fsdp=fsdp)
    whole = model.init(device="meta")
    return (tree_flatten(sh.param_specs(whole, rules, mesh))[0],
            tree_flatten(sh.opt_state_specs(whole, rules, mesh,
                                            zero1=zero1))[0])


@torch.no_grad()
def gather_params(params, model: Model, mesh, *, fsdp: bool = False):
    """The whole weights from every rank's part under ``param_specs``
    (with ``fsdp``): a new weight module; every rank of the mesh calls
    it."""
    pspecs = _whole_specs(model, mesh, fsdp)[0]
    return _with_params(params, _gathered(params.tree(), pspecs, mesh))


@torch.no_grad()
def gather_state(state: TrainState, model: Model, mesh, *,
                 zero1: bool = True, fsdp: bool = False) -> TrainState:
    """The whole state from every rank's part (:func:`shard_state`'s
    inverse with the same ``zero1`` and ``fsdp``, for a checkpoint's whole
    arrays): each split leaf gathered over its axes through the engine,
    which moves bytes only, so the result equals the uncut state bit for
    bit. Every rank of the mesh calls it and gets the whole state."""
    pspecs, ospecs = _whole_specs(model, mesh, fsdp, zero1)
    return TrainState(
        params=gather_params(state.params, model, mesh, fsdp=fsdp),
        opt={"mu": _gathered(state.opt["mu"], ospecs, mesh),
             "nu": _gathered(state.opt["nu"], ospecs, mesh),
             "count": state.opt["count"]},
        step=state.step,
        error=(None if state.error is None
               else _gathered(state.error, pspecs, mesh)))


def _fsdp_gather(spec_tree, mesh, dp):
    """The ``ShardFn.gather`` hook of an FSDP step: ``gather(path, leaf or
    module)`` returns the weights at ``path`` (``"embed"``,
    ``"final_norm"``, ``"vlm"``, ``("blocks", i)``, and the
    encoder-decoder's ``"enc_norm"``, ``("enc_blocks", i)`` and
    ``("dec_blocks", i)``) with every dp-split leaf gathered (backward:
    summed over dp, this rank's slice)."""
    def one(t, spec):
        d = _dp_dim(spec, dp)
        return t if d is None else P.gather_summed(t, mesh, dp, d)

    def walk(t, spec):
        if isinstance(spec, dict):
            return {k: walk(t[k], spec[k]) for k in spec}
        return one(t, spec)

    def gather(path, sub):
        spec = spec_tree[path[0]][path[1]] if isinstance(path, tuple) \
            else spec_tree[path]
        if isinstance(sub, torch.nn.Module) and not isinstance(
                sub, torch.nn.Parameter):
            sub = sub.tree(data=False)
        return walk(sub, spec)
    return gather


def _make_gspmd_step(model: Model, run_cfg: RunConfig, shard, adamw,
                     schedule, nmicro: int, zero1: bool) -> Callable:
    """The GSPMD step on a mesh of several ranks, run by every rank on its
    own process with the global batch and its part of the state.

    * Rows: this rank's ``batch_specs`` rows (the whole batch where the dp
      axes do not divide it); the forward and backward run the layers'
      tensor-parallel blocks (:mod:`repro_torch.partition`).
    * Gradients: each is divided by the dp size; the leaves whole over dp
      are summed over dp by ``allreduce_tree`` on the ``native`` schedule
      (the FSDP leaves' gradients are summed by their gather's backward).
    * The global norm adds each leaf's squares once: summed over ``tp``
      for a tp-split leaf, over dp for a dp-split one, once for a whole
      one; the clip scale and ``grad_norm`` are the one-rank step's.
    * AdamW in place, leaf by leaf. Under ZeRO-1 (the moments of a leaf
      whole over dp hold this rank's ``zero1_spec`` block) each dp rank
      updates its block of the weight from the reduced gradient, then the
      blocks are gathered over dp into the weight; the per-element
      operations are the whole update's, so the bits are the same.
    """
    mesh, rules = shard.mesh, shard.rules
    fsdp = rules.fsdp
    part = P.placement(shard)
    dp, dp_n, tp = rules.dp_spec, part.dp_n, part.tp
    engine = part.engine
    whole = model.init(device="meta")
    spec_tree = sh.param_specs(whole, rules, mesh)
    pspecs = tree_flatten(spec_tree)[0]
    on_dp = [_dp_dim(s, dp) is not None for s in pspecs]
    # the dimension of each weight whose ZeRO-1 block this rank updates
    ospecs = tree_flatten(sh.opt_state_specs(whole, rules, mesh,
                                             zero1=zero1))[0]
    zdims = [None if d else _dp_dim(o, dp) for d, o in zip(on_dp, ospecs)]
    on_tp = [tp is not None and any(e == tp for e in s) for s in pspecs]
    gather = _fsdp_gather(spec_tree, mesh, dp) if fsdp else None

    def loss_fn(step_shard):
        def fn(params, batch):
            logits, _, _ = model.apply(params, batch, shard=step_shard,
                                       remat=run_cfg.remat)
            return next_token_loss(logits, batch["tokens"])
        return fn

    def reduce(x, axis):
        return P.allreduce(x, mesh, axis, P.DP)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rows = len(batch["tokens"])
        split = sh._maybe(rows, dp, mesh) is not None
        local = batch
        if split:
            idx, n = sh.block_of(mesh, dp)
            b = rows // n
            local = {k: torch.as_tensor(v)[idx * b:(idx + 1) * b]
                     for k, v in batch.items()}
        step_shard = dataclasses.replace(shard, rows_split=split,
                                         gather=gather)
        loss, grads = _grads(state.params, loss_fn(step_shard), local,
                             nmicro)
        grads = [g.div_(dp_n) if g.dtype == torch.float32
                 else g.float() / dp_n for g in grads]
        if dp_n > 1:
            whole_dp = [i for i, d in enumerate(on_dp) if not d]
            red = engine.allreduce_tree([grads[i] for i in whole_dp], dp,
                                        schedule=P.SCHEDULE,
                                        callsite=P.DP)
            for i, g in zip(whole_dp, red):
                grads[i] = g
            del red
        loss = reduce(loss / dp_n, dp)
        # each leaf's sum of squares once: by the axes it is split over
        sq = {}
        for g, key in zip(grads, zip(on_tp, on_dp)):
            sq[key] = sq.get(key, 0) + torch.sum(torch.square(g))
        total = sq.get((False, False), 0)
        if (False, True) in sq:
            total = total + reduce(sq[False, True], dp)
        if (True, True) in sq or (True, False) in sq:
            t_sq = sq.get((True, False), 0)
            if (True, True) in sq:
                t_sq = t_sq + reduce(sq[True, True], dp)
            total = total + reduce(t_sq, tp)
        gnorm = torch.sqrt(total)
        lr = schedule(state.step)
        _zero1_update_(state, grads, zdims, adamw, lr,
                       clip_scale(gnorm, adamw.max_grad_norm), mesh, dp)
        state.step = state.step + 1
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.engine = engine
    return train_step


@torch.no_grad()
def _zero1_update_(state: TrainState, grads: list, zdims: list,
                   adamw: AdamWConfig, lr, scale, mesh, dp) -> None:
    """AdamW in place, leaf by leaf (``adamw_update_``, with its
    ``UPDATE_CHUNK`` runs); a leaf with a ZeRO-1 dimension ``d`` in
    ``zdims`` (its moments hold this rank's block along ``d``) updates
    that block of the weight, and the blocks are gathered over ``dp``
    into it."""
    count = state.opt["count"]
    after = count
    for p, m, v, g, d in zip(tree_flatten(state.params.tree(data=False))[0],
                             tree_flatten(state.opt["mu"])[0],
                             tree_flatten(state.opt["nu"])[0], grads, zdims):
        one = {"mu": [m], "nu": [v], "count": count}
        if d is None:
            adamw_update_([g], one, [p], adamw, lr, scale=scale)
        else:
            idx = sh.block_of(mesh, dp)[0]
            size = m.shape[d]
            blk = p.data.narrow(d, idx * size, size).contiguous()
            adamw_update_([g.narrow(d, idx * size, size)], one, [blk], adamw,
                          lr, scale=scale)
            p.data.copy_(P.gather(blk, mesh, dp, d, source=P.ZERO1))
            del blk
        after = one["count"]
    state.opt["count"] = after


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


def shard_whole_model_params(params, mesh, axis: str = "x"):
    """This rank's part of whole weights under
    :func:`whole_model_param_specs` on ``mesh``: a new weight module, with
    gradients on if ``params`` had them."""
    specs = whole_model_param_specs(params, axis)
    cut = type(params)(params.cfg, sh.cut(params.tree(), specs, mesh))
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
                      opt={"mu": sh.cut(state.opt["mu"], specs, mesh),
                           "nu": sh.cut(state.opt["nu"], specs, mesh),
                           "count": state.opt["count"]},
                      step=state.step, error=state.error)


@torch.no_grad()
def gather_whole_model_state(state: TrainState, mesh,
                             axis: str = "x") -> TrainState:
    """The whole state from every rank's part, the inverse of
    :func:`shard_whole_model_state`: each split leaf is gathered over
    ``axis`` as :func:`gather_state` gathers, which moves bytes only, so
    the result equals the uncut state bit for bit. Every rank of the axis
    calls it and gets the whole state; the replicated leaves are this
    rank's own."""
    specs = tree_flatten(whole_model_param_specs(state.params, axis))[0]
    return TrainState(
        params=_with_params(state.params,
                            _gathered(state.params.tree(), specs, mesh)),
        opt={"mu": _gathered(state.opt["mu"], specs, mesh),
             "nu": _gathered(state.opt["nu"], specs, mesh),
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
