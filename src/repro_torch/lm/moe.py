"""Mixture-of-Experts: top-k router and sort-based capacity dispatch.

The PyTorch counterpart of :mod:`repro.lm.moe`, on one device and under
``rules`` on a device mesh (expert sharding below).  Dispatch is the
reference's sort-and-slot scheme: flatten the
(token, k) assignments, sort them by expert (stably, so that within an
expert's segment the assignments keep token order), give each its position
in the segment, move tokens into an (E * C, d) buffer through an integer
table, run the grouped products ``ecd,edf->ecf`` / ``ecf,efd->ecd`` as
batched matrix products (the reference leaves them to XLA, outside any
kernel) and gather back with the router weights.  Assignments beyond an
expert's capacity C are dropped (weight 0).

The routing tables follow the reference as it runs on the CPU, where its
``.at[slot].set(..., mode="drop")`` applies duplicate writes in order.  An
assignment past capacity is clamped onto its expert's last slot C - 1 and
writes the out-of-bounds token there after the kept one, so an expert that
overflows keeps C - 1 tokens: its last slot holds the zero row, and the
token routed to it gets that expert's output of zeros at its full weight.
The tables here get that result with every kept write at an index of its
own (the dropped writes land on a spare entry that is cut off, and the
overwrite is a select) in :func:`dispatch`, so they are the same on every
device; an ``index_put_`` with duplicate indices has no defined order on
CUDA.

The router always computes in float32; the aux-free ``bias`` of
deepseek-v3 moves the selection only, the weights use the unbiased scores.
The top-k is a stable descending sort, so equal scores give the lower
expert first, as ``jax.lax.top_k`` does.

**Expert sharding** (``apply_moe(..., rules=...)``, DTensor activations on
a mesh).  The routing tables stay the reference's on every rank: each rank
gathers the layer's whole (T, d) input (an all-gather over the data axes;
T = B * S of the whole batch, so the capacity is the reference's) and runs
:func:`route` and :func:`dispatch` on it through ``local_map``, the same
function on the same values (DTensor has no rules for the sort, the
``searchsorted`` or the ``index_put_``).  Only floats move through the
tables, as in the reference.  The activations are placed at the
reference's four points by ``cfg.expert_sharding``
(:func:`expert_axes`): the buffer ``(exp, cap, None)``, the hidden
``(exp, cap, 'model' if tp)``, the output buffer ``(exp, cap, None)`` and
the combined output ``('batch', None)``, with ``exp`` = ``model`` for
``ep``, ``expert`` (data x model) for ``ep2d``, none for ``tp``, and
``cap`` = ``batch`` for ``ep`` and ``tp``.  Each rank fills its own slots
of the buffer from the gathered rows (no all-to-all), runs the grouped
products on its shard (DTensor places them; a product over a sharded
contraction dim is a partial sum, reduced at the constraint before the
gate, :func:`repro_torch.lm.layers.local_elementwise`, or the combine),
and adds the weighted rows of its own slots into a (T, d) partial sum,
reduced to ``('batch', None)``.  On a mesh of one device every step is
the single-device function on the same values, bit for bit.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.sharding.rules import shard

from .layers import (activation_fn, apply_mlp, draw_device, init_linear,
                     mlp_params, wval)

if TYPE_CHECKING:
    from repro_torch.sharding.rules import Rules

__all__ = ["moe_params", "apply_moe", "route", "scores", "select",
           "dispatch", "capacity", "expert_axes", "routing_on_mesh"]


def moe_params(generator: torch.Generator, d: int, cfg: MoEConfig,
               mlp_type: str, dtype: torch.dtype, lead=()) -> Dict:
    """The reference's tree: a float32 router (with a zero ``bias`` when
    aux-free), (E, d, f) ``wi``/``wg`` and (E, f, d) ``wo`` experts, and the
    shared experts as one MLP of width ``n_shared * d_ff_expert``."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    exp = tuple(lead) + (e,)
    p = {
        "router": init_linear(generator, d, e, torch.float32, lead=lead),
        "wi": init_linear(generator, d, f, dtype, lead=exp),
        "wo": init_linear(generator, f, d, dtype, lead=exp),
    }
    if mlp_type == "glu":
        p["wg"] = init_linear(generator, d, f, dtype, lead=exp)
    if cfg.router_aux_free:
        p["router"]["bias"] = torch.zeros(tuple(lead) + (e,),
                                          dtype=torch.float32,
                                          device=draw_device(generator))
    if cfg.n_shared:
        p["shared"] = mlp_params(generator, d, cfg.n_shared * f, mlp_type,
                                 dtype, lead)
    return p


def capacity(t: int, cfg: MoEConfig,
             capacity_factor: Optional[float] = None) -> int:
    """Slots per expert for ``t`` tokens: ``max(1, ceil(t k / E * cf))``."""
    cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
    return max(1, int(math.ceil(t * cfg.top_k / cfg.n_experts * cf)))


def scores(p: Dict, x32: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """(T, d) float32 -> the router's (T, E) float32 scores: sigmoid when
    aux-free, else softmax."""
    logits = x32 @ p["router"]["w"]
    if cfg.router_aux_free:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def select(p: Dict, s: torch.Tensor,
           cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) scores -> (weights (T, k) float32, experts (T, k) int64): the
    top k of the scores (plus the aux-free bias, for selection only), the
    highest first and the lower expert first among equal scores, their
    unbiased scores normalized to sum to 1.  The sum runs over k in order,
    so it is the same on every device."""
    sel = s + p["router"]["bias"][None, :] if cfg.router_aux_free else s
    experts = torch.sort(sel, dim=-1, descending=True,
                         stable=True).indices[:, :cfg.top_k]
    w = torch.gather(s, 1, experts)
    total = w[:, 0]
    for j in range(1, cfg.top_k):
        total = total + w[:, j]
    w = w / torch.clamp_min(total, 1e-9)[:, None]
    return w, experts


def route(p: Dict, x32: torch.Tensor,
          cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x32: (T, d) float32 -> (weights (T, k), experts (T, k))."""
    return select(p, scores(p, x32, cfg), cfg)


def dispatch(weights: torch.Tensor, experts: torch.Tensor, n_experts: int,
             cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The integer routing tables of ``cap`` slots per expert.

    Returns ``slot_token`` (E * cap,) int32, the token each slot reads (T,
    the zero row, when empty), ``token_slots`` (T, k) int32, the slot each
    assignment reads back (E * cap when dropped), and ``token_weights`` (T,
    k) float32 (0 when dropped).  An expert whose segment overflows reads
    the zero row into its last slot, as the reference does on the CPU (see
    the module docstring)."""
    t, k = experts.shape
    tk, dev, n = t * k, experts.device, n_experts * cap
    flat_expert = experts.reshape(tk)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = torch.div(order, k, rounding_mode="floor")
    # each expert's segment of the sorted assignments (no host sync, where
    # bincount and boolean indexing would wait for the card)
    bounds = torch.searchsorted(sorted_expert,
                                torch.arange(n_experts + 1, device=dev))
    seg_start, counts = bounds[:-1], bounds[1:] - bounds[:-1]
    pos = torch.arange(tk, device=dev) - seg_start[sorted_expert]
    keep = pos < cap
    slot = sorted_expert * cap + torch.clamp_max(pos, cap - 1)

    # kept assignments hold distinct slots; the dropped ones write to one
    # spare slot past the table, cut off after
    slot_token = torch.full((n + 1,), t, dtype=torch.int32, device=dev)
    slot_token.index_put_((torch.where(keep, slot, n),),
                          sorted_token.to(torch.int32))
    slot_token = slot_token[:n]
    last = torch.arange(n_experts, device=dev) * cap + (cap - 1)
    # the dropped write to an overflowing expert's last slot lands last
    slot_token[last] = torch.where(counts > cap, t, slot_token[last])
    # (token, j) pairs are a permutation of the flat assignments: unique
    token_slots = torch.empty(tk, dtype=torch.int32, device=dev)
    token_slots[order] = torch.where(keep, slot, n).to(torch.int32)
    token_weights = torch.empty(tk, dtype=torch.float32, device=dev)
    token_weights[order] = torch.where(keep, weights.reshape(tk)[order],
                                       0.0)
    return slot_token, token_slots.view(t, k), token_weights.view(t, k)


def expert_axes(cfg: MoEConfig) -> Tuple[Optional[str], Optional[str]]:
    """(expert axis, capacity axis): the reference's logical axes of the
    (E, C, ...) expert buffers for ``cfg.expert_sharding``."""
    exp_axis = {"ep": "model", "ep2d": "expert",
                "tp": None}[cfg.expert_sharding]
    cap_ax = "batch" if cfg.expert_sharding in ("ep", "tp") else None
    return exp_axis, cap_ax


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x``'s rows at ``idx``; index ``len(x)`` reads a zero row."""
    return torch.cat([x, x.new_zeros(1, x.shape[1])], 0)[idx.long()]


def _combine(out_buf: torch.Tensor, token_slots: torch.Tensor,
             token_weights: torch.Tensor) -> torch.Tensor:
    """(n, d) slot outputs -> (T, d): each token's k slot rows (slot n, a
    dropped assignment, the zero row) times their weights, summed over k."""
    outk = _rows(out_buf, token_slots)  # (T, k, d)
    return torch.sum(outk * token_weights[..., None].to(outk.dtype), dim=1)


def routing_on_mesh(p: Dict, xf, cfg: MoEConfig, cap: int):
    """The routing tables of a DTensor input ``xf`` (T, d), the same on
    every rank: ``xf`` gathered to every rank, then :func:`route` and
    :func:`dispatch` through ``local_map``.  Returns (the gathered ``xf``,
    ``slot_token``, ``token_slots``, ``token_weights``), replicated
    DTensors."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = xf.device_mesh
    rep = [Replicate()] * mesh.ndim
    xr = xf.redistribute(mesh, rep)
    keys = sorted(p["router"])

    def tables(x, *leaves):
        weights, experts = route({"router": dict(zip(keys, leaves))},
                                 x.to(torch.float32), cfg)
        return dispatch(weights, experts, cfg.n_experts, cap)

    return (xr,) + tuple(local_map(
        tables, out_placements=(rep, rep, rep),
        in_placements=(rep,) * (1 + len(keys)), device_mesh=mesh)(
            xr, *(p["router"][k].redistribute(mesh, rep) for k in keys)))


def _slots_on_mesh(p: Dict, xf, cfg: MoEConfig, cap: int, rules: "Rules"):
    """Under rules: the routing tables (:func:`routing_on_mesh`) and the
    (E, C, d) buffer placed ``(exp, cap, None)``, each rank's slots filled
    from the gathered rows.  Returns (buffer, the global slot ids placed as
    the buffer's first two dims, ``token_slots``, ``token_weights``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    e = cfg.n_experts
    exp_axis, cap_ax = expert_axes(cfg)
    xr, slot_token, token_slots, token_weights = routing_on_mesh(
        p, xf, cfg, cap)
    mesh = xr.device_mesh
    rep = [Replicate()] * mesh.ndim
    table = shard(slot_token.view(e, cap), (exp_axis, cap_ax), rules)
    placed = list(table.placements)
    # a rank's rows feed only its own slots: its gradient is a partial sum
    # over the mesh dims the slots are split on
    grad = [Partial() if q.is_shard() else Replicate() for q in placed]
    buf = local_map(_rows, out_placements=placed, in_placements=(rep, placed),
                    in_grad_placements=(grad, placed),
                    device_mesh=mesh)(xr, table)
    ids = shard(DTensor.from_local(
        torch.arange(e * cap, device=table.to_local().device).view(e, cap),
        mesh, rep), (exp_axis, cap_ax), rules)
    return buf, ids, token_slots, token_weights


def _combine_on_mesh(out_buf, ids, token_slots, token_weights):
    """Each rank's slots of ``out_buf`` (placed as ``ids``) weighted into
    a (T, d) partial sum over the mesh dims the slots are split on."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    e, cap, d = out_buf.shape

    def local(ob, sid, ts, tw):
        n = sid.numel()
        # global slot -> this rank's row (n, the zero row, when elsewhere)
        where = torch.full((e * cap + 1,), n, dtype=torch.long,
                           device=sid.device)
        where[sid.reshape(n).long()] = torch.arange(n, device=sid.device)
        return _combine(ob.reshape(n, d), where[ts.long()], tw)

    placed = list(ids.placements)
    rep = [Replicate()] * len(placed)
    part = [Partial() if q.is_shard() else Replicate() for q in placed]
    return local_map(local, out_placements=part,
                     in_placements=(placed, placed, rep, rep),
                     in_grad_placements=(placed, placed, rep, part),
                     device_mesh=ids.device_mesh)(
                         out_buf, ids, token_slots, token_weights)


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig, mlp_type: str,
              activation: str, capacity_factor: Optional[float] = None,
              gate_sigmoid: str = "exact", fused: bool = True,
              rules: "Optional[Rules]" = None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``fused``: on the card a pwl4 SiLU gate
    over the (E, C, f) expert activations is one ``pwl_activation`` launch
    (False: op by op, the training route).  Under ``rules`` ``x`` and the
    parameters are DTensors and the experts are sharded by
    ``cfg.expert_sharding`` (the module docstring); the gate is then one
    launch over each rank's local expert activations."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xf = x.reshape(t, d)
    act = activation_fn(activation, gate_sigmoid, fused)
    cap = capacity(t, cfg, capacity_factor)
    exp_axis, cap_ax = expert_axes(cfg)
    if rules is None:
        weights, experts = route(p, xf.to(torch.float32), cfg)
        slot_token, token_slots, token_weights = dispatch(weights, experts,
                                                          e, cap)
        buf = _rows(xf, slot_token).view(e, cap, d)
    else:
        buf, ids, token_slots, token_weights = _slots_on_mesh(p, xf, cfg,
                                                              cap, rules)
    buf = shard(buf, (exp_axis, cap_ax, None), rules)
    h = torch.bmm(buf, wval(p["wi"], x.dtype))
    h = shard(h, (exp_axis, cap_ax,
                  "model" if cfg.expert_sharding == "tp" else None), rules)
    if mlp_type == "glu":
        h = act(torch.bmm(buf, wval(p["wg"], x.dtype))) * h
    else:
        h = act(h)
    out_buf = torch.bmm(h, wval(p["wo"], x.dtype))
    out_buf = shard(out_buf, (exp_axis, cap_ax, None), rules)
    if rules is None:
        out = _combine(out_buf.view(e * cap, d), token_slots, token_weights)
    else:
        out = _combine_on_mesh(out_buf, ids, token_slots, token_weights)
    out = shard(out, ("batch", None), rules)
    if cfg.n_shared:
        out = out + apply_mlp(p["shared"], xf, mlp_type, activation,
                              gate_sigmoid, fused)
    return out.reshape(b, s, d).to(x.dtype)
