"""Mixture-of-Experts: top-k router and sort-based capacity dispatch.

The PyTorch counterpart of :mod:`repro.lm.moe`, on one device (the
reference's expert sharding, ``ep``/``tp``, arrives with the multi-GPU
slice).  Dispatch is the reference's sort-and-slot scheme: flatten the
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
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig

from .layers import (activation_fn, apply_mlp, draw_device, init_linear,
                     mlp_params, wval)

__all__ = ["moe_params", "apply_moe", "route", "scores", "select",
           "dispatch", "capacity"]


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


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig, mlp_type: str,
              activation: str, capacity_factor: Optional[float] = None,
              gate_sigmoid: str = "exact", fused: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  ``fused``: on the card a pwl4 SiLU gate
    over the (E, C, f) expert activations is one ``pwl_activation`` launch
    (False: op by op, the training route)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xf = x.reshape(t, d)
    act = activation_fn(activation, gate_sigmoid, fused)
    weights, experts = route(p, xf.to(torch.float32), cfg)
    cap = capacity(t, cfg, capacity_factor)
    slot_token, token_slots, token_weights = dispatch(weights, experts, e,
                                                      cap)

    xf_pad = torch.cat([xf, xf.new_zeros(1, d)], 0)
    buf = xf_pad[slot_token.long()].view(e, cap, d)
    h = torch.bmm(buf, wval(p["wi"], x.dtype))
    if mlp_type == "glu":
        h = act(torch.bmm(buf, wval(p["wg"], x.dtype))) * h
    else:
        h = act(h)
    out_buf = torch.bmm(h, wval(p["wo"], x.dtype)).view(e * cap, d)

    out_pad = torch.cat([out_buf, out_buf.new_zeros(1, d)], 0)
    outk = out_pad[token_slots.long()]  # (T, k, d); dropped: the zero row
    out = torch.sum(outk * token_weights[..., None].to(outk.dtype), dim=1)
    if cfg.n_shared:
        out = out + apply_mlp(p["shared"], xf, mlp_type, activation,
                              gate_sigmoid, fused)
    return out.reshape(b, s, d).to(x.dtype)
