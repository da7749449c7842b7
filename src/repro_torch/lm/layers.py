"""Shared LM layers: norms, MLPs, RoPE, embeddings, PWL-gated activations.

The PyTorch counterpart of :mod:`repro.lm.layers`.  All functions are pure;
parameters are plain dicts of tensors.  Compute dtype follows the input;
norm statistics and RoPE angles always run in float32.  The paper's PWL
sigmoid (C3) is available for every sigmoid-derived gate (sigmoid, silu)
via ``gate_sigmoid`` — exact by default; on the card a ``pwl4`` SiLU gate is
one ``pwl_activation`` launch (:func:`gated_silu`).  The norms compute in
float32, or in the input's dtype where it is wider (:func:`wide`): a
float64 model runs in float64 end to end, a check that two float32 runs
differ by rounding alone.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.activations import get_sigmoid
from repro_torch.spans import span

__all__ = ["rmsnorm", "layernorm", "make_norm_params", "apply_norm",
           "init_linear", "mlp_params", "apply_mlp", "activation_fn",
           "rope_freqs", "apply_rope", "init_embed", "gated_silu", "wval",
           "apply_linear", "embed_tokens", "unembed", "on_card", "wide",
           "draw_device", "draws_on", "local_elementwise", "local_heads"]


def wide(dtype: torch.dtype) -> torch.dtype:
    """float32, or ``dtype`` where it is the wider (float64)."""
    return torch.promote_types(dtype, torch.float32)


_DRAW_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "draw_device", default=None)


def draw_device(generator: torch.Generator) -> torch.device:
    """Where parameter draws from ``generator`` are made: the generator's
    device, or the one :func:`draws_on` names."""
    return _DRAW_DEVICE.get() or generator.device


@contextlib.contextmanager
def draws_on(device) -> Iterator[None]:
    """Parameter draws go to ``device`` (``"meta"``: shapes and dtypes
    only, nothing allocated) through the same shape code, whatever the
    generator's device (a meta generator does not exist)."""
    token = _DRAW_DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DRAW_DEVICE.reset(token)


def local_elementwise(fn: Callable, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` runs on each
    rank's local shard.  A shard of any dim will do, but a partial sum (a
    product over a sharded contraction dim) is reduced first: a nonlinear
    ``fn`` of the parts is not ``fn`` of their sum."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map

    placed = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, placed)
    # a list: local_map reads a tuple as one placement list per output
    return local_map(fn, out_placements=placed, in_placements=(placed,),
                     device_mesh=x.device_mesh)(x)


def local_heads(fn: Callable, out_placements, acts, leaves, heads: bool,
                whole=()):
    """``fn(part, parts, *local acts, *local leaves)`` on each rank's local
    shards, through one ``local_map``: a recurrent layer's scan on the
    rank's batch rows and, with ``heads``, on its share of the heads
    (``part`` of ``parts`` along ``model``; 0 of 1 otherwise).

    ``acts`` are DTensors already placed as ``fn`` reads them: the batch on
    the data axes, and each either head-aligned on ``model`` or whole over
    it (the indices in ``whole``: ``fn`` takes its own heads' columns).
    ``leaves`` are parameters, replicated to every rank here; ``fn`` takes
    its heads' share.  A value that a rank reads only in part has a
    gradient that is a partial sum over the ranks that split the work: a
    ``whole`` act's over ``model`` (with ``heads``), a leaf's over every
    mesh dim that splits the batch or the heads.  ``out_placements``: one
    placement list per output of ``fn``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    dm = acts[0].device_mesh
    names = tuple(dm.mesh_dim_names)
    model = names.index("model") if heads else None
    rep = [Replicate()] * dm.ndim
    split = [any(p.is_shard() for p in (a.placements[i] for a in acts))
             or i == model for i in range(dm.ndim)]
    leaf_grad = [Partial() if s else Replicate() for s in split]
    act_grads = []
    for j, a in enumerate(acts):
        g = list(a.placements)
        if j in whole and model is not None:
            g[model] = Partial()
        act_grads.append(g)
    part = dm.get_local_rank("model") if heads else 0
    parts = dm.size(model) if heads else 1
    leaves = [t.redistribute(dm, rep) for t in leaves]
    # local_map reads a tuple as one placement list per output, and a
    # list as the placements of a single output
    outs = (list(out_placements[0]) if len(out_placements) == 1
            else tuple(out_placements))
    return local_map(
        lambda *xs: fn(part, parts, *xs), out_placements=outs,
        in_placements=tuple(a.placements for a in acts)
        + (rep,) * len(leaves),
        in_grad_placements=tuple(act_grads) + (leaf_grad,) * len(leaves),
        device_mesh=dm)(*acts, *leaves)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA device, where the serving route
    launches the kernels."""
    return x.device.type == "cuda"


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x) * (1 + scale)`` in float32 (or wider), cast back to
    ``x``'s dtype."""
    x32 = x.to(wide(x.dtype))
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(x32.dtype))).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(wide(x.dtype))
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(x32.dtype))
            + bias.to(x32.dtype)).to(x.dtype)


def make_norm_params(kind: str, d: int, dtype: torch.dtype,
                     device: torch.device, lead=()) -> Dict:
    """Zero-initialized norm parameters, with leading (stacked) dims."""
    z = lambda: torch.zeros(tuple(lead) + (d,), dtype=dtype, device=device)
    if kind == "rmsnorm":
        return {"scale": z()}
    return {"scale": z(), "bias": z()}


def apply_norm(kind: str, p: Dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """The config's norm; ``eps`` is RMSNorm's (``ArchConfig.norm_eps``),
    layernorm keeps its own 1e-5."""
    with span("lm.norm"):
        if kind == "rmsnorm":
            return rmsnorm(x, p["scale"], eps)
        return layernorm(x, p["scale"], p["bias"])


# --------------------------------------------------------------------------
# Linear / MLP
# --------------------------------------------------------------------------
def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, bias: bool = False,
                scale: Optional[float] = None, lead=()) -> Dict:
    """A (lead..., d_in, d_out) weight drawn N(0, 1) * ``scale`` (default
    1/sqrt(d_in)) in float32 and cast to ``dtype``, on the generator's
    device; a zero bias when asked."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    dev = draw_device(generator)
    # scaled in place: a stacked expert leaf's float32 draw is the largest
    # buffer of a full-width init (15 GB for deepseek-v3's), held once
    w = torch.randn(tuple(lead) + (d_in, d_out), generator=generator,
                    dtype=torch.float32, device=dev).mul_(s)
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (d_out,), dtype=dtype, device=dev)
    return p


def wval(p: Dict, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Weight value of a linear dict, dequantizing a Qn.m/int8 artifact
    (``w_q`` in its integer container times ``scale``)."""
    if "w_q" in p:
        dt = dtype if dtype is not None else p["scale"].dtype
        return p["w_q"].to(dt) * p["scale"].to(dt)
    return p["w"] if dtype is None else p["w"].to(dtype)


def apply_linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``; a quantized linear computes
    ``(x @ w_q.to(x.dtype)) * scale`` — the integer buffer stays resident
    and is converted at use, as the reference does."""
    if "w_q" in p:
        y = (x @ p["w_q"].to(x.dtype)) * p["scale"].to(x.dtype)
    else:
        y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def activation_fn(name: str, gate_sigmoid: str = "exact",
                  fused: bool = True) -> Callable:
    """silu/gelu (tanh-approximate, as the reference)/gelu_exact (erf)/
    relu/relu2; silu routes through the (possibly PWL) sigmoid
    (:func:`gated_silu`), or op by op when ``fused`` is False (the
    training route: the gate's kernel has no backward).  On a DTensor each
    activation runs on each rank's local shard, a partial sum reduced first
    (:func:`local_elementwise`): the kernel takes plain tensors, and no
    DTensor rule decides what a nonlinear function of a partial sum is."""
    if name == "silu":
        if not fused:
            sig = get_sigmoid(gate_sigmoid)
            fn = lambda t: t * sig(t)
        else:
            fn = lambda t: gated_silu(t, gate_sigmoid)
    elif name == "gelu":
        fn = lambda t: F.gelu(t, approximate="tanh")
    elif name == "gelu_exact":
        fn = F.gelu
    elif name == "relu":
        fn = torch.relu
    elif name == "relu2":
        fn = lambda t: torch.square(torch.relu(t))
    else:
        raise KeyError(f"unknown activation '{name}'")
    return lambda x: local_elementwise(fn, x)


def gated_silu(x: torch.Tensor, gate_sigmoid: str = "exact") -> torch.Tensor:
    """``x * sigmoid(x)`` with the gate sigmoid ``gate_sigmoid``.

    A ``pwl4`` gate on a CUDA tensor of any rank is one ``pwl_activation``
    launch of its ``silu_pwl4`` variant (an MLP's (B, S, f) activations, or
    a MoE layer's (E, C, f) expert activations at once); on the CPU it
    stays op by op.  The kernel
    computes in float32 and rounds once, where the op-by-op route rounds
    every step to ``x``'s dtype: in float32 the two agree bit for bit but
    for the kernel's flush of a subnormal result (which XLA applies too); in
    bf16 they differ by the op-by-op route's roundings.  The other gates
    have no fused form in the kernel and stay in PyTorch ops."""
    if gate_sigmoid == "pwl4" and on_card(x):
        from repro_torch.kernels import ops

        return ops.pwl_activation(x, "silu_pwl4")
    sig = get_sigmoid(gate_sigmoid)
    return x * sig(x)


def mlp_params(generator: torch.Generator, d: int, d_ff: int, mlp_type: str,
               dtype: torch.dtype, lead=()) -> Dict:
    if mlp_type == "glu":
        return {
            "wi": init_linear(generator, d, d_ff, dtype, lead=lead),
            "wg": init_linear(generator, d, d_ff, dtype, lead=lead),
            "wo": init_linear(generator, d_ff, d, dtype, lead=lead),
        }
    return {
        "wi": init_linear(generator, d, d_ff, dtype, lead=lead),
        "wo": init_linear(generator, d_ff, d, dtype, lead=lead),
    }


def apply_mlp(p: Dict, x: torch.Tensor, mlp_type: str, activation: str,
              gate_sigmoid: str = "exact", fused: bool = True) -> torch.Tensor:
    with span("lm.mlp"):
        act = activation_fn(activation, gate_sigmoid, fused)
        h = apply_linear(p["wi"], x)
        if mlp_type == "glu":
            g = apply_linear(p["wg"], x)
            with span("lm.gate"):
                h = act(g) * h
        else:
            with span("lm.gate"):
                h = act(h)
        return apply_linear(p["wo"], h)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # a Python scalar base: no host-to-device copy (which would wait for
    # the card), and float32 arithmetic, as the reference's weak-typed theta
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh) rotated pairwise; positions: (..., S) int.  Angles,
    sin and cos in float32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# Embeddings
# --------------------------------------------------------------------------
def init_embed(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> Dict:
    table = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                        device=draw_device(generator))
    table.mul_(1.0 / math.sqrt(d))
    return {"table": table.to(dtype)}


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def unembed(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (loss-critical)."""
    return x.to(torch.float32) @ p["table"].T.to(torch.float32)
