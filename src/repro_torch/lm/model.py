"""Model assembly: init / forward / loss / decode for every block pattern.

The PyTorch counterpart of :mod:`repro.lm.model`, for all three block
patterns:

* ``attn``: dense decoders (GQA or MHA attention, glu or standard MLP,
  rmsnorm or layernorm), MoE stacks (:mod:`.moe`, after ``first_k_dense``
  dense layers), MLA attention (:mod:`.mla`), an encoder (bidirectional,
  no decode) and the modality front ends (audio frame embeddings in place
  of tokens; vision patch embeddings through ``modality_proj``,
  prepended);
* ``mamba_hybrid`` (zamba2): ``n_layers // shared_attn_every`` groups of
  ``shared_attn_every - 1`` Mamba2 layers (:mod:`.mamba2`), each group
  followed by one *shared* attention + MLP block (the same parameters at
  every call, with the config's sliding window), then a tail of the
  remaining Mamba2 layers;
* ``rwkv``: a stack of RWKV-6 layers (:mod:`.rwkv6`).

The parameter tree keeps the reference's layout — nested dicts, the layers
stacked on leading axes (zamba2's ``groups`` on two) — and its dtypes,
float32 leaves in a bf16 model included (:func:`float32_leaf`), so weights
carry across one to one (:func:`repro_torch.convert.lm_params_from_numpy`);
a Python loop over the stacked index takes the place of the reference's
``lax.scan``.

Public API:
  init_params(cfg, generator)            -> params tree on the generator's device
  forward(params, batch, cfg)            -> (B, S, vocab) float32 logits
  loss_fn(params, batch, cfg)            -> scalar float32 loss
  init_cache(cfg, batch, max_len, device) -> decode cache tree
  serve_step(params, cache, batch, cfg)  -> (logits, cache)

Two routes run the same layer stack (:func:`_stack`):

* the serving route (``forward``, ``serve_step``), under
  ``torch.inference_mode()``: on the card each layer's attention is one
  ``flash_attention`` launch (MLA's on the kernel's dh-192 instance,
  zamba2's shared block with its window) and a pwl4 gate one
  ``pwl_activation`` launch per MLP or expert stack, per Mamba2 gate and
  per RWKV gate;
* the training route (``loss_fn``, or ``forward(..., attn_impl="train")``):
  the reference's own branch on any device — ``blockwise_attention`` when
  ``S % attn_chunk == 0 and S > attn_chunk``, else ``full_attention`` — and
  the gate op by op, which are the functions the reference differentiates.
  Neither kernel has a backward, and each raises when asked for one
  (:mod:`repro_torch.kernels.ops`).  With ``cfg.remat`` each layer is
  recomputed in the backward (``torch.utils.checkpoint``), as the
  reference's ``jax.checkpoint`` does.

``init_params`` runs under ``torch.no_grad()``, so its tensors are normal
tensors that the trainer can differentiate.  ``serve_step`` updates the
cache's buffers in place (KV caches, Mamba2's conv and SSM states, RWKV's
WKV state and shifts) and returns the same buffers under an advanced
``pos``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig

from . import attention as attn_mod
from . import mamba2 as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import (apply_linear, apply_mlp, apply_norm, embed_tokens,
                     init_embed, init_linear, make_norm_params, mlp_params)

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "serve_step",
           "float32_leaf", "cast_params_", "ATTN_IMPLS"]

# Attention routes of the layer stack: "cuda" launches the flash_attention
# kernel on a CUDA tensor, "ref" computes the kernel's function through its
# plain version there, "train" takes the reference's own branch (blockwise
# or full attention) on any device, differentiably.
ATTN_IMPLS = ("cuda", "ref", "train")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def float32_leaf(path: Tuple[str, ...]) -> bool:
    """Whether the reference keeps the parameter at key ``path`` in float32
    whatever the model's dtype: a MoE router's leaves, Mamba2's ``A_log``,
    ``dt_bias`` and ``D``, and RWKV-6's token-shift anchors, decay base,
    bonus, group-norm scale and LayerNorms (:data:`.rwkv6.FLOAT32_LEAVES`)."""
    if "router" in path[:-1]:
        return True
    if len(path) >= 2 and path[-2] == "mamba":
        return path[-1] in mamba_mod.FLOAT32_LEAVES
    return (len(path) == 2 and path[0] == "layers"
            and path[1] in rwkv_mod.FLOAT32_LEAVES)


def cast_params_(tree: Dict, dtype: torch.dtype,
                 _path: Tuple[str, ...] = ()) -> Dict:
    """Every floating leaf of ``tree`` to ``dtype``, in place and one leaf
    at a time (the old leaf is freed as its copy is made), but those
    :func:`float32_leaf` names, which stay as they are.  Returns ``tree``."""
    for k, v in tree.items():
        path = _path + (k,)
        if isinstance(v, dict):
            cast_params_(v, dtype, path)
        elif v.is_floating_point() and not float32_leaf(path):
            tree[k] = v.to(dtype)
    return tree


def _hybrid_structure(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(groups, Mamba2 layers per group, tail layers) of the hybrid."""
    k = cfg.ssm.shared_attn_every
    n_groups = cfg.n_layers // k
    return n_groups, k - 1, cfg.n_layers - n_groups * k


def _layer(stacked: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters (views) from a stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _unbind_layers(stacked: Dict) -> List[Dict]:
    """Every layer's parameters (views) from a stacked tree, split once:
    autograd then writes a stacked leaf's gradient with one ``stack``,
    where indexing each layer would add a zero-filled stacked gradient per
    layer (O(L^2) traffic)."""
    per_leaf = {k: _unbind_layers(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in stacked.items()}
    n = len(next(iter(per_leaf.values())))
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def _n_layers(stacked: Dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _tokens(tokens: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device)


# ===========================================================================
# Parameter construction
# ===========================================================================
def _layer_params(generator: torch.Generator, cfg: ArchConfig, lead: tuple,
                  ffn: Callable[[tuple], Dict], ffn_key: str) -> Dict:
    """Layers stacked on ``lead``: norms, attention (MLA or GQA) and the FFN
    ``ffn(lead)`` under ``ffn_key`` (the reference's leaf order)."""
    dt, dev = _dtype(cfg), generator.device
    p = {"ln1": make_norm_params(cfg.norm, cfg.d_model, dt, dev, lead),
         "ln2": make_norm_params(cfg.norm, cfg.d_model, dt, dev, lead)}
    if cfg.mla is not None:
        p["attn"] = mla_mod.mla_params(generator, cfg.d_model, cfg.n_heads,
                                       cfg.mla, dt, lead)
    else:
        p["attn"] = attn_mod.attn_params(generator, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dt,
                                         cfg.qkv_bias, lead)
    p[ffn_key] = ffn(lead)
    return p


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator) -> Dict:
    """Seeded parameters (the reference's layout, init scales and dtypes)
    on the generator's device: normal tensors, not inference tensors, so
    that :func:`loss_fn` can be differentiated with respect to them."""
    dt, dev = _dtype(cfg), generator.device
    params: Dict[str, Any] = {
        "embed": init_embed(generator, cfg.vocab_size, cfg.d_model, dt)}
    if cfg.modality is not None:
        params["modality_proj"] = init_linear(generator, cfg.d_model,
                                              cfg.d_model, dt)

    def dense(lead, d_ff=cfg.d_ff):
        return _layer_params(
            generator, cfg, lead,
            lambda lead: mlp_params(generator, cfg.d_model, d_ff,
                                    cfg.mlp_type, dt, lead), "mlp")

    def mamba(lead):
        return {"ln": make_norm_params(cfg.norm, cfg.d_model, dt, dev, lead),
                "mamba": mamba_mod.mamba2_params(generator, cfg.d_model,
                                                 cfg.ssm, dt, lead)}

    mo = cfg.moe
    if cfg.block_pattern == "rwkv":
        params["layers"] = rwkv_mod.rwkv6_params(
            generator, cfg.d_model, cfg.d_ff, cfg.n_heads, dt,
            lead=(cfg.n_layers,))
    elif cfg.block_pattern == "mamba_hybrid":
        n_groups, per_group, tail = _hybrid_structure(cfg)
        params["groups"] = mamba((n_groups, per_group))
        if tail:
            params["tail"] = mamba((tail,))
        params["shared_attn"] = dense(())
    elif mo is not None:
        if mo.first_k_dense:
            params["dense_layers"] = dense((mo.first_k_dense,),
                                           mo.d_ff_dense or cfg.d_ff)
        params["layers"] = _layer_params(
            generator, cfg, (cfg.n_layers - mo.first_k_dense,),
            lambda lead: moe_mod.moe_params(generator, cfg.d_model, mo,
                                            cfg.mlp_type, dt, lead), "moe")
    else:
        params["layers"] = dense((cfg.n_layers,))
    params["final_norm"] = make_norm_params(cfg.norm, cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        params["head"] = init_linear(generator, cfg.d_model, cfg.vocab_size,
                                     dt)
    return params


# ===========================================================================
# Forward
# ===========================================================================
def _block_attn(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                attn_impl: str) -> torch.Tensor:
    if cfg.mla is not None:
        return mla_mod.mla_attention(p["attn"], x, n_heads=cfg.n_heads,
                                     m=cfg.mla, rope_theta=cfg.rope_theta,
                                     chunk=cfg.attn_chunk, impl=attn_impl)
    return attn_mod.attention(p["attn"], x, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.head_dim,
                              rope_theta=cfg.rope_theta,
                              causal=not cfg.encoder_only,
                              chunk=cfg.attn_chunk,
                              window=cfg.sliding_window, impl=attn_impl)


def _dense_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                 attn_impl: str) -> torch.Tensor:
    x = x + _block_attn(cfg, p, apply_norm(cfg.norm, p["ln1"], x), attn_impl)
    x = x + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["ln2"], x),
                      cfg.mlp_type, cfg.activation, cfg.gate_sigmoid,
                      fused=attn_impl != "train")
    return x


def _moe_ffn(cfg: ArchConfig, p: Dict, x: torch.Tensor,
             fused: bool) -> torch.Tensor:
    """The MoE FFN, over sequence chunks of ``moe_prefill_chunk`` tokens
    when ``S > chunk`` and the chunk divides S (the reference's scan; the
    capacity is then applied per chunk of B x chunk tokens)."""
    ck = cfg.moe_prefill_chunk
    b, s, d = x.shape

    def moe(xc):
        return moe_mod.apply_moe(p, xc, cfg.moe, cfg.mlp_type, cfg.activation,
                                 gate_sigmoid=cfg.gate_sigmoid, fused=fused)

    if ck and s > ck and s % ck == 0:
        return torch.cat([moe(x[:, i:i + ck]) for i in range(0, s, ck)], 1)
    return moe(x)


def _moe_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
               attn_impl: str) -> torch.Tensor:
    x = x + _block_attn(cfg, p, apply_norm(cfg.norm, p["ln1"], x), attn_impl)
    x = x + _moe_ffn(cfg, p["moe"], apply_norm(cfg.norm, p["ln2"], x),
                     fused=attn_impl != "train")
    return x


def _embed_inputs(cfg: ArchConfig, params: Dict,
                  batch: Dict) -> torch.Tensor:
    """The stack's input: audio frame embeddings in the model dtype, or
    the tokens' embeddings with the vision patches (through
    ``modality_proj``) prepended."""
    table = params["embed"]["table"]
    if cfg.modality == "audio":
        return _tokens(batch["embeds"], table.device).to(_dtype(cfg))
    x = embed_tokens(params["embed"], _tokens(batch["tokens"], table.device))
    if cfg.modality == "vision" and "image_embeds" in batch:
        img = _tokens(batch["image_embeds"], table.device).to(x.dtype)
        x = torch.cat([apply_linear(params["modality_proj"], img), x], 1)
    return x


def _logits(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    if cfg.tie_embeddings:
        return (x.to(torch.float32)
                @ params["embed"]["table"].T.to(torch.float32))
    return apply_linear(params["head"], x).to(torch.float32)


def _mamba_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                 attn_impl: str) -> torch.Tensor:
    return x + mamba_mod.mamba2_forward(
        p["mamba"], apply_norm(cfg.norm, p["ln"], x), cfg.d_model, cfg.ssm,
        cfg.gate_sigmoid, fused=attn_impl != "train")


def _rwkv_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                attn_impl: str) -> torch.Tensor:
    return rwkv_mod.rwkv6_forward(p, x, cfg.n_heads, cfg.gate_sigmoid,
                                  fused=attn_impl != "train")


def _stacks(cfg: ArchConfig, dense: Callable, moe: Callable) -> List:
    """(params key, block) of each attention-pattern stack in order: a MoE
    config's leading dense layers (absent when ``first_k_dense`` is 0),
    then its MoE layers; a dense config's layers."""
    if cfg.moe is None:
        return [("layers", dense)]
    return [("dense_layers", dense), ("layers", moe)]


def _layer_calls(cfg: ArchConfig, params: Dict) -> List[Tuple[Callable,
                                                              Dict]]:
    """(block, layer parameters) of every layer call of the forward, in
    order.  The hybrid calls the one ``shared_attn`` block after each group
    of Mamba2 layers, then runs its tail."""
    if cfg.block_pattern == "rwkv":
        return [(_rwkv_block, p) for p in _unbind_layers(params["layers"])]
    if cfg.block_pattern == "mamba_hybrid":
        calls = []
        for group in _unbind_layers(params["groups"]):
            calls += [(_mamba_block, p) for p in _unbind_layers(group)]
            calls.append((_dense_block, params["shared_attn"]))
        if "tail" in params:
            calls += [(_mamba_block, p)
                      for p in _unbind_layers(params["tail"])]
        return calls
    return [(block, p)
            for key, block in _stacks(cfg, _dense_block, _moe_block)
            if key in params for p in _unbind_layers(params[key])]


def _stack(params: Dict, batch: Dict, cfg: ArchConfig,
           attn_impl: str) -> torch.Tensor:
    """The inputs' embedding, the layers and the head -> float32 logits
    (B, S, vocab): the one layer stack of both routes."""
    if attn_impl not in ATTN_IMPLS:
        raise KeyError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                       f"{attn_impl!r}")
    x = _embed_inputs(cfg, params, batch)
    remat = attn_impl == "train" and cfg.remat and torch.is_grad_enabled()
    for block, p in _layer_calls(cfg, params):
        if remat:
            x = checkpoint(block, cfg, p, x, attn_impl, use_reentrant=False)
        else:
            x = block(cfg, p, x, attn_impl)
    return _logits(cfg, params, x)


@torch.inference_mode()
def forward(params: Dict, batch: Dict, cfg: ArchConfig,
            attn_impl: str = "cuda") -> torch.Tensor:
    """Full-sequence forward -> float32 logits (B, S, vocab).  On the card
    each layer's attention is one ``flash_attention`` launch
    (``attn_impl="ref"`` computes the same function through the
    materialized-scores oracle instead, for checks; ``"train"`` takes the
    training route of :func:`loss_fn`, without grad)."""
    return _stack(params, batch, cfg, attn_impl)


def _cross_entropy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: ``logsumexp`` through a detached
    max, as the reference computes it.  The target logit is a
    ``torch.gather``: the reference's masked sum over the vocabulary adds
    only zeros to it, so the two give the same value bit for bit (and the
    same one-hot gradient)."""
    l32 = logits.to(torch.float32)
    m = torch.amax(l32, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(l32 - m), dim=-1)) + m[..., 0]
    tgt = torch.gather(l32, -1, targets[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - tgt)


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (the target
    shifted by one, past a vision prefix), or over an encoder's or the
    audio stream's ``batch["labels"]`` unshifted, through the training
    route: differentiable on any device, no kernel launched."""
    logits = _stack(params, batch, cfg, "train")
    dev = logits.device
    if cfg.encoder_only or cfg.modality == "audio":
        return _cross_entropy(logits, _tokens(batch["labels"], dev))
    tokens = _tokens(batch["tokens"], dev)
    n_prefix = logits.shape[1] - tokens.shape[1]
    logits_text = logits[:, n_prefix:, :]
    return _cross_entropy(logits_text[:, :-1], tokens[:, 1:])


# ===========================================================================
# Decode (serve_step)
# ===========================================================================
@torch.inference_mode()
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: Any) -> Dict:
    """The decode cache: ``pos`` and, per stack (``dense_layers`` first
    when a MoE config has them, then ``layers``), an MLA latent cache or a
    GQA KV cache stacked over its layers; RWKV's state per layer; the
    hybrid's Mamba2 states (``groups``, ``tail``) and one KV cache of
    ``min(sliding_window, max_len)`` slots a group for the shared block."""
    device = torch.device(device)
    dt, kv_q = _dtype(cfg), cfg.kv_cache_dtype == "int8"

    def mk(n, length=max_len):
        if cfg.mla is not None:
            return mla_mod.init_mla_cache(batch, length, cfg.mla, dt, device,
                                          quantized=kv_q, lead=(n,))
        return attn_mod.init_kv_cache(batch, length, cfg.n_kv_heads,
                                      cfg.head_dim, dt, device,
                                      quantized=kv_q, lead=(n,))

    cache: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32,
                                                device=device)}
    if cfg.block_pattern == "rwkv":
        cache["layers"] = rwkv_mod.init_rwkv_cache(
            batch, cfg.d_model, cfg.n_heads, dt, device,
            lead=(cfg.n_layers,))
        return cache
    if cfg.block_pattern == "mamba_hybrid":
        n_groups, per_group, tail = _hybrid_structure(cfg)

        def states(lead):
            return mamba_mod.init_mamba_cache(batch, cfg.d_model, cfg.ssm,
                                              dt, device, lead)

        cache["groups"] = states((n_groups, per_group))
        if tail:
            cache["tail"] = states((tail,))
        cache["shared_attn"] = mk(
            n_groups, min(cfg.sliding_window or max_len, max_len))
        return cache
    n_dense = cfg.moe.first_k_dense if cfg.moe is not None else 0
    if n_dense:
        cache["dense_layers"] = mk(n_dense)
    cache["layers"] = mk(cfg.n_layers - n_dense)
    return cache


def _decode_attn(cfg: ArchConfig, p: Dict, x, layer_cache, pos):
    if cfg.mla is not None:
        return mla_mod.mla_decode(p["attn"], x, layer_cache, pos,
                                  n_heads=cfg.n_heads, m=cfg.mla,
                                  rope_theta=cfg.rope_theta)
    return attn_mod.decode_attention(p["attn"], x, layer_cache, pos,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim,
                                     rope_theta=cfg.rope_theta,
                                     window=cfg.sliding_window)


def _decode_dense_block(cfg, p, x, layer_cache, pos):
    att, new_cache = _decode_attn(cfg, p, apply_norm(cfg.norm, p["ln1"], x),
                                  layer_cache, pos)
    x = x + att
    x = x + apply_mlp(p["mlp"], apply_norm(cfg.norm, p["ln2"], x),
                      cfg.mlp_type, cfg.activation, cfg.gate_sigmoid)
    return x, new_cache


def _decode_moe_block(cfg, p, x, layer_cache, pos):
    att, new_cache = _decode_attn(cfg, p, apply_norm(cfg.norm, p["ln1"], x),
                                  layer_cache, pos)
    x = x + att
    x = x + moe_mod.apply_moe(p["moe"], apply_norm(cfg.norm, p["ln2"], x),
                              cfg.moe, cfg.mlp_type, cfg.activation,
                              gate_sigmoid=cfg.gate_sigmoid)
    return x, new_cache


def _decode_mamba_block(cfg, p, x, layer_cache, pos):
    out, new_cache = mamba_mod.mamba2_decode(
        p["mamba"], apply_norm(cfg.norm, p["ln"], x), layer_cache,
        cfg.d_model, cfg.ssm, cfg.gate_sigmoid)
    return x + out, new_cache


def _decode_rwkv_block(cfg, p, x, layer_cache, pos):
    return rwkv_mod.rwkv6_decode(p, x, layer_cache, cfg.n_heads,
                                 cfg.gate_sigmoid)


def _decode_calls(cfg: ArchConfig, params: Dict) -> List:
    """(block, layer parameters, cache key, index into the stacked cache)
    of every layer call of a decode step, in the forward's order."""
    if cfg.block_pattern == "rwkv":
        return [(_decode_rwkv_block, _layer(params["layers"], i), "layers",
                 i) for i in range(cfg.n_layers)]
    if cfg.block_pattern == "mamba_hybrid":
        n_groups, per_group, _ = _hybrid_structure(cfg)
        calls = []
        for g in range(n_groups):
            group = _layer(params["groups"], g)
            calls += [(_decode_mamba_block, _layer(group, j), "groups",
                       (g, j)) for j in range(per_group)]
            calls.append((_decode_dense_block, params["shared_attn"],
                          "shared_attn", g))
        if "tail" in params:
            calls += [(_decode_mamba_block, _layer(params["tail"], i),
                       "tail", i) for i in range(_n_layers(params["tail"]))]
        return calls
    return [(block, _layer(params[key], i), key, i)
            for key, block in _stacks(cfg, _decode_dense_block,
                                      _decode_moe_block)
            if key in params for i in range(_n_layers(params[key]))]


@torch.inference_mode()
def serve_step(params: Dict, cache: Dict, batch: Dict,
               cfg: ArchConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step: new tokens (B,) -> logits (B, vocab), cache.  The
    cache's buffers are written in place (a windowed layer's shifted buffer
    is copied back into its slot of the stack)."""
    pos = cache["pos"]
    tok = _tokens(batch["token"], pos.device)
    x = embed_tokens(params["embed"], tok[:, None])  # (B, 1, d)
    for block, p, key, i in _decode_calls(cfg, params):
        stacked = cache[key]
        layer_cache = {k: c[i] for k, c in stacked.items()}
        x, new_cache = block(cfg, p, x, layer_cache, pos)
        for k, c in new_cache.items():
            if c is not layer_cache[k]:
                stacked[k][i].copy_(c)
    new = {"pos": pos + 1}
    new.update((k, v) for k, v in cache.items() if k != "pos")
    return _logits(cfg, params, x[:, 0]), new
