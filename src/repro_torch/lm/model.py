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
* ``zamba2`` (Zamba2-7B as published): ``n_layers`` Mamba2 layers; before
  the mixer of each layer in ``cfg.shared.layers`` one of the shared
  blocks of :mod:`.zamba2` runs, in turn, on the stream joined with the
  embedding output, and its output (through the call's own linear) joins
  x at the Mamba2 input only: ``x <- x + mamba(norm(x + linear(block(x,
  emb))))``; the gated norm over the config's ``n_groups``.  No mesh route;
  :func:`prefill` fills its decode cache;
* ``rwkv``: a stack of RWKV-6 layers (:mod:`.rwkv6`).

The parameter tree keeps the reference's layout — nested dicts, the layers
stacked on leading axes (zamba2's ``groups`` on two) — and its dtypes,
float32 leaves in a bf16 model included (:func:`float32_leaf`), so weights
carry across one to one (:func:`repro_torch.convert.lm_params_from_numpy`);
a Python loop over the stacked index takes the place of the reference's
``lax.scan``.

Public API:
  init_params(cfg, generator)            -> params tree on the generator's device
  abstract_params(cfg)                   -> the same tree on the meta device
  param_specs(cfg, rules)                -> matching spec tree
  forward(params, batch, cfg)            -> (B, S, vocab) float32 logits
  loss_fn(params, batch, cfg)            -> scalar float32 loss
  init_cache(cfg, batch, max_len, device) -> decode cache tree
  cache_specs(cfg, rules, batch, max_len) -> matching spec tree
  serve_step(params, cache, batch, cfg)  -> (logits, cache)
  prefill(params, batch, cfg, max_len)   -> (logits, cache) (zamba2)
  input_specs(cfg, shape)                -> dict of meta-tensor stand-ins

**On a mesh.**  ``forward``, ``loss_fn`` and ``serve_step`` take ``rules``
(:class:`repro_torch.sharding.Rules`): the parameters, and the cache, are
then DTensors placed by :func:`param_specs` and :func:`cache_specs`
(:func:`repro_torch.sharding.device_put`), a plain input is placed with
its batch on the data axes, and the activations are constrained at the
reference's three points (the embedded input, the logits, the decode
logits).  Attention runs on each rank's local shard (batch on the data
axes, heads on ``model`` where the rules shard both head counts), through
``local_map``: on the card one ``flash_attention`` launch a layer and rank
(MLA's on the dh-192 instance, its decode over the latent gathered along
the cache length).  The MoE layers shard their experts by
``cfg.moe.expert_sharding`` with the reference's routing tables on every
rank (:mod:`.moe`).  The recurrent layers run their scans on each rank's
batch rows and heads through one ``local_map`` a layer: Mamba2's conv,
SSD scan and gates (:mod:`.mamba2`; its heads on ``model`` where the rules
shard both the SSM head count and ``n_groups``), RWKV-6's WKV loop and
group norm (:mod:`.rwkv6`; its heads on ``model`` where it divides them);
zamba2's shared block attends as any attention layer does, with its
window.  All ten configs run under rules.  A decode cache sharded on a
stacked dim it is indexed by (``cache_specs`` puts the batch axes on the
first dim of the batch's size, a group dim when there are as many groups
as rows) is decoded on a copy placed on its batch dim and written back
(:func:`_indexable`).

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

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.sharding.rules import Rules, device_put, is_dtensor, shard
from repro_torch.spans import span

from . import attention as attn_mod
from . import mamba2 as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import zamba2 as zamba2_mod
from .layers import (apply_linear, apply_mlp, apply_norm, draw_device,
                     draws_on, embed_tokens, init_embed, init_linear,
                     make_norm_params, mlp_params)

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "serve_step",
           "prefill", "float32_leaf", "cast_params_", "ATTN_IMPLS",
           "abstract_params", "param_specs", "input_specs", "cache_specs"]

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


def _norm(cfg: ArchConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The config's norm with its RMSNorm eps."""
    return apply_norm(cfg.norm, p, x, cfg.norm_eps)


def _tokens(tokens: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device)


# ===========================================================================
# Parameter construction
# ===========================================================================
def _layer_params(generator: torch.Generator, cfg: ArchConfig, lead: tuple,
                  ffn: Callable[[tuple], Dict], ffn_key: str) -> Dict:
    """Layers stacked on ``lead``: norms, attention (MLA or GQA) and the FFN
    ``ffn(lead)`` under ``ffn_key`` (the reference's leaf order)."""
    dt, dev = _dtype(cfg), draw_device(generator)
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
    dt, dev = _dtype(cfg), draw_device(generator)
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
    elif cfg.block_pattern == "zamba2":
        params["layers"] = mamba((cfg.n_layers,))
        params.update(zamba2_mod.shared_params(generator, cfg, dt))
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


def abstract_params(cfg: ArchConfig) -> Dict:
    """:func:`init_params`'s tree on the meta device: its structure, shapes
    and dtypes, nothing allocated (for the dry run)."""
    with draws_on("meta"):
        return init_params(cfg, torch.Generator())


# ===========================================================================
# Partition specs (the reference's rules; structure follows the tree)
# ===========================================================================
def _keystr(path: Tuple) -> str:
    """A key path as ``jax.tree_util.keystr`` prints it: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def _specs_like(tree: Any, rule_fn: Callable, path: Tuple = ()) -> Any:
    """Map each tensor leaf of a dict tree -> ``rule_fn(keystr, leaf)``."""
    if isinstance(tree, dict):
        return {k: _specs_like(v, rule_fn, path + (k,))
                for k, v in tree.items()}
    return rule_fn(_keystr(path), tree)


def _replicated(tree: Any) -> Any:
    return _specs_like(tree, lambda _, leaf: (None,) * leaf.dim())


def param_specs(cfg: ArchConfig, rules: Optional[Rules], fsdp: bool = True,
                tree: Optional[Dict] = None):
    """Spec tree for the params (the reference's rules, rule for rule).

    Policy: TP (``model``) on the head/ffn/vocab/expert dimension; FSDP
    (the data axes, gathered at use) on the other big dimension, never
    below 512; leading stacked-layer dims unsharded; a dimension the mesh
    axis does not divide stays replicated (the :class:`Rules` guard).
    ``tree``: the params to follow in place of :func:`abstract_params`
    (e.g. a quantized artifact whose linears are ``{'w_q', 'scale'}``).
    Without ``rules`` every leaf is replicated.
    """
    aps = tree if tree is not None else abstract_params(cfg)
    if rules is None:
        return _replicated(aps)

    def mdl(d: int):
        return rules.resolve("model", d)

    def dp(d: int):
        if not fsdp or d < 512:
            return None
        # every DP axis ('pod' included: ZeRO across pods); Rules falls
        # back to 'data' alone when the dim does not divide the full extent
        return rules.resolve("batch", d)

    def rule(path: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd <= 1:
            return (None,) * nd
        lead = (None,) * (nd - 2)
        if "embed" in path and "table" in path:
            return lead + (mdl(shape[-2]), dp(shape[-1]))
        if "head" in path:
            return lead + (dp(shape[-2]), mdl(shape[-1]))
        if "router" in path:
            return (None,) * nd
        if ("moe" in path and cfg.moe is not None and nd >= 3
                and shape[-3] == cfg.moe.n_experts):
            lead3 = (None,) * (nd - 3)
            if cfg.moe.expert_sharding == "ep2d":
                return lead3 + (rules.resolve("expert", shape[-3]), None,
                                None)
            if cfg.moe.expert_sharding == "ep":
                return lead3 + (mdl(shape[-3]), dp(shape[-2]), None)
            # tp: shard the expert-ffn dimension
            if shape[-1] == cfg.moe.d_ff_expert:
                return lead3 + (None, dp(shape[-2]), mdl(shape[-1]))
            return lead3 + (None, mdl(shape[-2]), dp(shape[-1]))
        din, dout = shape[-2], shape[-1]
        m = mdl(dout)
        if m is not None:
            return lead + (dp(din), m)
        return lead + (mdl(din), dp(dout))

    return _specs_like(aps, rule)


def _placed(x: Any, axes: Tuple, rules: Rules, device: torch.device):
    """A batch input under rules: a DTensor as given; a plain tensor (the
    same on every rank) placed with its leading dim on the data axes."""
    if is_dtensor(x):
        return x
    x = torch.as_tensor(x, device=device)
    return device_put(x, rules.sharding(axes[:x.dim()]
                                        + (None,) * (x.dim() - len(axes)),
                                        x.shape))


# ===========================================================================
# Forward
# ===========================================================================
def _block_attn(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                attn_impl: str, rules: Optional[Rules] = None
                ) -> torch.Tensor:
    with span("lm.attn"):
        if cfg.mla is not None:
            return mla_mod.mla_attention(p["attn"], x, n_heads=cfg.n_heads,
                                         m=cfg.mla, rope_theta=cfg.rope_theta,
                                         chunk=cfg.attn_chunk, impl=attn_impl,
                                         rules=rules)
        return attn_mod.attention(p["attn"], x, n_heads=cfg.n_heads,
                                  n_kv_heads=cfg.n_kv_heads,
                                  head_dim=cfg.head_dim,
                                  rope_theta=cfg.rope_theta,
                                  causal=not cfg.encoder_only,
                                  chunk=cfg.attn_chunk,
                                  window=cfg.sliding_window, impl=attn_impl,
                                  rules=rules)


def _dense_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                 attn_impl: str, rules: Optional[Rules] = None
                 ) -> torch.Tensor:
    x = x + _block_attn(cfg, p, _norm(cfg, p["ln1"], x), attn_impl, rules)
    x = x + apply_mlp(p["mlp"], _norm(cfg, p["ln2"], x),
                      cfg.mlp_type, cfg.activation, cfg.gate_sigmoid,
                      fused=attn_impl != "train")
    return x


def _moe_ffn(cfg: ArchConfig, p: Dict, x: torch.Tensor, fused: bool,
             rules: Optional[Rules] = None) -> torch.Tensor:
    """The MoE FFN, over sequence chunks of ``moe_prefill_chunk`` tokens
    when ``S > chunk`` and the chunk divides S (the reference's scan; the
    capacity is then applied per chunk of B x chunk tokens, under rules
    too: a chunk holds the whole batch)."""
    ck = cfg.moe_prefill_chunk
    b, s, d = x.shape

    def moe(xc):
        return moe_mod.apply_moe(p, xc, cfg.moe, cfg.mlp_type, cfg.activation,
                                 gate_sigmoid=cfg.gate_sigmoid, fused=fused,
                                 rules=rules)

    if ck and s > ck and s % ck == 0:
        return torch.cat([moe(x[:, i:i + ck]) for i in range(0, s, ck)], 1)
    return moe(x)


def _moe_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
               attn_impl: str, rules: Optional[Rules] = None
               ) -> torch.Tensor:
    x = x + _block_attn(cfg, p, _norm(cfg, p["ln1"], x), attn_impl, rules)
    x = x + _moe_ffn(cfg, p["moe"], _norm(cfg, p["ln2"], x),
                     attn_impl != "train", rules)
    return x


def _embed_on_mesh(table, tok):
    """``table[tok]`` for DTensors, on each rank's token shard: the table
    gathered (FSDP's gather at use) and indexed locally.  Each rank's table
    gradient is then a partial sum over the mesh dims its tokens are split
    on (replicated along the others), reduced back to the table's own
    placements.  DTensor's own index_put rule, the indexing's backward,
    fails in some torch releases."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * table.device_mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate()
            for p in tok.placements]
    return local_map(lambda t, i: t[i.long()], out_placements=list(
        tok.placements), in_placements=(rep, tok.placements),
        in_grad_placements=(grad, tok.placements),
        device_mesh=table.device_mesh)(
            table.redistribute(table.device_mesh, rep), tok)


def _embed_inputs(cfg: ArchConfig, params: Dict,
                  batch: Dict, rules: Optional[Rules] = None) -> torch.Tensor:
    """The stack's input: audio frame embeddings in the model dtype, or
    the tokens' embeddings with the vision patches (through
    ``modality_proj``) prepended; under rules, the inputs placed with their
    batch on the data axes (the projected patches constrained before they
    are joined) and the embedding constrained to ``('batch', None,
    None)``."""
    table = params["embed"]["table"]
    dev = table.device
    rows = ("batch", None, None)

    def placed(x, axes):
        if rules is None:
            return _tokens(x, dev)
        return _placed(x, axes, rules, dev)

    if cfg.modality == "audio":
        return shard(placed(batch["embeds"], rows).to(_dtype(cfg)), rows,
                     rules)
    tok = placed(batch["tokens"], ("batch", None))
    if rules is None:
        x = embed_tokens(params["embed"], tok)
    else:
        x = shard(_embed_on_mesh(table, tok), rows, rules)
    if cfg.modality == "vision" and "image_embeds" in batch:
        img = placed(batch["image_embeds"], rows).to(x.dtype)
        img = shard(apply_linear(params["modality_proj"], img), rows, rules)
        x = shard(torch.cat([img, x], 1), rows, rules)
    return x


def _logits(cfg: ArchConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = _norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        return (x.to(torch.float32)
                @ params["embed"]["table"].T.to(torch.float32))
    return apply_linear(params["head"], x).to(torch.float32)


def _mamba_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                 attn_impl: str, rules: Optional[Rules] = None
                 ) -> torch.Tensor:
    return x + mamba_mod.mamba2_forward(
        p["mamba"], _norm(cfg, p["ln"], x), cfg.d_model, cfg.ssm,
        cfg.gate_sigmoid, fused=attn_impl != "train", rules=rules)


def _zamba2_layer(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                  attn_impl: str, rules: Optional[Rules] = None,
                  emb: Optional[torch.Tensor] = None,
                  state: Optional[Dict] = None) -> torch.Tensor:
    """One Mamba2 layer of the zamba2 pattern, with its shared-block call
    where ``p`` holds one (``block``, ``call``).  ``state``: the layer's
    decode cache slots (``ssm``: its Mamba2 state; ``kv``: its call's KV
    cache), written by a prefill."""
    h = x
    if "block" in p:
        h = x + zamba2_mod.shared_call(
            cfg, p["block"], p["call"], x, emb, attn_impl,
            None if state is None else state["kv"])
    return x + mamba_mod.mamba2_forward(
        p["layer"]["mamba"], _norm(cfg, p["layer"]["ln"], h), cfg.d_model,
        cfg.ssm, cfg.gate_sigmoid, fused=attn_impl != "train",
        norm_groups=cfg.ssm.n_groups, eps=cfg.norm_eps,
        state=None if state is None else state["ssm"])


def _zamba2_calls(cfg: ArchConfig, params: Dict) -> List[Dict]:
    """Each Mamba2 layer's parameters, with its shared-block call's
    (``block``: the shared blocks taken in turn, ``call``: the call's
    linear and adapter) where it has one."""
    sh = cfg.shared
    at = {layer: c for c, layer in enumerate(sh.layers)}
    blocks = _unbind_layers(params["shared"])
    calls = _unbind_layers(params["hybrid"])
    out = []
    for i, layer in enumerate(_unbind_layers(params["layers"])):
        p = {"layer": layer}
        if i in at:
            p.update(block=blocks[at[i] % sh.n_blocks], call=calls[at[i]])
        out.append(p)
    return out


def _rwkv_block(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                attn_impl: str, rules: Optional[Rules] = None
                ) -> torch.Tensor:
    return rwkv_mod.rwkv6_forward(p, x, cfg.n_heads, cfg.gate_sigmoid,
                                  fused=attn_impl != "train", rules=rules)


def _stacks(cfg: ArchConfig, dense: Callable, moe: Callable) -> List:
    """(params key, block) of each attention-pattern stack in order: a MoE
    config's leading dense layers (absent when ``first_k_dense`` is 0),
    then its MoE layers; a dense config's layers."""
    if cfg.moe is None:
        return [("layers", dense)]
    return [("dense_layers", dense), ("layers", moe)]


def _layer_calls(cfg: ArchConfig, params: Dict,
                 emb: Optional[torch.Tensor] = None,
                 cache: Optional[Dict] = None) -> List[Tuple[Callable,
                                                             Dict]]:
    """(block, layer parameters) of every layer call of the forward, in
    order.  The hybrid calls the one ``shared_attn`` block after each group
    of Mamba2 layers, then runs its tail.  The zamba2 pattern's layers take
    the embedding output ``emb`` and, for a prefill, their slots of the
    decode ``cache``."""
    if cfg.block_pattern == "zamba2":
        sh = cfg.shared
        out = []
        for i, p in enumerate(_zamba2_calls(cfg, params)):
            state = None
            if cache is not None:
                state = {"ssm": _layer(cache["layers"], i), "kv": None}
                if i in sh.layers:
                    state["kv"] = _layer(cache["hybrid"], sh.layers.index(i))
            out.append((functools.partial(_zamba2_layer, emb=emb,
                                          state=state), p))
        return out
    if cache is not None:
        raise ValueError(f"prefill fills the decode cache of the zamba2 "
                         f"pattern, not of {cfg.block_pattern!r}")
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


def _no_mesh(cfg: ArchConfig, rules: Optional[Rules]) -> None:
    if rules is not None and cfg.block_pattern == "zamba2":
        raise NotImplementedError("the zamba2 pattern (Zamba2's published "
                                  "shared blocks) has no mesh route")


def _stack(params: Dict, batch: Dict, cfg: ArchConfig,
           attn_impl: str, rules: Optional[Rules] = None,
           cache: Optional[Dict] = None) -> torch.Tensor:
    """The inputs' embedding, the layers and the head -> float32 logits
    (B, S, vocab): the one layer stack of both routes (and of a prefill
    into ``cache``)."""
    if attn_impl not in ATTN_IMPLS:
        raise KeyError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                       f"{attn_impl!r}")
    _no_mesh(cfg, rules)
    with span("lm.embed"):
        x = _embed_inputs(cfg, params, batch, rules)
    remat = attn_impl == "train" and cfg.remat and torch.is_grad_enabled()
    for block, p in _layer_calls(cfg, params, x, cache):
        with span("lm.block"):
            if remat:
                x = checkpoint(block, cfg, p, x, attn_impl, rules,
                               use_reentrant=False)
            else:
                x = block(cfg, p, x, attn_impl, rules)
    with span("lm.logits"):
        logits = _logits(cfg, params, x)
    return shard(logits, ("batch", None, "model"), rules)


def forward(params: Dict, batch: Dict, cfg: ArchConfig,
            attn_impl: str = "cuda",
            rules: Optional[Rules] = None) -> torch.Tensor:
    """Full-sequence forward -> float32 logits (B, S, vocab).  On the card
    each layer's attention is one ``flash_attention`` launch
    (``attn_impl="ref"`` computes the same function through the
    materialized-scores oracle instead, for checks; ``"train"`` takes the
    training route of :func:`loss_fn`, without grad).  Under ``rules`` the
    logits are a DTensor placed ``('batch', None, 'model')``.  Runs under
    ``torch.inference_mode()``, or under ``torch.no_grad()`` with rules
    (a DTensor's views, such as the layers' ``unbind``, fail in inference
    mode)."""
    with (torch.no_grad() if rules is not None
          else torch.inference_mode()), span("lm.forward"):
        return _stack(params, batch, cfg, attn_impl, rules)


def prefill(params: Dict, batch: Dict, cfg: ArchConfig, max_len: int,
            attn_impl: str = "cuda") -> Tuple[torch.Tensor, Dict]:
    """The forward over ``batch["tokens"]`` (B, S) that also fills a decode
    cache of ``max_len`` >= S positions (the zamba2 pattern's: each Mamba2
    layer's conv history and state after the last position, each
    shared-block call's keys and values): -> (float32 logits (B, S, vocab),
    the cache at ``pos`` S), from which :func:`serve_step` decodes on."""
    tok = batch["tokens"]
    b, s = tok.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} positions in a cache of {max_len}")
    cache = init_cache(cfg, b, max_len, params["embed"]["table"].device)
    with torch.inference_mode(), span("lm.forward"):
        logits = _stack(params, batch, cfg, attn_impl, cache=cache)
        cache["pos"].fill_(s)
    return logits, cache


def _cross_entropy(logits: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32: ``logsumexp`` through a detached
    max, as the reference computes it.  The target logit is a
    ``torch.gather``: the reference's masked sum over the vocabulary adds
    only zeros to it, so the two give the same value bit for bit (and the
    same one-hot gradient).

    On a mesh (DTensor logits placed ``('batch', None, 'model')``) each
    rank gathers the vocabulary of its own batch rows, then runs this same
    body on its local rows through ``local_map``: its loss sum over the
    global token count is a partial sum over the data axes, and its
    gradient stays on its rows.  No DTensor rule takes part in the
    cross-entropy's backward (over a sharded vocabulary those rules gave
    gradients ~3e-3 off on four cards, torch 2.11).  The price is the
    gathered rows: each rank holds (B/dp, S, vocab) float32 logits, not
    (B/dp, S, vocab/tp)."""
    if not is_dtensor(logits):
        return torch.mean(_token_losses(logits, targets))
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    vocab = logits.dim() - 1
    rows = [Replicate() if p.is_shard(vocab) else p
            for p in logits.placements]
    if tuple(rows) != tuple(targets.placements):
        raise ValueError(f"cross-entropy: logit rows placed {rows}, targets "
                         f"{list(targets.placements)}")
    n = targets.numel()
    return local_map(
        lambda lg, t: torch.sum(_token_losses(lg, t)) / n,
        out_placements=[Partial() if p.is_shard() else Replicate()
                        for p in rows],
        in_placements=(rows, targets.placements),
        device_mesh=logits.device_mesh)(
            logits.redistribute(logits.device_mesh, rows), targets)


def _token_losses(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Each token's cross-entropy in float32 (the body of
    :func:`_cross_entropy`)."""
    l32 = logits.to(torch.float32)
    m = torch.amax(l32, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(l32 - m), dim=-1)) + m[..., 0]
    tgt = torch.gather(l32, -1, targets[..., None].to(torch.int64))[..., 0]
    return lse - tgt


def loss_fn(params: Dict, batch: Dict, cfg: ArchConfig,
            rules: Optional[Rules] = None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["tokens"]`` (the target
    shifted by one, past a vision prefix), or over an encoder's or the
    audio stream's ``batch["labels"]`` unshifted, through the training
    route: differentiable on any device, no kernel launched.  Under
    ``rules`` the loss is a replicated 0-d DTensor (each rank gathers the
    vocabulary of its batch rows for the cross-entropy)."""
    logits = _stack(params, batch, cfg, "train", rules)
    dev = logits.device

    def placed(x):
        if rules is None:
            return _tokens(x, dev)
        return _placed(x, ("batch", None), rules, dev)

    if cfg.encoder_only or cfg.modality == "audio":
        loss = _cross_entropy(logits, placed(batch["labels"]))
    else:
        tokens = placed(batch["tokens"])
        n_prefix = logits.shape[1] - tokens.shape[1]
        logits_text = logits[:, n_prefix:, :]
        loss = _cross_entropy(logits_text[:, :-1], tokens[:, 1:])
    return shard(loss, (), rules)


# ===========================================================================
# Input and cache specs (dry-run stand-ins on the meta device)
# ===========================================================================
def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    """Meta-tensor stand-ins for every model input of this cell, with the
    reference's shapes and dtypes (for decode, the cache among them)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=meta)

    if shape.kind in ("train", "prefill"):
        if cfg.modality == "audio":
            return {"embeds": sds((B, S, cfg.d_model), _dtype(cfg)),
                    "labels": sds((B, S), torch.int32)}
        if cfg.modality == "vision":
            n_img = cfg.n_prefix_embeds
            return {"tokens": sds((B, S - n_img), torch.int32),
                    "image_embeds": sds((B, n_img, cfg.d_model),
                                        torch.float32)}
        return {"tokens": sds((B, S), torch.int32)}
    return {"token": sds((B,), torch.int32),
            "cache": init_cache(cfg, B, S, meta)}


def cache_specs(cfg: ArchConfig, rules: Optional[Rules], batch: int,
                max_len: int):
    """Spec tree for the decode cache (the reference's rules): the batch
    dim on the data axes; then a kv-head or head dim on ``model`` where it
    divides, else the cache length on ``model`` (decode's softmax
    reductions over the length then become all-reduces)."""
    ac = init_cache(cfg, batch, max_len, "meta")
    if rules is None:
        return _replicated(ac)

    def rule(path: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        spec = [None] * nd
        for i, d in enumerate(shape):
            if d == batch:
                spec[i] = rules.resolve("batch", d)
                break
        assigned_model = False
        for i in range(nd - 1, 0, -1):
            if spec[i] is None and shape[i] in (cfg.n_kv_heads, cfg.n_heads) \
                    and rules.resolve("model", shape[i]):
                spec[i] = rules.resolve("model", shape[i])
                assigned_model = True
                break
        if not assigned_model:
            for i in range(1, nd):
                if spec[i] is None and shape[i] == max_len \
                        and rules.resolve("model", shape[i]):
                    spec[i] = rules.resolve("model", shape[i])
                    break
        return tuple(spec)

    return _specs_like(ac, rule)


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
    if cfg.block_pattern == "zamba2":
        cache["layers"] = mamba_mod.init_mamba_cache(
            batch, cfg.d_model, cfg.ssm, dt, device, lead=(cfg.n_layers,))
        cache["hybrid"] = mk(len(cfg.shared.layers))
        return cache
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


def _decode_attn(cfg: ArchConfig, p: Dict, x, layer_cache, pos,
                 rules: Optional[Rules] = None):
    if cfg.mla is not None:
        return mla_mod.mla_decode(p["attn"], x, layer_cache, pos,
                                  n_heads=cfg.n_heads, m=cfg.mla,
                                  rope_theta=cfg.rope_theta, rules=rules)
    return attn_mod.decode_attention(p["attn"], x, layer_cache, pos,
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim,
                                     rope_theta=cfg.rope_theta,
                                     window=cfg.sliding_window, rules=rules)


def _decode_dense_block(cfg, p, x, layer_cache, pos, rules=None):
    att, new_cache = _decode_attn(cfg, p, _norm(cfg, p["ln1"], x),
                                  layer_cache, pos, rules)
    x = x + att
    x = x + apply_mlp(p["mlp"], _norm(cfg, p["ln2"], x),
                      cfg.mlp_type, cfg.activation, cfg.gate_sigmoid)
    return x, new_cache


def _decode_moe_block(cfg, p, x, layer_cache, pos, rules=None):
    att, new_cache = _decode_attn(cfg, p, _norm(cfg, p["ln1"], x),
                                  layer_cache, pos, rules)
    x = x + att
    x = x + moe_mod.apply_moe(p["moe"], _norm(cfg, p["ln2"], x),
                              cfg.moe, cfg.mlp_type, cfg.activation,
                              gate_sigmoid=cfg.gate_sigmoid, rules=rules)
    return x, new_cache


def _decode_mamba_block(cfg, p, x, layer_cache, pos, rules=None):
    out, new_cache = mamba_mod.mamba2_decode(
        p["mamba"], _norm(cfg, p["ln"], x), layer_cache,
        cfg.d_model, cfg.ssm, cfg.gate_sigmoid, rules)
    return x + out, new_cache


def _decode_rwkv_block(cfg, p, x, layer_cache, pos, rules=None):
    return rwkv_mod.rwkv6_decode(p, x, layer_cache, cfg.n_heads,
                                 cfg.gate_sigmoid, rules)


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


def _indexable(cache: Dict, calls: List) -> Tuple[Dict, List]:
    """Under rules: ``cache`` with every stacked entry that is sharded on a
    dim the decode calls index (a layer or a group: ``cache_specs`` puts
    the batch axes on the first dim whose size is the batch, a group dim
    when there are as many groups as rows) replaced by a copy placed with
    those axes on its batch dim (replicated where they do not divide it),
    and the (entry, copy) pairs to write back.  Indexing a sharded dim
    would gather a new tensor, and a step's write would miss the cache."""
    from torch.distributed.tensor import Replicate, Shard

    lead = {key: len(i) if isinstance(i, tuple) else 1
            for _, _, key, i in calls}
    work, back = dict(cache), []
    for key, n in lead.items():
        work[key] = dict(cache[key])
        for k, c in cache[key].items():
            hit = [j for j, q in enumerate(c.placements)
                   if q.is_shard() and q.dim < n]
            if not hit:
                continue
            ways = 1
            for j in hit:
                ways *= c.device_mesh.size(j)
            to = Shard(n) if c.shape[n] % ways == 0 else Replicate()
            copy = c.redistribute(c.device_mesh, [
                to if j in hit else q for j, q in enumerate(c.placements)])
            work[key][k] = copy
            back.append((c, copy))
    return work, back


def serve_step(params: Dict, cache: Dict, batch: Dict, cfg: ArchConfig,
               rules: Optional[Rules] = None) -> Tuple[torch.Tensor, Dict]:
    """One decode step: new tokens (B,) -> logits (B, vocab), cache.  The
    cache's buffers are written in place (a windowed layer's shifted buffer
    is copied back into its slot of the stack).  Under ``rules`` the cache
    is a tree of DTensors placed by :func:`cache_specs`, and the logits a
    DTensor placed ``('batch', 'model')``."""
    with (torch.no_grad() if rules is not None
          else torch.inference_mode()):
        return _serve_step(params, cache, batch, cfg, rules)


def _zamba2_step(params: Dict, cache: Dict, x: torch.Tensor,
                 cfg: ArchConfig) -> torch.Tensor:
    """The zamba2 pattern's layers over one token's embedding x (B, 1, d),
    each layer's state and each call's KV cache updated in place."""
    sh, pos = cfg.shared, cache["pos"]
    emb = x
    for i, p in enumerate(_zamba2_calls(cfg, params)):
        h = x
        if "block" in p:
            kv = _layer(cache["hybrid"], sh.layers.index(i))
            h = x + zamba2_mod.shared_decode(cfg, p["block"], p["call"], x,
                                             emb, kv, pos)
        out, _ = mamba_mod.mamba2_decode(
            p["layer"]["mamba"], _norm(cfg, p["layer"]["ln"], h),
            _layer(cache["layers"], i), cfg.d_model, cfg.ssm,
            cfg.gate_sigmoid, norm_groups=cfg.ssm.n_groups, eps=cfg.norm_eps)
        x = x + out
    return x


def _serve_step(params, cache, batch, cfg, rules):
    _no_mesh(cfg, rules)
    pos = cache["pos"]
    if rules is None:
        tok = _tokens(batch["token"], pos.device)
    else:
        tok = _placed(batch["token"], ("batch",), rules, pos.device)
    if rules is None:
        x = embed_tokens(params["embed"], tok[:, None])  # (B, 1, d)
    else:
        x = _embed_on_mesh(params["embed"]["table"], tok[:, None])
    if cfg.block_pattern == "zamba2":
        x = _zamba2_step(params, cache, x, cfg)
        new = {"pos": pos + 1}
        new.update((k, v) for k, v in cache.items() if k != "pos")
        return _logits(cfg, params, x[:, 0]), new
    calls = _decode_calls(cfg, params)
    work, back = (cache, []) if rules is None else _indexable(cache, calls)
    for block, p, key, i in calls:
        stacked = work[key]
        layer_cache = {k: c[i] for k, c in stacked.items()}
        x, new_cache = block(cfg, p, x, layer_cache, pos, rules)
        for k, c in new_cache.items():
            if c is not layer_cache[k]:
                if rules is not None:
                    c = c.redistribute(c.device_mesh,
                                       layer_cache[k].placements)
                layer_cache[k].copy_(c)
    for entry, copy in back:
        entry.copy_(copy.redistribute(copy.device_mesh, entry.placements))
    new = {"pos": pos + 1}
    new.update((k, v) for k, v in cache.items() if k != "pos")
    return shard(_logits(cfg, params, x[:, 0]), ("batch", "model"),
                 rules), new
