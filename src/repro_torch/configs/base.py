"""Architecture configuration schema + registry.

The port's own copy of :mod:`repro.configs.base` (pure Python; the port
imports nothing of the reference package).  Every assigned architecture is
a frozen :class:`ArchConfig`; ``reduced()``
returns a same-family smoke-test configuration (few layers, narrow widths,
tiny vocab) that runs a real forward/train step on CPU.

Shape sets (assignment): ``train_4k``, ``prefill_32k``, ``decode_32k``,
``long_500k``.  ``runnable_shapes()`` applies the per-family skip rules
(full-attention archs skip long_500k; encoder-only archs skip decode shapes)
— each skip is recorded with its reason for EXPERIMENTS.md.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "SharedBlockConfig", "Zamba2ArchConfig", "SHAPES", "ShapeSpec",
           "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    first_k_dense: int = 0  # leading dense layers (deepseek-v3: 3)
    d_ff_dense: int = 0  # d_ff of those dense layers
    expert_sharding: str = "ep"  # 'ep' (experts over model axis) | 'tp' (d_ff over model)
    router_aux_free: bool = True  # deepseek aux-loss-free bias balancing
    capacity_factor: float = 1.25  # GShard capacity (drops above); smoke uses 8


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128  # SSD chunk length
    shared_attn_every: int = 6  # hybrid: shared attn block cadence (zamba2)


@dataclasses.dataclass(frozen=True)
class SharedBlockConfig:
    """Zamba2's shared transformer blocks (``block_pattern="zamba2"``):
    ``n_blocks`` blocks, called in turn before the Mamba2 mixer of each
    layer in ``layers``, on the concatenation of the stream and the
    embedding output (``d_attn`` = 2 d wide); each call has its own
    ``adapter_rank`` adapter on the MLP's gate and up projections and its
    own d x d output linear.  ``attn_scale`` multiplies the scores."""
    d_attn: int
    layers: Tuple[int, ...]
    attn_scale: float
    n_blocks: int = 2
    adapter_rank: int = 128


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'hybrid' | 'vlm' | 'ssm' | 'audio'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_type: str = "glu"  # 'glu' (SwiGLU) | 'standard' (2-matrix, e.g. starcoder2/hubert)
    activation: str = "silu"  # 'silu' | 'gelu' | 'relu'
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    encoder_only: bool = False
    sliding_window: Optional[int] = None  # attention window (used by hybrid @500k)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    block_pattern: str = "attn"  # 'attn' | 'mamba_hybrid' | 'zamba2' | 'rwkv'
    # modality frontends are stubs per assignment: inputs are precomputed
    # embeddings; n_prefix_embeds>0 means input_specs carries (B,N,d) floats.
    modality: Optional[str] = None  # None | 'vision' | 'audio'
    n_prefix_embeds: int = 0  # vision patches per example (llava anyres)
    attn_chunk: int = 1024  # blockwise-attention chunk (prefill memory bound)
    kv_cache_dtype: str = "bfloat16"  # 'int8' = Qn.m-quantized decode cache (C1)
    gate_sigmoid: str = "exact"  # serve-time gate sigmoid variant (paper C3)
    moe_prefill_chunk: int = 0  # scan MoE over token chunks (bounds live set)
    remat: bool = True
    dtype: str = "bfloat16"
    source: str = ""  # provenance note [paper/hf; tier]

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    # Fields of :class:`Zamba2ArchConfig` alone: properties here, so that
    # this class keeps the reference's fields one for one (the parity
    # tests compare the two field by field).
    @property
    def norm_eps(self) -> float:
        """RMSNorm's eps (layernorm keeps its 1e-5)."""
        return 1e-6

    @property
    def shared(self) -> Optional[SharedBlockConfig]:
        """Zamba2's shared blocks (the ``zamba2`` pattern), else None."""
        return None

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ---------------
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim
        n_attn_layers, n_mamba_layers = self._layer_split()
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder_only:
            emb = self.vocab_size * d + self.n_prefix_embeds  # unembed tiny
        attn = (d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh
                + self.n_heads * dh * d)
        if self.mla is not None:
            m = self.mla
            qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_dim
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        mlp_mult = 3 if self.mlp_type == "glu" else 2
        per_layer = attn + 2 * d  # + norms
        total = emb
        if self.moe is not None:
            mo = self.moe
            dense_layers = mo.first_k_dense
            moe_layers = n_attn_layers - dense_layers
            expert = mlp_mult * d * mo.d_ff_expert
            total += dense_layers * (per_layer + mlp_mult * d * (mo.d_ff_dense or self.d_ff))
            routed = mo.n_experts if not active_only else mo.top_k
            total += moe_layers * (per_layer + (routed + mo.n_shared) * expert
                                   + d * mo.n_experts)  # router
        else:
            total += n_attn_layers * (per_layer + mlp_mult * d * self.d_ff)
        if self.block_pattern in ("mamba_hybrid", "zamba2") \
                and self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            per_mamba = (d * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim)
                         + d_in * s.d_conv + d_in * d + 2 * d)
            total += n_mamba_layers * per_mamba
        if self.block_pattern == "zamba2":
            sh, f = self.shared, self.d_ff
            block = (sh.d_attn * (3 * self.n_heads * dh + 1)
                     + self.n_heads * dh * d + d + 3 * d * f)
            per_call = d * d + sh.adapter_rank * (d + 2 * f)
            total += sh.n_blocks * block + len(sh.layers) * per_call
        if self.block_pattern == "rwkv":
            # time-mix (r,k,v,g,o + lora decay) + channel-mix per layer
            per_rwkv = d * d * 5 + d * 64 * 2 + d * self.d_ff + self.d_ff * d + 2 * d
            total = emb + self.n_layers * per_rwkv
        return int(total)

    def _layer_split(self) -> Tuple[int, int]:
        """(#attention-layers, #mamba-layers) given the block pattern."""
        if self.block_pattern == "mamba_hybrid" and self.ssm is not None:
            k = self.ssm.shared_attn_every
            n_groups = self.n_layers // k
            n_attn = n_groups  # one shared-attn invocation per group
            return n_attn, self.n_layers - n_attn
        if self.block_pattern == "rwkv":
            return 0, 0
        if self.block_pattern == "zamba2":
            return 0, self.n_layers
        return self.n_layers, 0

    # -- shape/skip policy ----------------------------------------------------
    def runnable_shapes(self) -> Dict[str, str]:
        """shape name -> 'run' or 'skip: <reason>'."""
        out = {}
        subquadratic = self.block_pattern in ("mamba_hybrid", "rwkv")
        for name, spec in SHAPES.items():
            if self.encoder_only and spec.kind == "decode":
                out[name] = "skip: encoder-only arch has no decode step"
            elif name == "long_500k" and not subquadratic:
                out[name] = ("skip: pure full-attention arch — 500k decode KV "
                             "cache unservable; per assignment run only for "
                             "SSM/hybrid/linear-attn")
            else:
                out[name] = "run"
        return out

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 7 if self.block_pattern in (
                "mamba_hybrid", "zamba2") else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=32,
            d_ff=256,
            vocab_size=512,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            attn_chunk=64,
            remat=False,
            dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                first_k_dense=min(self.moe.first_k_dense, 1),
                d_ff_dense=256 if self.moe.first_k_dense else 0,
                capacity_factor=8.0)  # no drops: decode == prefill in smoke
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_head_dim=16, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                            chunk=32, shared_attn_every=3)
        if self.sliding_window:
            kw["sliding_window"] = 64
        if self.shared is not None:
            # three hybrid calls in 7 layers (both blocks run, block 0
            # twice), chunk 32 with ngroups kept: a length that is not a
            # multiple of 32 is ragged; heads of 2 d / n_heads, as
            # published, with the published scale's rule (dh / 2)^-1/2
            dh = 2 * kw["d_model"] // kw["n_heads"]
            kw.update(d_head=dh, shared=dataclasses.replace(
                self.shared, d_attn=2 * kw["d_model"], layers=(1, 3, 5),
                attn_scale=(dh / 2) ** -0.5, adapter_rank=16))
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Zamba2ArchConfig(ArchConfig):
    """An :class:`ArchConfig` of the ``zamba2`` block pattern, with the
    fields only the port has: the shared blocks and the RMSNorm eps the
    model states."""
    shared: Optional[SharedBlockConfig] = None
    norm_eps: float = 1e-6


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _  # noqa
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    from repro_torch import configs as _  # noqa
    return tuple(sorted(_REGISTRY))
