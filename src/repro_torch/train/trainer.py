"""The LM training loop and its step function.

The counterpart of :mod:`repro.train.trainer`, in eager PyTorch on one
device:

* **step function**: loss -> grad -> global-norm clip -> AdamW, with
  optional microbatch gradient accumulation (the batch's leading axis is
  split; gradients are accumulated in the parameters' dtype, as the
  reference's scan carries them, then divided).  The loss is
  :func:`repro_torch.lm.model.loss_fn`, the training route: the
  reference's own attention branch and gate, differentiated by autograd;
  no kernel is launched.
* **checkpoint/restart**: :class:`CheckpointManager` with atomic commits;
  the loop resumes from (step, params, opt) and replays the data stream
  from the step index.  The files are the reference's, so either package
  resumes the other's run.
* **preemption**: SIGTERM sets a flag; the loop saves at the next step
  boundary and stops (the previous handler is restored on exit).
* **straggler watchdog**: a per-step wall-time EMA; a step slower than
  ``watchdog_factor`` times it is reported as ``straggler_suspect``.

The reference's ``jit=`` argument of ``train_loop`` has no counterpart:
the port's step runs eagerly, and eager PyTorch donates no buffers.

**On a mesh** (``make_train_step(..., rules=...)``, one process a device,
:func:`repro_torch.launch.mesh.run_on_mesh`): the parameters and the
moments are DTensors placed by :func:`repro_torch.lm.model.param_specs`,
the step counter is replicated, and each gradient (which autograd may hand
back as a partial sum) is redistributed to its parameter's placements
before the clip and AdamW.  **Elastic resharding**: a checkpoint saved
under one mesh (:class:`CheckpointManager` gathers each DTensor leaf and
rank 0 writes the reference's file) restores under another, each leaf
placed as the ``like`` tree's leaf is.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.compile.api import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.lm import model as model_lib
from repro_torch.sharding.rules import Rules, full_value
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import (Optimizer, adamw, apply_updates,
                                     clip_by_global_norm, tree_leaves,
                                     tree_map)
from repro_torch.train.schedule import cosine_schedule

__all__ = ["TrainConfig", "make_train_step", "train_loop", "TrainState",
           "synthetic_token_stream", "make_optimizer", "loss_and_grads"]


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1  # gradient accumulation
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    moments_dtype: str = "float32"  # bf16 for >100B models (memory budget)
    watchdog_factor: float = 3.0
    seed: int = 0


class TrainState:
    """(params, opt_state) bundle — a plain pytree for checkpointing."""

    def __init__(self, params, opt_state):
        self.params = params
        self.opt_state = opt_state

    def tree(self):
        return {"params": self.params, "opt": self.opt_state}


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    sched = cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)
    return adamw(sched, weight_decay=cfg.weight_decay,
                 mu_dtype=getattr(torch, cfg.moments_dtype))


def loss_and_grads(params: Dict, batch: Dict, arch: ArchConfig,
                   rules: Optional[Rules] = None):
    """(loss, grads) of :func:`repro_torch.lm.model.loss_fn` at
    ``params``, the counterpart of ``jax.value_and_grad(loss_fn)``: the
    gradients come in the parameters' dtypes and structure (under
    ``rules``, in their placements).  The leaves of
    :func:`_not_differentiated` get zeros, as JAX gives them; any other
    leaf that does not reach the loss raises."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = model_lib.loss_fn(live, batch, arch, rules)
        raw = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = []
    for path, leaf, g in zip(_leaf_paths(live), leaves, raw):
        if g is None:
            if not _not_differentiated(path, arch):
                raise RuntimeError(f"parameter {'/'.join(map(str, path))} "
                                   f"does not reach the loss")
            g = torch.zeros_like(leaf)
        elif rules is not None:
            g = g.redistribute(leaf.device_mesh, leaf.placements)
        grads.append(g)
    grads = iter(grads)
    return loss.detach(), tree_map(lambda _: next(grads), live)


def _not_differentiated(path: tuple, arch: ArchConfig) -> bool:
    """Whether the loss reads the leaf at ``path`` only where no gradient
    flows: a MoE router's aux-free ``bias`` moves the top-k selection only,
    and an audio encoder takes frame embeddings in place of its token table
    (read by an untied head never) and ``modality_proj`` (vision's)."""
    if path[-2:] == ("router", "bias"):
        return True
    return arch.modality == "audio" and (
        path[0] == "modality_proj"
        or (path == ("embed", "table") and not arch.tie_embeddings))


def _leaf_paths(tree: Any, prefix: tuple = ()) -> list:
    """The key path of each leaf, in :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, prefix + (i,))]
    return [prefix]


def make_train_step(arch: ArchConfig, tcfg: TrainConfig,
                    optimizer: Optional[Optimizer] = None,
                    rules: Optional[Rules] = None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), with ``metrics`` the ``loss`` and ``grad_norm`` tensors.

    With ``tcfg.microbatches > 1`` the batch's leading dim is split and
    the gradients are accumulated in the parameters' dtype.  Under
    ``rules`` the parameters and ``opt_state`` are DTensors on the rules'
    mesh (the module docstring), the batch is placed by ``loss_fn`` (each
    microbatch taken from the full batch), and the metrics are plain
    tensors, the same on every rank.
    """
    opt = optimizer or make_optimizer(tcfg)
    mb = tcfg.microbatches

    def step(params, opt_state, batch):
        if mb > 1:
            micro = [{k: full_value(v).reshape(mb, v.shape[0] // mb,
                                               *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(mb)]
            # the reference's scan starts from zeros: 0 + g is g exactly
            loss, grads = loss_and_grads(params, micro[0], arch, rules)
            for m in micro[1:]:
                l, g = loss_and_grads(params, m, arch, rules)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
        else:
            loss, grads = loss_and_grads(params, batch, arch, rules)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": full_value(loss),
                                   "grad_norm": full_value(gnorm)}

    return step


# ---------------------------------------------------------------------------
# Deterministic synthetic token stream (data substrate for the examples)
# ---------------------------------------------------------------------------
def synthetic_token_stream(arch: ArchConfig, batch: int, seq: int,
                           seed: int = 0, start_step: int = 0,
                           device: Any = "cpu"
                           ) -> Iterator[Dict[str, torch.Tensor]]:
    """Markov-ish synthetic corpus, deterministic per (seed, step) so a
    restart at step k replays exactly the same batch k; the reference's
    batches, bit for bit, as tensors on ``device``: int32 ``tokens``; for
    the audio front end float32 frame ``embeds`` and int32 ``labels``; for
    the vision one the text ``tokens`` after ``n_prefix_embeds`` float32
    ``image_embeds`` (drawn from the same ``RandomState`` calls in the same
    order)."""
    vocab = arch.vocab_size
    step = start_step

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    while True:
        rng = np.random.RandomState((seed * 1_000_003 + step) % (2 ** 31))
        base = rng.randint(0, vocab, size=(batch, seq), dtype=np.int64)
        # inject local structure so the loss can fall: repeat previous token
        rep = rng.rand(batch, seq) < 0.35
        base[:, 1:] = np.where(rep[:, 1:], base[:, :-1], base[:, 1:])
        out = {"tokens": put((base % vocab).astype(np.int32))}
        if arch.modality == "audio":
            emb = rng.randn(batch, seq, arch.d_model).astype(np.float32)
            out = {"embeds": put(emb),
                   "labels": put((base % vocab).astype(np.int32))}
        elif arch.modality == "vision":
            n = arch.n_prefix_embeds
            out = {"tokens": put((base[:, :seq - n] % vocab).astype(np.int32)),
                   "image_embeds": put(rng.randn(batch, n, arch.d_model)
                                       .astype(np.float32))}
        yield out
        step += 1


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------
_PREEMPTED = {"flag": False}


def _sigterm_handler(signum, frame):  # pragma: no cover - signal path
    _PREEMPTED["flag"] = True


def train_loop(arch: ArchConfig, tcfg: TrainConfig, *, batch: int, seq: int,
               ckpt_dir: str, steps: int, data: Optional[Iterator] = None,
               log_every: int = 10,
               on_step: Optional[Callable[[int, Dict], None]] = None,
               device: Any = None) -> Dict:
    """Run (or resume) training for ``steps`` steps on ``device`` (the
    current CUDA device unless the caller names ``"cpu"``; raises without
    one).  Returns the last step's metrics with ``history`` (the losses
    of the steps run) and ``final_step``."""
    dev = resolve_device(device)
    opt = make_optimizer(tcfg)
    step_fn = make_train_step(arch, tcfg, opt)

    gen = torch.Generator(dev).manual_seed(tcfg.seed)
    params = model_lib.init_params(arch, gen)
    opt_state = opt.init(params)

    mgr = CheckpointManager(ckpt_dir, keep=tcfg.keep_checkpoints)
    state_like = {"params": params, "opt": opt_state}
    start_step, restored = mgr.restore_or_init(state_like)
    if start_step > 0:
        params, opt_state = restored["params"], restored["opt"]

    stream = data or synthetic_token_stream(arch, batch, seq, tcfg.seed,
                                            start_step, device=dev)
    prev = signal.signal(signal.SIGTERM, _sigterm_handler)
    ema = None
    metrics: Dict[str, Any] = {}
    history = []
    step = start_step - 1
    try:
        for step in range(start_step, steps):
            t0 = time.time()
            batch_data = next(stream)
            params, opt_state, metrics = step_fn(params, opt_state, batch_data)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            if dt > tcfg.watchdog_factor * ema and step > start_step + 3:
                metrics["straggler_suspect"] = dt / ema
            history.append(metrics["loss"])
            if on_step:
                on_step(step, metrics)
            if (step + 1) % tcfg.checkpoint_every == 0 or step + 1 == steps:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         metadata={"loss": metrics["loss"]})
            if _PREEMPTED["flag"]:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         metadata={"loss": metrics["loss"], "preempted": True})
                break
    finally:
        signal.signal(signal.SIGTERM, prev)
    metrics["history"] = history
    metrics["final_step"] = step + 1
    return metrics
