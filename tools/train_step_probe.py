#!/usr/bin/env python3
"""The LM trainer's full-width step on one card: a learning-rate sweep, or
the step before and after splitting the stacked layers once, in turns.

    python3 tools/train_step_probe.py sweep   # lr 3e-4, 1e-3, 3e-3
    python3 tools/train_step_probe.py ab      # old, new, new, old

Both run ``make_train_step`` at qwen2-0.5b's published widths (bf16
parameters, float32 moments, the config's remat) on ``chip_smoke.py``
path H's batch (8 x 512 of ``synthetic_token_stream``, seed 0).

* ``sweep``: 24 steps at each learning rate (warmup 3, cosine over 24):
  the losses, the mean of the first and of the last five, the loss of a
  held-out batch (stream step 10000) before and after, and ms per step.
* ``ab``: 12 steps of each variant in the order old, new, new, old, then
  one profiled step (device time by kind, launches, top ops).  ``new`` is
  the port as it stands; ``old`` indexes each layer's slice of the stacked
  parameters (autograd then adds a zero-filled stacked gradient per layer)
  and copies AdamW's two bias-correction bases from the host every step,
  as the trainer's first version did.  The losses of the variants must be
  equal (the two compute the same values).

Needs one NVIDIA GPU; nothing is built (no kernel of the port runs in a
step).  The first line is the card's name and power limit.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402  (adds src/ to the path)


def _setup(torch):
    K = C.namespace()
    return K, K.configs.get_config(C.LM_ARCH)


def sweep(torch, K, cfg, lrs=(3e-4, 1e-3, 3e-3), steps=24):
    M, TT = K.lm_model, K.trainer
    held = next(TT.synthetic_token_stream(cfg, C.TRAIN_BATCH, C.TRAIN_SEQ, 0,
                                          C.HELD_OUT_STEP, device="cuda"))
    for lr in lrs:
        tcfg = TT.TrainConfig(lr=lr, warmup_steps=C.TRAIN_WARMUP,
                              total_steps=steps, seed=0)
        opt = TT.make_optimizer(tcfg)
        step = TT.make_train_step(cfg, tcfg, opt)
        p = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        st = opt.init(p)
        with torch.no_grad():
            l0 = float(M.loss_fn(p, held, cfg))
        stream = TT.synthetic_token_stream(cfg, C.TRAIN_BATCH, C.TRAIN_SEQ, 0,
                                           device="cuda")
        losses, ts = [], []
        for _ in range(steps):
            b = next(stream)
            torch.cuda.synchronize()
            t = time.perf_counter()
            p, st, m = step(p, st, b)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
        with torch.no_grad():
            l1 = float(M.loss_fn(p, held, cfg))
        print(f"lr {lr}: {np.round(losses, 4).tolist()} mean of five "
              f"{np.mean(losses[:5]):.4f} -> {np.mean(losses[-5:]):.4f}; "
              f"held-out {l0:.4f} -> {l1:.4f}; {np.median(ts[3:]):.1f} "
              f"ms/step", flush=True)
        del p, st, opt, step
        torch.cuda.empty_cache()


def ab(torch, K, cfg, steps=12):
    M, TT, O = K.lm_model, K.trainer, K.optim
    new_unbind = M._unbind_layers

    def old_unbind(stacked):
        return [M._layer(stacked, i) for i in range(M._n_layers(stacked))]

    def old_adamw(tcfg):
        new = TT.make_optimizer(tcfg)

        def update(grads, state, params):
            # the first version's bias-correction bases, copied from the
            # host (each copy waits for the card)
            for b in (0.9, 0.95):
                torch.tensor(b, dtype=torch.float32, device=state.step.device)
            return new.update(grads, state, params)
        return O.Optimizer(new.init, update)

    def run(variant):
        old = variant == "old"
        M._unbind_layers = old_unbind if old else new_unbind
        tcfg = TT.TrainConfig(lr=C.TRAIN_LR, warmup_steps=C.TRAIN_WARMUP,
                              total_steps=C.TRAIN_STEPS, seed=0)
        opt = old_adamw(tcfg) if old else TT.make_optimizer(tcfg)
        step = TT.make_train_step(cfg, tcfg, opt)
        p = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
        st = opt.init(p)
        stream = TT.synthetic_token_stream(cfg, C.TRAIN_BATCH, C.TRAIN_SEQ, 0,
                                           device="cuda")
        ts, losses = [], []
        try:
            for _ in range(steps):
                b = next(stream)
                torch.cuda.synchronize()
                t = time.perf_counter()
                p, st, m = step(p, st, b)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t) * 1e3)
                losses.append(float(m["loss"]))
            prof = C._step_profile(torch, lambda: step(p, st, b))
        finally:
            M._unbind_layers = new_unbind
        ms = float(np.median(ts[3:]))
        print(f"{variant}: {ms:.2f} ms/step (median of steps 4-{steps}; "
              f"{[round(t, 1) for t in ts]}); profiled step "
              f"{prof['device_ms']:.2f} ms device in {prof['launches']} "
              f"launches, idle {1 - prof['device_ms'] / ms:.1%}; by kind "
              + ", ".join(f"{k} {v:.2f}" for k, v in prof["by_kind"].items())
              + "; top ops " + "; ".join(f"{n} {v:.2f}" for n, v in
                                         prof["top_ops"][:6]), flush=True)
        del p, st
        torch.cuda.empty_cache()
        return losses

    out = [run(v) for v in ("old", "new", "new", "old")]
    if not all(o == out[0] for o in out):
        print("the variants' losses differ:", out)
        return 1
    print("the variants' losses are equal")
    return 0


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available() or len(argv) != 1 \
            or argv[0] not in ("sweep", "ab"):
        print(__doc__, file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), "|", C.smi("name,power.limit"),
          flush=True)
    K, cfg = _setup(torch)
    if argv[0] == "sweep":
        sweep(torch, K, cfg)
        return 0
    return ab(torch, K, cfg)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
