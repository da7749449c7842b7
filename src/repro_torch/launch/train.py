"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The counterpart of :mod:`repro.launch.train`: runs the fault-tolerant
loop (:func:`repro_torch.train.trainer.train_loop`) on the chosen arch's
reduced config, or at its published widths with ``--full``.  Runs on the
current CUDA device unless ``--device cpu`` is given (and raises without
one).  Checkpoints go under ``<--ckpt-dir>/<config name>/step_<n>/``; a
second run with the same directory resumes from the last committed step.
The default directory lies in the system's temporary directory
(``TMPDIR``).
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.compile import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.train.trainer import TrainConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (published widths)")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the current CUDA device) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tcfg = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps, microbatches=args.microbatches,
                       checkpoint_every=args.checkpoint_every)

    def on_step(step, m):
        if step % 10 == 0:
            print(f"step {step:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f}"
                  + (" [straggler?]" if "straggler_suspect" in m else ""))

    metrics = train_loop(cfg, tcfg, batch=args.batch, seq=args.seq,
                         ckpt_dir=f"{args.ckpt_dir}/{cfg.name}",
                         steps=args.steps, on_step=on_step, device=device)
    h = metrics["history"]
    if h:
        print(f"done at step {metrics['final_step']} on {device}: loss "
              f"{h[0]:.3f} -> {h[-1]:.3f}")
    else:
        print(f"done at step {metrics['final_step']} on {device}: nothing "
              f"left to run")
    return metrics


if __name__ == "__main__":
    main()
