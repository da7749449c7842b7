#!/usr/bin/env python3
"""Paths L6, L5 and L of ``chip_smoke.py`` alone, on the cards of this
host.

    python3 tools/mesh_lm_probe.py [L6] [L5] [L]     (default: L5)

Builds the kernels, prints the card's name and power limit and the torch
version, then runs the paths asked for, in this order:

* ``L``: on a ('data' 2, 'model' 2) mesh of the first four cards (a
  process a card, ``launch.mesh.run_on_mesh``), qwen2-0.5b at full width,
  float32, one batch of 8 x 512 from path H's seeded stream: each rank
  takes ``loss_and_grads`` on one card and under the mesh from the same
  weights, and rank 0 prints the two losses and the eight gradient leaves
  furthest from the single-card ones (max abs difference over the leaf's
  largest value, with the leaf's placements).  Then ``main_path_mesh_lm``
  (L1-L4, the same checks and lines as in the whole smoke run, grep
  ``4L``; path H's numbers, which the whole run takes from phase 4H, print
  as nan).  Needs four cards.
* ``L5``: ``main_path_mesh_families`` on (2, 2) with four cards, (1, 1)
  with fewer: L5a first, where every gradient leaf of each float32 config's
  step under the mesh is held to one card's (1e-4 of the leaf's largest
  value; the worst leaf printed), then L5b's bf16 models (grep ``4L5``).
* ``L6``: ``main_path_mesh_recurrent`` on the same mesh: L6a's float32
  zamba2 and rwkv6, every gradient leaf held to one card's as in L5a, then
  L6b's bf16 models (grep ``4L6``).

Exits non-zero if any check fails.  Needs NVIDIA GPUs and ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

MESH = (2, 2)


def grads_rank(mesh):
    """Rank 0 prints the losses and the furthest gradient leaves."""
    import torch.distributed as dist

    K = cs.namespace()
    M, TT, S = K.lm_model, K.trainer, K.sharding
    cfg = dataclasses.replace(K.configs.get_config(cs.LM_ARCH),
                              dtype="float32")
    dev = torch.device("cuda", torch.cuda.current_device())
    init = M.init_params(cfg, torch.Generator(dev).manual_seed(0))
    batch = next(TT.synthetic_token_stream(cfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ,
                                           0, device=dev))
    l0, g0 = TT.loss_and_grads(init, batch, cfg)
    rules = S.Rules(mesh)
    placed = S.device_put_tree(init, M.param_specs(cfg, rules), mesh)
    l1, g1 = TT.loss_and_grads(placed, batch, cfg, rules)
    errs = []
    for p, a, b in zip(TT._leaf_paths(g0), TT.tree_leaves(g0),
                       TT.tree_leaves(g1)):
        full = b.full_tensor()
        errs.append((float((a - full).abs().max() / a.abs().max()),
                     "/".join(p), str(b.placements)))
    if dist.get_rank() == 0:
        print("loss", float(l0), float(l1.full_tensor()), flush=True)
        print("grad max rel", max(errs)[0], "over", len(errs), "leaves",
              flush=True)
        for e in sorted(errs, reverse=True)[:8]:
            print("grad", e, flush=True)


def path_l(K):
    if torch.cuda.device_count() < 4:
        print(f"path L needs four cards, this host has "
              f"{torch.cuda.device_count()}")
        return 1
    mesh = cs.card_mesh(torch, K, MESH)
    K.mesh.run_on_mesh(grads_rank, mesh, mesh)
    nan = float("nan")
    cs.main_path_mesh_lm(torch, K, dict(ms_per_step=nan, tokens_per_s=nan,
                                        peak_gb=nan, launches_per_step=0))
    print("PATH L OK", flush=True)
    return 0


def main(argv) -> int:
    from repro_torch.kernels import build

    paths = argv or ["L5"]
    if set(paths) - {"L", "L5", "L6"}:
        print(f"unknown path(s) {paths}; choose from L6, L5 and L")
        return 2
    build.build_all()
    print(cs.smi("name,power.limit"), torch.__version__, flush=True)
    K = cs.namespace()
    if "L6" in paths:
        cs.main_path_mesh_recurrent(torch, K)
        print("PATH L6 OK", flush=True)
    if "L5" in paths:
        cs.main_path_mesh_families(torch, K)
        print("PATH L5 OK", flush=True)
    if "L" in paths and path_l(K):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
