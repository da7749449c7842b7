"""Multi-pod dry run: plan and count every (arch x shape x mesh) cell.

The counterpart of :mod:`repro.launch.dryrun`.  The reference lowers and
compiles each cell with XLA on 512 emulated host devices; torch has no
single-controller SPMD compiler, so the port plans instead.  For each cell
it:

  1. builds the production mesh (16x16 single-pod, 2x16x16 multi-pod, or
     ``dp<D>tp<T>``) over host placeholders: no process group, no card;
  2. builds the abstract params, optimizer state and inputs on the meta
     device (nothing is allocated): the params quantized through
     ``quantize_lm_params`` where asked, the AdamW state through the
     port's ``adamw`` init with ``moments_dtype_for`` (bf16 moments above
     100 B parameters), the decode cache through ``init_cache``;
  3. takes their spec trees (``param_specs``, moments placed like the
     params and the step counter replicated, ``cache_specs``, the batch
     dim of each input on the data axes);
  4. counts the bytes each leaf holds on one device: numel x itemsize over
     the product of the sizes of the mesh axes in its spec.  Their sum is
     ``memory_analysis.argument_size_in_bytes`` (params and optimizer state
     plus inputs for train; params plus inputs for prefill; params, cache
     and inputs for decode), each part recorded beside it;
  5. records the analytic cost (``roofline.analytic_cost``) and its
     roofline terms on the H100 (``roofline.HW``), and writes a JSON record
     under ``--out-dir`` (default ``build/dryrun/``, git-ignored).

Absent, because nothing is compiled: ``lower_s``, ``compile_s``,
``cost_analysis``, ``hlo_flops_dev``, ``hlo_bytes_dev`` and
``collective_bytes`` (the reference's HLO parser is ported, in
``roofline.collective_bytes_from_hlo``, for HLO text that exists), and the
compiled program's output, temp and code sizes.  ``plan_s`` is the time a
cell's plan took.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multipod
Options: --quantized (weight-only int8 serving artifact), --no-fsdp,
--microbatches, --kv-int8, --expert-sharding, --moe-chunk, --out-dir.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.mesh import make_host_mesh_2d, make_production_mesh
from repro_torch.lm import model as model_lib
from repro_torch.roofline.analysis import model_flops, roofline_terms
from repro_torch.roofline.analytic import analytic_cost
from repro_torch.sharding.rules import Mesh, Rules
from repro_torch.train.optim import OptState
from repro_torch.train.trainer import TrainConfig, make_optimizer

__all__ = ["build_cell", "argument_bytes", "run_cell", "mesh_by_name",
           "moments_dtype_for", "main"]

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")


def mesh_by_name(name: str) -> Mesh:
    """``pod`` (16x16), ``multipod`` (2x16x16) or ``dp<D>tp<T>``."""
    if name.startswith("dp"):
        dpn, tpn = name[2:].split("tp")
        return make_host_mesh_2d(int(dpn), int(tpn))
    if name not in ("pod", "multipod"):
        raise ValueError(f"unknown mesh {name!r}: pod | multipod | dp<D>tp<T>")
    return make_production_mesh(multi_pod=name == "multipod")


def moments_dtype_for(cfg: ArchConfig) -> str:
    # >100B params: bf16 moments (the reference's capacity rule)
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"


def _batch_specs(shape: ShapeSpec, rules: Rules, inputs: Dict) -> Dict:
    """A spec per input leaf: its batch dim on the DP axes."""
    def rule(leaf) -> tuple:
        spec = [None] * leaf.dim()
        if (leaf.dim() and leaf.shape[0] == shape.global_batch
                and shape.global_batch > 1):
            spec[0] = rules.resolve("batch", leaf.shape[0])
        return tuple(spec)

    return {k: rule(v) for k, v in inputs.items()}


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh,
               quantized: bool = False, fsdp: bool = True,
               microbatches: int = 4) -> Dict[str, tuple]:
    """The cell's arguments, each part as (meta tree, spec tree): ``params``
    and ``opt_state`` (train), ``cache`` (decode) and ``inputs``."""
    rules = Rules(mesh)
    inputs = model_lib.input_specs(cfg, shape)
    aparams = model_lib.abstract_params(cfg)
    if shape.kind == "train":
        tcfg = TrainConfig(moments_dtype=moments_dtype_for(cfg),
                           microbatches=microbatches)
        aopt = make_optimizer(tcfg).init(aparams)
        pspecs = model_lib.param_specs(cfg, rules, fsdp=fsdp, tree=aparams)
        return {"params": (aparams, pspecs),
                "opt_state": (aopt, OptState((), pspecs, pspecs)),
                "inputs": (inputs, _batch_specs(shape, rules, inputs))}
    if quantized:
        from repro_torch.core.quantize import QuantSpec, quantize_lm_params

        aparams = quantize_lm_params(aparams, QuantSpec())
    cell = {"params": (aparams, model_lib.param_specs(
        cfg, rules, fsdp=fsdp, tree=aparams))}
    if shape.kind == "decode":
        acache = inputs.pop("cache")
        cell["cache"] = (acache, model_lib.cache_specs(
            cfg, rules, shape.global_batch, shape.seq_len))
    cell["inputs"] = (inputs, _batch_specs(shape, rules, inputs))
    return cell


def _leaf_bytes(leaf, spec: tuple, mesh: Mesh) -> int:
    ways = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                ways *= mesh.shape[axis]
    return leaf.numel() * leaf.element_size() // ways


def _tree_bytes(tree: Any, specs: Any, mesh: Mesh) -> int:
    if tree is None:
        return 0
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return sum(_tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return _leaf_bytes(tree, specs, mesh)


def argument_bytes(cell: Dict[str, tuple], mesh: Mesh) -> Dict[str, int]:
    """Bytes each part of ``cell`` holds on one device."""
    return {k: _tree_bytes(tree, specs, mesh)
            for k, (tree, specs) in cell.items()}


def run_cell(arch: str, shape_name: str, mesh_name: str,
             quantized: bool = False, fsdp: bool = True,
             out_dir: Optional[str] = None, verbose: bool = True,
             microbatches: int = 4, kv_int8: bool = False,
             expert_sharding=None, moe_chunk: int = 0) -> Dict:
    """Plan one cell (the module docstring) and return its record."""
    cfg = get_config(arch)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if expert_sharding is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_sharding=expert_sharding))
    if moe_chunk:
        cfg = dataclasses.replace(cfg, moe_prefill_chunk=moe_chunk)
    shape = SHAPES[shape_name]
    status = cfg.runnable_shapes()[shape_name]
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "quantized": quantized, "kv_int8": kv_int8, "status": status,
                 "microbatches": microbatches}
    if status != "run":
        if verbose:
            print(f"[dryrun] {arch} x {shape_name}: {status}")
        return rec

    mesh = mesh_by_name(mesh_name)
    chips = mesh.size
    t0 = time.perf_counter()
    parts = argument_bytes(build_cell(cfg, shape, mesh, quantized, fsdp,
                                      microbatches), mesh)
    plan_s = time.perf_counter() - t0
    arg_bytes = sum(parts.values())

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = model_flops(cfg.param_count(active_only=True), tokens,
                     "train" if shape.kind == "train" else "fwd")
    an = analytic_cost(
        cfg, shape, chips=chips, tp=mesh.shape.get("model", 1),
        dp_in_pod=mesh.shape.get("data", 1), pods=mesh.shape.get("pod", 1),
        microbatches=microbatches if shape.kind == "train" else 1,
        quantized=quantized, kv_quantized=kv_int8)
    rep = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        flops_dev=an.flops_global / chips,
        bytes_dev=an.hbm_bytes_global / chips,
        coll_bytes_dev=an.coll_bytes_dev, model_flops_global=mf,
        bytes_per_device=arg_bytes,
        note="analytic primary; nothing compiled (bytes_per_device: the "
             "planned argument bytes)")
    rec.update({
        "chips": chips,
        "plan_s": plan_s,
        "memory_analysis": {"argument_size_in_bytes": arg_bytes,
                            "argument_parts": parts},
        "analytic": an.to_dict(),
        "roofline": rep.to_dict(),
    })
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}"
              f"{' (int8)' if quantized else ''}: OK plan={plan_s:.2f}s "
              f"an_flops/dev={an.flops_global / chips:.3e} "
              f"an_bytes/dev={an.hbm_bytes_global / chips:.3e} "
              f"an_coll/dev={an.coll_bytes_dev:.3e} "
              f"dominant={rep.dominant} args/dev={arg_bytes / 1e9:.2f}GB")
        print(f"  argument bytes a device: {parts}")

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = ("_int8" if quantized else "") + ("_kv8" if kv_int8 else "") \
            + (f"_mb{microbatches}" if microbatches != 4
               and shape.kind == "train" else "") \
            + (f"_moechunk{moe_chunk}" if moe_chunk else "")
        path = os.path.join(
            out_dir, f"dryrun_{arch}_{shape_name}_{mesh_name}{suffix}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod",
                    help="pod | multipod | dp<D>tp<T> (e.g. dp64tp4)")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--expert-sharding", default=None,
                    choices=["ep", "ep2d", "tp"])
    ap.add_argument("--moe-chunk", type=int, default=0)
    ap.add_argument("--out-dir", default=os.path.abspath(DEFAULT_OUT))
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = []
    planned = 0
    for a, s in cells:
        try:
            rec = run_cell(a, s, args.mesh, quantized=args.quantized,
                           fsdp=not args.no_fsdp, out_dir=args.out_dir,
                           microbatches=args.microbatches,
                           kv_int8=args.kv_int8,
                           expert_sharding=args.expert_sharding,
                           moe_chunk=args.moe_chunk)
            planned += rec["status"] == "run"
        except Exception as e:  # noqa: BLE001 - report and continue
            failures.append((a, s, repr(e)))
            print(f"[dryrun] {a} x {s} x {args.mesh}: FAILED {e}")
            traceback.print_exc()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES: {failures}")
        sys.exit(1)
    print(f"[dryrun] all cells OK ({planned} planned)")


if __name__ == "__main__":
    main()
