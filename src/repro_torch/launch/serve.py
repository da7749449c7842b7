"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The counterpart of the ``--arch`` mode of :mod:`repro.launch.serve`: a thin
CLI over :class:`repro_torch.serve.InferenceService`.  The arch's seeded
parameters (no weights are downloaded) are compiled into an artifact
through the service's artifact cache, hosted on a named endpoint and
driven through the router, so the CLI runs the code path a long-lived
server would, per-endpoint stats included.

The conversion options are fields of one :class:`~repro_torch.compile.Target`:
weight-only int8 (per-channel or faithful global Qn.m), an int8 KV cache,
and PWL gate sigmoids.  Reduced configs by default; ``--full`` for the
published widths.  Runs on the current CUDA device unless ``--device cpu``
is given.  ``--classifier`` (classifier endpoints and the HTTP plane) is
not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.compile import LMModel, Target, resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.lm import model as M
from repro_torch.serve import InferenceService

__all__ = ["main"]

# CLI flag -> (Target.number_format, Target.weight_scale)
_WEIGHT_MODES = {
    "bf16": ("flt", "qnm"),
    "int8": ("fxp8", "per_channel"),
    "qnm": ("fxp8", "qnm"),
}
_CLASSIFIER_SLICE = (
    "--classifier is not ported to repro_torch yet: classifier endpoints "
    "and the HTTP plane come with the rest of the serving plane (roadmap "
    "item A9); serve classifiers in-process with "
    "repro_torch.serve.InferenceService meanwhile")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--classifier", choices=["tree", "mlp", "logistic"],
                    help="serve a classifier endpoint (not ported yet)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--weights", choices=sorted(_WEIGHT_MODES), default="bf16")
    ap.add_argument("--kv", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--gate-sigmoid",
                    choices=["exact", "rational", "pwl2", "pwl4"],
                    default="exact")
    ap.add_argument("--full", action="store_true",
                    help="the published widths (default: the reduced config)")
    ap.add_argument("--stats", action="store_true",
                    help="print the endpoint's serving stats after the run")
    ap.add_argument("--device", default=None,
                    help="'cuda' (default: the current CUDA device) or 'cpu'")
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.classifier is None):
        ap.error("pass exactly one of --arch or --classifier")
    if args.classifier:
        raise SystemExit(_CLASSIFIER_SLICE)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")

    number_format, weight_scale = _WEIGHT_MODES[args.weights]
    target = Target(
        number_format=number_format,
        weight_scale=weight_scale,
        kv_cache="int8" if args.kv == "int8" else "native",
        sigmoid=args.gate_sigmoid,
    )

    params = M.init_params(cfg, torch.Generator(device).manual_seed(0))
    svc = InferenceService(device=device)
    try:
        ep = svc.register(args.arch, LMModel(cfg, params), target)
        art = ep.artifact
        if args.weights != "bf16":
            from repro_torch.core.quantize import quantized_param_bytes
            tot, _ = quantized_param_bytes(params)
            print(f"artifact: {tot / 1e6:.1f}MB -> "
                  f"{art.memory_report()['flash'] / 1e6:.1f}MB "
                  f"({args.weights})")
        # The artifact keeps its own parameters through the service's cache.
        del params

        tok = np.random.RandomState(0).randint(
            1, cfg.vocab_size, (args.batch,)).astype(np.int32)
        t0 = time.perf_counter()
        seqs = svc.generate(args.arch, tok, args.tokens)
        dt = (time.perf_counter() - t0) / args.tokens * 1e3
        print(f"{args.tokens} tokens x batch {args.batch} on {device}: "
              f"{dt:.1f} ms/token")
        print("sample:", seqs[0, :16])
        if args.stats:
            snap = svc.stats()[args.arch]
            print(f"endpoint {args.arch}: {snap['rows']:.0f} tokens, "
                  f"p50 {snap['p50_ms']:.1f}ms, p95 {snap['p95_ms']:.1f}ms")
    finally:
        svc.close()


if __name__ == "__main__":
    main()
