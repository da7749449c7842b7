"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

The counterpart of :mod:`repro.launch.serve`: a thin CLI over
:class:`repro_torch.serve.InferenceService`.  The arch's seeded
parameters (no weights are downloaded) are compiled into an artifact
through the service's artifact cache, hosted on a named endpoint and
driven through the router, so the CLI runs the code path a long-lived
server would, per-endpoint stats included.

The conversion options are fields of one :class:`~repro_torch.compile.Target`:
weight-only int8 (per-channel or faithful global Qn.m), an int8 KV cache,
and PWL gate sigmoids.  Reduced configs by default; ``--full`` for the
published widths.  Runs on the current CUDA device unless ``--device cpu``
is given.

``--classifier {tree,mlp,logistic}`` serves a paper-style classifier
endpoint instead, trained on the device on synthetic blobs.  ``--http
HOST:PORT`` turns classifier mode into a long-lived network server
(:class:`repro_torch.serve.net.HttpServer`): ``/v1/predict/<name>`` +
``/v1/health``/``/v1/stats``/``/v1/endpoints``, admission control
(``--rate-limit``/``--queue-high``), SLO tracking (``--slo-ms``), and, with
``--degrade`` and a calibrated ``--format``, load-adaptive precision falling
back to ``--fallback-format`` under overload.  ``--backend`` takes the
port's names (``ref|cuda|emit``).  ``--dp N`` shards the endpoint
data-parallel across an N-replica serving mesh with replica-aware buckets:
N cards (``repro_torch.sharding.make_serving_mesh``, which raises when the
host has fewer), or with ``--device cpu`` N host replicas
(``make_host_mesh``, the counterpart of the reference's emulated host
devices).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.compile import LMModel, Target, resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.lm import model as M
from repro_torch.serve import BatchingPolicy, InferenceService

__all__ = ["main"]

# CLI flag -> (Target.number_format, Target.weight_scale)
_WEIGHT_MODES = {
    "bf16": ("flt", "qnm"),
    "int8": ("fxp8", "per_channel"),
    "qnm": ("fxp8", "qnm"),
}


def _serve_http(svc, args) -> None:
    """Run the asyncio HTTP front end until interrupted (or --http-duration)."""
    import asyncio

    from repro_torch.serve.net import AdmissionPolicy, SLOTracker

    host, _, port = args.http.rpartition(":")
    admission = AdmissionPolicy(
        rate_limit=args.rate_limit, burst=args.burst,
        queue_high=args.queue_high)
    slo = SLOTracker(default_slo_ms=args.slo_ms)
    server = svc.serve_http(host=host or "127.0.0.1", port=int(port),
                            admission=admission, slo=slo)

    async def run():
        await server.start()
        print(f"serving on {server.address} "
              f"(endpoints: {svc.router.names()})", flush=True)
        try:
            if args.http_duration is None:
                await asyncio.Event().wait()
            else:
                await asyncio.sleep(args.http_duration)
        finally:
            await server.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


def serve_classifier(args) -> None:
    """Serve a synthetic-blobs classifier endpoint, trained on the device,
    optionally DP-sharded."""
    from repro_torch.models import (synthetic_blobs, train_decision_tree,
                                    train_logistic, train_mlp)
    from repro_torch.serve import DegradationPolicy
    from repro_torch.sharding.rules import make_host_mesh, make_serving_mesh

    device = resolve_device(args.device)
    mesh = None
    if args.dp > 1:
        mesh = (make_host_mesh(args.dp) if device.type == "cpu"
                else make_serving_mesh(args.dp))
    x, y, c = synthetic_blobs(2048)
    trainers = {
        "tree": lambda: train_decision_tree(x[:1024], y[:1024], c,
                                            max_depth=8),
        "mlp": lambda: train_mlp(x[:1024], y[:1024], c, hidden=(32,),
                                 epochs=8, device=device),
        "logistic": lambda: train_logistic(x[:1024], y[:1024], c, epochs=15,
                                           device=device),
    }
    model = trainers[args.classifier]()
    target = Target(number_format=args.format, backend=args.backend)

    svc = InferenceService(device=device)
    try:
        ep = svc.register(args.classifier, model, target, mesh=mesh,
                          policy=BatchingPolicy(max_batch=64 * max(1, args.dp)),
                          # auto* formats calibrate on the training split
                          calibration=x[:1024] if target.is_calibrated else None,
                          # build the kernels over the bucket ladder at
                          # registration instead of on the first requests
                          pretune=x[:1] if args.pretune else False)
        art = ep.artifact
        print(f"endpoint {args.classifier}: {target.number_format}/"
              f"{target.backend} on {device}, replicas={art.replicas}"
              + (f" ({art.mesh_strategy})" if art.mesh is not None else "")
              + f", buckets={ep.policy.buckets()}"
              + (" [pretuned]" if args.pretune else ""))
        if args.degrade:
            if not target.is_calibrated:
                raise SystemExit("--degrade needs a calibrated --format "
                                 "(auto32/auto16/auto8) so the fallback "
                                 "plan coexists in the artifact cache")
            svc.enable_degradation(
                args.classifier, model,
                target.replace(number_format=args.fallback_format),
                policy=DegradationPolicy(p99_high_ms=args.slo_ms),
                calibration=x[:1024])
            print(f"degradation armed: {args.format} -> "
                  f"{args.fallback_format} under overload")
        if args.http:
            return _serve_http(svc, args)
        rows = x[-args.requests:]
        svc.predict(args.classifier, rows[:1])  # absorb warmup
        t0 = time.perf_counter()
        preds = svc.predict(args.classifier, rows)
        dt = time.perf_counter() - t0
        print(f"{rows.shape[0]} rows: {rows.shape[0] / dt:,.0f} rows/s "
              f"(accuracy {float(np.mean(preds == y[-args.requests:])):.3f})")
        if args.stats:
            snap = svc.stats()[args.classifier]
            print(f"endpoint {args.classifier}: {snap['rows']:.0f} rows, "
                  f"p50 {snap['p50_ms']:.1f}ms, p95 {snap['p95_ms']:.1f}ms, "
                  f"fill {snap['batch_fill']:.2f}")
    finally:
        svc.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--classifier", choices=["tree", "mlp", "logistic"],
                    help="serve a classifier endpoint instead of an LM arch")
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
    # classifier-mode knobs
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel serving replicas (classifier mode): "
                         "that many cards, or host replicas with --device cpu")
    ap.add_argument("--format",
                    choices=["flt", "fxp32", "fxp16", "fxp8",
                             "auto32", "auto16", "auto8"],
                    default="fxp16",
                    help="classifier serving number format (auto* = "
                         "calibrated per-tensor plans from the train split)")
    ap.add_argument("--backend", choices=["ref", "cuda", "emit"],
                    default="cuda", help="classifier serving backend")
    ap.add_argument("--requests", type=int, default=512,
                    help="rows of traffic to drive in classifier mode")
    ap.add_argument("--pretune", action="store_true",
                    help="run the endpoint over its bucket ladder at "
                         "registration (classifier mode)")
    # network serving (classifier mode)
    ap.add_argument("--http", metavar="HOST:PORT",
                    help="serve the classifier endpoint over HTTP instead "
                         "of driving synthetic traffic (port 0 = ephemeral)")
    ap.add_argument("--http-duration", type=float, default=None,
                    help="stop the HTTP server after N seconds "
                         "(default: run until interrupted)")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="p99 latency SLO target tracked in /v1/stats (and "
                         "the degradation p99 watermark with --degrade)")
    ap.add_argument("--rate-limit", type=float, default=None,
                    help="sustained requests/s admitted per endpoint "
                         "(token bucket; default unlimited)")
    ap.add_argument("--burst", type=int, default=32,
                    help="token-bucket burst capacity for --rate-limit")
    ap.add_argument("--queue-high", type=int, default=256,
                    help="scheduler queue depth at which requests are "
                         "refused with 503 + Retry-After")
    ap.add_argument("--degrade", action="store_true",
                    help="arm load-adaptive precision: fall back to "
                         "--fallback-format under overload (needs a "
                         "calibrated --format)")
    ap.add_argument("--fallback-format", choices=["auto32", "auto16", "auto8"],
                    default="auto8",
                    help="degraded-precision artifact format for --degrade")
    ap.add_argument("--faults", metavar="SPEC",
                    help="install a deterministic fault plan: JSON text or "
                         "@path/to/plan.json (see repro_torch.serve.faults); "
                         "equivalent to exporting REPRO_FAULTS")
    args = ap.parse_args(argv)

    if (args.arch is None) == (args.classifier is None):
        ap.error("pass exactly one of --arch or --classifier")
    if args.faults:
        from repro_torch.serve import faults as _faults

        inj = _faults.install(_faults.FaultPlan.from_json(args.faults))
        print(f"fault plan installed: {len(inj.plan.rules)} rule(s), "
              f"seed {inj.plan.seed}")
    if args.classifier:
        return serve_classifier(args)

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
