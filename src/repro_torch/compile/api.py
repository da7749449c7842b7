"""The staged compiler entry point: ``compile(model, Target(...))``.

The counterpart of :mod:`repro.compile.api`:

    extract_params -> calibrate -> quantize -> lower -> specialize

``calibrate`` runs only for calibrated (``auto*``) targets and stays on the
host in numpy.  ``lower`` places the quantized program on the artifact's
device: CUDA unless the caller passes ``device="cpu"``, which runs the
kernels' plain PyTorch versions on the host (the tests do).  With no CUDA
device and no explicit ``"cpu"``, compiling raises: the port never carries
on on the host by itself.  The ``emit`` backend lowers as ``ref`` on that
device and serves through the generated C on the host (:func:`_specialize`).
:func:`specialize_mesh` (an optional fifth stage) serves a classifier
artifact data-parallel over the replicas of a device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpStats

from .artifact import CompiledArtifact
from .fingerprint import fingerprint_params
from .registry import Lowered, get_lowering, model_kind
from .target import Target

__all__ = ["compile", "compile_from_params", "resolve_device",
           "specialize_mesh", "resolve_mesh_strategy"]


def resolve_device(device: Any = None) -> torch.device:
    """The device an artifact runs on: CUDA by default, the host only when
    asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch artifacts run on the GPU by "
                "default; pass device='cpu' to run the kernels' plain "
                "PyTorch versions on the host")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but no CUDA "
                               f"device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    return device


def resolve_mesh_strategy(mesh: Any, strategy: str = "auto") -> str:
    """Resolve ``'auto'`` to the concrete mesh execution strategy.

    ``fused`` on host-emulated meshes (every device a host placeholder, so
    per-replica dispatch is pure overhead) and ``spmd`` (each replica's
    shard on its own card) on any mesh with a CUDA device.  The single
    place this policy lives; the artifact cache and specialize_mesh both
    key off it.
    """
    if strategy == "auto":
        from repro_torch.sharding import rules as shrules

        return "fused" if shrules.is_host_emulated(mesh) else "spmd"
    return strategy


def _subtract_phantom_rows(stats: FxpStats, k: int, pad_row_cache: list,
                           probe: Callable) -> FxpStats:
    """Remove ``k`` zero-pad rows' contribution from ``stats``.

    Every counter is elementwise, so an all-zeros batch of N rows yields N
    copies of one pad row's events; ``probe()`` runs such a batch once and
    returns ``(n_rows, FxpStats)``, memoized in ``pad_row_cache``.  Shared
    by the fixed-batch wrapper and the mesh wrapper.  The counters stay on
    their device (only the probe waits for it).
    """
    if not pad_row_cache:
        n, zstats = probe()
        pad_row_cache.append(tuple(
            int(v) // n for v in (zstats.overflow, zstats.underflow,
                                  zstats.total)))
    per = pad_row_cache[0]
    return FxpStats(*(torch.as_tensor(v).to(torch.int64) - k * p
                      for v, p in zip((stats.overflow, stats.underflow,
                                       stats.total), per)))


def _emit_predict(program: Lowered, target: Target, kind: str) -> Callable:
    """The ``emit`` backend's predict: the lowering's ``emit_spec`` templated
    into a freestanding C translation unit, built with the host's C compiler
    on the first predict (emission itself needs no toolchain; without one
    the first predict raises ``EmitToolchainError``).  Inputs are quantized
    on the host with the tensor ops' rounding and the compiled binary gives
    the labels; stats cover the input quantization only (the C program has
    no stats plumbing)."""
    from repro_torch import emit as emit_mod

    spec = (program.extras or {}).get("emit_spec")
    if spec is None:
        if not target.is_quantized:
            raise TypeError(
                "the 'emit' backend serves quantized targets only — "
                "float models have no fixed-point program to emit "
                "(use number_format='fxp*'/'auto*')")
        raise TypeError(
            f"the '{kind or 'requested'}' lowering does not support the "
            f"'emit' backend (no emit_spec); C emission covers the "
            f"classifier lowerings (tree/logistic/mlp/svm-*)")
    runner_cell: list = []

    def predict(x):
        if not runner_cell:
            src = emit_mod.emit_c(spec, kind=kind,
                                  target_name=target.number_format)
            runner_cell.append(emit_mod.CRunner(
                src, emit_mod.input_format(spec)))
        labels, stats = runner_cell[0].predict(x)
        return torch.from_numpy(labels), stats

    return predict


def _specialize(program: Lowered, target: Target, kind: str = "") -> Callable:
    """Stage 4: the backend and the batch policy.  ``emit`` serves through
    the generated C (:func:`_emit_predict`); ``fixed`` pads every call up to
    ``batch_size`` (the embedded static-allocation posture), rejects larger
    batches and slices the padded rows off the output."""
    predict = program.predict
    if target.backend == "emit":
        predict = _emit_predict(program, target, kind)
    if target.batch_policy != "fixed":
        return predict
    inner = predict
    batch_size = target.batch_size
    pad_row_stats: list = []

    def predict(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        n = x.shape[0]
        if n > batch_size:
            raise ValueError(
                f"batch {n} exceeds the artifact's fixed batch_size "
                f"{batch_size}; recompile with a larger Target.batch_size")
        if n == batch_size:
            return inner(x)
        pad = x.new_zeros((batch_size - n,) + tuple(x.shape[1:]))
        out, stats = inner(torch.cat([x, pad]))
        if not target.is_quantized:
            return out[:n], stats  # float stats are structurally zero
        stats = _subtract_phantom_rows(
            stats, batch_size - n, pad_row_stats,
            lambda: (batch_size, inner(x.new_zeros(
                (batch_size,) + tuple(x.shape[1:])))[1]))
        return out[:n], stats

    return predict


def compile_from_params(kind: str, params: Any, target: Target,
                        calibration: Any = None, plan: Any = None,
                        device: Any = None) -> CompiledArtifact:
    """Run the calibrate/quantize/lower/specialize stages on already-extracted
    params (numpy).  Calibrated targets need a ``calibration`` batch or an
    already-frozen ``plan``."""
    from repro_torch.quant import make_plan

    dev = resolve_device(device)
    lowering = get_lowering(kind)
    if target.is_calibrated:
        if plan is None:
            plan = make_plan(lowering, params, target, calibration)
    else:
        plan = None  # fixed/float targets ignore stray plans
    qparams = lowering.quantize(params, target, plan)
    program = lowering.lower(qparams, target, plan, dev)
    return CompiledArtifact(kind=kind, target=target, params=params,
                            _predict=_specialize(program, target, kind),
                            device=dev,
                            flash_bytes=program.flash_bytes,
                            sram_bytes=program.sram_bytes,
                            extras=program.extras,
                            fingerprint=fingerprint_params(kind, params),
                            quant_plan=plan)


def _staged_rows(x: Any, total: int, pin: bool) -> torch.Tensor:
    """A predict input as a tensor of ``total`` rows, zero rows appended.
    With ``pin``, rows on the host are staged in pinned memory (one host
    copy, the padding included), so that every replica's copy to its card
    is issued without waiting (as_input copies pinned rows without
    blocking)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    n = x.shape[0]
    pin = pin and x.device.type == "cpu"
    if total == n and (x.is_pinned() or not pin):
        return x
    out = torch.empty((total,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device, pin_memory=pin)
    out[:n].copy_(x)
    out[n:].zero_()
    return out


def _stats_on(stats: FxpStats, device: torch.device) -> FxpStats:
    return FxpStats(*(torch.as_tensor(v).to(device, non_blocking=True)
                      for v in (stats.overflow, stats.underflow,
                                stats.total)))


def _replica_artifacts(artifact: CompiledArtifact, devices) -> list:
    """One single-device artifact per replica device: the artifact itself
    on its own device, else the same params, Target and frozen plan
    compiled on that device (once per distinct device)."""
    by_device = {artifact.device: artifact}
    out = []
    for dev in devices:
        if dev not in by_device:
            if artifact.params is None:
                raise ValueError(
                    f"spmd mesh specialization compiles the model on {dev}, "
                    f"but the artifact's parameters were dropped "
                    f"(discard_params); recompile it, or use a mesh over "
                    f"its own device {artifact.device}")
            by_device[dev] = compile_from_params(
                artifact.kind, artifact.params, artifact.target,
                plan=artifact.quant_plan, device=dev)
        out.append(by_device[dev])
    return out


def specialize_mesh(artifact: CompiledArtifact, mesh: Any,
                    strategy: str = "auto") -> CompiledArtifact:
    """Stage 5 (optional): replica-aware data-parallel predict over a mesh.

    Returns a new artifact whose predict shards the batch axis across the
    mesh's data-parallel replicas (see :mod:`repro_torch.sharding.rules`),
    with *replica-aware padding*: every replica sees the same power-of-two
    shard, the serving ladder's shapes, so the sharded predictions are bit
    for bit the single-device ones (row independence).  The padding's rows
    are kept out of the stats.

    Execution strategy:

    * ``spmd``  — one lowered program per replica device (the artifact
      itself on its own device, the same params compiled on each other
      one, once, here).  A call pads the batch, issues every replica's
      shard on its own device in turn without waiting for any (each
      replica's ``_predict`` leaves its labels and counters on its
      device), and gathers labels and counters onto the first replica's
      device at the end.  The real-mesh path; ``auto`` on any mesh with a
      CUDA device.  A host placeholder's replica runs on the host.
    * ``fused`` — the replica shards execute as one batch on the
      artifact's own specialized predict, on the artifact's device (a
      ``cuda`` artifact's shards run on its card).  ``auto`` on
      host-emulated meshes; bit for bit ``spmd`` by row independence.

    The ``fused`` path also tracks per-replica health
    (:class:`repro_torch.sharding.ReplicaHealthTracker`, surfaced as
    ``artifact.replica_health``): a replica whose shard keeps faulting at
    the ``mesh.replica`` fault site is evicted and its shards fail over to
    the survivors (still bit for bit), then periodically probed for
    re-admission.  While every replica is healthy and no ``mesh.replica``
    fault rule is installed, dispatch takes the untracked path: one call of
    the artifact's predict over the whole padded batch.
    """
    from repro_torch.sharding import ReplicaHealthTracker
    from repro_torch.sharding import rules as shrules

    if artifact.kind == "lm":
        raise TypeError(
            "specialize_mesh supports classifier artifacts only; LM decode "
            "shards via the model-parallel LM stack, not batch replicas")
    if artifact.target.backend == "emit":
        raise TypeError(
            "specialize_mesh does not apply to the 'emit' backend: the C "
            "binary serves on the host, not a device mesh — specialize a "
            "ref/cuda artifact instead")
    if artifact.mesh is not None:
        raise ValueError(
            f"artifact is already specialized for mesh {artifact.mesh_key}; "
            f"nesting mesh wrappers would double-pad every batch — "
            f"specialize the base (single-device) artifact instead")
    if strategy not in ("auto", "spmd", "fused"):
        raise ValueError("strategy must be 'auto', 'spmd' or 'fused'")
    strategy = resolve_mesh_strategy(mesh, strategy)
    replicas = shrules.dp_size(mesh)
    target = artifact.target
    fixed_shard = target.batch_size if target.batch_policy == "fixed" else None

    if strategy == "spmd":
        devices = [shrules.torch_device(d)
                   for d in shrules.replica_devices(mesh)]
        programs = [a._predict for a in _replica_artifacts(artifact, devices)]
        home = devices[0]
        tracker = None
    else:
        devices = [artifact.device]
        inner = artifact._predict  # already specialized (batch policy too)
        home = artifact.device
        tracker = ReplicaHealthTracker(replicas)
    pin = any(d.type == "cuda" for d in devices)

    def _mesh_faults():
        """The installed fault injector, iff it has ``mesh.replica`` rules
        (lazy import: repro_torch.serve imports repro_torch.compile)."""
        from repro_torch.serve import faults

        return faults.current() if faults.active_for("mesh.replica") else None

    def _replica_dispatch(shard_x, slot, injector):
        """Run one shard on the healthiest available replica (nominal
        replica first), reporting outcomes to the tracker.  Raises the last
        failure only when every candidate replica refused the shard."""
        last = None
        for replica in tracker.candidates(slot):
            try:
                if injector is not None:
                    injector.fire("mesh.replica", name=str(replica),
                                  batch=shard_x)
                o, s = inner(shard_x)
            except Exception as e:
                tracker.record_failure(replica)
                last = e
                continue
            tracker.record_success(replica)
            return o, s
        raise last

    pad_row_stats: list = []

    def predict(x):
        n = len(x)
        shard, total = shrules.replica_bucket(n, replicas)
        if fixed_shard is not None:
            if n > fixed_shard * replicas:
                raise ValueError(
                    f"batch {n} exceeds the mesh capacity "
                    f"{fixed_shard * replicas} ({replicas} replicas x fixed "
                    f"batch_size {fixed_shard}); recompile or grow the mesh")
            shard, total = fixed_shard, fixed_shard * replicas
        x = _staged_rows(x, total, pin)
        if strategy == "spmd":
            # issue every shard, then gather once: no replica waits for one
            # issued before it
            parts = [prog(x[r * shard:(r + 1) * shard])
                     for r, prog in enumerate(programs)]
            out = torch.cat([o.to(home, non_blocking=True) for o, _ in parts])
            stats = None
            for _, s in parts:
                s = _stats_on(s, home)
                stats = s if stats is None else stats.merge(s)
        else:
            injector = _mesh_faults()
            tracked = injector is not None or not tracker.all_healthy()
            if fixed_shard is not None or tracked:
                outs, stats = [], None
                for r in range(replicas):
                    shard_x = x[r * shard:(r + 1) * shard]
                    if tracked:
                        o, s = _replica_dispatch(shard_x, r, injector)
                    else:
                        o, s = inner(shard_x)
                    outs.append(o)
                    stats = s if stats is None else stats.merge(s)
                out = torch.cat(outs)
            else:
                out, stats = inner(x)
        if total == n or not target.is_quantized:
            return out[:n], stats
        stats = _subtract_phantom_rows(
            stats, total - n, pad_row_stats,
            lambda: (total, predict(torch.zeros(
                (total,) + tuple(x.shape[1:]), dtype=x.dtype))[1]))
        return out[:n], stats

    return dataclasses.replace(artifact, _predict=predict, device=home, mesh=mesh,
                       replicas=replicas, mesh_strategy=strategy,
                       replica_health=tracker)


def compile(model: Any, target: Optional[Target] = None,
            calibration: Any = None, device: Any = None,
            **kwargs) -> CompiledArtifact:
    """Compile a trained model into an inference artifact.

    ``target`` may be omitted and given as keyword fields instead:
    ``compile(model, number_format="fxp16", backend="cuda")``.
    ``calibration`` is a sample input batch, required by ``auto*`` formats.
    ``device`` defaults to the current CUDA device and raises without one;
    pass ``device="cpu"`` to run on the host.
    """
    if target is not None and kwargs:
        raise TypeError("pass either a Target or keyword fields, not both")
    tgt = target if target is not None else Target(**kwargs)
    kind = model_kind(model)
    params = get_lowering(kind).extract_params(model)
    return compile_from_params(kind, params, tgt, calibration=calibration,
                               device=device)
