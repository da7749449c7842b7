"""The compiled artifact — the paper's "output file" analogue.

The counterpart of :mod:`repro.compile.artifact`.  A
:class:`CompiledArtifact` holds the extracted parameters, the specialized
predict program and the memory model of one compile, and what the serving
plane reads off it (``max_supported_batch``, ``pretune``, and the mesh
specialization: ``mesh``, ``replicas``, ``mesh_strategy``,
``replica_health``, made by :meth:`CompiledArtifact.specialize_mesh`).  It
emits its C
(:meth:`CompiledArtifact.emit_c`) and reports its footprint, measured from
the compiled C where asked (:meth:`CompiledArtifact.report`).

``save(path)`` writes the reference's single-file archive, format v3:
compressed msgpack holding one blob per member (kind, Target, parameter
tree, frozen QuantPlan, metadata), each with its sha256, checked before
anything is deserialized.  :func:`load` re-runs the lowering pipeline on
the stored parameters on the given device (CUDA by default, the host when
asked), so an archive round-trips to an artifact that predicts
identically; v1 and v2 archives (members inline, no checksums) still load.

The archive carries the reference's backend names, so either package loads
the other's files: the port writes its ``cuda`` backend as ``pallas``, and
reads ``pallas`` and ``xla`` as ``cuda``; ``ref`` and ``emit`` keep their
names.  Any other backend in an archive raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fixedpoint import FxpStats
from repro_torch.sharding.rules import device_id, device_platform
from repro_torch.train.checkpoint import (LEAF_KEY, atomic_write_bytes,
                                          compress_bytes, decode_leaf,
                                          decompress_bytes, encode_leaf,
                                          packb, unpackb)

from .target import Target

__all__ = ["CompiledArtifact", "ArtifactIntegrityError", "load",
           "mesh_descriptor"]


class ArtifactIntegrityError(ValueError):
    """The archive's bytes do not match what was saved (member checksum
    mismatch, undecodable container, truncation).  Raised *before* any
    corrupted member is deserialized: a flipped bit in stored weights must
    fail loudly at load, never become a silently-wrong classifier."""


def mesh_descriptor(mesh: Optional[Any],
                    strategy: Optional[str]) -> Optional[Tuple]:
    """Hashable (axes, platform, device ids, strategy) descriptor of a mesh
    specialization: the cache-key component of mesh-specialized artifacts.

    Device identity is part of the key: two same-shaped meshes over
    *disjoint* device sets (splitting a host's cards between endpoints) must
    not alias to one artifact, or the second endpoint would silently serve
    on the first mesh's cards.  ``None`` for single-device artifacts."""
    if mesh is None:
        return None
    devs = list(mesh.devices.flat)
    return (tuple((a, int(mesh.shape[a])) for a in mesh.axis_names),
            device_platform(devs[0]) if devs else "cpu",
            tuple(device_id(d) for d in devs), strategy)


_ARCHIVE_FORMAT = "repro-compiled-artifact"
# v2: optional ``quant_plan`` payload (calibrated per-tensor formats).
# v3: members stored as individually-packed blobs with per-member sha256
# verified on load.  v1/v2 archives still load (without integrity checks —
# they carry none).
_ARCHIVE_VERSION = 3
# The v3 member blobs, in the order they are hashed into the archive.
_ARCHIVE_MEMBERS = ("kind", "target", "params", "quant_plan", "metadata")
# Backend names: the port's -> the archive's (the reference's), and back.
_BACKEND_OUT = {"ref": "ref", "cuda": "pallas", "emit": "emit"}
_BACKEND_IN = {"ref": "ref", "pallas": "cuda", "xla": "cuda", "emit": "emit"}


# --------------------------------------------------------------------------
# parameter-tree (de)serialization: nested dicts/lists of arrays + scalars,
# leaves in the shared checkpoint codec.
# --------------------------------------------------------------------------
def _encode(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {LEAF_KEY: "list", "items": [_encode(v) for v in x]}
    return encode_leaf(x)


def _decode(d: Any) -> Any:
    if not isinstance(d, dict):
        return d
    kind = d.get(LEAF_KEY)
    if kind is None:
        return {k: _decode(v) for k, v in d.items()}
    if kind == "list":
        return [_decode(v) for v in d["items"]]
    return decode_leaf(d)


@dataclasses.dataclass
class CompiledArtifact:
    """Frozen inference artifact: parameters + specialized predict program."""

    kind: str  # a registered lowering kind ('tree', 'mlp', 'svm-rbf', ...)
    target: Target
    params: Optional[Dict[str, Any]]  # extracted (float) parameters
    _predict: Callable[..., Tuple[torch.Tensor, FxpStats]] = dataclasses.field(repr=False)
    device: torch.device = torch.device("cpu")
    flash_bytes: int = 0  # read-only parameter memory
    sram_bytes: int = 0  # activation scratch
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict, repr=False)
    # sha256 of the extracted parameter tree (the reference's fingerprint)
    fingerprint: str = ""
    # Calibrated per-tensor formats (repro_torch.quant.QuantPlan); None for
    # fixed and float targets.
    quant_plan: Optional[Any] = dataclasses.field(default=None, repr=False)
    # Mesh specialization (None / 1 / None for single-device artifacts).
    mesh: Optional[Any] = dataclasses.field(default=None, repr=False)
    replicas: int = 1
    mesh_strategy: Optional[str] = None
    # Replica health tracker (repro_torch.sharding.ReplicaHealthTracker) of
    # a mesh artifact on the fused strategy; None elsewhere.  Surfaced into
    # /v1/stats by the serving router.
    replica_health: Optional[Any] = dataclasses.field(default=None, repr=False)

    @property
    def mesh_key(self) -> Optional[Tuple]:
        """Hashable mesh descriptor for cache keying (None = single-device)."""
        return mesh_descriptor(self.mesh, self.mesh_strategy)

    @property
    def plan_key(self) -> Optional[Tuple]:
        """Hashable QuantPlan descriptor (None = no calibrated plan)."""
        return None if self.quant_plan is None else self.quant_plan.descriptor()

    @property
    def kernel_strategy(self) -> Optional[str]:
        """How the ``cuda`` backend runs the forward pass: ``"megakernel"``
        (one launch), ``"per-layer"`` (one ``fxp_layer`` launch per layer),
        or None where the distinction does not exist."""
        return self.extras.get("kernel_strategy")

    @property
    def cache_key(self) -> Tuple[str, Target, Optional[Tuple],
                                 Optional[Tuple], Optional[str], str]:
        # kernel_strategy keys too: the routing depends on the shared-memory
        # budget override, which is ambient state beyond the Target.
        return (self.fingerprint, self.target, self.mesh_key, self.plan_key,
                self.kernel_strategy, str(self.device))

    @property
    def max_supported_batch(self) -> Optional[int]:
        """Largest batch one predict call accepts (None = unbounded): the
        micro-batching scheduler clamps its bucket ladder to it, so a
        ``batch_policy='fixed'`` artifact is never fed a batch it would
        reject.  A mesh-specialized artifact serves one fixed batch *per
        replica*, so its ceiling scales with the replica count."""
        if self.target.batch_policy == "fixed":
            return self.target.batch_size * max(1, self.replicas)
        return None

    def specialize_mesh(self, mesh: Any,
                        strategy: str = "auto") -> "CompiledArtifact":
        """Replica-aware data-parallel artifact over ``mesh`` (new artifact;
        see :func:`repro_torch.compile.api.specialize_mesh`)."""
        from .api import specialize_mesh as _specialize_mesh

        return _specialize_mesh(self, mesh, strategy)

    def pretune(self, example, batches: Optional[Tuple[int, ...]] = None
                ) -> "CompiledArtifact":
        """Warm the block-size tuner and the kernels for the serving bucket
        ladder, ahead of traffic.

        Runs one ``predict`` on zero rows shaped like ``example`` at each
        batch size in ``batches`` (default: the power-of-two ladder up to
        ``max_supported_batch``, or 64).  On the card each call makes the
        tuner's entry (:mod:`repro_torch.kernels.tune`: shape-bucketed,
        device-keyed, persisted to its JSON file) for every tuned kernel the
        artifact dispatches in that bucket, timing the kernel's blockings
        there, so a live request in a pretuned bucket makes no sweep launch;
        the first call also builds and loads the artifact's CUDA kernels.
        A mesh-specialized artifact walks the *mesh-level* ladder: replicas
        x the per-replica power-of-two shards, up to the per-replica cap (64
        x replicas by default), so every replica's shard shape is tuned.
        Returns self.
        """
        row = np.asarray(example)
        if row.ndim > 1:
            row = row[0]
        if batches is None:
            r = max(1, self.replicas)
            top = self.max_supported_batch or 64 * r
            ladder, b = [], r
            while b < top:
                ladder.append(b)
                b *= 2
            batches = tuple(ladder) + (top,)
        for b in batches:
            self.predict(np.zeros((int(b),) + row.shape, row.dtype))
        return self

    def predict(self, x) -> np.ndarray:
        """int32 class labels on the host."""
        out, _ = self._predict(x)
        return out.cpu().numpy().astype(np.int32, copy=False)

    def predict_with_stats(self, x) -> Tuple[np.ndarray, Dict[str, float]]:
        out, stats = self._predict(x)
        over, under, total = (int(stats.overflow), int(stats.underflow),
                              int(stats.total))
        denom = max(total, 1)
        return out.cpu().numpy().astype(np.int32, copy=False), {
            "overflow": over,
            "underflow": under,
            "total": total,
            "overflow_rate": float(over / denom),
            "underflow_rate": float(under / denom),
        }

    # -- C emission ----------------------------------------------------------
    def emit_c(self) -> str:
        """The freestanding C99 translation unit for this artifact.

        Available for any quantized classifier artifact regardless of its
        backend (the emit spec rides on the lowered program); raises
        :class:`repro_torch.emit.EmitError` for float targets and the ``lm``
        lowering.  Emission is pure templating: no C compiler is needed
        (only :meth:`report`'s measured sizes and the ``emit`` backend's
        replay build the C).
        """
        from repro_torch import emit as emit_mod

        return emit_mod.emit_artifact_c(self)

    # -- memory model --------------------------------------------------------
    def memory_report(self) -> Dict[str, int]:
        return {"flash": self.flash_bytes, "sram": self.sram_bytes,
                "total": self.flash_bytes + self.sram_bytes}

    def memory_bytes(self) -> Dict[str, int]:
        """Legacy alias for :meth:`memory_report` (EmbeddedModel API)."""
        return self.memory_report()

    def report(self, x: Optional[np.ndarray] = None,
               y: Optional[np.ndarray] = None,
               measure_c: Any = "auto") -> Dict[str, Any]:
        """Paper-style resource report for this artifact.

        Always includes the memory model and the per-tensor number formats
        (the QuantPlan table for calibrated targets, the single global
        format otherwise).  ``model_bytes`` is computed from the *actual
        quantized tensors* (per-tensor container widths), not a float-size
        estimate.  Given an evaluation batch ``x``, adds the observed
        saturation/underflow counts (paper §V-A); given labels ``y`` as
        well, adds accuracy and the delta vs a float recompile of the same
        parameters on the ``ref`` backend and the artifact's device (paper
        Tables V-VII).

        ``measure_c`` controls the *measured* footprint (paper Tables
        IV-VI): compile the generated C freestanding with the host's C
        compiler and report its real ``.text``/``.rodata``/``.data`` section
        sizes as ``c_sections`` (with ``model_bytes_measured = flash``).
        ``"auto"`` measures for ``emit``-backend artifacts when a toolchain
        exists and skips otherwise, as the reference does (the measurement
        is of the host's C build; it stands in for no device); ``True``
        forces measurement (raising without a C compiler or for
        un-emittable artifacts); ``False`` disables it.
        """
        rep: Dict[str, Any] = {
            "kind": self.kind,
            "number_format": self.target.number_format,
            "backend": self.target.backend,
            "model_bytes": self.flash_bytes,
            "sram_bytes": self.sram_bytes,
        }
        want_measure = (measure_c is True
                        or (measure_c == "auto"
                            and self.target.backend == "emit"))
        if want_measure:
            try:
                from repro_torch import emit as emit_mod

                rep["c_sections"] = emit_mod.measure_artifact(self)
                rep["model_bytes_measured"] = rep["c_sections"]["flash"]
            except Exception:
                if measure_c is True:
                    raise
                # auto mode: no toolchain / un-emittable — estimate only.
        if self.quant_plan is not None:
            rep["formats"] = {
                path: repr(self.quant_plan.fmt(path))
                for path in self.quant_plan.paths()}
            rep["calibration_ranges"] = dict(self.quant_plan.ranges)
        elif self.target.is_quantized:
            rep["formats"] = {"*": repr(self.target.fmt)}
        else:
            rep["formats"] = {}
        if x is not None:
            out, stats = self.predict_with_stats(x)
            rep["saturation"] = stats
            if y is not None:
                y = np.asarray(y)
                rep["accuracy"] = float((out == y).mean())
                if self.params is not None and self.target.is_quantized:
                    from .api import compile_from_params

                    flt = compile_from_params(
                        self.kind, self.params,
                        self.target.replace(number_format="flt",
                                            backend="ref"),
                        device=self.device)
                    rep["accuracy_float"] = float(
                        (flt.predict(x) == y).mean())
                    rep["accuracy_delta"] = (rep["accuracy"]
                                             - rep["accuracy_float"])
        return rep

    def discard_params(self) -> "CompiledArtifact":
        """Drop the retained (unquantized) parameter tree to free memory.

        The specialized predict program keeps working (it closes over the
        lowered representation), but :meth:`save` becomes unavailable.
        """
        self.params = None
        return self

    # -- persistence ---------------------------------------------------------
    def save(self, path: str, metadata: Optional[Dict] = None,
             include_c: bool = False) -> None:
        """Write the self-contained archive (paper Fig. 1 'output file').

        ``include_c=True`` additionally embeds the generated freestanding C
        source in the checksummed ``metadata`` member (key ``"emit_c"``).
        Quantized classifier artifacts only.  The write is atomic: a crash
        leaves the previous file at ``path`` whole.
        """
        if self.params is None:
            raise ValueError(
                "cannot save: parameters were dropped via discard_params(); "
                "recompile the model to obtain a saveable artifact")
        meta = dict(metadata or {})
        if include_c:
            meta["emit_c"] = self.emit_c()
        target = dataclasses.asdict(self.target)
        target["backend"] = _BACKEND_OUT[target["backend"]]
        members = {
            "kind": self.kind,
            "target": target,
            "params": _encode(self.params),
            # The frozen plan (not the calibration batch): load() must
            # reproduce this artifact bit for bit without re-calibrating.
            "quant_plan": (None if self.quant_plan is None
                           else self.quant_plan.to_dict()),
            "metadata": meta,
        }
        blobs = {name: packb(members[name]) for name in _ARCHIVE_MEMBERS}
        payload = {
            "format": _ARCHIVE_FORMAT,
            "version": _ARCHIVE_VERSION,
            "members": blobs,
            "integrity": {
                "algo": "sha256",
                "members": {name: hashlib.sha256(blob).hexdigest()
                            for name, blob in blobs.items()},
            },
            "saved_at": time.time(),
        }
        atomic_write_bytes(path, compress_bytes(packb(payload)))


def _filter_archive_bytes(data: bytes, path: str) -> bytes:
    """Fault-injection hook (``artifact.load`` byte-filter site): the chaos
    harness corrupts archives here to prove the integrity check catches it.
    Lazy import: repro_torch.serve imports repro_torch.compile, not vice
    versa."""
    from repro_torch.serve import faults

    return faults.filter_bytes("artifact.load", data, name=path)


def _verified_members(payload: Dict, path: str) -> Dict[str, Any]:
    """The v3 members, each blob's sha256 checked before it is decoded."""
    blobs = payload.get("members") or {}
    digests = (payload.get("integrity") or {}).get("members") or {}
    fields = {}
    for name in _ARCHIVE_MEMBERS:
        blob = blobs.get(name)
        want = digests.get(name)
        if not isinstance(blob, bytes) or want is None:
            raise ArtifactIntegrityError(
                f"{path}: archive member '{name}' is missing or "
                f"unchecksummed")
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise ArtifactIntegrityError(
                f"{path}: sha256 mismatch on member '{name}' (stored "
                f"{want[:12]}…, computed {got[:12]}…); refusing to "
                f"deserialize a corrupt archive")
        try:
            fields[name] = unpackb(blob)
        except ValueError as e:
            raise ArtifactIntegrityError(
                f"{path}: member '{name}' passed its checksum but is "
                f"undecodable ({e!r})") from e
    return fields


def _lm_tensors(tree: Any) -> Any:
    """An LM's decoded parameter leaves as tensors (bfloat16 leaves already
    are; numpy leaves are wrapped, bits unchanged)."""
    if isinstance(tree, dict):
        return {k: _lm_tensors(v) for k, v in tree.items()}
    return tree if isinstance(tree, torch.Tensor) else torch.from_numpy(tree)


def load(path: str, device: Any = None) -> CompiledArtifact:
    """Load an archive and recompile it into a live artifact on ``device``
    (the current CUDA device by default; ``"cpu"`` runs on the host).

    The stored parameters are re-run through the quantize/lower/specialize
    stages of the recorded Target, so the loaded artifact predicts
    identically to the one that was saved.  v3 archives are
    integrity-checked first; any mismatch, or an archive too mangled to
    decode, raises :class:`ArtifactIntegrityError`.  An archive of another
    format or of a newer version raises ``ValueError``.
    """
    from .api import compile_from_params

    with open(path, "rb") as f:
        data = _filter_archive_bytes(f.read(), path)
    try:
        payload = unpackb(decompress_bytes(data))
        if not isinstance(payload, dict):
            raise ValueError("archive container is not a map")
    except Exception as e:  # zlib.error, zstd errors, ValueError
        raise ArtifactIntegrityError(
            f"{path}: archive is not decodable ({e!r}); the file is "
            f"corrupt or truncated") from e
    if payload.get("format") != _ARCHIVE_FORMAT:
        raise ValueError(f"{path} is not a {_ARCHIVE_FORMAT} archive")
    version = payload.get("version", 0)
    if version > _ARCHIVE_VERSION:
        raise ValueError(f"archive version {version} is newer than "
                         f"this reader ({_ARCHIVE_VERSION})")
    # v1/v2: members inline, no integrity section
    fields = _verified_members(payload, path) if version >= 3 else payload
    target = dict(fields["target"])
    backend = target.get("backend")
    if backend not in _BACKEND_IN:
        raise ValueError(f"{path}: archive backend {backend!r} has no "
                         f"counterpart in this package")
    target["backend"] = _BACKEND_IN[backend]
    kind = fields["kind"]
    params = _decode(fields["params"])
    if kind == "lm":
        params["params"] = _lm_tensors(params["params"])
    plan = None
    if fields.get("quant_plan") is not None:
        from repro_torch.quant import QuantPlan

        plan = QuantPlan.from_dict(fields["quant_plan"])
    return compile_from_params(kind, params, Target(**target), plan=plan,
                               device=device)
