"""Fleet stacking: many compatible artifacts, one stacked kernel launch.

The counterpart of :mod:`repro.compile.fleet`.  Artifacts whose programs
are shape-compatible are stacked along a leading model axis and executed by
the fleet kernels (:func:`repro_torch.kernels.ops.fxp_mlp_fleet` /
``fxp_svm_fleet``), each model's layer schedule read from a per-model table,
so slot ``e`` of the output is bit-identical to member ``e``'s own
``predict``.

Compatibility is structural: members may carry different weights, Qm.n
splits and activation schedules, but must agree on model family, layer
widths and integer container width.  :func:`fleet_signature` reduces an
artifact to exactly that hashable essence (or ``None`` when it cannot ride a
stack); equal signatures == stackable.  A ``logistic`` (or ``svm-linear``)
artifact is a 1-layer MLP to the stacked program, so such endpoints of equal
shape coalesce into one fleet.

Members must also live on one device; :func:`stack_fleet` raises otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.kernels import fxp_model, ops

from .lowerings.common import argmax_first, as_input

__all__ = ["FleetStack", "fleet_signature", "stack_fleet"]

# Hashable structural essence of an artifact for stacking purposes.
FleetSignature = Tuple


def _mlp_spec(artifact) -> Optional[dict]:
    """The artifact's emit spec viewed as an MLP stack member (linear
    families are normalized to a 1-layer schedule), or None."""
    spec = artifact.extras.get("emit_spec")
    if not spec:
        return None
    if spec["family"] == "mlp":
        return spec
    if spec["family"] == "linear":
        return {"family": "mlp", "in_fmt": spec["in_fmt"],
                "out_fmts": (spec["out_fmt"],), "ws": [spec["w"]],
                "bs": [spec["b"]], "shifts": (spec["shift"],),
                "acts": ("none",)}
    return None


def fleet_signature(artifact) -> Optional[FleetSignature]:
    """Hashable stacking-compatibility key, or None if unstackable.

    Eligibility requires the ``cuda`` backend (the fleet kernels are its
    kernels), a quantized emit spec (the stacked tensors come from it), a
    single-device artifact, and — for multi-stage families (MLP, SVM) — the
    megakernel routing, since a member that fell back to per-layer launches
    exceeds one block's shared memory alone.
    """
    if artifact.target.backend != "cuda":
        return None
    if artifact.mesh is not None or artifact.replicas != 1:
        return None
    spec = artifact.extras.get("emit_spec")
    if not spec:
        return None
    family = spec["family"]
    if family in ("mlp", "linear"):
        if family == "mlp" and artifact.kernel_strategy != "megakernel":
            return None
        m = _mlp_spec(artifact)
        fmts = (m["in_fmt"],) + tuple(m["out_fmts"])
        bits = {f.total_bits for f in fmts}
        if len(bits) != 1:  # mixed containers: the stack has no one dtype
            return None
        widths = (int(m["ws"][0].shape[0]),) + tuple(
            int(w.shape[1]) for w in m["ws"])
        return ("mlp", bits.pop(), widths)
    if family == "svm":
        if artifact.kernel_strategy != "megakernel":
            return None
        if spec["fmt"].total_bits != spec["out_fmt"].total_bits:
            return None
        sv, dual = spec["sv"], spec["dual"]
        return ("svm", spec["kernel"], spec["fmt"].total_bits,
                (int(sv.shape[0]), int(sv.shape[1]), int(dual.shape[1])))
    return None  # trees and float targets: no stacked program exists


@dataclasses.dataclass
class FleetStack:
    """E compatible artifacts fused into one stacked predict program.

    ``predict_device(x)`` launches the stacked kernel on ``x`` — shared
    ``(M, F)`` rows or per-slot ``(E, M, F)`` rows (the coalescer's staging
    buffer; numpy, or a tensor, pinned host memory included) — and returns
    the ``(E, M)`` int32 labels as a tensor on the stack's device without
    waiting for them: nothing in it synchronizes with the card, so the
    coalescer can assemble the next round while this one computes.
    ``predict(x)`` is the blocking convenience wrapper.  Slot ``e`` of the
    output is bit-identical to ``members[e]``'s own ``predict(x)``.
    """

    signature: FleetSignature
    members: Tuple  # the member artifacts' cache keys, in slot order
    n_models: int
    n_features: int
    device: torch.device
    _predict_device: Callable[[Any], torch.Tensor] = dataclasses.field(
        repr=False)

    @property
    def cache_key(self) -> Tuple:
        return ("fleet",) + tuple(self.members)

    def predict_device(self, x) -> torch.Tensor:
        """One stacked launch; returns the (E, M) labels on the device."""
        return self._predict_device(x)

    def predict(self, x) -> np.ndarray:
        return self.predict_device(x).cpu().numpy()


def _quantizer(in_fmts: Sequence[fxp.FxpFormat], n_models: int):
    """Float rows on the device -> (E, M, F) quantized stack.

    Accepts ``(M, F)`` shared rows (every model sees the same batch) or
    ``(E, M, F)`` per-slot rows.  Members sharing one input format quantize
    in one shot; heterogeneous formats quantize per model.  Either way the
    values are exactly what each member's own input stage produces.  No
    overflow statistics: reading them would wait for the card.
    """
    shared = in_fmts[0] if len(set(in_fmts)) == 1 else None
    fmts = tuple(in_fmts)

    def qstack(xf: torch.Tensor) -> torch.Tensor:
        if xf.dim() == 2:  # shared rows for every model
            if shared is not None:
                return fxp.quantize(xf, shared).expand(
                    (n_models,) + tuple(xf.shape))
            return torch.stack([fxp.quantize(xf, f) for f in fmts])
        if shared is not None:  # (E, M, F) per-slot rows
            return fxp.quantize(xf, shared)
        return torch.stack([fxp.quantize(xf[e], f)
                            for e, f in enumerate(fmts)])

    return qstack


def _stack(arrays, device: torch.device) -> torch.Tensor:
    return torch.stack([torch.from_numpy(a) for a in arrays]).to(device)


def _stack_mlp(artifacts, device: torch.device) -> Callable:
    specs = [_mlp_spec(a) for a in artifacts]
    n_layers = len(specs[0]["ws"])
    weights = tuple(_stack([s["ws"][i] for s in specs], device)
                    for i in range(n_layers))
    biases = tuple(_stack([s["bs"][i] for s in specs], device)
                   for i in range(n_layers))
    schedules = tuple(
        tuple(zip(s["shifts"], s["out_fmts"], s["acts"])) for s in specs)
    qstack = _quantizer([s["in_fmt"] for s in specs], len(specs))
    if device.type == "cuda":
        fxp_model.mlp_fleet_table(schedules, device)  # built once, here

    def predict_device(x):
        rows = as_input(x, device, (2, 3))  # shared or per-slot rows
        out = ops.fxp_mlp_fleet(qstack(rows), weights, biases, schedules)
        return argmax_first(out)

    return predict_device


def _stack_svm(artifacts, device: torch.device) -> Callable:
    specs = [a.extras["emit_spec"] for a in artifacts]
    kind = specs[0]["kernel"]
    sv = _stack([s["sv"] for s in specs], device)
    dual = _stack([s["dual"] for s in specs], device)
    icept = _stack([s["b"] for s in specs], device)
    params = tuple((s["fmt"], s["out_fmt"], s["qgamma"], s["qcoef0"],
                    s["degree"], s["dec_shift"]) for s in specs)
    qstack = _quantizer([s["fmt"] for s in specs], len(specs))
    if device.type == "cuda":
        fxp_model.svm_fleet_table(params, device)  # built once, here

    def predict_device(x):
        rows = as_input(x, device, (2, 3))  # shared or per-slot rows
        out = ops.fxp_svm_fleet(qstack(rows), sv, dual, icept, kind, params)
        return argmax_first(out)

    return predict_device


def stack_fleet(artifacts: Sequence[Any]) -> FleetStack:
    """Fuse ``artifacts`` (all sharing one :func:`fleet_signature` and one
    device) into a :class:`FleetStack`.  Raises ``ValueError`` for
    empty/incompatible input or a stack the fleet kernels cannot take."""
    arts: List[Any] = list(artifacts)
    if len(arts) < 2:
        raise ValueError("a fleet needs at least 2 member artifacts")
    sigs = [fleet_signature(a) for a in arts]
    if sigs[0] is None or any(s != sigs[0] for s in sigs):
        raise ValueError(f"artifacts are not fleet-compatible: {sigs}")
    devices = {str(a.device) for a in arts}
    if len(devices) != 1:
        raise ValueError(f"fleet members live on several devices: "
                         f"{sorted(devices)}")
    device = arts[0].device
    sig = sigs[0]
    if sig[0] == "mlp":
        _, bits, widths = sig
        if not fxp_model.mlp_fleet_fits_smem(len(arts), widths, bits):
            raise ValueError(
                f"a fleet of {len(arts)} models of widths {widths} at "
                f"w{bits} does not fit the fleet kernel's shared memory")
        predict_device = _stack_mlp(arts, device)
        n_features = widths[0]
    else:
        _, kernel, bits, (s_, f_, _c) = sig
        if not fxp_model.svm_fleet_fits_smem(len(arts), s_):
            raise ValueError(
                f"a fleet of {len(arts)} {kernel}-SVMs (S={s_}, F={f_}) does "
                f"not fit the fleet kernel's shared memory")
        predict_device = _stack_svm(arts, device)
        n_features = f_
    return FleetStack(signature=sig,
                      members=tuple(a.cache_key for a in arts),
                      n_models=len(arts), n_features=n_features,
                      device=device, _predict_device=predict_device)
