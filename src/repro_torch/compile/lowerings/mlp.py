"""Lowering for sigmoid-MLP classifiers (paper C3: sigmoid replacements).

The counterpart of :mod:`repro.compile.lowerings.mlp`.  Backend routing:

* float targets — float32 matmuls through ``torch.matmul`` with TF32 off
  (the reference leaves them to XLA, outside any kernel); on ``cuda`` a
  ``pwl2``/``pwl4``/``rational`` sigmoid is the ``pwl_activation`` kernel
  (``ops.pwl_activation``), as on the reference's ``pallas``, with the
  hidden layer's bias added in the same launch; otherwise the float
  sigmoid in PyTorch ops.
* fixed-point targets on ``cuda`` — the whole forward pass is one
  ``fxp_mlp_model`` megakernel launch when the activations fit one block's
  shared memory (:func:`repro_torch.kernels.fxp_model.mlp_fits_smem`),
  otherwise one ``fxp_layer`` launch per layer.  On a CPU device the same
  routes run the kernels' plain versions.  The route is
  ``extras["kernel_strategy"]``.
* fixed-point targets on ``ref`` — the fused layer accumulating in
  ``fmt.wide_dtype``, with overflow/underflow stats.

Quantized tensor paths are the reference's: ``input``, ``layers/{i}/w``,
``layers/{i}/b`` and ``layers/{i}/out`` (bias and out share a group).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.activations import get_sigmoid
from repro_torch.core.fixedpoint import to_numpy
from repro_torch.quant import Calibration, activation_range, amax

from ..registry import Lowered, Lowering, register_lowering
from ..target import Target
from .common import (argmax_first, as_input, elem_bytes, nbytes, q,
                     qx_with_stats, require_full_float32, resolve_formats,
                     zero_stats)

# Float sigmoids the cuda backend runs through the pwl_activation kernel.
PWL_SIGMOIDS = ("pwl2", "pwl4", "rational")


@register_lowering("mlp")
class MLPLowering(Lowering):
    def extract_params(self, model: Any) -> Dict[str, Any]:
        return {"weights": [np.asarray(w) for w in model.weights],
                "biases": [np.asarray(b) for b in model.biases]}

    def calibrate(self, params: Dict[str, Any], x: Any,
                  target: Target) -> Calibration:
        weights = [np.asarray(w, np.float32) for w in params["weights"]]
        biases = [np.asarray(b, np.float32) for b in params["biases"]]
        sig = get_sigmoid(target.sigmoid)
        h = np.asarray(x, np.float32)
        ranges = {"input": amax(h)}
        groups, matmuls, acc_ranges = [], [], {}
        prev = "input"
        for i, (w, b) in enumerate(zip(weights, biases)):
            wp, bp, op = f"layers/{i}/w", f"layers/{i}/b", f"layers/{i}/out"
            acc = h @ w
            h = acc + b
            last = i == len(weights) - 1
            ranges[wp] = amax(w)
            ranges[bp] = amax(b)
            # The out format also hosts the sigmoid's in-format constants.
            ranges[op] = activation_range(target.sigmoid, amax(h), last)
            groups.append((bp, op))
            matmuls.append((prev, wp, op))
            acc_ranges[op] = amax(acc)
            if not last:
                h = sig(torch.from_numpy(h)).numpy()
            prev = op
        return Calibration(ranges=ranges, groups=tuple(groups),
                           matmuls=tuple(matmuls), acc_ranges=acc_ranges)

    def lower(self, qparams: Dict[str, Any], target: Target,
              plan: Optional[Any], device: torch.device) -> Lowered:
        F = resolve_formats(target, plan)
        weights = qparams["weights"]
        biases = qparams["biases"]
        widths = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
        extras: Dict[str, Any] = {}

        if F is None:
            ws = [torch.from_numpy(np.asarray(w, np.float32)).to(device)
                  for w in weights]
            bs = [torch.from_numpy(np.asarray(b, np.float32)).to(device)
                  for b in biases]
            if target.backend == "cuda" and target.sigmoid in PWL_SIGMOIDS:
                from repro_torch.kernels import ops

                variant = target.sigmoid

                def hidden(h, w, b):
                    # the bias add rides in the activation's launch
                    return ops.pwl_activation(h @ w, variant, bias=b)
            else:
                sig = get_sigmoid(target.sigmoid)

                def hidden(h, w, b):
                    return sig(h @ w + b)

            def predict(x):
                require_full_float32(device)
                h = as_input(x, device)
                for w, b in zip(ws[:-1], bs[:-1]):
                    h = hidden(h, w, b)
                h = h @ ws[-1] + bs[-1]
                return (torch.argmax(h, -1).to(torch.int32),
                        zero_stats(device))

            flash = nbytes(*[np.asarray(w, np.float32) for w in weights],
                           *[np.asarray(b, np.float32) for b in biases])
            sram = max(widths) * elem_bytes(None)
            return Lowered(predict, flash, sram, extras=extras)

        from repro_torch.kernels import fxp_model, ops
        from repro_torch.kernels import ref as ref_ops

        in_fmt = F("input")
        w_fmts = [F(f"layers/{i}/w") for i in range(len(weights))]
        out_fmts = [F(f"layers/{i}/out") for i in range(len(weights))]
        qws = [q(w, f, device) for w, f in zip(weights, w_fmts)]
        # biases ride at the layer-out scale (grouped by the planner)
        qbs = [q(b, F(f"layers/{i}/b"), device) for i, b in enumerate(biases)]
        in_fracs = [in_fmt.frac_bits] + [f.frac_bits for f in out_fmts[:-1]]
        shifts = [fi + fw.frac_bits - fo.frac_bits
                  for fi, fw, fo in zip(in_fracs, w_fmts, out_fmts)]
        # Hidden layers fuse the sigmoid into the layer op; the output layer
        # emits raw logits ("none").
        acts = [target.sigmoid] * (len(qws) - 1) + ["none"]

        if target.backend == "cuda":
            schedule = tuple(zip(shifts, out_fmts, acts))
            if fxp_model.mlp_fits_smem(widths, in_fmt.total_bits):
                strategy = "megakernel"

                def predict(x):
                    h, stats = qx_with_stats(as_input(x, device), in_fmt)
                    out = ops.fxp_mlp_model(h, qws, qbs, schedule)
                    return argmax_first(out), stats
            else:
                strategy = "per-layer"

                def predict(x):
                    h, stats = qx_with_stats(as_input(x, device), in_fmt)
                    for w, b, act, fo, sh in zip(qws, qbs, acts, out_fmts,
                                                 shifts):
                        h = ops.fxp_layer(h, w, b, fo, activation=act,
                                          shift=sh)
                    return argmax_first(h), stats

            extras["kernel_strategy"] = strategy
        else:
            def predict(x):
                h, stats = qx_with_stats(as_input(x, device), in_fmt)
                for w, b, act, fo, sh in zip(qws, qbs, acts, out_fmts, shifts):
                    h, s = ref_ops.fxp_layer_ref_with_stats(
                        h, w, b, fo, activation=act, shift=sh)
                    stats = stats.merge(s)
                return argmax_first(h), stats

        flash = nbytes(*qws, *qbs)
        # One reused activation buffer (paper §III-D): the widest layer.
        sram = max(widths) * elem_bytes(in_fmt)
        # The quantized program as data: what the C emitter consumes, and
        # what the tests compare with the reference package byte for byte.
        extras["emit_spec"] = {
            "family": "mlp",
            "in_fmt": in_fmt,
            "out_fmts": out_fmts,
            "ws": [to_numpy(w) for w in qws],
            "bs": [to_numpy(b) for b in qbs],
            "shifts": shifts,
            "acts": acts,
        }
        return Lowered(predict, flash, sram, extras=extras)
