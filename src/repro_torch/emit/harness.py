"""Host-side toolchain harness for the C emission backend.

The counterpart of :mod:`repro.emit.harness`; inputs are quantized on the
host with the port's ``quantize_with_stats``.

Compiles the generated translation unit twice:

1. **Freestanding proof + measurement** — ``-std=c99 -Wall -Wextra -Werror
   -ffreestanding -fno-builtin -c`` produces an object with no libc, no FPU
   and no warnings tolerated; its ``.text``/``.rodata`` section sizes are the
   *measured* flash footprint (what the paper's Tables IV–VI estimate).
2. **Replay** — the same translation unit linked with a tiny hosted stdio
   ``main``, so quantized rows can be piped through the actual compiled
   integers and their labels compared with the ``ref`` and ``cuda``
   backends'.

No compiler is assumed: :func:`find_cc` probes ``$CC``/``cc``/``gcc``/
``clang``; without one, building raises :class:`EmitToolchainError` (the
``emit`` backend's first predict, ``report(measure_c=True)``), and callers
that only want to know (tests, ``report``'s ``"auto"`` mode) check first.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp

__all__ = ["EmitToolchainError", "find_cc", "section_sizes", "CRunner",
           "FREESTANDING_FLAGS"]

FREESTANDING_FLAGS = ["-std=c99", "-Wall", "-Wextra", "-Werror", "-O2",
                      "-ffreestanding", "-fno-builtin"]
_HOSTED_FLAGS = ["-std=c99", "-Wall", "-Wextra", "-Werror", "-O2"]
_TIMEOUT = 120


class EmitToolchainError(RuntimeError):
    """No usable C compiler/binutils, or the generated C failed to build —
    the error message carries the full compiler diagnostics."""


def find_cc() -> Optional[str]:
    """The first usable C compiler: ``$CC``, then cc/gcc/clang on PATH."""
    env = os.environ.get("CC")
    if env:
        found = shutil.which(env)
        if found:
            return found
    for name in ("cc", "gcc", "clang"):
        found = shutil.which(name)
        if found:
            return found
    return None


def _run(cmd: List[str], **kw) -> subprocess.CompletedProcess:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=_TIMEOUT, **kw)
    except subprocess.TimeoutExpired as e:
        raise EmitToolchainError(f"timed out: {' '.join(cmd)}") from e


def section_sizes(obj_path: str) -> Dict[str, int]:
    """Measured section sizes of an object file, in bytes.

    Returns ``{"text", "rodata", "data", "bss", "flash"}`` where ``flash =
    text + rodata + data`` (everything that occupies program memory on an
    MCU; ``bss`` is RAM only).  Uses ``size -A`` with an ``objdump -h``
    fallback so it works with either binutils entry point.
    """
    buckets = {"text": 0, "rodata": 0, "data": 0, "bss": 0}

    def bucket_of(section: str) -> Optional[str]:
        name = section.lstrip(".")
        for b in buckets:
            if name == b or name.startswith(b + "."):
                return b
        return None

    size_tool = shutil.which("size")
    rows: List[tuple] = []
    if size_tool:
        proc = _run([size_tool, "-A", obj_path])
        if proc.returncode == 0:
            for line in proc.stdout.splitlines():
                m = re.match(r"^(\.\S+)\s+(\d+)", line)
                if m:
                    rows.append((m.group(1), int(m.group(2))))
    if not rows:
        objdump = shutil.which("objdump")
        if objdump is None:
            raise EmitToolchainError(
                "neither 'size' nor 'objdump' is available to measure "
                "section sizes")
        proc = _run([objdump, "-h", obj_path])
        if proc.returncode != 0:
            raise EmitToolchainError(
                f"objdump -h failed on {obj_path}:\n{proc.stderr}")
        for line in proc.stdout.splitlines():
            m = re.match(r"^\s*\d+\s+(\.\S+)\s+([0-9a-fA-F]+)", line)
            if m:
                rows.append((m.group(1), int(m.group(2), 16)))
    for section, nbytes in rows:
        b = bucket_of(section)
        if b is not None:
            buckets[b] += nbytes
    buckets["flash"] = buckets["text"] + buckets["rodata"] + buckets["data"]
    return buckets


_REPLAY_MAIN = """\
/* Hosted replay program (NOT part of the freestanding artifact): reads
 * "rows cols" then row-major quantized integers on stdin, prints one
 * predicted label per row. */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>

extern int32_t emb_predict(const {ctype} *x);

int main(void) {{
  long rows, cols, i, j, v;
  {ctype} *x;
  if (scanf("%ld %ld", &rows, &cols) != 2 || rows < 0 || cols <= 0) {{
    return 1;
  }}
  x = ({ctype} *)malloc((size_t)cols * sizeof *x);
  if (x == NULL) {{
    return 1;
  }}
  for (i = 0; i < rows; ++i) {{
    for (j = 0; j < cols; ++j) {{
      if (scanf("%ld", &v) != 1) {{
        free(x);
        return 1;
      }}
      x[j] = ({ctype})v;
    }}
    printf("%ld\\n", (long)emb_predict(x));
  }}
  free(x);
  return 0;
}}
"""


class CRunner:
    """Build the generated C once, then replay quantized batches through it.

    * ``sizes()``      — measured sections of the *freestanding* object.
    * ``predict_q(q)`` — labels for a batch of already-quantized inputs.
    * ``predict(x)``   — quantize floats host-side (with the exact traced
      round-half-even + saturation via ``fxp.quantize_with_stats``) then
      replay; returns ``(labels, FxpStats)`` like the traced predicts.
    """

    def __init__(self, source: str, in_fmt: fxp.FxpFormat,
                 cc: Optional[str] = None):
        cc = cc or find_cc()
        if cc is None:
            raise EmitToolchainError(
                "no C compiler found (tried $CC, cc, gcc, clang)")
        self.cc = cc
        self.in_fmt = in_fmt
        # TemporaryDirectory (not mkdtemp): its finalizer reclaims the build
        # dir even when a long-lived artifact never calls close().
        self._tmp = tempfile.TemporaryDirectory(prefix="repro-torch-emit-")
        self.tmpdir = self._tmp.name
        self.model_c = os.path.join(self.tmpdir, "model.c")
        self.model_o = os.path.join(self.tmpdir, "model.o")
        self.runner_bin = os.path.join(self.tmpdir, "runner")
        try:
            with open(self.model_c, "w") as f:
                f.write(source)
            # 1. the freestanding artifact build — the paper's deliverable
            self._cc(FREESTANDING_FLAGS + ["-c", self.model_c,
                                           "-o", self.model_o])
            # 2. hosted replay binary: the same unit + a stdio main
            main_c = os.path.join(self.tmpdir, "replay_main.c")
            from .cgen import CTYPES
            with open(main_c, "w") as f:
                f.write(_REPLAY_MAIN.format(
                    ctype=CTYPES[in_fmt.total_bits]))
            hosted_o = os.path.join(self.tmpdir, "model_hosted.o")
            self._cc(_HOSTED_FLAGS + ["-c", self.model_c, "-o", hosted_o])
            self._cc(_HOSTED_FLAGS + [main_c, hosted_o,
                                      "-o", self.runner_bin])
        except BaseException:
            self.close()
            raise

    def _cc(self, argv: List[str]) -> None:
        proc = _run([self.cc] + argv)
        if proc.returncode != 0:
            raise EmitToolchainError(
                f"{self.cc} {' '.join(argv)} failed:\n"
                f"{proc.stdout}\n{proc.stderr}")

    def sizes(self) -> Dict[str, int]:
        return section_sizes(self.model_o)

    def predict_q(self, qx: np.ndarray) -> np.ndarray:
        """Labels for a batch of already-quantized integer feature rows."""
        qx = np.asarray(qx)
        if qx.ndim == 1:
            qx = qx[None, :]
        rows, cols = qx.shape
        payload = [f"{rows} {cols}"]
        payload += [" ".join(str(int(v)) for v in row) for row in qx]
        proc = _run([self.runner_bin], input="\n".join(payload) + "\n")
        if proc.returncode != 0:
            raise EmitToolchainError(
                f"replay binary exited {proc.returncode}:\n{proc.stderr}")
        labels = [int(tok) for tok in proc.stdout.split()]
        if len(labels) != rows:
            raise EmitToolchainError(
                f"replay binary returned {len(labels)} labels for "
                f"{rows} rows")
        return np.asarray(labels, np.int32)

    def predict(self, x) -> tuple:
        """Quantize float inputs host-side (an array or a tensor on any
        device), replay, return (labels, stats)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().to("cpu", torch.float32)
        else:
            x = torch.from_numpy(np.asarray(x, np.float32))
        qx, stats = fxp.quantize_with_stats(x, self.in_fmt)
        return self.predict_q(qx.numpy()), stats

    def close(self) -> None:
        try:
            self._tmp.cleanup()
        except OSError:
            pass

    def __enter__(self) -> "CRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
