"""What a run loads: nothing of JAX or the JAX package (top-level names
compared whole), and a yardstick that loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from conftest import ROOT

from bench import harness


def _modules_after(code: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_everything_a_run_loads_is_free_of_jax():
    cells = [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    code = (
        "from bench import run, harness, calibrate\n"
        "import bench.metrics as m, importlib, pkgutil\n"
        f"for c in {cells!r}:\n"
        "    cell = harness.load_cell(c)\n"
        "    cell.program.arch(cell.cfg)\n"
        "for info in pkgutil.iter_modules(m.__path__):\n"
        "    importlib.import_module('bench.metrics.' + info.name)\n"
        "import torch.profiler\n")
    names = _modules_after(code)
    assert "repro_torch" in names  # the port is loaded, so this looks
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_yardstick_loads_nothing_of_the_port():
    code = ("import bench.reference.dense, bench.flops.dense, bench.check, "
            "bench.traffic, bench.tracing, bench.metrics\n"
            "import importlib, pkgutil\n"
            "for i in pkgutil.iter_modules(bench.metrics.__path__):\n"
            "    importlib.import_module('bench.metrics.' + i.name)\n")
    names = _modules_after(code)
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.lm", "jaxtyping", "reprox"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.lm", types.ModuleType("repro.lm"))
    assert harness.forbidden_modules() == ["repro"]
