"""Production mesh construction: the counterpart of :mod:`repro.launch.mesh`.

Both meshes are plans over host placeholder devices
(:class:`repro_torch.sharding.HostDevice`): building one allocates nothing
and needs no card, as the reference's dry run builds its meshes over
placeholder host devices.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sharding.rules import HostDevice, Mesh

__all__ = ["make_production_mesh", "make_ci_mesh"]


def _host_mesh(shape, axes) -> Mesh:
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = [HostDevice(i) for i in range(n)]
    return Mesh(devs.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.

    Axes: ``data`` carries in-pod DP/FSDP/SP; ``model`` carries TP/EP/vocab;
    ``pod`` (multi-pod) is pure DP so the slower inter-pod link only sees the
    once-per-step gradient all-reduce.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _host_mesh(shape, axes)


def make_ci_mesh(n_devices: int = 8) -> Mesh:
    """Small mesh for CI-scale tests (data x model)."""
    d = max(1, n_devices // 2)
    return _host_mesh((d, n_devices // d), ("data", "model"))
