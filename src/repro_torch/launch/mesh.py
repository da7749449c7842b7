"""Production mesh construction: the counterpart of :mod:`repro.launch.mesh`,
and :func:`run_on_mesh`, which starts the processes a placement needs.

The meshes are plans over host placeholder devices
(:class:`repro_torch.sharding.HostDevice`): building one allocates nothing
and needs no card, as the reference's dry run builds its meshes over
placeholder host devices.

JAX runs one program over a mesh from a single controller; torch places a
tensor on a mesh from one process per device (DTensor).
:func:`run_on_mesh` is that price: it runs a function once per mesh
device, in a process of its own with the process group set up (gloo over
host placeholders, NCCL over cards), or in this process when the mesh has
one device.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.sharding.rules import HostDevice, Mesh, device_platform

__all__ = ["make_production_mesh", "make_ci_mesh", "make_host_mesh_2d",
           "run_on_mesh"]


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


def make_host_mesh_2d(data: int, model: int) -> Mesh:
    """A ``(data, model)`` mesh of host placeholders: the reference's
    ``dp<D>tp<T>`` meshes (``jax.make_mesh((D, T), ('data', 'model'))``)."""
    return _host_mesh((data, model), ("data", "model"))


def _init_group(mesh: Mesh, rank: int, store_path: str,
                timeout_s: float) -> None:
    import torch.distributed as dist

    d = mesh.devices.flat[rank]
    kw = {}
    if device_platform(d) == "gpu":
        torch.cuda.set_device(d)
        kw["device_id"] = d
    dist.init_process_group(
        "nccl" if device_platform(d) == "gpu" else "gloo",
        store=dist.FileStore(store_path, mesh.size), rank=rank,
        world_size=mesh.size, timeout=datetime.timedelta(seconds=timeout_s),
        **kw)


def _rank_main(rank, workdir, timeout_s):
    import torch.distributed as dist

    with open(os.path.join(workdir, "job.pkl"), "rb") as f:
        fn, mesh, args = pickle.load(f)
    _init_group(mesh, rank, os.path.join(workdir, "store"), timeout_s)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # the time of the failure: the first rank to fail is the cause (the
        # others fail after it, in the collectives it left)
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _first_failure(workdir: str, n: int):
    """(rank, traceback) of the rank that failed first, or None."""
    errs = []
    for r in range(n):
        path = os.path.join(workdir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                t, tb = f.read().split("\n", 1)
            errs.append((float(t), r, tb))
    return min(errs)[1:] if errs else None


def run_on_mesh(fn, mesh: Mesh, *args, timeout_s: float = 600.0) -> list:
    """``fn(*args)`` once per device of ``mesh``, each with the process
    group of the mesh initialized (rank r on ``mesh.devices.flat[r]``, its
    card the current device): in this process when the mesh has one
    device, else in one spawned process per device, joined under a
    ``FileStore`` in a temporary directory (no TCP port).  Returns the
    ranks' return values in rank order (picklable; host tensors).

    A rank that raises makes the call raise ``RuntimeError`` with the
    traceback of the first rank that failed (the others fail after it, in
    the collectives it left); the other ranks are stopped.  ``timeout_s``
    bounds every collective.
    """
    import torch.distributed as dist
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mesh_") as workdir:
        if mesh.size == 1:
            if dist.is_initialized():
                raise RuntimeError("run_on_mesh: a process group is already "
                                   "initialized in this process")
            _init_group(mesh, 0, os.path.join(workdir, "store"), timeout_s)
            try:
                return [fn(*args)]
            finally:
                dist.destroy_process_group()
        # the job goes through a file: spawn's own pickling of numpy
        # arguments costs seconds a rank
        with open(os.path.join(workdir, "job.pkl"), "wb") as f:
            pickle.dump((fn, mesh, args), f)
        try:
            mp.start_processes(_rank_main, args=(workdir, timeout_s),
                               nprocs=mesh.size, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = _first_failure(workdir, mesh.size)
            if first is None:
                raise
            raise RuntimeError(f"run_on_mesh: rank {first[0]} of "
                               f"{mesh.size} raised first:\n{first[1]}") from e
        out = []
        for r in range(mesh.size):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
