"""Per-rank cases of ``tests/test_torch_sharded_recurrent.py``: the Mamba2
hybrid (zamba2) and RWKV-6 under rules on a host mesh.

``repro_torch.launch.mesh.run_on_mesh`` runs each case once per device, in
a spawned process with the gloo group of the mesh set up.  This module
imports no JAX: the test holds what the ranks return against the JAX
package in its own process.  Every case takes the reference's numpy
parameters (and caches) and returns host values.
"""

import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.lm import mamba2 as mamba_mod
from repro_torch.lm import model as M
from repro_torch.lm import rwkv6 as rwkv_mod
from repro_torch.sharding import Rules, device_put_tree

import _torch_mesh_family_cases as fc
from _torch_mesh_cases import _rank0

# case -> (arch, n_layers, the config fields replaced, the SSM fields
# replaced); widths of 512, where param_specs shards the contraction dims
# on the data axis.  zamba2 keeps reduced()'s SSM (d_state 16, head_dim 32,
# chunk 32, shared_attn_every 3: 32 SSM heads in 2 groups) and window 64:
# one group of 2 Mamba2 layers with the shared block (8 heads over 2 KV
# heads), then a tail of 1.  rwkv6: 8 heads of 64.  Both recompute each
# layer in the backward (remat), as training does.  "zamba2-groups": 4
# groups of 1 Mamba2 layer and the shared block, for the cache whose group
# dim equals the batch.
CASES = {
    "zamba2": ("zamba2-7b", 4, dict(n_kv_heads=2, remat=True), None),
    "rwkv6": ("rwkv6-1.6b", 2, dict(n_kv_heads=8, remat=True), None),
    "zamba2-groups": ("zamba2-7b", 8, dict(n_kv_heads=2),
                      dict(shared_attn_every=2)),
}
MODEL_CASES = ("zamba2", "rwkv6")
BATCH, SEQ = 8, 64  # two SSD chunks of 32
DECODE_STEPS = 6
# zamba2 decoding past its window of 64: the reference's cache after
# WINDOW_FROM steps, placed on the mesh, then WINDOW_STEPS sharded steps
WINDOW_FROM, WINDOW_STEPS, WINDOW_LEN = 62, 6, 72
# the group dim equal to the batch: 4 groups at batch 4 on data 4
GROUPS_BATCH, GROUPS_STEPS = 4, 3


def recurrent_cfg(case, pkg_get_config=get_config):
    """The config of ``case`` (:data:`CASES`), from either package."""
    arch, n_layers, fields, ssm = CASES[case]
    widths = dict(fc.WIDTHS, **fields)
    cfg = dataclasses.replace(pkg_get_config(arch).reduced(),
                              n_layers=n_layers, **widths)
    if ssm is not None:
        cfg = dataclasses.replace(cfg,
                                  ssm=dataclasses.replace(cfg.ssm, **ssm))
    return cfg


def _torch_tree(np_tree):
    """A numpy cache tree (the reference's) as torch tensors on the host."""
    if isinstance(np_tree, dict):
        return {k: _torch_tree(v) for k, v in np_tree.items()}
    return torch.from_numpy(np.array(np_tree))


def _spy_local(record):
    """The Mamba2 and RWKV local bodies recording, on this rank, the part
    of the heads each call takes and the local shapes it is given; and
    each ``local_heads`` call, its body's name, the placements of the
    DTensors it gets and whether it splits the heads."""
    real = {"scan": mamba_mod._scan, "heads": rwkv_mod._heads,
            "m_map": mamba_mod.local_heads, "r_map": rwkv_mod.local_heads}

    @functools.wraps(real["scan"])
    def scan(part, parts, proj, *rest):
        record.append(("scan", part, parts, tuple(proj.shape)))
        return real["scan"](part, parts, proj, *rest)

    @functools.wraps(real["heads"])
    def heads(part, parts, r, *rest):
        record.append(("wkv", part, parts, tuple(r.shape)))
        return real["heads"](part, parts, r, *rest)

    def mapped(name):
        def call(fn, outs, acts, leaves, heads, whole=()):
            record.append((name, fn.__name__,
                           [fc._names(a.placements) for a in acts], heads))
            return real[name](fn, outs, acts, leaves, heads, whole)
        return call

    mamba_mod._scan, rwkv_mod._heads = scan, heads
    mamba_mod.local_heads = mapped("m_map")
    rwkv_mod.local_heads = mapped("r_map")

    def undo():
        mamba_mod._scan, rwkv_mod._heads = real["scan"], real["heads"]
        mamba_mod.local_heads, rwkv_mod.local_heads = (real["m_map"],
                                                       real["r_map"])
    return undo


def local_placements(mesh, case, np_params, np_batch):
    """One sharded forward of ``case``, recording its local bodies' calls
    on this rank (every rank returns them, with its mesh coordinates)."""
    cfg, rules = recurrent_cfg(case), Rules(mesh)
    placed = fc._placed(cfg, rules, mesh, np_params)
    record = []
    undo = _spy_local(record)
    try:
        M.forward(placed, fc._batch(np_batch), cfg, "ref", rules)
    finally:
        undo()
    dm = placed["embed"]["table"].device_mesh
    return {"rank": dist.get_rank(), "data": dm.get_local_rank("data"),
            "model": dm.get_local_rank("model"), "calls": record}


def window_case(mesh, np_params, np_cache, tokens):
    """zamba2 from the reference's cache at position WINDOW_FROM (placed by
    ``cache_specs``), WINDOW_STEPS sharded ``serve_step``s past the window
    of 64: their logits, and the shared block's K cache after them."""
    cfg, rules = recurrent_cfg("zamba2"), Rules(mesh)
    placed = fc._placed(cfg, rules, mesh, np_params)
    b = tokens.shape[0]
    cache = device_put_tree(_torch_tree(np_cache),
                            M.cache_specs(cfg, rules, b, WINDOW_LEN), mesh)
    dec = []
    for i in range(tokens.shape[1]):
        logits, cache = M.serve_step(
            placed, cache, {"token": torch.from_numpy(tokens[:, i])}, cfg,
            rules)
        dec.append(logits.full_tensor().numpy())
    return {"decode": np.stack(dec, 1), "pos": int(cache["pos"].full_tensor()),
            "k": cache["shared_attn"]["k"].full_tensor().numpy()}


def groups_case(mesh, np_params, tokens):
    """"zamba2-groups" decoding from a fresh cache placed by ``cache_specs``
    (its group dim the batch's size, so the data axis lands there): the
    logits of each step, the placements of the stacked entries, whether
    the returned cache holds the same DTensors, and their full values."""
    cfg, rules = recurrent_cfg("zamba2-groups"), Rules(mesh)
    placed = fc._placed(cfg, rules, mesh, np_params)
    b = tokens.shape[0]
    steps = tokens.shape[1]
    cache = device_put_tree(M.init_cache(cfg, b, steps + 2, "cpu"),
                            M.cache_specs(cfg, rules, b, steps + 2), mesh)
    first = cache
    dec = []
    for i in range(steps):
        logits, cache = M.serve_step(
            placed, cache, {"token": torch.from_numpy(tokens[:, i])}, cfg,
            rules)
        dec.append(logits.full_tensor().numpy())
    entries = [(key, k) for key in ("groups", "shared_attn")
               for k in first[key]]
    return {"decode": np.stack(dec, 1),
            "placements": {e: fc._names(first[e[0]][e[1]].placements)
                           for e in entries},
            "same": all(cache[key][k] is first[key][k] for key, k in entries),
            "cache": {e: first[e[0]][e[1]].full_tensor().numpy()
                      for e in entries}}


def recurrent_mesh_cases(mesh, jobs, lr, window, groups):
    """Everything the test reads, in one run of the mesh's processes:
    ``jobs`` (case -> (numpy parameters, numpy batch)) through
    ``model_case`` and ``local_placements``; ``window`` (numpy parameters,
    cache, tokens) through :func:`window_case`; ``groups`` (numpy
    parameters, tokens) through :func:`groups_case`."""
    models = {c: fc.model_case(mesh, c, *jobs[c], lr, DECODE_STEPS,
                               cfg=recurrent_cfg(c)) for c in jobs}
    local = {c: local_placements(mesh, c, *jobs[c]) for c in jobs}
    out = {"models": models, "window": window_case(mesh, *window),
           "groups": groups_case(mesh, *groups)}
    return {"local": local, **(_rank0(out) or {})}
