"""Per-rank cases of ``tests/test_torch_sharded.py``.

``repro_torch.launch.mesh.run_on_mesh`` runs each case once per device of a
host mesh, in a spawned process with the gloo group of the mesh set up.
This module imports no JAX: the test holds what rank 0 returns against the
JAX package in its own process.  Every case takes the reference's numpy
parameters and returns host values (numpy arrays, floats) from rank 0.
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.lm import model as M
from repro_torch.sharding import (Rules, device_mesh, device_put,
                                  device_put_tree, placements, shard)
from repro_torch.train import trainer as TT
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import adamw, apply_updates, tree_map


def elastic_cfg(pkg_get_config=get_config):
    """``tests/test_elastic.py``'s reduced qwen2 (its lines 28-31)."""
    return dataclasses.replace(
        pkg_get_config("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        remat=False, dtype="float32")


def fsdp_cfg(pkg_get_config=get_config):
    """One layer at widths of 512 (8 heads over 2 KV heads, vocabulary
    512): every matrix dim reaches the FSDP floor of ``param_specs``, so
    the contraction dims are sharded on the data axis and products come
    back as partial sums."""
    return dataclasses.replace(
        pkg_get_config("qwen2-0.5b").reduced(), n_layers=1, d_model=512,
        n_heads=8, n_kv_heads=2, d_head=64, d_ff=1024, vocab_size=512,
        remat=False, dtype="float32")


def _host(tree):
    """Full values of a tree of DTensors, as numpy (a collective)."""
    return tree_map(lambda t: t.full_tensor().numpy(), tree)


def _rank0(out):
    return out if dist.get_rank() == 0 else None


def placement_case(mesh):
    """``Rules.sharding``, ``placements``, ``device_put`` and ``shard`` on
    a (4, 2) mesh: placements of the specs, each rank's local shape, the
    round trip through ``full_tensor``, and ``shard`` of a plain tensor."""
    rules = Rules(mesh)
    dm = device_mesh(mesh)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    ns = rules.sharding(("batch", None, "model"), x.shape)
    d = device_put(x, ns)
    y = shard(d, (None, None, None), rules)
    z = shard(d, ("batch", "model", None), rules)
    try:
        shard(x, ("batch", None, None), rules)
        plain = "no error"
    except TypeError as e:
        plain = str(e)
    out = {"spec": ns.spec, "placements": [str(p) for p in d.placements],
           "local": tuple(d.to_local().shape),
           "rep": [str(p) for p in y.placements],
           "z": [str(p) for p in z.placements],
           "z_local": tuple(z.to_local().shape),
           "full": d.full_tensor().numpy(), "y": y.to_local().numpy(),
           "z_full": z.full_tensor().numpy(), "plain": plain,
           "multi": [str(p) for p in placements((("data", "model"),), dm)]}
    return _rank0(out)


def train_case(mesh, np_params, tokens, lr):
    """On ``mesh``: ``loss_fn`` and its gradients, then one
    ``make_train_step`` (the reference's defaults but ``lr``, warmup 1) from
    the same parameters."""
    cfg, rules = elastic_cfg(), Rules(mesh)
    params = lm_params_from_numpy(np_params, "cpu")
    placed = device_put_tree(params, M.param_specs(cfg, rules), mesh)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = TT.loss_and_grads(placed, batch, cfg, rules)
    same = all(g.placements == p.placements for g, p in
               zip(TT.tree_leaves(grads), TT.tree_leaves(placed)))
    tcfg = TT.TrainConfig(lr=lr, warmup_steps=1, total_steps=10)
    opt = TT.make_optimizer(tcfg)
    state = opt.init(placed)
    new, state, metrics = TT.make_train_step(cfg, tcfg, opt, rules)(
        placed, state, batch)
    out = {"loss": float(loss.full_tensor()), "grads": _host(grads),
           "grad_placements_as_params": same,
           "loss_placements": [str(p) for p in loss.placements],
           "step_loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "params": _host(new),
           "mu_as_params": all(
               m.placements == p.placements for m, p in
               zip(TT.tree_leaves(state.mu), TT.tree_leaves(new))),
           "step_counter": [str(p) for p in state.step.placements]}
    return _rank0(out)


def serve_case(mesh, np_params, tokens, steps):
    """On ``mesh``: ``forward`` (the ``ref`` route), then ``steps``
    ``serve_step``s from a cache placed by ``cache_specs``."""
    cfg, rules = elastic_cfg(), Rules(mesh)
    params = lm_params_from_numpy(np_params, "cpu")
    placed = device_put_tree(params, M.param_specs(cfg, rules), mesh)
    logits = M.forward(placed, {"tokens": torch.from_numpy(tokens)}, cfg,
                       "ref", rules)
    b = tokens.shape[0]
    cache = M.init_cache(cfg, b, steps + 2, "cpu")
    cache = device_put_tree(cache, M.cache_specs(cfg, rules, b, steps + 2),
                            mesh)
    dec = []
    for i in range(steps):
        step_logits, cache = M.serve_step(
            placed, cache, {"token": torch.from_numpy(tokens[:, i])}, cfg,
            rules)
        dec.append(step_logits.full_tensor().numpy())
    out = {"logits": logits.full_tensor().numpy(),
           "placements": [str(p) for p in logits.placements],
           "decode": np.stack(dec, 1),
           "decode_placements": [str(p) for p in step_logits.placements],
           "pos": int(cache["pos"].full_tensor())}
    return _rank0(out)


def _adamw_step(cfg, rules, params, batch):
    """``tests/test_elastic.py``'s step: value and grad, a fresh
    ``adamw(1e-3)``, the update."""
    opt = adamw(1e-3)
    loss, grads = TT.loss_and_grads(params, batch, cfg, rules)
    updates, _ = opt.update(grads, opt.init(params), params)
    return apply_updates(params, updates), float(loss.full_tensor())


def elastic_save(mesh, np_params, tokens, ckpt_dir):
    """Under ``mesh``: one step from the reference's parameters, saved."""
    cfg, rules = elastic_cfg(), Rules(mesh)
    params = lm_params_from_numpy(np_params, "cpu")
    placed = device_put_tree(params, M.param_specs(cfg, rules), mesh)
    new, loss = _adamw_step(cfg, rules, placed,
                            {"tokens": torch.from_numpy(tokens)})
    CheckpointManager(ckpt_dir, keep=2).save(1, {"params": new},
                                              metadata={"loss": loss})
    return _rank0(loss)


def elastic_restore(mesh, np_params, tokens, ckpt_dir):
    """Under ``mesh``: restore step 1 into a tree placed for this mesh
    (the ``like``), then one more step."""
    cfg, rules = elastic_cfg(), Rules(mesh)
    like = device_put_tree(lm_params_from_numpy(np_params, "cpu"),
                           M.param_specs(cfg, rules), mesh)
    step, tree, meta = CheckpointManager(ckpt_dir, keep=2).restore(
        {"params": like})
    as_like = all(t.placements == l.placements for t, l in
                  zip(TT.tree_leaves(tree["params"]), TT.tree_leaves(like)))
    _, loss = _adamw_step(cfg, rules, tree["params"],
                          {"tokens": torch.from_numpy(tokens)})
    return _rank0({"step": step, "saved_loss": meta["loss"], "loss": loss,
                   "placed_as_like": as_like})


def failing_case(bad_rank):
    """Raises on ``bad_rank``; the others wait at a barrier."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def fsdp_case(mesh, np_params, tokens):
    """``loss_fn``, its gradients and ``forward`` at :func:`fsdp_cfg`'s
    widths, where the weights are sharded on both mesh axes."""
    cfg, rules = fsdp_cfg(), Rules(mesh)
    placed = device_put_tree(lm_params_from_numpy(np_params, "cpu"),
                             M.param_specs(cfg, rules), mesh)
    batch = {"tokens": torch.from_numpy(tokens)}
    loss, grads = TT.loss_and_grads(placed, batch, cfg, rules)
    logits = M.forward(placed, batch, cfg, "ref", rules)
    w = placed["layers"]["mlp"]["wi"]["w"]
    return _rank0({"loss": float(loss.full_tensor()), "grads": _host(grads),
                   "logits": logits.full_tensor().numpy(),
                   "wi_placements": [str(p) for p in w.placements]})


def mesh_cases(mesh, np_params, tokens, lr, steps, fsdp_params):
    """The placement, train, serve and FSDP-width cases in one run of the
    mesh's processes (each spawn costs seconds)."""
    return _rank0({"placement": placement_case(mesh),
                   "train": train_case(mesh, np_params, tokens, lr),
                   "serve": serve_case(mesh, np_params, tokens, steps),
                   "fsdp": fsdp_case(mesh, fsdp_params, tokens)})


def world_of_one(mesh):
    """What a one-device mesh runs in: this process, a group of one."""
    import os

    return {"world": dist.get_world_size(), "pid": os.getpid(),
            "backend": dist.get_backend()}
