"""Per-rank cases of ``tests/test_torch_sharded_moe.py`` and
``tests/test_torch_sharded_modality.py``: the attention families (MoE,
MLA with MoE, the vision and audio front ends) under rules on a host mesh.

``repro_torch.launch.mesh.run_on_mesh`` runs each case once per device, in
a spawned process with the gloo group of the mesh set up.  This module
imports no JAX: the tests hold what the ranks return against the JAX
package in their own process.  Every case takes the reference's numpy
parameters and returns host values (numpy arrays, floats).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.lm import model as M
from repro_torch.lm import moe as moe_mod
from repro_torch.sharding import Rules, device_put, device_put_tree
from repro_torch.train import trainer as TT

from _torch_mesh_cases import _host, _rank0

# The widths of every case: 512 and more, so that param_specs shards the
# contraction dims on the data axis (its FSDP floor), 8 heads over 2 KV
# heads (MLA has no KV heads), d_head 64, vocabulary 512.
WIDTHS = dict(d_model=512, n_heads=8, n_kv_heads=2, d_head=64,
              vocab_size=512, d_ff=1024, remat=False, dtype="float32")

# case -> (arch, n_layers, the MoE fields replaced); the MoE cases keep
# reduced()'s MLA ranks, aux-free router and capacity factor 8
CASES = {
    "grok-1-tp": ("grok-1-314b", 1,
                  dict(n_experts=4, top_k=2, d_ff_expert=512)),
    # 1 dense layer, then 1 MoE layer of 4 experts (2 a model rank) and 1
    # shared expert; prefill chunks of 8 tokens a row (two of them)
    "deepseek-v3-ep": ("deepseek-v3-671b", 2,
                       dict(n_experts=4, top_k=2, d_ff_expert=512,
                            n_shared=1, first_k_dense=1, d_ff_dense=1024)),
    # 8 experts: 1 a rank of the (4, 2) mesh
    "deepseek-v3-ep2d": ("deepseek-v3-671b", 2,
                         dict(n_experts=8, top_k=2, d_ff_expert=512,
                              n_shared=1, first_k_dense=1, d_ff_dense=1024,
                              expert_sharding="ep2d")),
    "llava-next": ("llava-next-mistral-7b", 1, None),
    "hubert": ("hubert-xlarge", 1, None),
}
MOE_CASES = ("grok-1-tp", "deepseek-v3-ep", "deepseek-v3-ep2d")
MODALITY_CASES = ("llava-next", "hubert")
PREFILL_CHUNK = {"deepseek-v3-ep": 8}
BATCH, SEQ = 8, 16
# the MoE layer alone: its sharding -> (the case's config, d); capacity
# factors 8 (nothing drops) and 1 (experts overflow)
LAYER_SHARDINGS = {"ep": "deepseek-v3-ep", "ep2d": "deepseek-v3-ep2d",
                   "tp": "grok-1-tp"}
LAYER_FACTORS = (8.0, 1.0)


def family_cfg(case, pkg_get_config=get_config):
    """The config of ``case`` (:data:`CASES`), from either package."""
    arch, n_layers, moe = CASES[case]
    cfg = dataclasses.replace(pkg_get_config(arch).reduced(),
                              n_layers=n_layers, **WIDTHS)
    if moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe),
            moe_prefill_chunk=PREFILL_CHUNK.get(case, cfg.moe_prefill_chunk))
    return cfg


def _placed(cfg, rules, mesh, np_params):
    return device_put_tree(lm_params_from_numpy(np_params, "cpu"),
                           M.param_specs(cfg, rules), mesh)


def _batch(np_batch):
    return {k: torch.from_numpy(v) for k, v in np_batch.items()}


def _names(placements):
    return [str(p) for p in placements]


def model_case(mesh, case, np_params, np_batch, lr, steps, cfg=None):
    """On ``mesh``, ``case``'s config (or ``cfg``) from the reference's
    parameters: ``loss_fn`` and its gradients, one ``make_train_step`` (the
    reference's defaults but ``lr``, warmup 1), ``forward`` on the ``ref``
    route and, but for an encoder, ``steps`` ``serve_step``s from a cache
    placed by ``cache_specs``."""
    cfg, rules = cfg or family_cfg(case), Rules(mesh)
    placed = _placed(cfg, rules, mesh, np_params)
    batch = _batch(np_batch)
    loss, grads = TT.loss_and_grads(placed, batch, cfg, rules)
    tcfg = TT.TrainConfig(lr=lr, warmup_steps=1, total_steps=10)
    opt = TT.make_optimizer(tcfg)
    new, _, metrics = TT.make_train_step(cfg, tcfg, opt, rules)(
        placed, opt.init(placed), batch)
    logits = M.forward(placed, batch, cfg, "ref", rules)
    out = {"loss": float(loss.full_tensor()), "grads": _host(grads),
           "step_loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "params": _host(new), "logits": logits.full_tensor().numpy(),
           "logit_placements": _names(logits.placements)}
    if not cfg.encoder_only:
        tokens = np_batch["tokens"]
        b = tokens.shape[0]
        cache = device_put_tree(M.init_cache(cfg, b, steps + 2, "cpu"),
                                M.cache_specs(cfg, rules, b, steps + 2),
                                mesh)
        out["cache_placements"] = {
            k: _names(v.placements)
            for k, v in cache.get("layers", {}).items()}
        dec = []
        for i in range(steps):
            step_logits, cache = M.serve_step(
                placed, cache, {"token": torch.from_numpy(tokens[:, i])},
                cfg, rules)
            dec.append(step_logits.full_tensor().numpy())
        out["decode"] = np.stack(dec, 1)
    return _rank0(out)


def _spy_constraints(record):
    """``moe.shard`` recording each constraint of an activation (the
    integer tables are placed through it too): its logical axes, shape and
    the placements it returns."""
    real = moe_mod.shard

    def spy(x, axes, rules):
        y = real(x, axes, rules)
        if rules is not None and x.is_floating_point():
            record.append((tuple(axes), tuple(x.shape), _names(y.placements)))
        return y

    return real, spy


def moe_layer_case(mesh, np_layers, np_x):
    """The MoE layer alone under each expert sharding and capacity factor:
    ``apply_moe(rules=)`` on the input placed ``('batch', None, None)``;
    this rank's routing tables (:func:`repro_torch.lm.moe.routing_on_mesh`)
    against the single-device ``route`` and ``dispatch`` of the whole input,
    bit for bit; the placements at the four constraint points.  Every rank
    returns its results."""
    rules = Rules(mesh)
    xt = torch.from_numpy(np_x)
    x = device_put(xt, rules.sharding(("batch", None, None), xt.shape))
    out = {}
    for sharding, case in LAYER_SHARDINGS.items():
        mo = family_cfg(case).moe
        p = lm_params_from_numpy(np_layers[sharding], "cpu")
        pspecs = M.param_specs(family_cfg(case), rules)["layers"]["moe"]
        # the stacked layer's specs without the layer dim
        placed = device_put_tree(p, _drop_lead(pspecs), mesh)
        for cf in LAYER_FACTORS:
            record = []
            real, spy = _spy_constraints(record)
            moe_mod.shard = spy
            try:
                y = moe_mod.apply_moe(placed, x, mo, "glu", "silu",
                                      capacity_factor=cf, rules=rules)
            finally:
                moe_mod.shard = real
            cap = moe_mod.capacity(xt.shape[0] * xt.shape[1], mo, cf)
            xf = xt.reshape(-1, xt.shape[-1])
            _, *mesh_tables = moe_mod.routing_on_mesh(
                placed, x.reshape(xf.shape), mo, cap)
            local = [t.to_local() for t in mesh_tables]
            single = moe_mod.dispatch(*moe_mod.route(p, xf, mo),
                                      mo.n_experts, cap)
            out[(sharding, cf)] = {
                "y": y.full_tensor().numpy(),
                "y_placements": _names(y.placements),
                "cap": cap,
                "tables": [t.numpy() for t in local],
                "tables_equal_single": all(torch.equal(a, b) for a, b in
                                           zip(local, single)),
                "constraints": record}
    out["rank"] = dist.get_rank()
    return out


def _drop_lead(specs):
    if isinstance(specs, dict):
        return {k: _drop_lead(v) for k, v in specs.items()}
    return specs[1:]


def moe_mesh_cases(mesh, jobs, lr, steps, np_layers, np_x):
    """The model cases of :data:`MOE_CASES` (``jobs``: case -> (numpy
    parameters, numpy batch)) on rank 0, and the MoE layer case on every
    rank, in one run of the mesh's processes."""
    models = {c: model_case(mesh, c, *jobs[c], lr, steps) for c in jobs}
    return {"models": _rank0(models),
            "layer": moe_layer_case(mesh, np_layers, np_x)}


def modality_mesh_cases(mesh, jobs, lr, steps):
    """The model cases of :data:`MODALITY_CASES`, and the placement of the
    embedded input, in one run of the mesh's processes."""
    models = {c: model_case(mesh, c, *jobs[c], lr, steps) for c in jobs}
    rules = Rules(mesh)
    fronts = {}
    for c, (np_params, np_batch) in jobs.items():
        cfg = family_cfg(c)
        x = M._embed_inputs(cfg, _placed(cfg, rules, mesh, np_params),
                            _batch(np_batch), rules)
        fronts[c] = {"shape": tuple(x.shape),
                     "placements": _names(x.placements),
                     "value": x.full_tensor().numpy()}
    return _rank0({"models": models, "fronts": fronts})
