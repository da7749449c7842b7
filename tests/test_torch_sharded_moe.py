"""MoE and MLA on a device mesh (DTensor over gloo) against the live JAX
package run unsharded.

Three configs at widths of 512 (``tests/_torch_mesh_family_cases.py``):
grok-1's pattern with its experts' d_ff on ``model`` (``tp``), deepseek-v3's
(MLA, 1 dense layer then 1 MoE layer, the aux-free router, 1 shared expert)
with its experts on ``model`` (``ep``), and an ``ep2d`` variant with 8
experts, one a rank of the ('data' 4, 'model' 2) host mesh.  The
reference's parameters are carried across with
``convert.lm_params_from_numpy``; the port runs in one spawned process a
placeholder device (``repro_torch.launch.mesh.run_on_mesh``), JAX in this
process.  What is held, and how closely:

* the MoE layer alone, at capacity factors 8 and 1 (where an expert
  overflows): ``apply_moe(rules=)`` within 1e-5 relative of the
  reference's ``apply_moe`` (``tests/test_torch_moe.py``'s ``OUT_RTOL``);
  every rank's routing tables equal, bit for bit, the single-device
  ``dispatch`` of the whole input; the placements at the reference's four
  constraint points equal ``Rules.spec`` of its logical axes;
* each config (``tests/test_torch_sharded.py``'s tolerances): ``loss_fn``
  within 1e-6 relative and every gradient leaf within 1e-4 of its leaf's
  largest value (the aux-free router bias, whose gradient is zero,
  zero); one ``make_train_step`` within 1e-5 but for elements whose
  gradient is below 1e-6; ``forward`` on the ``ref`` route and four
  ``serve_step``s (MLA's latent cache with its length on ``model``)
  within 1e-4 of the largest logit.
"""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.lm import model as JM
from repro.lm import moe as jmoe
from repro.train import trainer as JT
from repro_torch.launch.mesh import make_host_mesh_2d, run_on_mesh
from repro_torch.sharding import Rules
from repro_torch.sharding.rules import placements

import _torch_mesh_family_cases as fc

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
LOGIT_RTOL = 1e-4
OUT_RTOL = 1e-5
LR = 1e-3
DECODE_STEPS = 4
MESH = (4, 2)
# the reference's logical axes at its four constraint points
# (src/repro/lm/moe.py:125-150)
CONSTRAINTS = {
    "ep": [("model", "batch", None), ("model", "batch", None),
           ("model", "batch", None), ("batch", None)],
    "ep2d": [("expert", None, None), ("expert", None, None),
             ("expert", None, None), ("batch", None)],
    "tp": [(None, "batch", None), (None, "batch", "model"),
           (None, "batch", None), ("batch", None)],
}
# and the placements they give on the (4, 2) mesh
PLACED = {"ep": [["S(1)", "S(0)"]] * 3 + [["S(0)", "R"]],
          "ep2d": [["S(0)", "S(0)"]] * 3 + [["S(0)", "R"]],
          "tp": [["S(1)", "R"], ["S(1)", "S(2)"], ["S(1)", "R"],
                 ["S(0)", "R"]]}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.fixture(scope="module")
def ref():
    """Each config's reference parameters and batch, and the MoE layer's
    parameters (a nonzero aux-free bias, so it moves the selection) and
    input."""
    out = {}
    for i, case in enumerate(fc.MOE_CASES):
        jc = fc.family_cfg(case, jget_config)
        jp = jax.jit(JM.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(i))
        batch = next(JT.synthetic_token_stream(jc, fc.BATCH, fc.SEQ,
                                               seed=i))
        out[case] = (jc, jp, _np(batch))
    layers = {}
    for i, (sharding, case) in enumerate(fc.LAYER_SHARDINGS.items()):
        mo = fc.family_cfg(case, jget_config).moe
        jp = jmoe.moe_params(jax.random.PRNGKey(10 + i), fc.WIDTHS["d_model"],
                             mo, "glu", jnp.float32)
        jp["router"]["bias"] = jnp.asarray(
            (np.random.RandomState(i).randn(mo.n_experts) * 0.3)
            .astype(np.float32))
        layers[sharding] = (mo, jp)
    x = np.random.RandomState(7).randn(fc.BATCH, fc.SEQ,
                                       fc.WIDTHS["d_model"]) \
        .astype(np.float32)
    return out, layers, x


@pytest.fixture(scope="module")
def mesh_run(ref):
    """Every rank's results of the model and MoE-layer cases, all in one
    run of a (4, 2) host mesh."""
    models, layers, x = ref
    jobs = {c: (_np(jp), batch) for c, (_, jp, batch) in models.items()}
    mesh = make_host_mesh_2d(*MESH)
    return run_on_mesh(fc.moe_mesh_cases, mesh, mesh, jobs, LR,
                       DECODE_STEPS, {s: _np(jp) for s, (_, jp) in
                                      layers.items()}, x)


# --------------------------------------------------------------------------
# the MoE layer alone
# --------------------------------------------------------------------------
_japply = jax.jit(jmoe.apply_moe, static_argnums=(2, 3, 4, 5))
LAYER = [(s, cf) for s in fc.LAYER_SHARDINGS for cf in fc.LAYER_FACTORS]


@pytest.mark.parametrize("sharding,cf", LAYER)
def test_apply_moe_under_rules_matches_reference(ref, mesh_run, sharding,
                                                 cf):
    _, layers, x = ref
    mo, jp = layers[sharding]
    want = np.asarray(_japply(jp, jnp.asarray(x), mo, "glu", "silu", cf))
    got = mesh_run[0]["layer"][(sharding, cf)]
    assert got["y_placements"][0] == "S(0)"  # the batch on data
    assert _rel(got["y"], want) <= OUT_RTOL
    if cf == 1.0:  # the case where experts overflow
        _, experts = jmoe._route(jp, jnp.asarray(x.reshape(-1, x.shape[-1])),
                                 mo)
        counts = np.bincount(np.asarray(experts).ravel(),
                             minlength=mo.n_experts)
        assert counts.max() > got["cap"], (counts, got["cap"])


@pytest.mark.parametrize("sharding,cf", LAYER)
def test_routing_tables_equal_the_single_device_on_every_rank(
        ref, mesh_run, sharding, cf):
    """Each rank routes the whole batch: its tables equal the single-device
    ``dispatch`` bit for bit, and so each other rank's."""
    _, layers, x = ref
    mo, jp = layers[sharding]
    ranks = [r["layer"][(sharding, cf)] for r in mesh_run]
    assert len(ranks) == int(np.prod(MESH))
    first = ranks[0]["tables"]
    assert first[0].shape == (mo.n_experts * ranks[0]["cap"],)
    for r in ranks:
        assert r["tables_equal_single"]
        for a, b in zip(r["tables"], first):
            np.testing.assert_array_equal(a, b)
    # rank 0's top-k is the reference's
    _, experts = jmoe._route(jp, jnp.asarray(x.reshape(-1, x.shape[-1])), mo)
    experts = np.asarray(experts)
    ts = first[1]
    kept = ts < mo.n_experts * ranks[0]["cap"]
    np.testing.assert_array_equal((ts // ranks[0]["cap"])[kept],
                                  experts[kept])


@pytest.mark.parametrize("sharding", list(fc.LAYER_SHARDINGS))
def test_constraint_points_are_placed_as_the_reference(mesh_run, sharding):
    mesh = make_host_mesh_2d(*MESH)
    rules = Rules(mesh)

    class DM:
        mesh_dim_names = mesh.axis_names

    for cf in fc.LAYER_FACTORS:
        record = mesh_run[0]["layer"][(sharding, cf)]["constraints"]
        assert [axes for axes, _, _ in record] == CONSTRAINTS[sharding]
        assert [got for _, _, got in record] == PLACED[sharding]
        for axes, shape, got in record:
            want = placements(rules.spec(axes, shape), DM())
            assert got == [str(p) for p in want], (axes, shape)


# --------------------------------------------------------------------------
# the models under (4, 2)
# --------------------------------------------------------------------------
_GRADS = {}


def _jax_grads(ref, case):
    """The reference's (loss, gradients) of ``case``, computed once."""
    if case not in _GRADS:
        jc, jp, batch = ref[0][case]
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        _GRADS[case] = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, batch, jc)))(jp)
    return _GRADS[case]


def _model(ref, mesh_run, case):
    jc, jp, batch = ref[0][case]
    return jc, jp, {k: jnp.asarray(v) for k, v in batch.items()}, \
        mesh_run[0]["models"][case]


@pytest.mark.parametrize("case", fc.MOE_CASES)
def test_loss_and_grads_match_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    jloss, jgrads = _jax_grads(ref, case)
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(_leaves(_np(jgrads)))
    have = dict(_leaves(got["grads"]))
    assert want.keys() == have.keys()
    for k in want:
        if not want[k].any():  # the aux-free router bias
            assert k.endswith("router/bias") and not have[k].any(), k
            continue
        assert _rel(have[k], want[k]) <= GRAD_RTOL, k


@pytest.mark.parametrize("case", fc.MOE_CASES)
def test_train_step_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    jcfg = JT.TrainConfig(lr=LR, warmup_steps=1, total_steps=10)
    opt = JT.make_optimizer(jcfg)
    jnew, _, jm = jax.jit(JT.make_train_step(jc, jcfg, opt))(
        jp, opt.init(jp), batch)
    for k, key in (("loss", "step_loss"), ("grad_norm", "grad_norm")):
        want = float(jm[k])
        assert abs(got[key] - want) <= STEP_RTOL * abs(want), k
    grads = dict(_leaves(_np(_jax_grads(ref, case)[1])))
    want = dict(_leaves(_np(jnew)))
    for k, v in _leaves(got["params"]):
        live = np.abs(grads[k]) >= 1e-6
        np.testing.assert_allclose(v[live], want[k][live], rtol=0,
                                   atol=STEP_RTOL, err_msg=k)


@pytest.mark.parametrize("case", fc.MOE_CASES)
def test_forward_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    want = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, batch))
    assert got["logit_placements"] == ["S(0)", "S(2)"]
    assert _rel(got["logits"], want) <= LOGIT_RTOL


@pytest.mark.parametrize("case", fc.MOE_CASES)
def test_serve_step_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    tokens = batch["tokens"]
    cache = JM.init_cache(jc, tokens.shape[0], DECODE_STEPS + 2)
    step = jax.jit(lambda p, c, t: JM.serve_step(p, c, {"token": t}, jc))
    want = []
    for i in range(DECODE_STEPS):
        logits, cache = step(jp, cache, tokens[:, i])
        want.append(np.asarray(logits))
    assert _rel(got["decode"], np.stack(want, 1)) <= LOGIT_RTOL
    if jc.mla is not None:  # the latent: batch on data, its length on model
        for k in ("c_kv", "k_rope"):
            assert got["cache_placements"][k] == ["S(1)", "S(2)"], k
