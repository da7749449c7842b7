"""The port's LM on a device mesh (DTensor over gloo) against the live JAX
package run unsharded.

The model is ``tests/test_elastic.py``'s reduced qwen2 (2 layers, d_model
64, 4 heads over 2 KV heads, float32), the reference's parameters carried
across with ``convert.lm_params_from_numpy``.  The port runs on host meshes
of 8 placeholder devices, one spawned process each
(``repro_torch.launch.mesh.run_on_mesh``, ``tests/_torch_mesh_cases.py``);
JAX runs in this process.  Tolerances, all measured well inside:

* placements of ``Rules.sharding`` specs, ``device_put`` and ``shard``;
* under (4, 2), ``loss_fn`` within 1e-6 relative of JAX's and every
  gradient leaf within 1e-4 of its leaf's largest value, also at widths
  of 512 where the weights are sharded on the data axis (FSDP); one
  ``make_train_step`` step: the metrics within 1e-5 relative, the
  parameters within 1e-5 but for elements whose gradient is below 1e-6
  (``tests/test_torch_lm_train.py``'s rule);
* ``forward`` (the ``ref`` route) and four ``serve_step``s within 1e-4 of
  JAX's, relative to the largest logit;
* elastic: one step under (4, 2) saved, restored under (2, 4) and stepped
  again; both losses within 1e-5 of JAX's two unsharded steps (the
  optimizer re-initialised, as ``tests/test_elastic.py`` does);
* every one of the ten configs plans under rules, and each of its layer
  blocks, prefill and decode, takes the rules (the sharded runs:
  ``tests/test_torch_sharded_moe.py``, ``test_torch_sharded_modality.py``
  and ``test_torch_sharded_recurrent.py``); no fallback: ``shard`` raises
  on a plain tensor, and a rank that raises makes ``run_on_mesh`` raise.
"""

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.lm import model as JM
from repro.train import trainer as JT
from repro.train.optim import adamw as jadamw
from repro.train.optim import apply_updates as japply
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget_config
from repro_torch.launch.mesh import make_host_mesh_2d, run_on_mesh
from repro_torch.lm import model as TM
from repro_torch.sharding import HostDevice, Mesh, Rules, shard
from repro_torch.sharding.rules import placements
from repro_torch.train.checkpoint import CheckpointManager

import _torch_mesh_cases as cases

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
LOGIT_RTOL = 1e-4
ELASTIC_RTOL = 1e-5
LR = 1e-3
DECODE_STEPS = 4
DENSE = ("qwen2-0.5b", "starcoder2-15b", "minitron-8b", "qwen1.5-32b")
ATTENTION_FAMILIES = ("grok-1-314b", "deepseek-v3-671b",
                      "llava-next-mistral-7b", "hubert-xlarge")
RECURRENT = ("zamba2-7b", "rwkv6-1.6b")


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters (numpy) and a batch of 8 x 16 tokens."""
    jc = cases.elastic_cfg(jget_config)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tokens = np.random.RandomState(0).randint(0, jc.vocab_size, (8, 16)) \
        .astype(np.int32)
    return jc, jp, jax.tree.map(np.asarray, jp), tokens


@pytest.fixture(scope="module")
def fsdp_ref():
    """The reference's parameters at :func:`cases.fsdp_cfg`'s widths."""
    jc = cases.fsdp_cfg(jget_config)
    jp = JM.init_params(jc, jax.random.PRNGKey(1))
    return jc, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def mesh_run(ref, fsdp_ref):
    """Rank 0's results of the placement, train, serve and FSDP-width
    cases, all in one run of a (4, 2) host mesh."""
    _, _, np_params, tokens = ref
    mesh = make_host_mesh_2d(4, 2)
    return run_on_mesh(cases.mesh_cases, mesh, mesh, np_params, tokens, LR,
                       DECODE_STEPS, fsdp_ref[2])[0]


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
def test_rules_sharding_and_device_put(mesh_run):
    got = mesh_run["placement"]
    assert got["spec"] == ("data", None, "model")
    assert got["placements"] == ["S(0)", "S(2)"]
    assert got["local"] == (2, 6, 2)  # 8 / data 4, 4 / model 2
    np.testing.assert_array_equal(
        got["full"], np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4))


def test_shard_redistributes_and_refuses_plain_tensors(mesh_run):
    got = mesh_run["placement"]
    assert got["rep"] == ["R", "R"]
    np.testing.assert_array_equal(got["y"], got["full"])
    assert got["z"] == ["S(0)", "S(1)"] and got["z_local"] == (2, 3, 4)
    np.testing.assert_array_equal(got["z_full"], got["full"])
    assert "plain Tensor" in got["plain"]
    assert got["multi"] == ["S(0)", "S(0)"]  # ('data', 'model') on one dim


def test_shard_without_rules_and_on_a_plain_tensor():
    x = torch.ones(8, 4)
    assert shard(x, ("batch", None), None) is x
    rules = Rules(make_host_mesh_2d(4, 2))
    with pytest.raises(TypeError, match="plain Tensor"):
        shard(x, ("batch", None), rules)


def test_placements_follow_the_mesh_order():
    class DM:
        mesh_dim_names = ("pod", "data", "model")

    got = placements((("pod", "data"), None, "model"), DM())
    assert [str(p) for p in got] == ["S(0)", "S(0)", "S(2)"]
    with pytest.raises(ValueError, match="axis order"):
        placements((("data", "pod"),), DM())
    with pytest.raises(ValueError, match="twice"):
        placements(("model", "model"), DM())


def test_rules_sharding_is_a_named_sharding():
    mesh = make_host_mesh_2d(2, 4)
    ns = Rules(mesh).sharding(("batch", None, "model"), (8, 3, 6))
    assert ns.mesh is mesh and ns.spec == ("data", None, None)


# --------------------------------------------------------------------------
# training under (4, 2)
# --------------------------------------------------------------------------
def test_loss_and_grads_match_reference(ref, mesh_run):
    jc, jp, _, tokens = ref
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, batch, jc))(jp)
    got = mesh_run["train"]
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert got["loss_placements"] == ["R", "R"]
    assert got["grad_placements_as_params"]
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    have = dict(_leaves(got["grads"]))
    assert want.keys() == have.keys()
    for k in want:
        assert _rel(have[k], want[k]) <= GRAD_RTOL, k


def test_train_step_matches_reference(ref, mesh_run):
    jc, jp, _, tokens = ref
    jcfg = JT.TrainConfig(lr=LR, warmup_steps=1, total_steps=10)
    jnew, _, jm = JT.make_train_step(jc, jcfg, JT.make_optimizer(jcfg))(
        jp, JT.make_optimizer(jcfg).init(jp),
        {"tokens": jnp.asarray(tokens)})
    got = mesh_run["train"]
    for k in ("loss", "grad_norm"):
        want = float(jm[k])
        key = "step_loss" if k == "loss" else k
        assert abs(got[key] - want) <= STEP_RTOL * abs(want), k
    _, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jc))(jp)
    grads = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    want = dict(_leaves(jax.tree.map(np.asarray, jnew)))
    for k, v in _leaves(got["params"]):
        live = np.abs(grads[k]) >= 1e-6
        np.testing.assert_allclose(v[live], want[k][live], rtol=0,
                                   atol=STEP_RTOL, err_msg=k)
    assert got["mu_as_params"] and got["step_counter"] == ["R", "R"]


def test_fsdp_widths_match_reference(ref, fsdp_ref, mesh_run):
    """At widths of 512 the weights are sharded on the data axis too (the
    FSDP floor), so products over a sharded dim come back as partial sums:
    the loss, the gradients and the logits still match JAX unsharded."""
    tokens = ref[3]
    jc, jp, _ = fsdp_ref
    batch = {"tokens": jnp.asarray(tokens)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, batch, jc))(jp)
    got = mesh_run["fsdp"]
    assert got["wi_placements"] == ["S(1)", "S(2)"]  # (layer, data, model)
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for k, v in _leaves(got["grads"]):
        assert _rel(v, want[k]) <= GRAD_RTOL, k
    assert _rel(got["logits"], np.asarray(JM.forward(jp, batch, jc))) \
        <= LOGIT_RTOL


# --------------------------------------------------------------------------
# serving under (4, 2)
# --------------------------------------------------------------------------
def test_forward_matches_reference(ref, mesh_run):
    jc, jp, _, tokens = ref
    want = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jc))
    got = mesh_run["serve"]
    assert got["placements"] == ["S(0)", "S(2)"]  # ('batch', None, 'model')
    assert _rel(got["logits"], want) <= LOGIT_RTOL


def test_serve_step_matches_reference(ref, mesh_run):
    jc, jp, _, tokens = ref
    cache = JM.init_cache(jc, tokens.shape[0], DECODE_STEPS + 2)
    want = []
    for i in range(DECODE_STEPS):
        logits, cache = JM.serve_step(
            jp, cache, {"token": jnp.asarray(tokens[:, i])}, jc)
        want.append(np.asarray(logits))
    got = mesh_run["serve"]
    assert got["decode_placements"] == ["S(0)", "S(1)"]  # ('batch', 'model')
    assert got["pos"] == DECODE_STEPS
    assert _rel(got["decode"], np.stack(want, 1)) <= LOGIT_RTOL


# --------------------------------------------------------------------------
# elastic: saved under (4, 2), restored under (2, 4)
# --------------------------------------------------------------------------
def test_checkpoint_reshards_across_meshes(ref, tmp_path):
    jc, jp, np_params, tokens = ref
    d = str(tmp_path)
    mesh_a, mesh_b = make_host_mesh_2d(4, 2), make_host_mesh_2d(2, 4)
    saved = run_on_mesh(cases.elastic_save, mesh_a, mesh_a, np_params,
                        tokens, d)[0]
    restored = run_on_mesh(cases.elastic_restore, mesh_b, mesh_b, np_params,
                           tokens, d)[0]
    # the reference's two unsharded steps, the optimizer fresh each time
    opt, batch = jadamw(1e-3), {"tokens": jnp.asarray(tokens)}
    want = []
    p = jp
    for _ in range(2):
        loss, g = jax.value_and_grad(lambda q: JM.loss_fn(q, batch, jc))(p)
        u, _ = opt.update(g, opt.init(p), p)
        p = japply(p, u)
        want.append(float(loss))
    assert restored["step"] == 1 and restored["saved_loss"] == saved
    assert restored["placed_as_like"]
    for got, w in zip((saved, restored["loss"]), want):
        assert abs(got - w) <= ELASTIC_RTOL * abs(w)
    # the file is the reference's: it restores in the port without a mesh
    _, tree, _ = CheckpointManager(d).restore(
        {"params": TM.init_params(cases.elastic_cfg(),
                                  torch.Generator().manual_seed(0))})
    assert tree["params"]["embed"]["table"].shape == (256, 64)


# --------------------------------------------------------------------------
# no fallback
# --------------------------------------------------------------------------
def _plans_under_rules(arch):
    """``arch``'s parameter and cache specs plan on a (4, 2) mesh, tree for
    tree, and every block of its forward and decode takes ``rules``."""
    import inspect

    cfg = tget_config(arch).reduced()
    rules = Rules(make_host_mesh_2d(4, 2))
    specs = TM.param_specs(cfg, rules)
    assert set(specs) == set(TM.abstract_params(cfg))
    if not cfg.encoder_only:
        assert set(TM.cache_specs(cfg, rules, 8, 16)) == set(
            TM.init_cache(cfg, 8, 16, "meta"))
    params = TM.abstract_params(cfg)
    blocks = {b for b, _ in TM._layer_calls(cfg, params)}
    if not cfg.encoder_only:
        blocks |= {c[0] for c in TM._decode_calls(cfg, params)}
    for block in blocks:
        assert "rules" in inspect.signature(block).parameters, block


@pytest.mark.parametrize("arch", ATTENTION_FAMILIES + RECURRENT)
def test_attention_families_pass_the_mesh_guard(arch):
    """MoE, MLA with MoE, the two front ends, the hybrid and RWKV run under
    rules (``tests/test_torch_sharded_moe.py``,
    ``tests/test_torch_sharded_modality.py``,
    ``tests/test_torch_sharded_recurrent.py``): their specs plan, and every
    block of theirs takes the rules."""
    _plans_under_rules(arch)


def test_a_failing_rank_makes_run_on_mesh_raise():
    mesh = make_host_mesh_2d(2, 1)
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        run_on_mesh(cases.failing_case, mesh, 1)


def test_a_one_device_mesh_runs_in_this_process():
    import os

    import torch.distributed as dist

    mesh = Mesh(np.array([[HostDevice(0)]], dtype=object), ("data", "model"))
    (got,) = run_on_mesh(cases.world_of_one, mesh, mesh)
    assert got == {"world": 1, "pid": os.getpid(), "backend": "gloo"}
    assert not dist.is_initialized()


def test_dense_configs_run_under_rules_at_reduced_width():
    """The four dense configs plan under rules, and their blocks take the
    rules."""
    for arch in DENSE:
        _plans_under_rules(arch)
    assert set(DENSE + ATTENTION_FAMILIES + RECURRENT) == set(ARCH_IDS)
