"""The vision and audio front ends on a device mesh (DTensor over gloo)
against the live JAX package run unsharded.

llava-next (8 image embeddings through ``modality_proj``, prepended to 8
tokens a row) and hubert (bidirectional attention over audio frame
embeddings, encoder-only), one layer each at widths of 512
(``tests/_torch_mesh_family_cases.py``), on a ('data' 4, 'model' 2) host
mesh, one spawned process a placeholder device.  What is held
(``tests/test_torch_sharded.py``'s tolerances): the embedded input placed
``('batch', None, None)`` and equal to the reference's; ``loss_fn`` (over
llava's text positions past its image prefix, over hubert's labels)
within 1e-6 relative and every gradient leaf within 1e-4 of its leaf's
largest value (hubert's token table and ``modality_proj``, which frame
embeddings bypass, zero); one ``make_train_step`` within 1e-5 but for
elements whose gradient is below 1e-6; ``forward`` on the ``ref`` route
and, for llava, four ``serve_step``s within 1e-4 of the largest logit.
"""

import numpy as np
import pytest

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as jget_config
from repro.lm import model as JM
from repro.train import trainer as JT
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.mesh import make_host_mesh_2d, run_on_mesh

import _torch_mesh_family_cases as fc

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
LOGIT_RTOL = 1e-4
LR = 1e-3
DECODE_STEPS = 4
MESH = (4, 2)


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
    out = {}
    for i, case in enumerate(fc.MODALITY_CASES):
        jc = fc.family_cfg(case, jget_config)
        jp = jax.jit(JM.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(20 + i))
        batch = next(JT.synthetic_token_stream(jc, fc.BATCH, fc.SEQ,
                                               seed=20 + i))
        out[case] = (jc, jp, _np(batch))
    return out


@pytest.fixture(scope="module")
def mesh_run(ref):
    """Rank 0's results of the model cases and the embedded inputs, in one
    run of a (4, 2) host mesh."""
    jobs = {c: (_np(jp), batch) for c, (_, jp, batch) in ref.items()}
    mesh = make_host_mesh_2d(*MESH)
    return run_on_mesh(fc.modality_mesh_cases, mesh, mesh, jobs, LR,
                       DECODE_STEPS)[0]


_GRADS = {}


def _jax_grads(ref, case):
    """The reference's (loss, gradients) of ``case``, computed once."""
    if case not in _GRADS:
        jc, jp, batch = ref[case]
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        _GRADS[case] = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, batch, jc)))(jp)
    return _GRADS[case]


def _model(ref, mesh_run, case):
    jc, jp, batch = ref[case]
    return jc, jp, {k: jnp.asarray(v) for k, v in batch.items()}, \
        mesh_run["models"][case]


def test_the_configs_are_the_front_ends():
    llava, hubert = (fc.family_cfg(c) for c in fc.MODALITY_CASES)
    assert llava.modality == "vision" and llava.n_prefix_embeds == 8
    assert hubert.modality == "audio" and hubert.encoder_only
    assert {"llava-next-mistral-7b", "hubert-xlarge"} <= set(ARCH_IDS)


@pytest.mark.parametrize("case", fc.MODALITY_CASES)
def test_embedded_input_is_placed_and_matches_reference(ref, mesh_run, case):
    jc, jp, batch, _ = _model(ref, mesh_run, case)
    got = mesh_run["fronts"][case]
    assert got["shape"] == (fc.BATCH, fc.SEQ, jc.d_model)
    assert got["placements"] == ["S(0)", "R"]  # ('batch', None, None)
    want = np.asarray(JM._embed_inputs(jc, jp, batch))
    assert _rel(got["value"], want) <= LOGIT_RTOL


@pytest.mark.parametrize("case", fc.MODALITY_CASES)
def test_loss_and_grads_match_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    jloss, jgrads = _jax_grads(ref, case)
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(_leaves(_np(jgrads)))
    have = dict(_leaves(got["grads"]))
    assert want.keys() == have.keys()
    for k in want:
        if not want[k].any():  # hubert's token table and modality_proj
            assert jc.modality == "audio" and not have[k].any(), k
            continue
        assert _rel(have[k], want[k]) <= GRAD_RTOL, k


@pytest.mark.parametrize("case", fc.MODALITY_CASES)
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


@pytest.mark.parametrize("case", fc.MODALITY_CASES)
def test_forward_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    want = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, batch))
    assert got["logits"].shape == (fc.BATCH, fc.SEQ, jc.vocab_size)
    assert got["logit_placements"] == ["S(0)", "S(2)"]
    assert _rel(got["logits"], want) <= LOGIT_RTOL


def test_vision_serve_step_matches_reference(ref, mesh_run):
    jc, jp, batch, got = _model(ref, mesh_run, "llava-next")
    tokens = batch["tokens"]
    cache = JM.init_cache(jc, tokens.shape[0], DECODE_STEPS + 2)
    step = jax.jit(lambda p, c, t: JM.serve_step(p, c, {"token": t}, jc))
    want = []
    for i in range(DECODE_STEPS):
        logits, cache = step(jp, cache, tokens[:, i])
        want.append(np.asarray(logits))
    assert _rel(got["decode"], np.stack(want, 1)) <= LOGIT_RTOL
    assert "decode" not in mesh_run["models"]["hubert"]  # encoder-only
