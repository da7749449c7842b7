"""The Mamba2 hybrid and RWKV-6 on a device mesh (DTensor over gloo)
against the live JAX package run unsharded.

Two configs at widths of 512 (``tests/_torch_mesh_recurrent_cases.py``):
zamba2's pattern (one group of two Mamba2 layers and the shared attention
block, then a tail of one; 32 SSM heads in 2 groups, the window 64) and
RWKV-6 (two layers of 8 heads), on a ('data' 4, 'model' 2) host mesh: the
batch on the data axis, the heads on ``model``.  The reference's
parameters are carried across with ``convert.lm_params_from_numpy``; the
port runs in one spawned process a placeholder device
(``repro_torch.launch.mesh.run_on_mesh``), JAX in this process.  What is
held, and how closely (``tests/test_torch_sharded_moe.py``'s bounds):

* ``loss_fn`` within 1e-6 relative, every gradient leaf (the shared
  block's, summed over its calls, included) within 1e-4 of its leaf's
  largest value; one ``make_train_step``: its loss and grad norm within
  1e-5 of the reference's step, its parameters within 1e-5 (where the
  gradient is at least 1e-6) of the reference's clip and AdamW applied to
  the port's gradients, and zamba2's of the reference's whole step too;
  ``forward`` on the ``ref`` route and six ``serve_step``s within 1e-4 of
  the largest logit;
* zamba2 decoding past its window: from the reference's cache at position
  62, six sharded steps (the shared block's cache shifting from 64 on)
  within 1e-4, and the shifted K cache within 1e-5;
* a cache whose group dim equals the batch (4 groups at batch 4:
  ``cache_specs`` puts the data axis on the group dim): three steps within
  1e-4, written into the cache's own DTensors;
* the SSD scan and the WKV loop run in one ``local_map`` a layer on each
  rank's batch rows and its half of the heads.

Where a mesh axis splits a sum (the batch over ``data``, a product over
``model``'s shards), the port adds float32 partial sums in another order
than one device: RWKV's float32 gradients, which the reference's own
rounding puts 4.4e-5 from the port's float64 run's, then sit up to 8.2e-5
from the reference's on this mesh.
"""

import numpy as np
import pytest

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
import jax.numpy as jnp
from repro.lm import model as JM
from repro.configs import get_config as jget_config
from repro.train import trainer as JT
from repro.train.optim import apply_updates, clip_by_global_norm
from repro_torch.launch.mesh import make_host_mesh_2d, run_on_mesh

import _torch_mesh_recurrent_cases as rc

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
STEP_RTOL = 1e-5
LOGIT_RTOL = 1e-4
CACHE_RTOL = 1e-5
LR = 1e-3
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


def _decode(jc, jp, tokens, max_len, start=0, cache=None):
    """The reference's ``serve_step`` logits over ``tokens`` (B, T) from
    ``cache`` (a fresh one of ``max_len``), and the cache after them; the
    cache at step ``start`` too."""
    step = jax.jit(lambda p, c, t: JM.serve_step(p, c, {"token": t}, jc))
    cache = cache or JM.init_cache(jc, tokens.shape[0], max_len)
    logits, at_start = [], None
    for i in range(tokens.shape[1]):
        if i == start:
            at_start = _np(cache)
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, i]))
        if i >= start:
            logits.append(np.asarray(lg))
    return np.stack(logits, 1), _np(cache), at_start


@pytest.fixture(scope="module")
def ref():
    """Each config's reference parameters and batch; the tokens, starting
    cache and reference decode of the window and group cases."""
    out = {}
    for i, case in enumerate(rc.CASES):
        jc = rc.recurrent_cfg(case, jget_config)
        jp = jax.jit(JM.init_params, static_argnums=0)(
            jc, jax.random.PRNGKey(i))
        batch = next(JT.synthetic_token_stream(jc, rc.BATCH, rc.SEQ,
                                               seed=i))
        out[case] = (jc, jp, _np(batch))
    jc, jp, _ = out["zamba2"]
    tokens = np.random.RandomState(3).randint(
        1, jc.vocab_size, (rc.BATCH, rc.WINDOW_FROM + rc.WINDOW_STEPS)
    ).astype(np.int32)
    logits, cache, start = _decode(jc, jp, tokens, rc.WINDOW_LEN,
                                   start=rc.WINDOW_FROM)
    window = dict(tokens=tokens[:, rc.WINDOW_FROM:], start=start,
                  logits=logits, k=cache["shared_attn"]["k"])
    jc, jp, _ = out["zamba2-groups"]
    tokens = np.random.RandomState(4).randint(
        1, jc.vocab_size, (rc.GROUPS_BATCH, rc.GROUPS_STEPS)).astype(np.int32)
    logits, cache, _ = _decode(jc, jp, tokens, rc.GROUPS_STEPS + 2)
    groups = dict(tokens=tokens, logits=logits, cache=cache)
    return out, window, groups


@pytest.fixture(scope="module")
def mesh_run(ref):
    """Every rank's results, all in one run of a (4, 2) host mesh."""
    models, window, groups = ref
    jobs = {c: (_np(models[c][1]), models[c][2]) for c in rc.MODEL_CASES}
    mesh = make_host_mesh_2d(*MESH)
    return run_on_mesh(
        rc.recurrent_mesh_cases, mesh, mesh, jobs, LR,
        (_np(models["zamba2"][1]), window["start"], window["tokens"]),
        (_np(models["zamba2-groups"][1]), groups["tokens"]))


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


@pytest.mark.parametrize("case", rc.MODEL_CASES)
def test_loss_and_grads_match_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    jloss, jgrads = _jax_grads(ref, case)
    assert abs(got["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = dict(_leaves(_np(jgrads)))
    have = dict(_leaves(got["grads"]))
    assert want.keys() == have.keys()
    if case == "zamba2":
        assert any(k.startswith("shared_attn/") for k in want)
    for k in want:
        assert want[k].any(), k  # every leaf reaches the loss
        assert _rel(have[k], want[k]) <= GRAD_RTOL, k


@pytest.mark.parametrize("case", rc.MODEL_CASES)
def test_train_step_matches_reference(ref, mesh_run, case):
    """The step's loss and grad norm within 1e-5 of the reference's step;
    its parameters within 1e-5 (where the gradient is at least 1e-6) of
    the reference's clip and AdamW applied to the port's sharded gradients
    (which the gradient test holds to the reference's), and for zamba2 of
    the reference's whole step too.  RWKV's float32 gradients carry
    rounding of ~1e-4 of a leaf's largest value (the reference's own sit
    4.4e-5 from the port's float64 run's), and AdamW's first step moves an
    element
    by lr x eps / g^2 per unit of gradient error: near |g| = 1e-6 that
    turns the rounding into 1e-5-sized moves, for the single device as
    for the mesh (one device's step misses the reference's whole step on
    16 elements by up to 4.7e-5)."""
    jc, jp, batch, got = _model(ref, mesh_run, case)
    jcfg = JT.TrainConfig(lr=LR, warmup_steps=1, total_steps=10)
    opt = JT.make_optimizer(jcfg)
    jnew, _, jm = jax.jit(JT.make_train_step(jc, jcfg, opt))(
        jp, opt.init(jp), batch)
    for k, key in (("loss", "step_loss"), ("grad_norm", "grad_norm")):
        want = float(jm[k])
        assert abs(got[key] - want) <= STEP_RTOL * abs(want), k

    @jax.jit
    def apply(params, grads):
        grads, _ = clip_by_global_norm(grads, jcfg.clip_norm)
        updates, _ = opt.update(grads, opt.init(params), params)
        return apply_updates(params, updates)

    from_port = dict(_leaves(_np(apply(jp, jax.tree.map(
        jnp.asarray, got["grads"])))))
    grads = dict(_leaves(_np(_jax_grads(ref, case)[1])))
    want = dict(_leaves(_np(jnew)))
    for k, v in _leaves(got["params"]):
        live = np.abs(grads[k]) >= 1e-6
        np.testing.assert_allclose(v[live], from_port[k][live], rtol=0,
                                   atol=STEP_RTOL, err_msg=k)
        if case == "zamba2":
            np.testing.assert_allclose(v[live], want[k][live], rtol=0,
                                       atol=STEP_RTOL, err_msg=k)


@pytest.mark.parametrize("case", rc.MODEL_CASES)
def test_forward_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    want = np.asarray(jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, batch))
    assert got["logit_placements"] == ["S(0)", "S(2)"]
    assert _rel(got["logits"], want) <= LOGIT_RTOL


@pytest.mark.parametrize("case", rc.MODEL_CASES)
def test_serve_step_matches_reference(ref, mesh_run, case):
    jc, jp, batch, got = _model(ref, mesh_run, case)
    want, _, _ = _decode(jc, jp, np.asarray(batch["tokens"])[
        :, :rc.DECODE_STEPS], rc.DECODE_STEPS + 2)
    assert _rel(got["decode"], want) <= LOGIT_RTOL


def test_zamba2_decodes_past_its_window_on_the_mesh(ref, mesh_run):
    _, window, _ = ref
    got = mesh_run[0]["window"]
    assert rc.WINDOW_FROM < 64 < rc.WINDOW_FROM + rc.WINDOW_STEPS
    assert got["pos"] == rc.WINDOW_FROM + rc.WINDOW_STEPS
    assert got["k"].shape[2] == 64  # min(window, max_len) slots
    assert _rel(got["decode"], window["logits"]) <= LOGIT_RTOL
    assert _rel(got["k"], window["k"]) <= CACHE_RTOL


def test_stacked_cache_sharded_on_its_group_dim_decodes_in_place(ref,
                                                                 mesh_run):
    """4 groups at batch 4: ``cache_specs`` (the reference's rule: the data
    axes on the first dim of the batch's size) shards every stacked entry
    on its group dim.  The steps still decode as the reference, and they
    write into the cache's own DTensors."""
    _, _, groups = ref
    got = mesh_run[0]["groups"]
    for (key, k), placed in got["placements"].items():
        assert placed[0] == "S(0)", (key, k)  # data on the group dim
    assert got["same"]
    assert _rel(got["decode"], groups["logits"]) <= LOGIT_RTOL
    for (key, k), v in got["cache"].items():
        assert _rel(v, groups["cache"][key][k]) <= CACHE_RTOL, (key, k)


@pytest.mark.parametrize("case", rc.MODEL_CASES)
def test_scan_and_wkv_run_on_local_heads(ref, mesh_run, case):
    """On every rank, each Mamba2 layer's conv and SSD scan (zamba2: 32
    heads in 2 groups) and each RWKV layer's WKV loop (8 heads) run in one
    ``local_map`` on the rank's 2 of 8 batch rows and its model coordinate's
    half of the heads; RWKV's token-shift interpolation in one more, on the
    rank's rows, whole over ``model``."""
    jc = ref[0][case][0]
    n_layers = {"zamba2": 3, "rwkv6": 2}[case]  # Mamba2 or RWKV layers
    rows = rc.BATCH // MESH[0]
    assert len(mesh_run) == MESH[0] * MESH[1]
    for r in mesh_run:
        got = r["local"][case]
        body = [c for c in got["calls"] if c[0] in ("scan", "wkv")]
        maps = [c[1:] for c in got["calls"] if c[0] not in ("scan", "wkv")]
        assert len(body) == n_layers
        for name, part, parts, shape in body:
            assert (part, parts) == (got["model"], MESH[1])
            if case == "zamba2":
                s = jc.ssm
                d_in = s.expand * jc.d_model
                heads = d_in // s.head_dim
                # the projection whole: its z | xBC | dt shards are not
                # head-aligned; the scan takes its own heads' columns
                assert shape == (rows, rc.SEQ,
                                 2 * d_in + 2 * s.n_groups * s.d_state
                                 + heads)
            else:
                assert shape == (rows, rc.SEQ, jc.d_model // MESH[1])
        if case == "zamba2":
            assert maps == [("scan", [["S(0)", "R"]], True)] * n_layers
        else:  # the interpolation, then r, k, v, w and the gate by heads
            assert maps == [("_interpolate", [["S(0)", "R"]] * 2, False),
                            ("_heads", [["S(0)", "S(2)"]] * 5, True)
                            ] * n_layers
