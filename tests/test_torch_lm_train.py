"""The port's LM trainer against the live JAX package on the host.

Configs: ``tests/test_trainer.py``'s ``_tiny_arch`` and reduced qwen2
(float32); the reference's parameters are carried across with
``convert.lm_params_from_numpy``.  Tolerances, all measured well inside:

* ``loss_fn`` within 1e-6 relative, at the exact gate and at pwl4, on a
  sequence that takes the blockwise branch (reduced qwen2: S 128 over
  chunks of 64) and one that takes the full one;
* every gradient leaf within 1e-4 of the largest value in its leaf;
* one ``make_train_step`` step at ``microbatches`` 1 and 4: the metrics
  within 1e-5 relative, the parameters within 1e-5 but for elements whose
  gradient is below 1e-6 in magnitude (AdamW's first update is about
  lr * sign(g), so noise in a near-zero gradient flips it; the count
  excluded is bounded);
* ``synthetic_token_stream`` equal bit for bit;
* a run checkpointed by one package at step 10 and resumed by the other to
  20: the loss history within 1e-4 of the reference's own run to 20;
* the five ``tests/test_trainer.py`` cases, mirrored in the port;
* the kernel route raising under grad, and the training route never
  reaching a kernel wrapper, with the card's route patched in on the host;
* ``launch/train.py --device cpu`` and ``roofline.analytic_cost`` (field
  for field, every ported config, full and reduced, every shape).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.lm import model as JM
from repro.roofline import analytic as janalytic
from repro.train import trainer as JT
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain_cli
from repro_torch.lm import attention as tattn
from repro_torch.lm import layers as tlayers
from repro_torch.lm import model as TM
from repro_torch.roofline import analytic_cost
from repro_torch.train import trainer as TT
from repro_torch.train.checkpoint import CheckpointManager, _flatten

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4  # of the largest |value| in the leaf
STEP_RTOL = 1e-5
RESUME_ATOL = 1e-4


def _tiny(pkg_get_config):
    return dataclasses.replace(
        pkg_get_config("qwen2-0.5b").reduced(), name="tiny", n_layers=2,
        d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
        vocab_size=256, remat=False, dtype="float32")


def _cfgs(arch, gate="exact"):
    """(reference config, port config), equal field for field."""
    if arch == "tiny":
        jc, tc = _tiny(jget_config), _tiny(tget_config)
    else:
        jc, tc = jget_config(arch).reduced(), tget_config(arch).reduced()
    jc = dataclasses.replace(jc, gate_sigmoid=gate)
    tc = dataclasses.replace(tc, gate_sigmoid=gate)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _params(jc, seed=0):
    jp = JM.init_params(jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(jc, tc, batch, seq, seed=1):
    jb = next(JT.synthetic_token_stream(jc, batch, seq, seed=seed))
    tb = next(TT.synthetic_token_stream(tc, batch, seq, seed=seed))
    return jb, tb


def _leaves(tree):
    out = []
    _flatten(tree, out)
    return [np.asarray(l.detach().numpy() if isinstance(l, torch.Tensor)
                       else l) for l in out]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


# reduced qwen2 at S 128 takes the blockwise branch (chunk 64); the tiny
# arch at S 32 the full one
CASES = [("tiny", 4, 32), ("qwen2-0.5b", 2, 128)]


# --------------------------------------------------------------------------
# loss, gradients, one step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("gate", ["exact", "pwl4"])
@pytest.mark.parametrize("arch,batch,seq", CASES)
def test_loss_fn_matches_reference(arch, batch, seq, gate):
    jc, tc = _cfgs(arch, gate)
    jp, tp = _params(jc)
    jb, tb = _batches(jc, tc, batch, seq)
    want = float(JM.loss_fn(jp, jb, jc))
    got = TM.loss_fn(tp, tb, tc)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("gate", ["exact", "pwl4"])
@pytest.mark.parametrize("arch,batch,seq", CASES)
def test_gradients_match_reference(arch, batch, seq, gate):
    jc, tc = _cfgs(arch, gate)
    jp, tp = _params(jc)
    jb, tb = _batches(jc, tc, batch, seq)
    jgrads = jax.grad(JM.loss_fn)(jp, jb, jc)
    _, tgrads = TT.loss_and_grads(tp, tb, tc)
    want, got = [np.asarray(l) for l in jax.tree.leaves(jgrads)], \
        _leaves(tgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= GRAD_RTOL


@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch,batch,seq", CASES)
def test_train_step_matches_reference(arch, batch, seq, microbatches):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    batch *= 2  # divisible by 4 microbatches
    jb, tb = _batches(jc, tc, batch, seq)
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=10,
              microbatches=microbatches)
    jcfg, tcfg = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    jopt, topt = JT.make_optimizer(jcfg), TT.make_optimizer(tcfg)
    jnew, jstate, jm = JT.make_train_step(jc, jcfg, jopt)(
        jp, jopt.init(jp), jb)
    tnew, tstate, tm = TT.make_train_step(tc, tcfg, topt)(
        tp, topt.init(tp), tb)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= STEP_RTOL * abs(
            float(jm[k]))
    assert int(tstate.step) == int(jstate.step) == 1
    # near-zero gradients decide the sign of AdamW's first update
    grads = jax.grad(JM.loss_fn)(jp, jb, jc)
    excluded = total = 0
    for g, w, t in zip(jax.tree.leaves(grads), jax.tree.leaves(jnew),
                       _leaves(tnew)):
        keep = np.abs(np.asarray(g)) >= 1e-6
        excluded += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(t[keep], np.asarray(w)[keep],
                                   rtol=STEP_RTOL, atol=STEP_RTOL)
    assert excluded <= 0.01 * total, (excluded, total)
    # the moments, in the same leaf order
    for t, w in zip(_leaves(tstate), [np.asarray(l)
                                      for l in jax.tree.leaves(jstate)]):
        assert t.shape == w.shape and t.dtype == w.dtype


@pytest.mark.parametrize("seed,start", [(0, 0), (7, 5), (123, 10_000)])
def test_token_stream_bit_for_bit(seed, start):
    jc, tc = _cfgs("qwen2-0.5b")
    js = JT.synthetic_token_stream(jc, 4, 48, seed=seed, start_step=start)
    ts = TT.synthetic_token_stream(tc, 4, 48, seed=seed, start_step=start)
    for _ in range(3):
        want, got = np.asarray(next(js)["tokens"]), next(ts)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_token_stream_raises_for_unported_modalities():
    """The audio and vision streams are ported (the reference's batches bit
    for bit), and so, now that the port runs them, are the recurrent block
    patterns' (zamba2, rwkv6): nothing raises any more."""
    for arch in ("hubert-xlarge", "llava-next-mistral-7b", "zamba2-7b",
                 "rwkv6-1.6b"):
        jc, tc = _cfgs(arch)
        want = next(JT.synthetic_token_stream(jc, 2, 16, seed=4))
        got = next(TT.synthetic_token_stream(tc, 2, 16, seed=4))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# --------------------------------------------------------------------------
# the loop: resume across packages
# --------------------------------------------------------------------------
def _run_ref(jc, d, steps):
    tcfg = JT.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                          checkpoint_every=10, seed=3)
    return JT.train_loop(jc, tcfg, batch=4, seq=32, ckpt_dir=d, steps=steps)


def _run_port(tc, d, steps):
    tcfg = TT.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                          checkpoint_every=10, seed=3)
    return TT.train_loop(tc, tcfg, batch=4, seq=32, ckpt_dir=d, steps=steps,
                         device="cpu")


@pytest.fixture(scope="module")
def ref_run_to_20(tmp_path_factory):
    jc, _ = _cfgs("tiny")
    return _run_ref(jc, str(tmp_path_factory.mktemp("ref20")), 20)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(tmp_path, ref_run_to_20, writer):
    """One package trains to step 10 and checkpoints; the other resumes to
    20.  The resumed losses follow the reference's own run to 20."""
    jc, tc = _cfgs("tiny")
    d = str(tmp_path)
    if writer == "reference":
        _run_ref(jc, d, 10)
        resumed = _run_port(tc, d, 20)
        # the port resumed from the reference's state: its steps 10..19
        # follow the reference's own run
        np.testing.assert_allclose(resumed["history"],
                                   ref_run_to_20["history"][10:],
                                   rtol=0, atol=RESUME_ATOL)
    else:
        # the port's own init differs (torch.Generator): take its run to 10
        # and resume it in the reference, against the port's own run to 20
        first = _run_port(tc, d, 10)
        resumed = _run_ref(jc, d, 20)
        port20 = _run_port(tc, str(tmp_path / "p20"), 20)
        np.testing.assert_allclose(first["history"], port20["history"][:10],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(resumed["history"],
                                   port20["history"][10:],
                                   rtol=0, atol=RESUME_ATOL)
    assert resumed["final_step"] == 20 and len(resumed["history"]) == 10
    assert CheckpointManager(d).all_steps() == [10, 20]


# --------------------------------------------------------------------------
# tests/test_trainer.py, mirrored in the port
# --------------------------------------------------------------------------
def test_loss_decreases(tmp_path):
    """The loss falls over 40 steps: the mean of the last five losses is
    below the mean of the first five.  (The reference's test compares the
    first and last single losses, which step-to-step noise of ~0.1 decides
    at this size: its own run reads 5.869 -> 5.842, the port's, from
    another draw of the same init, 5.723 -> 5.815, while both runs' means of
    five fall by 0.06-0.08.)"""
    _, arch = _cfgs("tiny")
    tcfg = TT.TrainConfig(lr=3e-3, warmup_steps=5, total_steps=40,
                          checkpoint_every=100, seed=0)
    metrics = TT.train_loop(arch, tcfg, batch=4, seq=32,
                            ckpt_dir=str(tmp_path), steps=40, device="cpu")
    hist = metrics["history"]
    assert len(hist) == 40
    assert np.mean(hist[-5:]) < np.mean(hist[:5]), \
        f"loss did not fall: {hist[:5]} -> {hist[-5:]}"


def test_checkpoint_resume_exact(tmp_path):
    """Interrupted run + resume == uninterrupted run (bitwise on the host:
    the final parameters too)."""
    _, arch = _cfgs("tiny")

    def run(ckpt_dir, steps):
        tcfg = TT.TrainConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                              checkpoint_every=10, seed=3)
        return TT.train_loop(arch, tcfg, batch=4, seq=32, ckpt_dir=ckpt_dir,
                             steps=steps, device="cpu")

    d1 = os.path.join(tmp_path, "a")
    full = run(d1, 20)
    d2 = os.path.join(tmp_path, "b")
    run(d2, 10)  # stops at step 10 (checkpointed)
    resumed = run(d2, 20)  # resumes 10 -> 20
    np.testing.assert_allclose(full["history"][-1], resumed["history"][-1],
                               rtol=1e-5)
    assert full["history"][10:] == resumed["history"]
    _, a, _ = CheckpointManager(d1).restore(None, 20)
    _, b, _ = CheckpointManager(d2).restore(None, 20)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_data_stream_deterministic_replay():
    _, arch = _cfgs("tiny")
    a = TT.synthetic_token_stream(arch, 4, 32, seed=7, start_step=5)
    b = TT.synthetic_token_stream(arch, 4, 32, seed=7, start_step=5)
    for _ in range(3):
        assert torch.equal(next(a)["tokens"], next(b)["tokens"])


def test_grad_accumulation_matches_full_batch():
    """microbatches=K averages to the same gradients as one big batch."""
    _, arch = _cfgs("tiny")
    params = TM.init_params(arch, torch.Generator("cpu").manual_seed(0))
    batch = next(TT.synthetic_token_stream(arch, 8, 32, seed=0))

    def one(mb):
        tcfg = TT.TrainConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                              microbatches=mb, clip_norm=1e9)
        opt = TT.make_optimizer(tcfg)
        step = TT.make_train_step(arch, tcfg, opt)
        p, _, m = step(params, opt.init(params), batch)
        return p, m

    p1, m1 = one(1)
    p4, m4 = one(4)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(_leaves(p1)[0], _leaves(p4)[0], atol=5e-4)


def test_watchdog_field_and_final_step(tmp_path):
    _, arch = _cfgs("tiny")
    tcfg = TT.TrainConfig(lr=1e-3, total_steps=5, checkpoint_every=100)
    metrics = TT.train_loop(arch, tcfg, batch=2, seq=16,
                            ckpt_dir=str(tmp_path), steps=5, device="cpu")
    assert metrics["final_step"] == 5
    assert len(metrics["history"]) == 5


def test_train_loop_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    _, arch = _cfgs("tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.train_loop(arch, TT.TrainConfig(), batch=2, seq=16,
                      ckpt_dir=str(tmp_path), steps=1)


# --------------------------------------------------------------------------
# routes: the kernels are never differentiated
# --------------------------------------------------------------------------
def _on_card(monkeypatch):
    """The serving route's branches as on the card, on host tensors."""
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    monkeypatch.setattr(tattn, "on_card", lambda x: True)


def _counted(monkeypatch):
    calls = {"flash_attention": 0, "pwl_activation": 0}
    for name in calls:
        real = getattr(ops, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, wrapped)
    return calls


def test_training_route_never_reaches_a_kernel(monkeypatch):
    jc, tc = _cfgs("qwen2-0.5b", "pwl4")
    jp, tp = _params(jc)
    jb, tb = _batches(jc, tc, 2, 128)
    _on_card(monkeypatch)
    calls = _counted(monkeypatch)
    loss, _ = TT.loss_and_grads(tp, tb, tc)
    assert calls == {"flash_attention": 0, "pwl_activation": 0}
    assert abs(float(loss) - float(JM.loss_fn(jp, jb, jc))) <= \
        LOSS_RTOL * float(loss)
    # the serving route reaches both wrappers once a layer
    TM.forward(tp, tb, tc)
    assert calls == {"flash_attention": tc.n_layers,
                     "pwl_activation": tc.n_layers}


@pytest.mark.parametrize("wrapper", ["flash_attention", "pwl_activation"])
def test_kernel_route_raises_under_grad(monkeypatch, wrapper):
    """On the card's route a wrapper refuses an input that requires grad
    (the launch would cut the gradient); without grad it launches."""
    launched = []
    monkeypatch.setattr(ops, "_route", lambda impl, t: "cuda")
    monkeypatch.setattr(ops, "flash_attention_cuda",
                        lambda *a: launched.append("flash") or a[0])
    monkeypatch.setattr(ops, "pwl_activation_cuda",
                        lambda *a: launched.append("pwl") or a[0])
    x = torch.randn(2, 8, 16, requires_grad=True)
    call = ((lambda: ops.flash_attention(x, x, x, True))
            if wrapper == "flash_attention"
            else (lambda: ops.pwl_activation(x, "silu_pwl4")))
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert launched == []
    with torch.no_grad():
        call()
    assert len(launched) == 1


def test_serving_route_under_grad_raises(monkeypatch):
    """The serving stack, differentiated on the card's route, stops at the
    first kernel instead of returning a cut gradient."""
    jc, tc = _cfgs("tiny")
    _, tp = _params(jc)
    _, tb = _batches(jc, tc, 2, 16)
    _on_card(monkeypatch)
    monkeypatch.setattr(ops, "_route", lambda impl, t: "cuda")
    live = {k: v for k, v in tp.items()}
    live["embed"] = {"table": tp["embed"]["table"].clone().requires_grad_()}
    with pytest.raises(RuntimeError, match="no backward"):
        TM._stack(live, tb, tc, "cuda")


def test_loss_fn_rejects_unported_families():
    """The recurrent block patterns, once refused, now train: ``loss_fn``
    of zamba2 and rwkv6 at their reduced configs within LOSS_RTOL of the
    reference's on the stream's batch (their gradients:
    ``tests/test_torch_lm_recurrent.py``)."""
    for arch in ("zamba2-7b", "rwkv6-1.6b"):
        jc, tc = _cfgs(arch)
        jp, tp = _params(jc)
        jb, tb = _batches(jc, tc, 2, 64, seed=3)
        want = float(JM.loss_fn(jp, jb, jc))
        got = TM.loss_fn(tp, tb, tc)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= LOSS_RTOL * abs(want)


# --------------------------------------------------------------------------
# the CLI and the roofline
# --------------------------------------------------------------------------
def test_train_cli_runs_reduced_on_the_host(tmp_path, capsys):
    argv = ["--arch", "qwen2-0.5b", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "32", "--checkpoint-every", "2",
            "--ckpt-dir", str(tmp_path)]
    metrics = ttrain_cli.main(argv)
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done at step 4 on cpu" in out
    assert metrics["final_step"] == 4 and len(metrics["history"]) == 4
    mgr = CheckpointManager(str(tmp_path / "qwen2-0.5b-smoke"))
    assert mgr.all_steps() == [2, 4]
    # a second run resumes from the last committed step: nothing left
    assert ttrain_cli.main(argv)["final_step"] == 4


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_cost_matches_reference(arch, reduced):
    jc, tc = jget_config(arch), tget_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for name in SHAPES:
        for kw in (dict(chips=1, tp=1, dp_in_pod=1, pods=1, microbatches=1),
                   dict(chips=256), dict(chips=512, pods=2, remat=False,
                                         quantized=True, kv_quantized=True)):
            want = janalytic.analytic_cost(jc, JSHAPES[name], **kw)
            got = analytic_cost(tc, SHAPES[name], **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
