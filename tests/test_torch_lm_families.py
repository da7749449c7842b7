"""The port's attention families against the live JAX package, on the CPU:
MoE (grok-1), MLA with MoE (deepseek-v3), the vision front end
(llava-next) and the audio encoder (hubert), each at its ``reduced()``
config in float32 (their serving: ``tests/test_torch_lm_families_serve.py``).

The reference's ``init_params`` draws the weights, carried across by
``lm_params_from_numpy``; the batches come from each package's
``synthetic_token_stream`` (tokens, or audio frame embeddings and labels, or
text tokens after image embeddings).  Bounds, as for the dense family
(``tests/test_torch_lm.py``, ``tests/test_torch_lm_train.py``):

* ``forward`` logits within 1e-4 relative (max |diff| over max |logit|);
* ``loss_fn`` within 1e-6 relative, every gradient leaf within 1e-4 of the
  largest value in its leaf (the aux-free router bias, which moves the
  selection only, gets zeros in both);
* the streams bit for bit; deepseek-v3 with its MoE scanned over two
  prefill chunks; the card's routes taken on the host (one
  ``flash_attention`` dispatch per layer, one ``silu_pwl4`` per gated MLP
  or expert stack).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.configs import get_config as jget_config
from repro.lm import model as JM
from repro.train import trainer as JT
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops as tops
from repro_torch.lm import attention as tattn
from repro_torch.lm import layers as tlayers
from repro_torch.lm import mla as tmla
from repro_torch.lm import model as TM
from repro_torch.lm import moe as tmoe
from repro_torch.train import trainer as TT
from repro_torch.train.checkpoint import _flatten

FAMILIES = ("grok-1-314b", "deepseek-v3-671b", "llava-next-mistral-7b",
            "hubert-xlarge")
SEQ = 24  # llava's reduced config prepends 8 image embeddings to 16 tokens


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jget_config(arch).reduced(), **kw)
    tc = dataclasses.replace(tget_config(arch).reduced(), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


_PARAMS = {}


def _params(arch):
    """(reference params, port params) of one reduced config, drawn once."""
    if arch not in _PARAMS:
        jp = jax.jit(JM.init_params, static_argnums=0)(
            jget_config(arch).reduced(), jax.random.PRNGKey(1))
        _PARAMS[arch] = (jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                                  "cpu"))
    return _PARAMS[arch]


def _batches(jc, tc, batch=2, seq=SEQ, seed=1):
    jb = next(JT.synthetic_token_stream(jc, batch, seq, seed=seed))
    tb = next(TT.synthetic_token_stream(tc, batch, seq, seed=seed))
    return jb, tb


def _leaves(tree):
    out = []
    _flatten(tree, out)
    return [l.detach().numpy() for l in out]


# --------------------------------------------------------------------------
# forward, loss, gradients
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    jb, tb = _batches(jc, tc)
    want = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, jb)
    got = TM.forward(tp, tb, tc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.shape == (2, SEQ, tc.vocab_size)
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(arch)
    jb, tb = _batches(jc, tc, seed=2)
    want, jgrads = jax.value_and_grad(JM.loss_fn)(jp, jb, jc)
    got, tgrads = TT.loss_and_grads(tp, tb, tc)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    want_leaves = [np.asarray(l) for l in jax.tree.leaves(jgrads)]
    got_leaves = _leaves(tgrads)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype
        if not w.any():  # router bias; hubert's table and modality_proj
            assert not g.any()
            continue
        assert _rel(g, w) <= 1e-4


def test_only_the_router_bias_may_miss_the_loss():
    """The aux-free router bias (and hubert's token table and
    ``modality_proj``, which frame embeddings bypass) get zeros; any other
    leaf that does not reach the loss (here one a layer stack would skip)
    raises, naming it."""
    jc, tc = _cfgs("deepseek-v3-671b")
    _, tp = _params("deepseek-v3-671b")
    _, tb = _batches(jc, tc, seed=2)
    _, grads = TT.loss_and_grads(tp, tb, tc)
    bias = grads["layers"]["moe"]["router"]["bias"]
    assert bias.shape == tp["layers"]["moe"]["router"]["bias"].shape
    assert not bias.any()
    stray = dict(tp, layers=dict(tp["layers"], stray=torch.ones(3)))
    with pytest.raises(RuntimeError, match="layers/stray does not reach"):
        TT.loss_and_grads(stray, tb, tc)


def test_moe_prefill_chunks_match_reference(monkeypatch):
    """deepseek-v3 with ``moe_prefill_chunk`` 8 at S 16: each MoE layer runs
    over two chunks of 2 x 8 tokens, capacity applied per chunk (factor
    1.0, so experts overflow), in both packages."""
    jc, tc = _cfgs("deepseek-v3-671b", moe_prefill_chunk=8)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                         capacity_factor=1.0))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                         capacity_factor=1.0))
    jp, tp = _params("deepseek-v3-671b")
    jb, tb = _batches(jc, tc, seq=16, seed=3)
    calls = []
    apply_moe = tmoe.apply_moe

    def spy(p, x, *args, **kw):
        calls.append(tuple(x.shape))
        return apply_moe(p, x, *args, **kw)

    monkeypatch.setattr(tmoe, "apply_moe", spy)
    want = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, jb)
    got = TM.forward(tp, tb, tc)
    n_moe = tc.n_layers - tc.moe.first_k_dense
    assert calls == [(2, 8, tc.d_model)] * (2 * n_moe)
    assert _rel(got, want) <= 1e-4


# --------------------------------------------------------------------------
# the card's routes on the host
# --------------------------------------------------------------------------
def test_kernel_routes_dispatch_once_per_layer_and_expert_stack(monkeypatch):
    """deepseek-v3 at the pwl4 gate with the card's routes patched in:
    one ``flash_attention`` dispatch per layer (dh 32 + v padded: the
    reduced MLA), one ``silu_pwl4`` per dense MLP and two per MoE layer
    (the (E, C, f) experts at once, and the shared expert); the logits
    within 1e-4 of the reference's."""
    jc, tc = _cfgs("deepseek-v3-671b", gate_sigmoid="pwl4")
    jp, tp = _params("deepseek-v3-671b")
    counts = {"flash_attention": 0, "pwl_activation": 0}
    for name in counts:
        wrapper = getattr(tops, name)

        def spy(*args, _w=wrapper, _n=name, **kw):
            counts[_n] += 1
            return _w(*args, **kw)
        monkeypatch.setattr(tops, name, spy)
    monkeypatch.setattr(tmla, "on_card", lambda x: True)
    monkeypatch.setattr(tattn, "on_card", lambda x: True)
    monkeypatch.setattr(tlayers, "on_card", lambda x: True)
    jb, tb = _batches(jc, tc, seed=4)
    want = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, jb)
    got = TM.forward(tp, tb, tc)
    n_dense = tc.moe.first_k_dense
    assert counts == {"flash_attention": tc.n_layers,
                      "pwl_activation": n_dense
                      + 2 * (tc.n_layers - n_dense)}
    assert _rel(got, want) <= 1e-4


# --------------------------------------------------------------------------
# the streams, the lowering and the CLIs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,start", [(0, 0), (7, 5)])
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "hubert-xlarge"])
def test_front_end_streams_bit_for_bit(arch, seed, start):
    jc, tc = _cfgs(arch)
    js = JT.synthetic_token_stream(jc, 3, 20, seed=seed, start_step=start)
    ts = TT.synthetic_token_stream(tc, 3, 20, seed=seed, start_step=start)
    for _ in range(2):
        want, got = next(js), next(ts)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert str(got[k].dtype).replace("torch.", "") == str(w.dtype)
            np.testing.assert_array_equal(got[k].numpy(), w)
