"""The port's flash_attention against the live JAX package, on the CPU.

The same seeded numpy inputs go through the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and its oracle ``flash_attention_ref``,
and through the port's ``ops.flash_attention`` on CPU tensors (the kernel's
plain version, which is what the CUDA kernel is held to on the card) and
its oracle.  Bounds are the reference's own (``tests/test_kernels.py``):
atol 2e-5 in float32, 3e-2 in bfloat16 (one rounding of a bf16 output
near 2-4 is 1.6e-2).  The CUDA kernel itself is tested on the card in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro.kernels import ops as jops
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.lm import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _qkv(seed, bh, s, dh):
    rng = np.random.RandomState(seed)
    return [rng.randn(bh, s, dh).astype(np.float32) for _ in range(3)]


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,bq,bk", [(128, 64, 64), (256, 128, 64),
                                     (64, 64, 64)])
def test_flash_attention_matches_reference_kernel(causal, s, bq, bk):
    """The reference test's shapes (dh 32), against the Pallas kernel in
    interpret mode and against the reference oracle."""
    arrays = _qkv(s + causal, 2, s, 32)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, arrays),
                                           causal=causal, bq=bq, bk=bk))
    want_ref = np.asarray(jref.flash_attention_ref(*map(jnp.asarray, arrays),
                                                   causal=causal))
    got = tops.flash_attention(*_port(arrays), causal=causal).numpy()
    got_ref = tref.flash_attention_ref(*_port(arrays), causal=causal).numpy()
    for g in (got, got_ref):
        np.testing.assert_allclose(g, want, atol=2e-5)
        np.testing.assert_allclose(g, want_ref, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 12, 100])
def test_flash_attention_ragged_lengths(causal, s):
    """Any S (the LM's prefill lengths are arbitrary): the reference kernel
    takes one block of S there (bq = bk = min(512, S))."""
    arrays = _qkv(7 * s + causal, 3, s, 64)
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, arrays),
                                           causal=causal))
    got = tops.flash_attention(*_port(arrays), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if causal:  # the first query sees only the first key
        np.testing.assert_array_equal(got[:, 0], arrays[2][:, 0])


def test_flash_attention_bf16():
    arrays = _qkv(7, 2, 128, 64)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    want = np.asarray(jops.flash_attention(*jin, bq=64, bk=64), np.float32)
    tin = _port(arrays, torch.bfloat16)
    got = tops.flash_attention(*tin)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2)
    want_ref = np.asarray(jref.flash_attention_ref(*jin), np.float32)
    np.testing.assert_allclose(tref.flash_attention_ref(*tin).float().numpy(),
                               want_ref, atol=3e-2)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _port(_qkv(3, 2, 64, 32))
    before = tfa.flash_attention_cuda.launches
    with tops.count_dispatches() as c:
        got = tops.flash_attention(q, k, v)
    assert c.count == 1 and tfa.flash_attention_cuda.launches == before
    torch.testing.assert_close(got, tfa.flash_attention_plain(q, k, v),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="one shape"):
        tops.flash_attention(q, k[:, :32], v)
    with pytest.raises(TypeError, match="dtype"):
        tops.flash_attention(q, k.double(), v)
    with pytest.raises(KeyError, match="impl"):
        tops.flash_attention(q, k, v, impl="pallas")
    # grouped K/V: BH / G rows, G read off the shapes and dividing BH
    k3, v3 = torch.cat([k, k[:1]]), torch.cat([v, v[:1]])
    with pytest.raises(ValueError, match="BH / G"):
        tops.flash_attention(q, k3, v3)
    with pytest.raises(ValueError, match="BH / G"):
        tops.flash_attention(q, k[:, :32], v[:, :32])
    with pytest.raises(ValueError, match="BH / G"):
        tops.flash_attention(q, k[:0], v[:0])
    assert tfa.check_shapes(q, k[:1], v[:1]) == 2
    assert torch.equal(tfa.expand_kv(k[:1], 2), k[:1].expand_as(q))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 7])
def test_flash_attention_gqa_matches_reference_kernel(causal, group):
    """Grouped-query attention in the kernel's function: K/V with BH / G
    rows, query row b*H + h reading KV row (b*H + h) // G = b*(H/G) + h//G,
    against the Pallas kernel (interpret mode) on K/V repeated with
    np.repeat."""
    b, h, s, dh = 2, 14, 64, 32
    rng = np.random.RandomState(100 + 2 * group + causal)
    q = rng.randn(b * h, s, dh).astype(np.float32)
    k, v = (rng.randn(b * h // group, s, dh).astype(np.float32)
            for _ in range(2))
    k_rep, v_rep = (np.repeat(t.reshape(b, h // group, s, dh), group, axis=1)
                    .reshape(b * h, s, dh) for t in (k, v))
    want = np.asarray(jfa.flash_attention_pallas(
        *map(jnp.asarray, (q, k_rep, v_rep)), causal=causal, bq=32, bk=32,
        interpret=True))
    tq, tk, tv = _port((q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    plain = tfa.flash_attention_plain(tq, tk, tv, causal)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-5)
    ref = tops.flash_attention(tq, tk, tv, causal=causal, impl="ref")
    np.testing.assert_allclose(ref.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh,padded", [(56, 64), (80, 128), (112, 128),
                                       (20, 32), (64, 64)])
def test_head_dim_padding_is_exact_through_the_plain_version(causal, dh,
                                                             padded):
    """The CUDA wrapper zero-pads dh to the kernel's next instance and keeps
    the true 1/sqrt(dh) scale (``pad_head_dim``): through the plain version,
    the padded attention sliced back to dh equals the unpadded one, and the
    padded output columns are zero.  The sums only gain exact zeros, so the
    bound is float32 rounding (2e-6)."""
    q, k, v = _port(_qkv(dh, 6, 37, dh))
    k, v = k[:3], v[:3]  # G 2, as the grouped kernel takes them
    pq, pk, pv, scale = tfa.pad_head_dim(q, k, v)
    assert pq.shape == (6, 37, padded) and pk.shape == (3, 37, padded)
    assert scale == float(np.float32(1.0 / np.sqrt(dh)))
    got = tfa.flash_attention_plain(pq, pk, pv, causal, scale)
    want = tfa.flash_attention_plain(q, k, v, causal)
    np.testing.assert_allclose(got[..., :dh].numpy(), want.numpy(), rtol=0,
                               atol=2e-6)
    assert not got[..., dh:].any()
    # and the unpadded plain version is the reference's oracle
    ref = jref.flash_attention_ref(*(jnp.asarray(t.numpy()) for t in
                                     (q, tfa.expand_kv(k, 2),
                                      tfa.expand_kv(v, 2))), causal)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref), rtol=0,
                               atol=2e-5)


def test_head_dim_above_the_largest_instance_raises():
    q = torch.zeros(1, 4, tfa.HEAD_DIMS[-1] + 1)
    with pytest.raises(ValueError, match="head dims up to"):
        tfa.pad_head_dim(q, q, q)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_head_dim_with_padded_v_matches_reference_kernel(causal):
    """MLA's shape on the kernel's dh-192 instance: q and k of 128 + 64
    dims, v of 128 zero-padded to 192 (``src/repro/lm/mla.py``'s padding),
    against the Pallas kernel in interpret mode at the same padded inputs;
    the padded output columns are zero, and the first 128 are the attention
    over the unpadded v."""
    q, k, v = _qkv(192, 2, 128, 192)
    v[..., 128:] = 0.0
    want = np.asarray(jops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=causal, bq=64, bk=64))
    got = tops.flash_attention(*_port((q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert not got[..., 128:].any()
    # the unpadded v gives the same first 128 columns (the scale is q.k's)
    tq, tk, tv = _port((q, k, v))
    short = tref.flash_attention_ref(tq, tk, tv[..., :128], causal)
    np.testing.assert_allclose(got[..., :128], short.numpy(), atol=2e-6)


def _fold(t):
    """(B, S, H, dh) -> (B*H, S, dh), the LM's layout for the kernel."""
    b, s, h, dh = t.shape
    return t.transpose(1, 2).reshape(b * h, s, dh)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 63, 64, 65, 127, 128, 133])
def test_flash_attention_window_matches_reference_attention(causal, window):
    """A sliding window (the score at (q, k) masked where q - k >= window,
    causal or not) in the kernel's function, against the reference LM's
    ``blockwise_attention`` (chunk 32, the mask the TPU kernel's docstring
    names as its source) and ``full_attention`` with the same window, at
    S 128, 8 query heads over 2 KV heads (G 4): windows of 1, around the
    tile width, S - 1, S and above S."""
    b, s, hq, hkv, dh = 2, 128, 8, 2, 32
    rng = np.random.RandomState(window + 1000 * causal)
    q = rng.randn(b, s, hq, dh).astype(np.float32)
    k, v = (rng.randn(b, s, hkv, dh).astype(np.float32) for _ in range(2))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_block = np.asarray(jattn.blockwise_attention(jq, jk, jv, causal, 32,
                                                      window))
    want_full = np.asarray(jattn.full_attention(jq, jk, jv, causal, window))
    tq, tk, tv = (_fold(torch.from_numpy(a)) for a in (q, k, v))
    for got in (tfa.flash_attention_plain(tq, tk, tv, causal, window=window),
                tops.flash_attention(tq, tk, tv, causal, window=window),
                tref.flash_attention_ref(tq, tfa.expand_kv(tk, 4),
                                         tfa.expand_kv(tv, 4), causal,
                                         window=window)):
        got = got.view(b, hq, s, dh).transpose(1, 2).numpy()
        np.testing.assert_allclose(got, want_block, atol=2e-5)
        np.testing.assert_allclose(got, want_full, atol=2e-5)
    if window == 1 and causal:  # each query sees only its own key
        np.testing.assert_allclose(got, np.repeat(v, 4, axis=2), atol=1e-6)
    if window >= s and causal:  # no key is left out: the causal function
        np.testing.assert_array_equal(
            tfa.flash_attention_plain(tq, tk, tv, causal, window=window),
            tfa.flash_attention_plain(tq, tk, tv, causal))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_window_at_ragged_lengths(causal):
    """Any S with a window (S 100 and 1, window 7): against the reference's
    ``full_attention``, which the LM takes when the chunk does not divide
    S."""
    for s in (1, 100):
        rng = np.random.RandomState(s)
        q, k, v = (rng.randn(1, s, 4, 64).astype(np.float32)
                   for _ in range(3))
        want = np.asarray(jattn.full_attention(*map(jnp.asarray, (q, k, v)),
                                               causal, 7))
        got = tops.flash_attention(*(_fold(torch.from_numpy(a))
                                     for a in (q, k, v)), causal, window=7)
        np.testing.assert_allclose(
            got.view(1, 4, s, 64).transpose(1, 2).numpy(), want, atol=2e-5)


def test_window_must_be_a_positive_int():
    q, k, v = _port(_qkv(3, 2, 16, 32))
    for bad in (0, -4, 2.5):
        with pytest.raises(ValueError, match="window"):
            tops.flash_attention(q, k, v, window=bad)
    assert tfa.check_window(None) == 0 and tfa.check_window(5) == 5


_CSRC = Path(tfa.__file__).with_name("csrc") / "flash_attention.cu"
_ROOFLINE = (Path(__file__).resolve().parents[1] / "bench" / "metrics"
             / "flash_attention_roofline.py")


def test_every_kernel_carries_the_name_the_roofline_metric_sums():
    """The benchmark's ``flash_attention_roofline`` sums the device time of
    kernels whose names hold its ``KERNEL``: each ``__global__`` function of
    the source (the bfloat16 ones among them) must hold it, or the metric
    reads null."""
    name = re.search(r'^KERNEL = "(\w+)"', _ROOFLINE.read_text(), re.M)[1]
    text = _CSRC.read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(", text)
    bf16 = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                      r"\s+)?(\w+)\s*\(",
                      text[text.index("namespace bf16 {"):
                           text.index("}  // namespace bf16")])
    assert bf16 and set(bf16) <= set(kernels)
    assert all(name in k for k in kernels), (name, kernels)


def test_wgmma_head_dims_match_the_launcher():
    """The wrapper counts ``wgmma_launches`` for the head dims it believes
    run on the warpgroup-MMA design: those are the source's ``bf16::Tile``
    instances, and the launcher sends every bfloat16 instance there."""
    text = _CSRC.read_text()
    tiles = {int(d) for d in re.findall(r"template <>\s*struct Tile<(\d+)>",
                                        text)}
    assert tiles == set(tfa.WGMMA_HEAD_DIMS)
    assert set(tfa.WGMMA_HEAD_DIMS) <= set(tfa.HEAD_DIMS)
    cases = {int(d) for d in re.findall(r"case (\d+):", text)}
    assert cases == set(tfa.HEAD_DIMS)
    assert "return bf16::launch<DH>(" in text
