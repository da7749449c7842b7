"""The port's MLP compile -> predict path against the reference, end to end.

For MLPs 12->16->3 and 12->16->8->3 with seeded numpy parameters, at every
quantized tag: the port's ``cuda`` backend on a CPU device (the kernels'
plain versions) gives the reference ``pallas`` labels, its ``ref`` backend
the reference ``ref`` labels and stats, bit for bit; the frozen program
(``emit_spec``), the QuantPlan descriptor and the kernel routing are equal,
also with the per-layer route forced.
"""

import numpy as np
import pytest

from _torch_port_cases import QUANT_TAGS, PairCache, assert_same_spec

MODELS = ("mlp1", "mlp2")


@pytest.fixture(scope="module")
def cases(blobs):
    x_train, y_train, x_test, _, _ = blobs
    return PairCache(x_train, y_train), x_test


@pytest.mark.parametrize("tag", QUANT_TAGS)
@pytest.mark.parametrize("name", MODELS)
def test_cuda_backend_matches_pallas(cases, name, tag):
    cache, x = cases
    jart, tart = cache.pair(name, tag, "cuda")
    assert tart.kernel_strategy == jart.kernel_strategy == "megakernel"
    assert tart.plan_key == jart.plan_key
    assert tart.fingerprint == jart.fingerprint
    assert_same_spec(jart.extras["emit_spec"], tart.extras["emit_spec"])
    np.testing.assert_array_equal(tart.predict(x), jart.predict(x))
    # a ragged batch and a single row take the same route
    np.testing.assert_array_equal(tart.predict(x[:7]), jart.predict(x[:7]))
    np.testing.assert_array_equal(tart.predict(x[:1]), jart.predict(x[:1]))


@pytest.mark.parametrize("tag", QUANT_TAGS)
@pytest.mark.parametrize("name", MODELS)
def test_ref_backend_matches_ref(cases, name, tag):
    cache, x = cases
    jart, tart = cache.pair(name, tag, "ref")
    assert tart.plan_key == jart.plan_key
    assert_same_spec(jart.extras["emit_spec"], tart.extras["emit_spec"])
    jlab, jstats = jart.predict_with_stats(x)
    tlab, tstats = tart.predict_with_stats(x)
    np.testing.assert_array_equal(tlab, jlab)
    assert tstats == jstats


@pytest.mark.parametrize("tag", QUANT_TAGS)
@pytest.mark.parametrize("name", MODELS)
def test_forced_per_layer_route_matches(cases, name, tag):
    cache, x = cases
    jart, tart = cache.pair(name, tag, "cuda", per_layer=True)
    assert tart.kernel_strategy == jart.kernel_strategy == "per-layer"
    assert tart.cache_key != cache.pair(name, tag, "cuda")[1].cache_key
    np.testing.assert_array_equal(tart.predict(x), jart.predict(x))
    mega = cache.pair(name, tag, "cuda")[1]
    np.testing.assert_array_equal(tart.predict(x), mega.predict(x))
