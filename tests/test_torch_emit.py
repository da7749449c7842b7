"""The port's C emission (``repro_torch.emit``) against the reference's.

The cells of ``tests/test_emit.py``: the six classifier kinds trained by the
reference's fixed-seed trainers on the seeded blobs data
(``tests/golden/regenerate.py``), carried over with ``model_from_params``,
at the five quantized tags.  For each cell:

* the port's ``emit_c()`` is the reference's text, character for character,
  after the first ``/* ... */`` comment (which names the emitting package);
  both packages' ``emit_spec`` are already equal byte for byte, so a
  difference here would be the emitter's;
* the C built by the host's compiler (the port's ``emit`` backend) replays
  the reference's ``emit`` labels and the port's ``ref`` and ``cuda``
  (plain kernel versions on the host) labels on every row, on the test rows
  and on rows at 10x the data's scale (saturating inputs).

Then the source-level contracts (integer-only text, deterministic
emission, the same rejections), ``report(measure_c=True)`` (the same
measured sections as the reference's), and the toolchain's absence.
"""

import dataclasses

import jax
import numpy as np
import pytest

from golden import regenerate as G

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro import emit as jemit
from repro_torch import compile as tcompile
from repro_torch import emit as temit
from repro_torch.compile.lowerings.lm import cfg_from_dict
from repro_torch.convert import lm_params_from_numpy, model_from_params
from repro_torch.kernels import ops

KINDS = ("tree", "logistic", "mlp", "svm-linear", "svm-poly", "svm-rbf")
QUANT_TAGS = tuple(t for t in G.CLASSIFIER_TARGETS if t != "flt")
CELLS = [(k, t) for k in KINDS for t in QUANT_TAGS]

needs_cc = pytest.mark.skipif(temit.find_cc() is None,
                              reason="no C compiler (cc/gcc/clang) on PATH")


@pytest.fixture(scope="module")
def dataset():
    return G.make_dataset()


@pytest.fixture(scope="module")
def models(dataset):
    """kind -> (reference model, the port's model of the same params)."""
    xtr, ytr, _, c = dataset
    out = {}
    for kind, m in G.train_classifiers(xtr, ytr, c).items():
        params = jcompile.get_lowering(kind).extract_params(m)
        out[kind] = (m, model_from_params(kind, params))
    return out


def _compile(models, dataset, kind, tag, backend, port_backend=None):
    """(reference artifact on ``backend``, port artifact on
    ``port_backend`` or the same, on the host)."""
    jm, tm = models[kind]
    kw = G.CLASSIFIER_TARGETS[tag]
    cal = dataset[0] if tag in G.CALIBRATED_TAGS else None
    jart = jcompile.compile(jm, jcompile.Target(backend=backend, **kw),
                            calibration=cal)
    tart = tcompile.compile(tm, tcompile.Target(
        backend=port_backend or backend, **kw), calibration=cal, device="cpu")
    return jart, tart


def _body(src: str) -> str:
    """The translation unit after its first comment (the header)."""
    assert src.startswith("/*")
    return src[src.index("*/") + 2:]


@pytest.mark.parametrize("kind,tag", CELLS)
def test_emitted_c_equals_reference(models, dataset, kind, tag):
    jart, tart = _compile(models, dataset, kind, tag, "ref")
    src = tart.emit_c()
    assert _body(src) == _body(jart.emit_c())
    assert src.startswith("/* Generated by repro_torch.emit")
    assert f"kind={kind} target={tart.target.number_format}" in src
    temit.assert_integer_only(src)
    assert src == tart.emit_c() == temit.emit_artifact_c(tart)
    assert (temit.input_format(temit.spec_of(tart)).total_bits
            == jemit.input_format(jemit.spec_of(jart)).total_bits)


@needs_cc
@pytest.mark.parametrize("kind,tag", CELLS)
def test_compiled_c_replays_reference_and_port_labels(models, dataset, kind,
                                                      tag):
    """The port's ``emit`` backend (the C, built freestanding and replayed
    by the host's compiler) against the reference's ``emit`` backend and the
    port's ``ref`` and ``cuda`` artifacts, label for label."""
    _, _, xte, _ = dataset
    rows = np.concatenate([xte, np.random.RandomState(7).randn(64, 12)
                           .astype(np.float32) * 10.0])
    jart, tart = _compile(models, dataset, kind, tag, "emit")
    got = tart.predict(rows)
    assert got.dtype == np.int32 and got.shape == (len(rows),)
    np.testing.assert_array_equal(got, jart.predict(rows))
    for backend in ("ref", "cuda"):
        _, other = _compile(models, dataset, kind, tag, "ref", backend)
        np.testing.assert_array_equal(got, other.predict(rows),
                                      err_msg=backend)
    labels, stats = tart.predict_with_stats(rows[:5])
    np.testing.assert_array_equal(labels, got[:5])
    assert stats["total"] == 5 * rows.shape[1]


@needs_cc
def test_emit_backend_launches_nothing_and_pads_fixed_batches(models,
                                                              dataset):
    _, _, xte, _ = dataset
    _, tm = models["mlp"]
    art = tcompile.compile(tm, tcompile.Target(number_format="fxp16",
                                               backend="emit"), device="cpu")
    fixed = tcompile.compile(tm, tcompile.Target(
        number_format="fxp16", backend="emit", batch_policy="fixed",
        batch_size=32), device="cpu")
    with ops.count_dispatches() as c:
        want = art.predict(xte)
        got = np.concatenate([fixed.predict(xte[i:i + 32])
                              for i in range(0, len(xte), 32)])
    assert c.count == 0
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="batch_size"):
        fixed.predict(xte[:33])


SNIPPETS = ["double x = 1;", "float f;", "long double d;",
            "int32_t x = (int32_t)1.5;", "int32_t x = 1e3;",
            "uint64_t u = 0x1.8p3;", "#include <math.h>",
            "int32_t half = .5;"]


@pytest.mark.parametrize("snippet", SNIPPETS)
def test_assert_integer_only_rejects_what_the_reference_rejects(snippet):
    src = f"#include <stdint.h>\n{snippet}\n"
    with pytest.raises(jemit.EmitError) as jerr:
        jemit.assert_integer_only(src)
    with pytest.raises(temit.EmitError) as terr:
        temit.assert_integer_only(src)
    assert str(terr.value) == str(jerr.value)


def test_assert_integer_only_accepts_comments_and_ints():
    src = ("#include <stdint.h>\n"
           "/* float semantics note: 1.5 would round to 2 */\n"
           "static const int32_t x = 15;\n")
    jemit.assert_integer_only(src)
    temit.assert_integer_only(src)


def test_literals_print_python_ints():
    """``_ci`` and ``_carray`` print the same text from a Python int, a
    numpy or torch integer, a 0-d tensor and -0."""
    import torch

    from repro.emit import cgen as jcgen
    from repro_torch.emit import cgen as tcgen

    for v in (0, -0, 7, -(2 ** 31), 2 ** 31, -(2 ** 63), 2 ** 40):
        want = jcgen._ci(v)
        for form in (v, np.int64(v), torch.tensor(v)):
            assert tcgen._ci(form) == want
    assert tcgen._ci(np.float32(-0.0)) == "0"
    arr = np.arange(-40, 40, dtype=np.int16).reshape(8, 10)
    assert (tcgen._carray("A", torch.from_numpy(arr), "int16_t")
            == jcgen._carray("A", arr, "int16_t"))


def test_float_target_and_lm_rejected(models):
    jm, tm = models["mlp"]
    for pkg, emit_mod, m, kw in (
            (jcompile, jemit, jm, {}), (tcompile, temit, tm,
                                        dict(device="cpu"))):
        with pytest.raises(TypeError, match="quantized"):
            pkg.compile(m, pkg.Target(number_format="flt", backend="emit"),
                        **kw)
        flt = pkg.compile(m, pkg.Target(number_format="flt"), **kw)
        with pytest.raises(emit_mod.EmitError, match="quantized"):
            flt.emit_c()
    jlm = G.make_lm_model()
    tlm = tcompile.LMModel(cfg_from_dict(dataclasses.asdict(jlm.cfg)),
                           lm_params_from_numpy(
                               jax.tree.map(np.asarray, jlm.params), "cpu"))
    target = dict(backend="emit", **G.LM_TARGETS["fxp8_qnm_pwl4"])
    with pytest.raises(TypeError, match="emit") as jerr:
        jcompile.compile(jlm, jcompile.Target(**target))
    with pytest.raises(TypeError, match="emit") as terr:
        tcompile.compile(tlm, tcompile.Target(**target), device="cpu")
    assert str(terr.value) == str(jerr.value)


@needs_cc
@pytest.mark.parametrize("tag", ["fxp16", "auto8"])
@pytest.mark.parametrize("kind", KINDS)
def test_report_measures_the_reference_sections(models, dataset, kind, tag):
    """``report(measure_c=True)`` compiles the C freestanding and gives the
    reference's section sizes; ``"auto"`` measures on ``emit``; the rest of
    the report (model bytes, formats, accuracy against a float recompile)
    equals the reference's."""
    xtr, ytr = dataset[0][:128], dataset[1][:128]
    jart, tart = _compile(models, dataset, kind, tag, "ref")
    want = jart.report(measure_c=True)
    got = tart.report(measure_c=True)
    assert got["c_sections"] == want["c_sections"]
    sec = got["c_sections"]
    assert sec["flash"] == sec["text"] + sec["rodata"] + sec["data"] > 0
    assert got["model_bytes_measured"] == sec["flash"]
    assert got["model_bytes"] == want["model_bytes"] == tart.flash_bytes
    assert "c_sections" not in tart.report()  # auto: the ref backend
    _, emit_art = _compile(models, dataset, kind, tag, "ref", "emit")
    assert emit_art.report()["c_sections"] == sec
    full_j, full_t = jart.report(xtr, ytr), tart.report(xtr, ytr)
    for key in ("formats", "accuracy", "accuracy_float", "accuracy_delta",
                "number_format", "kind", "sram_bytes"):
        assert full_t[key] == full_j[key], key
    assert full_t["saturation"]["total"] == int(full_j["saturation"]
                                                ["total"])


def test_no_toolchain_raises_emit_toolchain_error(models, dataset,
                                                  monkeypatch):
    """Without a C compiler the ``emit`` backend's first predict and a
    forced measurement raise; ``"auto"`` falls back to the estimate, as the
    reference's does; emission itself needs no compiler."""
    monkeypatch.setattr("repro_torch.emit.harness.find_cc", lambda: None)
    _, tm = models["logistic"]
    art = tcompile.compile(tm, tcompile.Target(number_format="fxp16",
                                               backend="emit"), device="cpu")
    assert "emb_predict" in art.emit_c()
    with pytest.raises(temit.EmitToolchainError, match="no C compiler"):
        art.predict(dataset[2])
    with pytest.raises(temit.EmitToolchainError):
        art.report(measure_c=True)
    rep = art.report()
    assert "c_sections" not in rep and rep["model_bytes"] > 0
    with pytest.raises(temit.EmitToolchainError, match="no C compiler"):
        temit.CRunner(art.emit_c(), temit.input_format(temit.spec_of(art)))


@needs_cc
def test_crunner_mechanics(models, dataset):
    """Direct harness use: sizes() buckets, a 1-D row, a tensor input, and
    the build directory reclaimed on close."""
    import os

    import torch

    _, _, xte, _ = dataset
    _, tm = models["logistic"]
    art = tcompile.compile(tm, tcompile.Target(number_format="fxp16"),
                           device="cpu")
    spec = temit.spec_of(art)
    with temit.CRunner(art.emit_c(), temit.input_format(spec)) as runner:
        tmpdir = runner.tmpdir
        sizes = runner.sizes()
        assert set(sizes) == {"text", "rodata", "data", "bss", "flash"}
        assert sizes == temit.measure_artifact(art)
        labels, stats = runner.predict(xte[0])
        assert labels.shape == (1,) and labels.dtype == np.int32
        assert int(stats.total) == xte.shape[1]
        batch, _ = runner.predict(torch.from_numpy(xte[:5]))
        np.testing.assert_array_equal(batch, art.predict(xte[:5]))
        assert os.path.isdir(tmpdir)
    assert not os.path.exists(tmpdir)
