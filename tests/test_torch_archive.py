"""The port's artifact archives (``save``/``load``) against the reference's.

The six classifier kinds trained by the reference's fixed-seed trainers on
the seeded blobs data (``tests/golden/regenerate.py``), carried over with
``model_from_params``, at ``flt`` and every quantized tag, on ``ref`` and
on the port's ``cuda`` (the reference's ``pallas``):

* an archive the reference saves loads in the port (``device="cpu"``), and
  one the port saves loads in the reference; labels are equal bit for bit
  at the quantized tags and on the test rows at ``flt``;
* ``include_c``: the C either package's archive carries equals the port's
  ``emit_c()`` after the header comment;
* the port's msgpack writes every archive container of the matrix byte for
  byte as ``msgpack.packb`` does and decodes it as ``msgpack.unpackb`` does.

The reference's ``pallas`` tree compile raises on the installed JAX, so its
tree archives for the port's ``cuda`` are saved on ``xla`` (which the port
reads as ``cuda``), and the port's ``cuda`` tree archive is checked on the
port's side; the port-to-reference direction for trees saves a ``ref``
tree.  Then an LM archive with bfloat16 leaves, the integrity failures
(mirroring ``tests/test_reliability.py``), atomic saves, and zlib and zstd
archives across the two packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _hypothesis_shim import given, settings, st
from golden import regenerate as G

import repro  # noqa: F401  (enables jax x64, as the reference runs)
from repro import compile as jcompile
from repro.compile import artifact as jartifact
from repro.configs import get_config as jget_config
from repro.lm import model as JM
from repro.train import checkpoint as jckpt
from repro_torch import compile as tcompile
from repro_torch.compile import artifact as tartifact
from repro_torch.compile.lowerings.lm import cfg_from_dict
from repro_torch.convert import lm_params_from_numpy, model_from_params
from repro_torch.serve import FaultPlan, FaultRule, faults
from repro_torch.train import checkpoint as tckpt

KINDS = ("tree", "logistic", "mlp", "svm-linear", "svm-poly", "svm-rbf")
TAGS = tuple(G.CLASSIFIER_TARGETS)
CELLS = [(k, t, b) for k in KINDS for t in TAGS for b in ("ref", "cuda")]


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


def _ref_compile(models, dataset, kind, tag, backend):
    kw = G.CLASSIFIER_TARGETS[tag]
    cal = dataset[0] if tag in G.CALIBRATED_TAGS else None
    return jcompile.compile(models[kind][0],
                            jcompile.Target(backend=backend, **kw),
                            calibration=cal)


def _port_compile(models, dataset, kind, tag, backend):
    kw = G.CLASSIFIER_TARGETS[tag]
    cal = dataset[0] if tag in G.CALIBRATED_TAGS else None
    return tcompile.compile(models[kind][1],
                            tcompile.Target(backend=backend, **kw),
                            calibration=cal, device="cpu")


def _container(path):
    """The decompressed msgpack container of an archive."""
    with open(path, "rb") as f:
        return tckpt.decompress_bytes(f.read())


def _members(path):
    """The v3 archive's members, decoded with the port's codec."""
    payload = tckpt.unpackb(_container(path))
    return {k: tckpt.unpackb(v) for k, v in payload["members"].items()}


def _assert_codec_matches_msgpack(path):
    raw = _container(path)
    want = msgpack.unpackb(raw, raw=False, strict_map_key=False)
    got = tckpt.unpackb(raw)
    assert got == want
    assert tckpt.packb(got) == msgpack.packb(want, use_bin_type=True) == raw
    for name, blob in got["members"].items():
        member = msgpack.unpackb(blob, raw=False, strict_map_key=False)
        assert tckpt.unpackb(blob) == member, name
        assert tckpt.packb(member) == blob, name


def _body(src):
    assert src.startswith("/*")
    return src[src.index("*/") + 2:]


def _assert_same_labels(got, want, tag):
    assert got.dtype == np.int32 and got.shape == want.shape
    if tag == "flt":
        assert (got == want).mean() == 1.0, "flt labels differ on test rows"
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,tag,backend", CELLS)
def test_reference_archive_loads_in_port(models, dataset, tmp_path, kind,
                                         tag, backend):
    _, _, xte, _ = dataset
    jbackend = {"ref": "ref", "cuda": "xla" if kind == "tree" else "pallas"}
    jart = _ref_compile(models, dataset, kind, tag, jbackend[backend])
    path = str(tmp_path / "ref.embml")
    jart.save(path, include_c=tag != "flt")
    _assert_codec_matches_msgpack(path)
    tart = tcompile.load(path, device="cpu")
    assert tart.target.backend == backend
    assert tart.kind == kind and tart.device.type == "cpu"
    _assert_same_labels(tart.predict(xte), jart.predict(xte), tag)
    if tag != "flt":
        assert _body(_members(path)["metadata"]["emit_c"]) == \
            _body(tart.emit_c())
        assert (tart.quant_plan is None) == (jart.quant_plan is None)
        if tart.quant_plan is not None:
            assert tart.quant_plan.descriptor() == jart.quant_plan.descriptor()


@pytest.mark.parametrize("kind,tag,backend", CELLS)
def test_port_archive_loads_in_reference(models, dataset, tmp_path, kind,
                                         tag, backend):
    _, _, xte, _ = dataset
    saved = "ref" if kind == "tree" else backend
    tart = _port_compile(models, dataset, kind, tag, saved)
    path = str(tmp_path / "port.embml")
    tart.save(path, metadata={"by": "port"}, include_c=tag != "flt")
    _assert_codec_matches_msgpack(path)
    members = _members(path)
    assert members["target"]["backend"] == {"ref": "ref",
                                            "cuda": "pallas"}[saved]
    assert members["metadata"]["by"] == "port"
    jart = jcompile.load(path)
    assert jart.target.backend == members["target"]["backend"]
    _assert_same_labels(jart.predict(xte), tart.predict(xte), tag)
    if tag != "flt":
        assert _body(members["metadata"]["emit_c"]) == _body(tart.emit_c())
    again = tcompile.load(path, device="cpu")  # and back in the port
    assert again.target == tart.target and again.cache_key == tart.cache_key
    np.testing.assert_array_equal(again.predict(xte), tart.predict(xte))


@pytest.mark.parametrize("tag", ["fxp16", "auto8", "flt"])
def test_port_cuda_tree_archive_names_pallas(models, dataset, tmp_path, tag):
    _, _, xte, _ = dataset
    tart = _port_compile(models, dataset, "tree", tag, "cuda")
    path = str(tmp_path / "tree.embml")
    tart.save(path)
    assert _members(path)["target"]["backend"] == "pallas"
    again = tcompile.load(path, device="cpu")
    assert again.target.backend == "cuda"
    np.testing.assert_array_equal(again.predict(xte), tart.predict(xte))


def test_target_fields_match_reference():
    names = [f.name for f in dataclasses.fields(jcompile.Target)]
    assert names == [f.name for f in dataclasses.fields(tcompile.Target)]
    assert len(names) == 8
    assert set(tartifact._BACKEND_IN) >= set(jcompile.BACKENDS)
    assert set(tartifact._BACKEND_OUT) == set(tcompile.BACKENDS)
    assert set(tartifact._BACKEND_OUT.values()) <= set(jcompile.BACKENDS)


def test_unknown_backend_raises(models, dataset, tmp_path):
    tart = _port_compile(models, dataset, "logistic", "fxp16", "ref")
    path = str(tmp_path / "odd.embml")
    tart.save(path)
    payload = tckpt.unpackb(_container(path))
    members = {k: tckpt.unpackb(v) for k, v in payload["members"].items()}
    members["target"]["backend"] = "tpu9"
    _rewrite(path, payload, members)
    with pytest.raises(ValueError, match="tpu9"):
        tcompile.load(path, device="cpu")


def _rewrite(path, payload, members, checksum=True):
    """Write ``members`` back into the archive's container (recomputing the
    checksums unless ``checksum`` is False)."""
    import hashlib

    for name, value in members.items():
        blob = tckpt.packb(value)
        payload["members"][name] = blob
        if checksum:
            payload["integrity"]["members"][name] = \
                hashlib.sha256(blob).hexdigest()
    with open(path, "wb") as f:
        f.write(tckpt.compress_bytes(tckpt.packb(payload)))


# --------------------------------------------------------------------------
# an LM archive
# --------------------------------------------------------------------------
def test_reference_lm_archive_loads_in_port(tmp_path):
    cfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                              dtype="bfloat16")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    assert {str(l.dtype) for l in jax.tree.leaves(jp)} == {"bfloat16"}
    jart = jcompile.compile(jcompile.LMModel(cfg, jp),
                            jcompile.Target(number_format="flt"))
    path = str(tmp_path / "lm.embml")
    jart.save(path)
    _assert_codec_matches_msgpack(path)
    loaded = tcompile.load(path, device="cpu")
    assert loaded.kind == "lm"
    want = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    flat_l = jax.tree.leaves(loaded.params["params"])
    flat_w = jax.tree.leaves(want)
    assert len(flat_l) == len(flat_w)
    for a, b in zip(flat_l, flat_w):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    direct = tcompile.compile_from_params(
        "lm", {"cfg": dataclasses.asdict(cfg), "params": want},
        tcompile.Target(number_format="flt"), device="cpu")
    tcfg = cfg_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(loaded.extras["cfg"]) == \
        dataclasses.asdict(direct.extras["cfg"]) == dataclasses.asdict(tcfg)
    tok = {"token": torch.tensor([3, 7, 11], dtype=torch.int32)}
    outs = []
    for art in (loaded, direct):
        cache = art.extras["init_cache"](3, 4)
        with torch.inference_mode():
            logits, _ = art.extras["serve_step"](art.extras["params"], cache,
                                                 tok)
        outs.append(logits.float())
    assert torch.isfinite(outs[0]).all()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(loaded.predict(np.array([3, 7, 11])),
                                  direct.predict(np.array([3, 7, 11])))


# --------------------------------------------------------------------------
# integrity (the reference's tests/test_reliability.py archive cases)
# --------------------------------------------------------------------------
@pytest.fixture
def tree_archive(models, dataset, tmp_path):
    art = _port_compile(models, dataset, "tree", "fxp16", "cuda")
    path = str(tmp_path / "tree.embml")
    art.save(path)
    return art, path


def test_roundtrip_keeps_cache_key(tree_archive, dataset):
    art, path = tree_archive
    again = tcompile.load(path, device="cpu")
    np.testing.assert_array_equal(again.predict(dataset[2]),
                                  art.predict(dataset[2]))
    assert again.cache_key == art.cache_key
    assert again.memory_bytes() == art.memory_report()


def test_corrupt_byte_raises_integrity_error(tree_archive):
    _, path = tree_archive
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(tcompile.ArtifactIntegrityError):
        tcompile.load(path, device="cpu")


def test_truncated_archive_raises_integrity_error(tree_archive):
    _, path = tree_archive
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:len(raw) // 2])
    with pytest.raises(tcompile.ArtifactIntegrityError):
        tcompile.load(path, device="cpu")


def test_member_checksum_mismatch_detected(tree_archive):
    _, path = tree_archive
    payload = tckpt.unpackb(_container(path))
    params = bytearray(payload["members"]["params"])
    params[len(params) // 2] ^= 0x01
    payload["members"]["params"] = bytes(params)
    open(path, "wb").write(tckpt.compress_bytes(tckpt.packb(payload)))
    with pytest.raises(tcompile.ArtifactIntegrityError, match="params"):
        tcompile.load(path, device="cpu")
    with pytest.raises(jartifact.ArtifactIntegrityError, match="params"):
        jcompile.load(path)


def test_fault_injected_archive_corruption_caught(tree_archive):
    _, path = tree_archive
    plan = FaultPlan([FaultRule(site="artifact.load", kind="corrupt",
                                corrupt_bytes=8)], seed=3)
    with faults.inject(plan):
        with pytest.raises(tcompile.ArtifactIntegrityError):
            tcompile.load(path, device="cpu")
    assert tcompile.load(path, device="cpu") is not None


def test_non_archive_and_newer_version_raise(tree_archive, tmp_path):
    _, path = tree_archive
    junk = str(tmp_path / "junk.bin")
    open(junk, "wb").write(b"\x00\x01 not an archive at all")
    with pytest.raises(tcompile.ArtifactIntegrityError):
        tcompile.load(junk, device="cpu")
    other = str(tmp_path / "other.embml")
    open(other, "wb").write(tckpt.compress_bytes(tckpt.packb(
        {"format": "something-else", "version": 1})))
    with pytest.raises(ValueError, match="not a repro-compiled-artifact"):
        tcompile.load(other, device="cpu")
    payload = tckpt.unpackb(_container(path))
    payload["version"] = 4
    open(path, "wb").write(tckpt.compress_bytes(tckpt.packb(payload)))
    with pytest.raises(ValueError, match="newer"):
        tcompile.load(path, device="cpu")


@pytest.mark.parametrize("version", [1, 2])
def test_legacy_archive_still_loads(tree_archive, dataset, tmp_path,
                                    version):
    art, _ = tree_archive
    target = dataclasses.asdict(art.target)
    target["backend"] = "pallas"
    payload = {"format": "repro-compiled-artifact", "version": version,
               "kind": art.kind, "target": target,
               "params": tartifact._encode(art.params),
               "quant_plan": None, "metadata": {}, "saved_at": 0.0}
    path = str(tmp_path / "legacy.embml")
    open(path, "wb").write(tckpt.compress_bytes(tckpt.packb(payload)))
    again = tcompile.load(path, device="cpu")
    np.testing.assert_array_equal(again.predict(dataset[2]),
                                  art.predict(dataset[2]))


def test_discard_params_blocks_save(tree_archive, dataset, tmp_path):
    art, path = tree_archive
    again = tcompile.load(path, device="cpu")
    assert again.discard_params() is again and again.params is None
    np.testing.assert_array_equal(again.predict(dataset[2]),
                                  art.predict(dataset[2]))
    with pytest.raises(ValueError, match="discard_params"):
        again.save(str(tmp_path / "x.embml"))


def test_save_is_atomic(tree_archive, dataset, tmp_path, monkeypatch):
    import os

    art, path = tree_archive
    want = tcompile.load(path, device="cpu").predict(dataset[2])

    def boom(src, dst):
        raise OSError("simulated power loss at publish")

    monkeypatch.setattr(tckpt.os, "replace", boom)
    with pytest.raises(OSError, match="power loss"):
        art.save(path, metadata={"attempt": 2})
    monkeypatch.undo()
    np.testing.assert_array_equal(
        tcompile.load(path, device="cpu").predict(dataset[2]), want)
    assert [f for f in os.listdir(tmp_path) if ".tmp-" in f] == []


# --------------------------------------------------------------------------
# codecs
# --------------------------------------------------------------------------
@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(-2 ** 63, 2 ** 64 - 1), max_size=40),
       st.lists(st.floats(-1e300, 1e300), max_size=20),
       st.integers(0, 70000),
       st.sampled_from(["", "a", "é" * 40, "key" * 30]))
def test_packb_equals_msgpack(ints, floats, n, text):
    obj = {"ints": ints, "floats": tuple(floats), "bin": b"\x07" * n,
           "str": text * (1 + n % 7), text: [None, True, False, {}],
           "nested": {str(i): [i, -i, float(i)] for i in range(n % 20)},
           "long": list(range(n % 300)), 7: -1}
    raw = msgpack.packb(obj, use_bin_type=True)
    assert tckpt.packb(obj) == raw
    assert tckpt.unpackb(raw) == msgpack.unpackb(raw, raw=False,
                                                 strict_map_key=False)


def test_unpackb_rejects_bad_bytes():
    raw = tckpt.packb({"a": [1, 2, 3]})
    for bad in (raw[:-1], raw + b"\x00", b"\xc1", b"\xd4\x00\x00"):
        with pytest.raises(ValueError):
            tckpt.unpackb(bad)
    with pytest.raises(TypeError):
        tckpt.packb({"x": np.int64(3)})


def test_leaves_cross_decode():
    bf = torch.randn(3, 5).to(torch.bfloat16)
    enc = tckpt.encode_leaf(bf)
    assert enc["dtype"] == "bfloat16"
    back = tckpt.decode_leaf(enc)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), bf.view(torch.int16))
    ref = jckpt.decode_leaf(enc)  # the reference reads it as ml_dtypes
    assert str(ref.dtype) == "bfloat16"
    np.testing.assert_array_equal(ref.view(np.uint16),
                                  bf.view(torch.int16).numpy().view(np.uint16))
    jenc = jckpt.encode_leaf(jnp.asarray(bf.float().numpy(), jnp.bfloat16))
    assert jenc == enc
    for x in (np.arange(6, dtype=np.int16).reshape(2, 3), np.float32(1.5),
              torch.arange(4, dtype=torch.float64), 3, "s", None, b"b"):
        enc = tckpt.encode_leaf(x)
        assert enc == jckpt.encode_leaf(np.asarray(x) if isinstance(
            x, torch.Tensor) else x)
        got = tckpt.decode_leaf(enc)
        if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
            np.testing.assert_array_equal(got, np.asarray(x))
        else:
            assert got == x


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_zlib_and_zstd_archives_cross_load(models, dataset, tmp_path,
                                           monkeypatch, writer):
    _, _, xte, _ = dataset
    tart = _port_compile(models, dataset, "mlp", "auto8", "cuda")
    jart = _ref_compile(models, dataset, "mlp", "auto8", "pallas")
    want = jart.predict(xte)
    np.testing.assert_array_equal(tart.predict(xte), want)
    for zstd in (True, False):
        if not zstd:
            monkeypatch.setattr(tckpt, "zstandard", None)
            monkeypatch.setattr(jckpt, "zstandard", None)
        path = str(tmp_path / f"{writer}-{zstd}.embml")
        (tart if writer == "port" else jart).save(path)
        head = open(path, "rb").read(4)
        assert (head == b"\x28\xb5\x2f\xfd") == zstd
        monkeypatch.undo()  # both readers with zstandard again
        np.testing.assert_array_equal(
            tcompile.load(path, device="cpu").predict(xte), want)
        np.testing.assert_array_equal(jcompile.load(path).predict(xte), want)
        if zstd:  # a zstd archive where the package is missing
            monkeypatch.setattr(tckpt, "zstandard", None)
            with pytest.raises(tcompile.ArtifactIntegrityError,
                               match="zstandard"):
                tcompile.load(path, device="cpu")
            monkeypatch.undo()
