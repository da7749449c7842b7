"""The port's spec functions and dry run against the live JAX package.

* ``param_specs`` leaf for leaf (a ``PartitionSpec`` read as a tuple) for
  all ten ``ARCH_IDS`` on the ``pod``, ``multipod`` and ``dp64tp4`` meshes,
  FSDP on and off, the three expert layouts of grok-1 and deepseek-v3, and
  a quantized tree; the reference's ``Rules`` runs on a stand-in mesh, as
  ``tests/test_sharding_rules.py`` does;
* ``cache_specs`` for every runnable decode cell on the three meshes;
* ``abstract_params`` and ``input_specs``: structure, shapes and dtypes
  equal to the reference's ``eval_shape`` for every runnable cell;
* the HLO collective parser and ``roofline_terms`` equal to the
  reference's on the same input;
* ``run_cell``'s ``analytic`` equal to ``analytic_cost`` for every runnable
  cell on ``pod``, and the CLI planning the 31 cells of each mesh;
* a reduced prefill cell's planned argument bytes equal to the reference's
  compiled ``memory_analysis().argument_size_in_bytes`` on 8 emulated host
  devices (in a subprocess, as ``tests/test_elastic.py`` runs them).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import pytest

import repro  # noqa: F401  (enables jax x64, as the reference runs)
import jax
from jax.sharding import PartitionSpec as P
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.core.quantize import QuantSpec as JQuantSpec
from repro.core.quantize import quantize_lm_params as jquantize
from repro.lm import model as JM
from repro.roofline import analysis as janalysis
from repro.roofline.analytic import analytic_cost as janalytic_cost
from repro.sharding.rules import Rules as JRules
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config as tget_config
from repro_torch.core.quantize import quantize_lm_params as tquantize
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh_2d
from repro_torch.lm import model as TM
from repro_torch.roofline import analysis as tanalysis
from repro_torch.sharding import Rules as TRules

MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16},
          "dp64tp4": {"data": 64, "model": 4}}
RUNNABLE = [(a, s) for a in ARCH_IDS for s, st in
            tget_config(a).runnable_shapes().items() if st == "run"]
DECODE = [(a, s) for a, s in RUNNABLE if SHAPES[s].kind == "decode"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    """A mesh stand-in (``tests/test_sharding_rules.py``): the rules read
    only ``shape`` and ``axis_names``."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(p): l for p, l in flat}


def _tflat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, path + (k,)))
        return out
    return {"".join(f"[{k!r}]" for k in path): tree}


@functools.lru_cache(maxsize=None)
def _abstract(arch, expert_sharding=None):
    jc, tc = jget_config(arch), tget_config(arch)
    if expert_sharding is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(
            jc.moe, expert_sharding=expert_sharding))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(
            tc.moe, expert_sharding=expert_sharding))
    return jc, tc, JM.abstract_params(jc), TM.abstract_params(tc)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _same_specs(jspecs, tspecs):
    jf, tf = _jflat(jspecs), _tflat(tspecs)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert tf[k] == tuple(jf[k]), k
    return len(jf)


def _same_shapes(jtree, ttree):
    jf, tf = _jflat(jtree), _tflat(ttree)
    assert jf.keys() == tf.keys()
    for k in jf:
        assert tuple(tf[k].shape) == tuple(jf[k].shape), k
        assert _dtype_name(tf[k].dtype) == str(jf[k].dtype), k
        assert tf[k].device.type == "meta", k


# --------------------------------------------------------------------------
# spec functions
# --------------------------------------------------------------------------
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    jc, tc, ja, ta = _abstract(arch)
    m = FakeMesh(MESHES[mesh])
    n = _same_specs(JM.param_specs(jc, JRules(m), fsdp=fsdp, tree=ja),
                    TM.param_specs(tc, TRules(m), fsdp=fsdp, tree=ta))
    assert n > 5


@pytest.mark.parametrize("layout", ["ep", "ep2d", "tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_expert_layouts_match_reference(arch, mesh, layout):
    jc, tc, ja, ta = _abstract(arch, layout)
    m = FakeMesh(MESHES[mesh])
    jspecs = JM.param_specs(jc, JRules(m), tree=ja)
    _same_specs(jspecs, TM.param_specs(tc, TRules(m), tree=ta))
    # the expert dim is sharded somewhere under every layout but tp
    experts = [s for k, s in _jflat(jspecs).items()
               if "moe" in k and "router" not in k and "shared" not in k]
    assert experts


@pytest.mark.parametrize("mesh", ["pod", "dp64tp4"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantized_tree_specs_match_reference(arch, mesh):
    jc, tc, ja, ta = _abstract(arch)
    jq = jax.eval_shape(lambda p: jquantize(p, JQuantSpec()), ja)
    tq = tquantize(ta)
    _same_shapes(jq, tq)
    m = FakeMesh(MESHES[mesh])
    _same_specs(JM.param_specs(jc, JRules(m), tree=jq),
                TM.param_specs(tc, TRules(m), tree=tq))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE)
def test_cache_specs_match_reference(arch, shape, mesh):
    jc, tc, _, _ = _abstract(arch)
    sh = SHAPES[shape]
    m = FakeMesh(MESHES[mesh])
    _same_specs(JM.cache_specs(jc, JRules(m), sh.global_batch, sh.seq_len),
                TM.cache_specs(tc, TRules(m), sh.global_batch, sh.seq_len))


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_specs_and_abstract_params_match_eval_shape(arch, shape):
    jc, tc, ja, ta = _abstract(arch)
    _same_shapes(ja, ta)
    got, want = TM.input_specs(tc, SHAPES[shape]), \
        JM.input_specs(jc, JSHAPES[shape])
    assert sorted(got) == sorted(want)
    if "cache" in want:
        _same_shapes(want.pop("cache"), got.pop("cache"))
    _same_shapes(want, got)


def test_specs_without_rules_replicate_every_leaf():
    _, tc, _, ta = _abstract("qwen2-0.5b")
    for spec, leaf in zip(_tflat(TM.param_specs(tc, None, tree=ta)).values(),
                          _tflat(ta).values()):
        assert spec == (None,) * leaf.dim()
    cache = _tflat(TM.cache_specs(tc, None, 2, 8))
    assert cache["['pos']"] == ()


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------
HLO = [
    """
  %ar = bf16[16,1024] all-reduce(bf16[16,1024] %x), replica_groups={}
  %ag.1 = f32[512]{0} all-gather(f32[128]{0} %y), dimensions={0}
  %noise = f32[2,2] add(f32[2,2] %a, f32[2,2] %b)
  %rs = (s8[64,64], s8[64,64]) reduce-scatter(...), dimensions={0}
""",
    "%m = f32[128,128] dot(f32[128,128] %a, f32[128,128] %b)",
    """
  %ars = (f32[8,256]{1,0}, f32[8,256]{1,0}) all-reduce-start(f32[8,256] %p)
  %ard = f32[8,256]{1,0} all-reduce-done(%ars)
  %a2a = bf16[4,32,128] all-to-all(bf16[4,32,128] %q), dimensions={0}
  %cp.3 = s32[7]{0} collective-permute(s32[7] %r), source_target_pairs={{0,1}}
  %ag.start = (f8e4m3fn[64], f8e4m3fn[256]) all-gather-start(f8e4m3fn[64] %s)
  %odd = u4[16] all-gather(u4[4] %t)
  %pred = pred[3,3] all-reduce(pred[3,3] %u)
""",
]


@pytest.mark.parametrize("i", range(len(HLO)))
def test_collective_parser_matches_reference(i):
    assert (tanalysis.collective_bytes_from_hlo(HLO[i])
            == janalysis.collective_bytes_from_hlo(HLO[i]))


def test_hw_is_the_h100_and_roofline_terms_match_reference():
    hw = tanalysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.hbm_bytes) == (
        989.4e12, 3.35e12, 450e9, 80e9)
    jhw = janalysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                       ici_bw=hw.ici_bw, hbm_bytes=hw.hbm_bytes)
    for kw in (dict(flops_dev=3e14, bytes_dev=2e11, coll_bytes_dev=1e10),
               dict(flops_dev=1e9, bytes_dev=9e11, coll_bytes_dev=1e6),
               dict(flops_dev=1e9, bytes_dev=1e6, coll_bytes_dev=9e11),
               dict(flops_dev=0.0, bytes_dev=0.0, coll_bytes_dev=0.0)):
        common = dict(arch="a", shape="s", mesh_name="pod", chips=256,
                      model_flops_global=5e16, bytes_per_device=1e9,
                      note="n", **kw)
        assert (tanalysis.roofline_terms(**common).to_dict()
                == janalysis.roofline_terms(hw=jhw, **common).to_dict())
    assert tanalysis.model_flops(10, 7, "train") == janalysis.model_flops(
        10, 7, "train")
    assert tanalysis.model_flops(10, 7, "fwd") == janalysis.model_flops(
        10, 7, "fwd")


# --------------------------------------------------------------------------
# the dry run
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_run_cell_analytic_matches_reference(arch, shape):
    rec = dryrun.run_cell(arch, shape, "pod", verbose=False)
    sh = JSHAPES[shape]
    want = janalytic_cost(
        jget_config(arch), sh, chips=256, tp=16, dp_in_pod=16, pods=1,
        microbatches=4 if sh.kind == "train" else 1).to_dict()
    assert rec["analytic"] == want
    assert rec["chips"] == 256 and rec["status"] == "run"
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == sum(
        mem["argument_parts"].values()) > 0
    assert rec["roofline"]["bytes_per_device"] == mem[
        "argument_size_in_bytes"]
    assert rec["plan_s"] >= 0
    for absent in ("lower_s", "compile_s", "cost_analysis",
                   "collective_bytes", "hlo_flops_dev"):
        assert absent not in rec


def test_run_cell_skips_what_the_reference_skips():
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", "pod",
                          verbose=False)
    assert rec["status"].startswith("skip") and "memory_analysis" not in rec


@pytest.mark.parametrize("mesh", ["pod", "multipod"])
def test_cli_plans_every_runnable_cell(mesh, tmp_path, capsys):
    dryrun.main(["--all", "--mesh", mesh, "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "all cells OK (31 planned)" in out
    assert len(os.listdir(tmp_path)) == 31


def test_cli_single_cell_on_a_dp_tp_mesh(tmp_path):
    dryrun.main(["--arch", "qwen2-0.5b", "--shape", "train_4k", "--mesh",
                 "dp64tp4", "--out-dir", str(tmp_path)])
    (name,) = os.listdir(tmp_path)
    assert name == "dryrun_qwen2-0.5b_train_4k_dp64tp4.json"


def test_cli_exits_1_listing_failures(tmp_path, monkeypatch, capsys):
    real = dryrun.run_cell

    def flaky(arch, shape, *a, **kw):
        if arch == "rwkv6-1.6b" and shape == "train_4k":
            raise RuntimeError("planted")
        return real(arch, shape, *a, **kw)

    monkeypatch.setattr(dryrun, "run_cell", flaky)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--mesh", "pod", "--out-dir", str(tmp_path)])
    assert e.value.code == 1
    assert "1 FAILURES" in capsys.readouterr().out


def test_abstract_params_allocate_nothing():
    """671 B parameters' tree on the meta device: no storage behind it."""
    tree = TM.abstract_params(tget_config("deepseek-v3-671b"))
    assert all(t.device.type == "meta" for t in _tflat(tree).values())
    assert sum(t.numel() for t in _tflat(tree).values()) > 600e9


_MEMORY_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import dryrun

    cfg = dataclasses.replace(
        get_config("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        remat=False, dtype="float32")
    out = {}
    for kind, seq in (("prefill", 64), ("decode", 64)):
        shape = ShapeSpec("cell", seq, 8, kind)
        # Auto axes: JAX 0.9's make_mesh defaults to Explicit ones, under
        # which the reference's with_sharding_constraint raises
        mesh = jax.make_mesh((4, 2), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        fn, args, shardings, donate = dryrun.build_cell(cfg, shape, mesh)
        with mesh:
            compiled = jax.jit(fn, in_shardings=shardings).lower(
                *args).compile()
        out[kind] = compiled.memory_analysis().argument_size_in_bytes
    print("BYTES", json.dumps(out))
""")


def test_argument_bytes_match_compiled_reference():
    """A reduced cell on a (4, 2) mesh: the planned bytes a device equal
    XLA's compiled argument size, for prefill and for decode (cache
    included)."""
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _MEMORY_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("BYTES")][0]
    import json

    want = json.loads(line.split(" ", 1)[1])
    cfg = dataclasses.replace(
        tget_config("qwen2-0.5b").reduced(), n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab_size=256,
        remat=False, dtype="float32")
    mesh = make_host_mesh_2d(4, 2)
    for kind, seq in (("prefill", 64), ("decode", 64)):
        from repro_torch.configs.base import ShapeSpec

        shape = ShapeSpec("cell", seq, 8, kind)
        got = dryrun.argument_bytes(dryrun.build_cell(cfg, shape, mesh), mesh)
        assert sum(got.values()) == want[kind], (kind, got, want)
