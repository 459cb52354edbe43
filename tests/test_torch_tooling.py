"""The port's tooling against the reference's: ``configs.all_cells``,
``roofline/analysis.py``, ``launch/mesh.py``, ``launch/cells.py`` and
``launch/dryrun.py``.

The reference's cells need an 8-device mesh, so one subprocess with 8
forced host devices builds all 40 of them on ``tiny`` and ``tiny-multi``
(no compile: ``build_cell`` only traces shapes) and writes their
``model_flops``, the bytes of one shard of their ``args`` under
``in_shardings`` (``NamedSharding.shard_shape``), and the HLO text of
one small compiled program with all five collectives. The port builds
the same cells from meta-device stand-ins and must give the same counts:
FLOPs to 1e-12 relative, bytes exactly.

On the CPU the LM cells' steps run at the smoke width (``override``)
over a CPU mesh and must equal the port's own step bitwise."""

import ast
import copy
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import repro.roofline.analysis as ref_analysis
from repro.configs import all_cells as ref_all_cells
from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.cells import (OPT_CFG, build_cell, device_bytes,
                                      shard_shape)
from repro_torch.launch.mesh import MESHES
from repro_torch.models import transformer as tf
from repro_torch.models.common import MeshRules, cast_tree
from repro_torch.roofline import analysis
from repro_torch.train.optimizer import init_state
from repro_torch.train.trainer import make_train_step
from repro_torch.train.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = list(all_cells())
TINY = ("tiny", "tiny-multi")

REFERENCE = r"""
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import all_cells
from repro.launch.cells import build_cell
from repro.launch.mesh import MESHES
from repro.roofline.analysis import parse_collective_bytes

out = {"flops": {}, "bytes": {}}
for mesh_name in ("tiny", "tiny-multi"):
    mesh = MESHES[mesh_name]()
    with jax.set_mesh(mesh):
        for arch, shape in all_cells():
            cell = build_cell(arch, shape, mesh)
            if mesh_name == "tiny":
                out["flops"][f"{arch}|{shape}"] = cell.model_flops
            sizes = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                lambda x, s: int(np.prod(s.shard_shape(x.shape)))
                * np.dtype(x.dtype).itemsize, cell.args, cell.in_shardings))
            out["bytes"][f"{arch}|{shape}|{mesh_name}"] = int(sum(sizes))

mesh = jax.make_mesh((2, 4), ("data", "model"))


def body(x):
    a = jax.lax.psum(x, "model")
    b = jax.lax.all_gather(x, "data", axis=0, tiled=True)
    c = jax.lax.psum_scatter(x, "model", scatter_dimension=1, tiled=True)
    d = jax.lax.all_to_all(x, "model", 1, 1, tiled=True)
    e = jax.lax.ppermute(x, "data", [(0, 1), (1, 0)])
    return a.sum() + b.sum() + c.sum() + d.sum() + e.sum()


f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("data", "model"),
                          out_specs=P(), check_vma=False))
out["hlo"] = f.lower(jnp.ones((16, 32), jnp.float32)).compile().as_text()
out["collectives"] = parse_collective_bytes(out["hlo"])
with open(sys.argv[1], "w") as fh:
    json.dump(out, fh)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's counts of every cell, from one 8-device
    subprocess."""
    path = tmp_path_factory.mktemp("tooling") / "ref.json"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def meta_meshes():
    return {name: MESHES[name]("meta") for name in TINY}


# ---------------------------------------------------------------------------
# configs, meshes, cells
# ---------------------------------------------------------------------------


def test_all_cells_equal_the_reference():
    assert CELLS == list(ref_all_cells())
    assert len(CELLS) == 40


@pytest.mark.parametrize("name", sorted(MESHES))
def test_meshes_match_the_reference(name, monkeypatch):
    """Shapes and axis names of the four meshes (the reference's mesh
    maker swapped for one that returns its inputs: no jax device)."""
    import repro.launch.mesh as ref_mesh
    monkeypatch.setattr(ref_mesh, "_mk", lambda shape, axes: (shape, axes))
    shape, axes = ref_mesh.MESHES[name]()
    mesh = MESHES[name]("cpu")
    assert tuple(mesh.devices.shape) == tuple(shape)
    assert mesh.axis_names == tuple(axes)
    assert {d.type for d in mesh.devices.flat} == {"cpu"}


def test_meshes_default_to_the_card():
    """``device=None`` means cuda: it raises where there is no card."""
    if torch.cuda.is_available():
        assert MESHES["tiny"]().devices.flat[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MESHES["tiny"]()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_the_reference(ref, meta_meshes, arch, shape):
    cell = build_cell(arch, shape, meta_meshes["tiny"])
    want = ref["flops"][f"{arch}|{shape}"]
    assert cell.model_flops == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("mesh_name", TINY)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_match_the_reference(ref, meta_meshes, arch, shape,
                                            mesh_name):
    """The bytes of one shard of the stand-ins equal the sum of the
    reference's ``shard_shape`` bytes; every stand-in is a meta tensor."""
    mesh = meta_meshes[mesh_name]
    cell = build_cell(arch, shape, mesh)
    assert all(t.is_meta for t in tree_leaves(cell.args))
    assert device_bytes(cell.args, cell.in_shardings, mesh) == \
        ref["bytes"][f"{arch}|{shape}|{mesh_name}"]


def test_shard_shape_splits_by_the_product_of_the_axes():
    mesh = MESHES["tiny-multi"]("meta")
    assert shard_shape((16, 8), (("pod", "data"), "model"), mesh) == (4, 4)
    assert shard_shape((7, 3), ("model",), mesh) == (4, 3)   # ceil; no split
    assert shard_shape((), (), mesh) == ()


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

# (flops, hbm_bytes, collective_bytes, n_chips, model_flops): bound by
# compute, by memory, by the collectives, and an empty one
ROOF_CASES = [(8.1e15, 2.0e12, 1.0e9, 8, 6.0e15),
              (1.0e12, 9.0e12, 1.0e9, 4, 1.0e12),
              (1.0e12, 1.0e9, 7.0e12, 16, 5.0e11),
              (0.0, 0.0, 0.0, 1, 0.0)]


@pytest.mark.parametrize("peak", ["PEAK_FLOPS", "PEAK_FLOPS_FP32"])
@pytest.mark.parametrize("case", range(len(ROOF_CASES)))
def test_roofline_to_dict_matches_the_reference(case, peak, monkeypatch):
    """The same counts give the reference's dict once its constants are
    the port's (monkeypatched; no file changes)."""
    monkeypatch.setattr(ref_analysis, "PEAK_FLOPS", getattr(analysis, peak))
    monkeypatch.setattr(ref_analysis, "HBM_BW", analysis.HBM_BW)
    monkeypatch.setattr(ref_analysis, "ICI_BW", analysis.ICI_BW)
    counts = ROOF_CASES[case]
    got = analysis.Roofline(*counts, peak_flops=getattr(analysis, peak))
    assert got.to_dict() == ref_analysis.Roofline(*counts).to_dict()


def test_roofline_names_and_constants():
    """The reference's public names, and the H100 SXM's rates."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "Roofline",
                 "parse_collective_bytes"):
        assert hasattr(analysis, name)
    assert (analysis.PEAK_FLOPS, analysis.PEAK_FLOPS_FP32, analysis.HBM_BW,
            analysis.ICI_BW) == (989e12, 67e12, 3.35e12, 450e9)


def test_parse_collective_bytes_matches_the_reference(ref):
    got = analysis.parse_collective_bytes(ref["hlo"])
    assert got == ref["collectives"]
    assert got["count"] >= 5 and all(got[c] > 0
                                     for c in analysis._COLLECTIVES)


@pytest.mark.parametrize("arch,shape", [("fm", "train_batch"),
                                        ("gemma-2b", "decode_32k"),
                                        ("fm", "serve_p99"),
                                        ("fm", "retrieval_cand")])
def test_from_cell_counts_the_least_traffic(meta_meshes, arch, shape):
    """Arguments read once, but a serving step's tables only at its ids'
    rows (one row an id) and no parameter its output does not need; a
    training step also writes its parameters and optimizer state; no
    collective bytes; the compute dtype's peak."""
    cell = build_cell(arch, shape, meta_meshes["tiny"])
    r = analysis.from_cell(cell, 8)
    params, rest = cell.args[0], cell.args[1:]
    embed = params["embed"]
    row = embed.shape[1] * embed.element_size()
    if shape == "train_batch":
        want = analysis.tree_bytes(cell.args) \
            + analysis.tree_bytes(cell.args[:2])
    elif arch == "gemma-2b":
        B = rest[1].shape[0]
        want = analysis.tree_bytes(cell.args) - (embed.shape[0] - B) * row
    else:
        n_ids = rest[0]["sparse"].numel()
        want = analysis.tree_bytes(rest) + n_ids * row
        if shape == "serve_p99":   # the first-order term and the bias
            want += n_ids * 4 + 4
    assert r.hbm_bytes == want
    assert r.flops == r.model_flops == cell.model_flops
    assert r.collective_bytes == 0.0 and r.n_chips == 8
    assert r.peak_flops == (analysis.PEAK_FLOPS if arch == "gemma-2b"
                            else analysis.PEAK_FLOPS_FP32)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [("fm", "retrieval_cand"),
                                        ("pna", "molecule"),
                                        ("stablelm-3b", "decode_32k")])
def test_dryrun_cli_finishes_the_reference_cells(arch, shape, tmp_path):
    """The reference's own test cells, on ``tiny-multi``, with no card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "tiny-multi", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "DRYRUN DONE: 1 ok, 0 failed" in r.stdout
    with open(tmp_path / f"{arch}__{shape}__tiny-multi.json") as fh:
        rec = json.load(fh)
    assert rec["status"] == "ok"
    assert rec["roofline"]["flops"] > 0


def test_dryrun_all_cells_on_single(tmp_path):
    records = dryrun.main(["--all", "--mesh", "single", "--out",
                           str(tmp_path)])
    assert [(r["arch"], r["shape"]) for r in records] == CELLS
    assert all(r["status"] == "ok" and r["n_chips"] == 256
               for r in records)
    assert len(list(tmp_path.glob("*__single.json"))) == 40


def _reference_source(module: str) -> ast.Module:
    """The reference module's syntax tree, read without importing it (the
    reference's dry run sets XLA_FLAGS when imported)."""
    path = importlib.util.find_spec(module).origin
    with open(path) as fh:
        return ast.parse(fh.read(), path)


def _defines(tree: ast.Module, path: str) -> bool:
    """Whether ``tree`` defines ``path``: a top-level function or class, or
    a ``Class.field`` annotated in its class body."""
    name, _, field = path.partition(".")
    for node in tree.body:
        if getattr(node, "name", None) != name:
            continue
        if not field:
            return True
        return any(isinstance(n, ast.AnnAssign) and n.target.id == field
                   for n in node.body)
    return False


def _names_in(tree: ast.Module) -> set:
    """Every string constant and keyword-argument name in ``tree``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.add(node.value)
        elif isinstance(node, ast.keyword) and node.arg:
            out.add(node.arg)
    return out


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """The port's records of a training cell and a serving cell."""
    out = tmp_path_factory.mktemp("records")
    return out, {kind: dryrun.run_cell(arch, shape, "tiny", str(out))
                 for kind, (arch, shape) in
                 {"train": ("pna", "molecule"),
                  "serve": ("gemma-2b", "decode_32k")}.items()}


@pytest.mark.parametrize("key", sorted(dryrun.REPLACED))
def test_replaced_map_holds(key, port_records):
    """Each entry names a reference name or record key that exists; the
    port has no counterpart under the same name (a record key holds the
    replacement's value); a named replacement resolves."""
    entry = dryrun.REPLACED[key]
    assert entry.why
    if entry.port is not None:
        module, name = entry.port.split(":")
        assert callable(getattr(importlib.import_module(module), name))
    out_dir, recs = port_records
    kind, _, what = key.partition(":")
    if kind == "record":
        assert what.split(".")[-1] in _names_in(
            _reference_source("repro.launch.dryrun"))
        for rec_kind, rec in recs.items():
            value = rec
            for part in what.split("."):
                value = value[part]
            if what in ("memory.temp_bytes", "hlo_lines") or (
                    what == "memory.output_bytes" and rec_kind == "serve"):
                assert value is None
            else:
                assert isinstance(value, (int, float)) and value >= 0
        return
    if kind == "file":
        assert what in _names_in(_reference_source("repro.launch.dryrun"))
        assert not list(out_dir.glob(f"*{what}"))
        return
    assert _defines(_reference_source(kind), what)
    port_module = importlib.import_module(
        kind.replace("repro.", "repro_torch.", 1))
    name, _, field = what.partition(".")
    if field:
        cls = getattr(port_module, name)
        assert field not in {f.name for f in dataclasses.fields(cls)}
        assert not hasattr(cls, field)
    else:
        assert not hasattr(port_module, name)


def test_memory_record_counts_the_shards(port_records):
    """``argument_bytes`` is one shard of the arguments; a training
    cell's ``output_bytes`` one shard of its parameters and optimizer
    state, and the peak their sum."""
    _, recs = port_records
    mesh = MESHES["tiny"]("meta")
    cell = build_cell("pna", "molecule", mesh)
    mem = recs["train"]["memory"]
    assert mem["argument_bytes"] == device_bytes(cell.args,
                                                 cell.in_shardings, mesh)
    assert mem["output_bytes"] == device_bytes(cell.args[:2],
                                               cell.out_shardings[:2], mesh)
    assert mem["peak_bytes_per_device"] == \
        mem["argument_bytes"] + mem["output_bytes"]


# ---------------------------------------------------------------------------
# the LM cells' steps on the CPU
# ---------------------------------------------------------------------------

LM_ARCHS = ("gemma-2b", "olmoe-1b-7b")
LM_SHAPES = [s.name for s in get_arch("gemma-2b").shapes]
B, S = 2, 16


def _smoke_override(arch):
    smoke = get_arch(arch).make_smoke_config()
    return {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)
            if f.name != "name"}


def _assert_bitwise(got, want):
    got_l, want_l = tree_leaves(got), tree_leaves(want)
    assert len(got_l) == len(want_l) > 0
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_cell_step_equals_the_ports_step(arch, shape):
    """``cell.fn`` at the smoke width over a CPU ``tiny`` mesh equals the
    port's own step (``make_train_step`` over ``loss_fn``, ``prefill``,
    ``serve_step(top_k=8)``) bitwise, on parameters shaped as the
    cell's stand-ins and a small batch."""
    mesh = MESHES["tiny"]("cpu")
    cell = build_cell(arch, shape, mesh, override=_smoke_override(arch))
    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(),
                              name=get_arch(arch).make_config().name)
    rules = MeshRules()
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cell.kind != "lm_train":
        params = cast_tree(params, torch.bfloat16)
    for got, want in zip(tree_leaves(params), tree_leaves(cell.args[0]),
                         strict=True):
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                           dtype=torch.int32)

    if cell.kind == "lm_train":
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        args = (params, init_state(OPT_CFG, params), batch)
        step = make_train_step(
            lambda p, b: tf.loss_fn(p, b, cfg, rules, mesh), OPT_CFG)
        want = step(*copy.deepcopy(args))
    elif cell.kind == "lm_prefill":
        args = (params, tokens[:, :-1])
        want = tf.prefill(*args, cfg, rules, mesh=mesh)
    else:
        _, prompt_cache = tf.prefill(params, tokens[:, :-1], cfg, rules,
                                     mesh=mesh)
        cache = tf.init_kv_cache(cfg, B, S + 4, device="cpu")
        for key in cache:
            cache[key][:, :, :S] = prompt_cache[key]
        cache_len = torch.tensor(S, dtype=torch.int32)
        args = (params, cache, tokens[:, -1:], cache_len)
        want = tf.serve_step(*copy.deepcopy(args), cfg, rules, top_k=8,
                             mesh=mesh)
    got = cell.fn(*copy.deepcopy(args))
    _assert_bitwise(got, want)
