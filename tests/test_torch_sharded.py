"""The port's sharded slice against the reference's, on the CPU: the mesh,
the four strategies, ``ShardedNormLayout`` and the ``norm_sharded``
engine; and the seeded data generators.

The reference runs as ``tests/test_sharded.py`` runs it: one subprocess
with 4 forced host devices (``--xla_force_host_platform_device_count``),
launched once for the module, writes every result to an ``.npz``. The
port runs the same cases on meshes of 4 logical shards on the CPU
(``make_mesh((4,), ("data",), ["cpu"] * 4)``, and ``(2, 2)`` over
``("pod", "data")``). Values agree within ``_torch_parity``'s 1e-5
relative + 1e-6 absolute, ids wherever the scores are distinct, and
``n_scored``/``depth`` exactly; on a catalogue whose shards repeat each
other's rows the ids must be equal tie for tie (the gathers' order).

The module imports no jax at the top: its ``cuda`` case (the strategies
on a card mesh of 4 logical shards against the CPU mesh, with kernel
B4's launches on the blocked path) runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_sharded.py``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import (EngineContext, ShardedLsmCatalogue,
                              get_engine, hierarchical_merge_topk,
                              naive_topk, sharded_blocked_topk,
                              sharded_naive_topk, sharded_norm_topk)
from repro_torch.core.index import build_index
from repro_torch.core.layout import build_layout
from repro_torch.core.mesh import (ShardedArray, gather_order, make_mesh,
                                  shard_array, shard_groups)
from repro_torch.kernels.gather_scores import gather_scores

from _torch_parity import assert_ids_where_distinct, assert_values, host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("values", "indices", "n_scored", "depth")

# The cases both packages run; each builds its data from numpy seeds.


def strategy_problem():
    rng = np.random.default_rng(1)
    T = rng.standard_normal((1024, 32)).astype(np.float32)
    U = rng.standard_normal((4, 32)).astype(np.float32)
    return T, U, 10


def tie_problem():
    """Shards 1 and 2 of 4 hold the same rows: their scores tie exactly
    across shards, so the merge order decides the ids."""
    T, U, k = strategy_problem()
    T = T.copy()
    T[256:512] = T[512:768]
    return T, U, k


def slab_indices(T, n):
    """Per-slab sorted lists (local ids), concatenated along the items."""
    m = T.shape[0] // n
    orders, tsorts = [], []
    for s in range(n):
        slab = T[s * m:(s + 1) * m]
        od = np.argsort(-slab, axis=0, kind="stable").T.astype(np.int32)
        orders.append(od)
        tsorts.append(np.take_along_axis(slab.T, od, axis=1))
    return np.concatenate(orders, 1), np.concatenate(tsorts, 1)


def engine_cases():
    """``name -> (T, [U, ...], k, EngineContext kwargs)``: the reference's
    two multi-device cases, an all-padding shard with ``k`` past the merge
    width, ``k > m_local``, and a ``max_blocks`` halt."""
    rng = np.random.default_rng(3)
    T = rng.standard_normal((4096, 16)).astype(np.float32)
    T *= (1.0 / np.sqrt(1.0 + np.arange(4096)))[:, None].astype(np.float32)
    decaying = (T, [np.random.default_rng(s).standard_normal(
        (6, 16)).astype(np.float32) for s in range(3)], 10,
        {"block_size": 128})
    rng = np.random.default_rng(7)
    T = rng.standard_normal((1000, 12)).astype(np.float32)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    flat = (T, [rng.standard_normal((4, 12)).astype(np.float32)], 5,
            {"block_size": 64})
    rng = np.random.default_rng(11)
    tiny = (rng.standard_normal((3, 8)).astype(np.float32),
            [rng.standard_normal((3, 8)).astype(np.float32)], 5,
            {"block_size": 64})
    small = (rng.standard_normal((20, 8)).astype(np.float32),
             [rng.standard_normal((5, 8)).astype(np.float32)], 12,
             {"block_size": 4})
    T = rng.standard_normal((2000, 16)).astype(np.float32)
    halted = (T, [rng.standard_normal((4, 16)).astype(np.float32)], 10,
              {"block_size": 32, "max_blocks": 2})
    return {"decaying": decaying, "flat": flat, "tiny": tiny,
            "small": small, "halted": halted}


REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, {tests!r})
from test_torch_sharded import (engine_cases, slab_indices,
                                strategy_problem, tie_problem)
from repro.core import (EngineContext, get_engine, hierarchical_merge_topk,
                        sharded_blocked_topk, sharded_naive_topk,
                        sharded_norm_topk)
from repro.core.layout import build_layout
from repro.core.index import build_index

assert len(jax.devices()) == 4, jax.devices()
devs = np.asarray(jax.devices())
mesh = Mesh(devs, ("data",))
mesh2 = Mesh(devs.reshape(2, 2), ("pod", "data"))
out = {{}}

def put(name, res):
    for f in {fields!r}:
        out[name + "/" + f] = np.asarray(getattr(res, f))

T, U, k = strategy_problem()
T, U = jnp.asarray(T), jnp.asarray(U)
put("naive", sharded_naive_topk(mesh, P("data", None), ("data",))(T, U, k))
od, ts = slab_indices(np.asarray(T), 4)
for blk in (16, 64):
    put(f"blocked{{blk}}", sharded_blocked_topk(
        mesh, (P("data", None), P(None, "data"), P(None, "data")),
        ("data",))(T, jnp.asarray(od), jnp.asarray(ts), U, k, blk))
put("hierarchical", hierarchical_merge_topk(
    mesh2, P(("pod", "data"), None), ("data",), ("pod",))(T, U, k))
lay = build_layout("norm_sharded", np.asarray(T), build_index(T),
                   n_shards=4)
put("norm2x2", sharded_norm_topk(mesh2, ("pod", "data"))(
    lay.targets_sharded, lay.norms_sharded, lay.ids_sharded, U, k, 32))

T, U, k = tie_problem()
T, U = jnp.asarray(T), jnp.asarray(U)
put("tie_naive2x2", sharded_naive_topk(
    mesh2, P(("pod", "data"), None), ("pod", "data"))(T, U, k))
put("tie_hierarchical", hierarchical_merge_topk(
    mesh2, P(("pod", "data"), None), ("data",), ("pod",))(T, U, k))

for name, (T, Us, k, kw) in engine_cases().items():
    ctx = EngineContext(jnp.asarray(T), **kw)
    for i, U in enumerate(Us):
        put(f"engine_{{name}}_{{i}}",
            get_engine("norm_sharded").run(ctx, jnp.asarray(U), k))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every reference result, from one 4-device subprocess."""
    path = tmp_path_factory.mktemp("sharded") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    code = REFERENCE.format(tests=os.path.join(REPO, "tests"), fields=FIELDS)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                        str(path)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def cpu_mesh(shape=(4,), names=("data",)):
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def assert_same(got, ref, name, exact_ids=False):
    want = {f: ref[f"{name}/{f}"] for f in FIELDS}
    assert_values(got.values, want["values"])
    if exact_ids:
        np.testing.assert_array_equal(host(got.indices), want["indices"])
    else:
        assert_ids_where_distinct(got.indices, want["indices"],
                                  want["values"])
    np.testing.assert_array_equal(host(got.n_scored), want["n_scored"])
    np.testing.assert_array_equal(host(got.depth), want["depth"])


def assert_exact(res, T, U, k):
    """Values equal to the unsharded top-k (the first M slots when k > M;
    the rest hold -inf)."""
    kk = min(k, T.shape[0])
    want = naive_topk(torch.from_numpy(T), torch.from_numpy(U), kk)
    assert_values(res.values[:, :kk], want.values)
    assert bool(torch.isneginf(torch.as_tensor(res.values[:, kk:])).all())


# ---------------------------------------------------------------------------
# The mesh and the deal
# ---------------------------------------------------------------------------


def test_mesh_shape_and_validation():
    mesh = cpu_mesh((2, 2), ("pod", "data"))
    assert mesh.shape == {"pod": 2, "data": 2} and mesh.size == 4
    assert mesh.axis_names == ("pod", "data")
    assert mesh.devices.shape == (2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh((1,), ("data",))


def test_shard_array_deals_rows_as_shard_map_reads_specs():
    x = torch.arange(24.0).reshape(8, 3)
    mesh = cpu_mesh((2, 2), ("pod", "data"))
    sh = shard_array(x, mesh, (("pod", "data"), None))
    assert isinstance(sh, ShardedArray) and sh.n_shards == 4
    assert len(sh.parts) == 1 and sh.parts[0].shape == (4, 2, 3)
    assert sh.parts[0].data_ptr() == x.data_ptr()     # a view, no copy
    np.testing.assert_array_equal(np.asarray(sh), x.numpy())
    assert shard_array(sh, mesh, (("pod", "data"), None)) is sh
    cols = shard_array(x.T, mesh, (None, ("pod", "data")))
    assert cols.parts[0].shape == (4, 3, 2)
    torch.testing.assert_close(cols.parts[0][1], x.T[:, 2:4])
    with pytest.raises(ValueError, match="4 equal shards"):
        shard_array(x[:6], mesh, (("pod", "data"), None))
    with pytest.raises(ValueError, match="exactly one"):
        shard_array(x, mesh, (None, None))


def test_shard_groups_and_gather_order():
    a, b = torch.device("cpu"), torch.device("meta")
    mesh = make_mesh((2, 2), ("pod", "data"), [a, b, a, b])
    groups = shard_groups(mesh, ("pod", "data"))
    assert [(g.device, g.shards) for g in groups] == [(a, (0, 2)),
                                                      (b, (1, 3))]
    # shards of one axis sit at 0 on the other (it replicates them)
    assert [g.shards for g in shard_groups(mesh, ("data",))] == [(0,), (1,)]
    # the last gathered axis is the outermost
    assert gather_order(mesh, ("pod", "data")) == [0, 2, 1, 3]
    assert gather_order(mesh, ("data",)) == [0, 1]


# ---------------------------------------------------------------------------
# The four strategies against the reference's
# ---------------------------------------------------------------------------


def test_sharded_naive_topk(ref):
    T, U, k = strategy_problem()
    f = sharded_naive_topk(cpu_mesh(), ("data", None), ("data",))
    res = f(torch.from_numpy(T), torch.from_numpy(U), k)
    assert_same(res, ref, "naive")
    assert_exact(res, T, U, k)


@pytest.mark.parametrize("block", [16, 64])
def test_sharded_blocked_topk(ref, block):
    T, U, k = strategy_problem()
    od, ts = slab_indices(T, 4)
    g = sharded_blocked_topk(cpu_mesh(), (("data", None), (None, "data"),
                                          (None, "data")), ("data",))
    res = g(torch.from_numpy(T), torch.from_numpy(od), torch.from_numpy(ts),
            torch.from_numpy(U), k, block)
    assert_same(res, ref, f"blocked{block}")
    assert_exact(res, T, U, k)
    assert int(res.depth[0]) < T.shape[0] // 4       # it pruned


def test_hierarchical_merge_topk(ref):
    T, U, k = strategy_problem()
    h = hierarchical_merge_topk(cpu_mesh((2, 2), ("pod", "data")),
                                (("pod", "data"), None), ("data",), ("pod",))
    res = h(torch.from_numpy(T), torch.from_numpy(U), k)
    assert_same(res, ref, "hierarchical")
    assert_exact(res, T, U, k)


def test_sharded_norm_topk_over_two_axes(ref):
    T, U, k = strategy_problem()
    lay = build_layout("norm_sharded", T, build_index(T, device="cpu"),
                       n_shards=4, device="cpu")
    f = sharded_norm_topk(cpu_mesh((2, 2), ("pod", "data")),
                          ("pod", "data"))
    res = f(lay.targets_sharded, lay.norms_sharded, lay.ids_sharded,
            torch.from_numpy(U), k, 32)
    assert_same(res, ref, "norm2x2")
    assert_exact(res, T, U, k)


@pytest.mark.parametrize("name", ["tie_naive2x2", "tie_hierarchical"])
def test_ties_across_shards_follow_the_gathers_order(ref, name):
    T, U, k = tie_problem()
    mesh = cpu_mesh((2, 2), ("pod", "data"))
    spec = (("pod", "data"), None)
    f = (sharded_naive_topk(mesh, spec, ("pod", "data"))
         if name == "tie_naive2x2"
         else hierarchical_merge_topk(mesh, spec, ("data",), ("pod",)))
    res = f(torch.from_numpy(T), torch.from_numpy(U), k)
    ids = host(res.indices)
    assert np.any((ids >= 256) & (ids < 768))        # the tied rows ranked
    assert_same(res, ref, name, exact_ids=True)


def test_a_spec_that_disagrees_with_the_axes_raises():
    mesh = cpu_mesh((2, 2), ("pod", "data"))
    with pytest.raises(ValueError, match="strategy indexes shards"):
        hierarchical_merge_topk(mesh, (("data", "pod"), None), ("data",),
                                ("pod",))


# ---------------------------------------------------------------------------
# ShardedNormLayout and the norm_sharded engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_total", [None, 64])
def test_round_robin_slabs_equal_the_references(m_total):
    import jax.numpy as jnp
    from repro.core.index import build_index as ref_build_index
    from repro.core.layout import build_layout as ref_build_layout
    rng = np.random.default_rng(23)
    T = rng.standard_normal((37, 6)).astype(np.float32)
    want = ref_build_layout("norm_sharded", T, ref_build_index(
        jnp.asarray(T)), n_shards=4, m_total=m_total)
    got = build_layout("norm_sharded", T, build_index(T, device="cpu"),
                       n_shards=4, m_total=m_total, device="cpu")
    for f in ("targets_sharded", "norms_sharded", "ids_sharded"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    assert got.n_shards == 4 and got.name == "norm_sharded"
    # with a mesh: the same arrays, dealt
    placed = build_layout("norm_sharded", T, build_index(T, device="cpu"),
                          n_shards=4, m_total=m_total, mesh=cpu_mesh())
    assert isinstance(placed.targets_sharded, ShardedArray)
    np.testing.assert_array_equal(np.asarray(placed.ids_sharded),
                                  np.asarray(want.ids_sharded))


@pytest.mark.parametrize("name", sorted(engine_cases()))
def test_norm_sharded_engine_on_4_shards(ref, name):
    T, Us, k, kw = engine_cases()[name]
    ctx = EngineContext(T, device="cpu", **kw)
    ctx._mesh = cpu_mesh()
    assert ctx.layout("norm_sharded").n_shards == 4
    for i, U in enumerate(Us):
        res = get_engine("norm_sharded").run(ctx, U, k)
        assert res.values.shape == (U.shape[0], k)
        assert_same(res, ref, f"engine_{name}_{i}")
        if "max_blocks" not in kw:
            assert_exact(res, T, U, k)


def test_one_shard_engine_is_the_norm_scan_and_the_references():
    """A 1-device mesh degenerates to the single-host scan: the port's
    ``norm`` and the reference's 1-device ``norm_sharded`` alike."""
    import jax
    import jax.numpy as jnp
    from repro.core import EngineContext as RefContext
    from repro.core import get_engine as ref_get_engine
    rng = np.random.default_rng(29)
    T = rng.standard_normal((512, 16)).astype(np.float32)
    T *= (1.0 / np.sqrt(1.0 + np.arange(512)))[:, None]
    U = rng.standard_normal((5, 16)).astype(np.float32)
    ctx = EngineContext(T, block_size=64, device="cpu")
    n_dev = jax.device_count()
    if n_dev != 1:
        ctx._mesh = cpu_mesh((n_dev,))
    assert ctx.mesh.size == n_dev
    got = get_engine("norm_sharded").run(ctx, U, 9)
    want = ref_get_engine("norm_sharded").run(RefContext(
        jnp.asarray(T), block_size=64), jnp.asarray(U), 9)
    assert_values(got.values, np.asarray(want.values))
    assert_ids_where_distinct(got.indices, np.asarray(want.indices),
                              np.asarray(want.values))
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    if n_dev == 1:
        norm = get_engine("norm").run(ctx, U, 9)
        for f in FIELDS:
            torch.testing.assert_close(getattr(got, f), getattr(norm, f),
                                       rtol=0, atol=0)


def test_norm_sharded_engine_registry_and_budget():
    eng = get_engine("norm_sharded")
    assert (eng.exact, eng.needs_index, eng.supports_budget, eng.layout) == (
        True, True, False, "norm_sharded")
    rng = np.random.default_rng(10)
    ctx = EngineContext(rng.standard_normal((64, 12)).astype(np.float32),
                        block_size=32, device="cpu")
    U = rng.standard_normal((2, 12)).astype(np.float32)
    with pytest.raises(ValueError, match="budget"):
        eng.run(ctx, U, 3, budget=5)
    traffic = eng.traffic(ctx, eng.run(ctx, U, 3))
    assert traffic["rows_gathered"] == 0.0 and traffic["rows_contiguous"] > 0


def test_server_norm_sharded_method():
    """``TopKServer.query(method="norm_sharded")`` by registry name, equal
    to ``norm`` on the 1-device mesh, with its own stats."""
    from repro_torch.core.seplr import random_model
    from repro_torch.serving.server import TopKServer
    model = random_model(np.random.default_rng(9), 2000, 16,
                         "lowrank_spectrum", device="cpu")
    srv = TopKServer(model, max_batch=8, block_size=64, device="cpu")
    U = np.random.default_rng(10).standard_normal((8, 16)).astype(np.float32)
    r_norm = srv.query(U, 10, "norm")
    r_sh = srv.query(U, 10, "norm_sharded")
    np.testing.assert_array_equal(r_sh.values, r_norm.values)
    np.testing.assert_array_equal(r_sh.indices, r_norm.indices)
    st_sh, st_norm = srv.stats["norm_sharded"], srv.stats["norm"]
    assert st_sh.n_queries == 8
    assert (st_sh.n_scored, st_sh.depth_sum) == (st_norm.n_scored,
                                                 st_norm.depth_sum)


def _check_query(cat, shadow, U, k=5, engine="norm_sharded"):
    """One query against the float64 oracle over the live rows: exact
    values, live gids, each scoring to the value beside it."""
    res, _ = cat.query(get_engine(engine), U, k)
    vals, idx = host(res.values), host(res.indices)
    gids = np.fromiter(shadow.keys(), np.int64, len(shadow))
    rows = np.stack([shadow[int(g)] for g in gids]).astype(np.float64)
    s = U.astype(np.float64) @ rows.T
    kk = min(k, len(shadow))
    np.testing.assert_allclose(vals[:, :kk], -np.sort(-s, axis=1)[:, :kk],
                               atol=1e-4)
    by_gid = {int(g): rows[i] for i, g in enumerate(gids)}
    for b in range(idx.shape[0]):
        for j in range(kk):
            g = int(idx[b, j])
            assert g in by_gid, (b, j, g)
            np.testing.assert_allclose(vals[b, j], U[b] @ by_gid[g],
                                       atol=1e-4)


@pytest.mark.parametrize("mesh_shards", [1, 4])
def test_norm_sharded_engine_on_ladder_is_exact(mesh_shards):
    """The reference's title configuration: the ``norm_sharded`` engine
    querying the 4-shard LSM catalogue, before and after ``promote()``.
    Before it, the snapshot's engine runs on a mesh of ``mesh_shards``
    CPU shards; the promotion's new snapshot readies the engine on its
    own default mesh, as the reference's does."""
    R = 10
    rng = np.random.default_rng(17)
    base = rng.standard_normal((96, R)).astype(np.float32)
    cat = ShardedLsmCatalogue(base, n_shards=4, delta_capacity=4,
                              l1_capacity=32, block_size=8,
                              compact_async=False, device="cpu")
    shadow = {i: base[i] for i in range(96)}
    rows = rng.standard_normal((9, R)).astype(np.float32)
    for g, row in zip(cat.add_targets(rows), rows):
        shadow[int(g)] = row
    cat.delete_targets([0, 50])
    del shadow[0], shadow[50]
    U = rng.standard_normal((3, R)).astype(np.float32)
    ctx = cat.snapshot.ctx
    ctx._mesh = cpu_mesh((mesh_shards,))
    _check_query(cat, shadow, U)
    assert ctx.layout("norm_sharded").n_shards == mesh_shards
    cat.promote(wait=True)
    assert cat.l1_rows == 0 and cat.l0_chain_len == 0
    assert cat.snapshot.ctx is not ctx
    _check_query(cat, shadow, U)


# ---------------------------------------------------------------------------
# The seeded generators: bitwise the reference's
# ---------------------------------------------------------------------------


#: Reference parameters that its generator never reads; the port omits them.
UNREAD_PARAMS = {"recsys_batches": {"embed_dim_for_labels"}}


@pytest.mark.parametrize("name", ["cf_ratings", "probabilistic_pca",
                                  "multilabel_factors", "recsys_batches"])
def test_generator_signature(name):
    """The port's generators take the reference's parameters, name for
    name, with the same defaults, but for the ones it never reads."""
    import inspect
    from repro.data import synthetic as ref_syn
    from repro_torch.data import synthetic as syn

    def params(fn, drop=frozenset()):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]
    assert params(getattr(syn, name)) == params(
        getattr(ref_syn, name), UNREAD_PARAMS.get(name, frozenset()))


@pytest.mark.parametrize("implicit", [False, True])
def test_cf_ratings_and_probabilistic_pca(implicit):
    from repro.data import synthetic as ref_syn
    from repro_torch.data import synthetic as syn
    got = syn.cf_ratings(np.random.default_rng(5), 60, 80, density=0.05,
                         implicit=implicit, rank=6)
    want = ref_syn.cf_ratings(np.random.default_rng(5), 60, 80,
                              density=0.05, implicit=implicit, rank=6)
    assert got.dtype == np.float32 and np.count_nonzero(got) > 0
    np.testing.assert_array_equal(got, want)
    for a, b in zip(syn.probabilistic_pca(got, 4, n_iters=5, seed=2),
                    ref_syn.probabilistic_pca(want, 4, n_iters=5, seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["ridge", "pls"])
def test_multilabel_factors(kind):
    from repro.data import synthetic as ref_syn
    from repro_torch.data import synthetic as syn
    got = syn.multilabel_factors(np.random.default_rng(6), 50, 12, kind)
    want = ref_syn.multilabel_factors(np.random.default_rng(6), 50, 12,
                                      kind)
    assert got.shape == (50, 12)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shard", [0, 1])
def test_recsys_batches_sharded(shard):
    from repro.data import synthetic as ref_syn
    from repro_torch.data import synthetic as syn
    args = (3, 4, 6, 100, 16)
    kw = {"shard": shard, "num_shards": 2}
    for got, want, _ in zip(syn.recsys_batches(*args, **kw),
                            ref_syn.recsys_batches(*args, **kw), range(3)):
        assert got.keys() == want.keys()
        assert got["sparse"].shape == (8, 6)
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# On the card: 4 logical shards on one device against the CPU mesh
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_mesh_strategies_equal_the_cpu_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel B4 has no CPU mode)")
    T, U, k = strategy_problem()
    od, ts = slab_indices(T, 4)
    meshes = {"cuda": (make_mesh((4,), ("data",), ["cuda:0"] * 4),
                       make_mesh((2, 2), ("pod", "data"), ["cuda:0"] * 4)),
              "cpu": (cpu_mesh(), cpu_mesh((2, 2), ("pod", "data")))}
    out = {}
    for dev, (mesh, mesh2) in meshes.items():
        args = [torch.from_numpy(a).to(dev) for a in (T, od, ts, U)]
        before = gather_scores.launches
        out[dev] = {
            "naive": sharded_naive_topk(mesh, ("data", None), ("data",))(
                args[0], args[3], k),
            "blocked": sharded_blocked_topk(
                mesh, (("data", None), (None, "data"), (None, "data")),
                ("data",))(*args, k, 16),
            "hierarchical": hierarchical_merge_topk(
                mesh2, (("pod", "data"), None), ("data",), ("pod",))(
                args[0], args[3], k)}
        launched = gather_scores.launches - before
        assert launched > 0 if dev == "cuda" else launched == 0
        assert launched in (0, int(out[dev]["blocked"].depth[0]) // 16)
    for name, res in out["cuda"].items():
        want = out["cpu"][name]
        assert res.values.device.type == "cuda"
        assert_values(res.values, want.values)
        assert_ids_where_distinct(res.indices, want.indices, want.values)
        for f in ("n_scored", "depth"):
            np.testing.assert_array_equal(host(getattr(res, f)),
                                          host(getattr(want, f)))
