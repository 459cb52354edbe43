"""Parity of the port's host oracles with the JAX reference's, on the CPU:
Table 1's toy and Table 2's adversarial set, ``fagin_topk_np`` and
``partial_threshold_topk_np`` (values, ids and every statistic, equal: both
packages run the same numpy arithmetic), the ``fagin`` and ``partial``
registry engines, Theorem 4 (``partial`` touches exactly TA's items) and
Table 1's counts through the port's engines."""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import fagin as ref_fagin
from repro.core import partial as ref_partial
from repro.core import toy as ref_toy
from repro.core.engines import EngineContext as RefContext
from repro.core.engines import get_engine as ref_get_engine
from repro.core.index import build_index as ref_build_index
from repro_torch.core import (FaginStats, PartialTAStats, build_index,
                              fagin_topk_np, partial_threshold_topk_np,
                              threshold_topk_np)
from repro_torch.core import toy
from repro_torch.core.engines import EngineContext, get_engine

from _torch_parity import host


def _order(T):
    order = host(build_index(T, device="cpu").order_desc)
    np.testing.assert_array_equal(
        order, np.asarray(ref_build_index(jnp.asarray(T)).order_desc))
    return order


def _problems():
    """(name, T, u, k): the toy, Table 2, and seeded random catalogues with
    dense, sparse, negative and mixed-sign queries."""
    out = [("toy", toy.TOY_T, toy.TOY_U, 1), ("toy_k3", toy.TOY_T,
                                              toy.TOY_U, 3)]
    T2, u2 = toy.table2_adversarial(400)
    out.append(("table2", T2, u2, 1))
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        m, r = (150, 6) if seed % 2 else (90, 10)
        T = rng.standard_normal((m, r)).astype(np.float32)
        u = rng.standard_normal(r).astype(np.float32)
        if seed == 1:
            u[::2] = 0.0
        elif seed == 2:
            u = -np.abs(u)
        out.append((f"random{seed}", T, u, 5))
    return out


PROBLEMS = {name: (T, u, k) for name, T, u, k in _problems()}


def test_toy_data_equals_the_reference():
    np.testing.assert_array_equal(toy.TOY_T, ref_toy.TOY_T)
    np.testing.assert_array_equal(toy.TOY_U, ref_toy.TOY_U)
    np.testing.assert_array_equal(toy.TOY_SCORES, ref_toy.TOY_SCORES)
    assert toy.TOY_BEST_ITEM == ref_toy.TOY_BEST_ITEM == 5
    for m in (10, 400):
        for got, want in zip(toy.table2_adversarial(m),
                             ref_toy.table2_adversarial(m)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_fagin_oracle_matches_reference(name):
    T, u, k = PROBLEMS[name]
    order = _order(T)
    v, i, st = fagin_topk_np(T, order, u, k)
    rv, ri, rst = ref_fagin.fagin_topk_np(T, order, u, k)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(i, ri)
    assert isinstance(st, FaginStats)
    assert tuple(st) == tuple(rst) and st._fields == rst._fields


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_partial_oracle_matches_reference(name):
    T, u, k = PROBLEMS[name]
    order = _order(T)
    v, i, st = partial_threshold_topk_np(T, order, u, k)
    rv, ri, rst = ref_partial.partial_threshold_topk_np(T, order, u, k)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(i, ri)
    assert isinstance(st, PartialTAStats)
    assert tuple(st) == tuple(rst) and st._fields == rst._fields
    # Theorem 4's logic: the same items as TA, never more than R terms each
    _, _, ta = threshold_topk_np(T, order, u, k)
    assert st.n_items_touched == ta.n_scored and st.depth == ta.depth
    assert st.avg_score_fraction <= 1.0 + 1e-9


def test_table1_and_table2_counts():
    order = _order(toy.TOY_T)
    _, ids, fa = fagin_topk_np(toy.TOY_T, order, toy.TOY_U, 1)
    assert ids[0] == toy.TOY_BEST_ITEM and (fa.n_scored, fa.depth) == (9, 5)
    _, ids, pa = partial_threshold_topk_np(toy.TOY_T, order, toy.TOY_U, 1)
    assert ids[0] == toy.TOY_BEST_ITEM
    assert (pa.n_items_touched, pa.depth) == (5, 2)
    T, u = toy.table2_adversarial(400)
    order = _order(T)
    _, _, ta = threshold_topk_np(T, order, u, 1)
    _, _, fa = fagin_topk_np(T, order, u, 1)
    assert ta.depth == 2 and fa.depth >= 180     # Theorem 3: ~M/2


@pytest.mark.parametrize("name", ["fagin", "partial"])
@pytest.mark.parametrize("regime", ["dense", "sparse", "negative"])
def test_oracle_engines_match_reference(name, regime):
    rng = np.random.default_rng(7)
    T = rng.standard_normal((200, 8)).astype(np.float32)
    U = rng.standard_normal((3, 8)).astype(np.float32)
    if regime == "sparse":
        U[:, 1::2] = 0.0
    elif regime == "negative":
        U = -np.abs(U)
    ctx = EngineContext(T, block_size=16, device="cpu")
    ref = RefContext(jnp.asarray(T), block_size=16)
    eng = get_engine(name)
    assert eng.host_only and not eng.supports_batch and eng.backend == "numpy"
    assert not eng.has_executable and eng.dispatch is not None
    got = eng.run(ctx, U, 6)
    want = ref_get_engine(name).run(ref, jnp.asarray(U), 6)
    for field in ("values", "indices", "n_scored", "depth", "upper"):
        np.testing.assert_array_equal(host(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert got.values.device == ctx.device
    # exact engines: a vacuous bound, every slot certified
    assert bool((got.upper == float("-inf")).all())
    with pytest.raises(ValueError, match="does not support budgeted"):
        eng.run(ctx, U, 6, budget=10)


@pytest.mark.parametrize("regime", ["dense", "sparse", "mixed"])
def test_theorem4_partial_touches_ta_items_through_the_engines(regime):
    rng = np.random.default_rng(12)
    T = rng.standard_normal((300, 10)).astype(np.float32)
    U = rng.standard_normal((4, 10)).astype(np.float32)
    if regime == "sparse":
        U[:, :7] = 0.0
    elif regime == "mixed":
        U[:, ::2] = np.abs(U[:, ::2])
        U[:, 1::2] = -np.abs(U[:, 1::2])
    ctx = EngineContext(T, block_size=16, device="cpu")
    r_ta = get_engine("ta").run(ctx, U, 5)
    r_p = get_engine("partial").run(ctx, U, 5)
    r_f = get_engine("fagin").run(ctx, U, 5)
    np.testing.assert_allclose(host(r_p.values), host(r_ta.values),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(host(r_f.values), host(r_ta.values),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(host(r_p.n_scored), host(r_ta.n_scored))
    assert (host(r_ta.n_scored) <= host(r_f.n_scored)).all()


def test_table1_counts_through_the_engines():
    ctx = EngineContext(toy.TOY_T, device="cpu")
    for name, scored, depth in (("fagin", 9, 5), ("ta", 5, 2),
                                ("partial", 5, 2)):
        res = get_engine(name).run(ctx, toy.TOY_U, 1)
        assert int(res.indices[0, 0]) == toy.TOY_BEST_ITEM, name
        assert (int(res.n_scored[0]), int(res.depth[0])) == (scored, depth)
