"""Parity of the port's admission ladder with the JAX reference's, on the
CPU: the reference's ladder tests (tests/test_serving.py) run on both
servers with the same forced cost model (``_cost_ewma``), comparing the
rungs taken (``degradations``), ``n_uncertified``, values, ids and the
certificate bound ``upper``; the policy's default deadline; the warmed
cost table as the ladder's fallback; and the host oracles served by name.

Values are held to 1e-5 relative + 1e-4 absolute (two fp32 summation
orders), ``upper`` (a query norm times a catalogue norm) to 1e-6
relative; ids and counts are equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import random_model as ref_random_model
from repro.serving.server import AdmissionPolicy as RefPolicy
from repro.serving.server import TopKServer as RefServer
from repro_torch.core import SepLRModel
from repro_torch.serving.server import AdmissionPolicy, TopKServer

RTOL, ATOL = 1e-5, 1e-4


def _servers(seed, m, policy=None):
    """The reference's server and the port's over the same catalogue."""
    rng = np.random.default_rng(seed)
    ref_model = ref_random_model(rng, m, 16, "lowrank_spectrum")
    ref_pol = None if policy is None else RefPolicy(**policy)
    pol = None if policy is None else AdmissionPolicy(**policy)
    ref = RefServer(ref_model, max_batch=8, block_size=64, policy=ref_pol)
    srv = TopKServer(SepLRModel(np.array(ref_model.targets), device="cpu"),
                     max_batch=8, block_size=64, policy=pol, device="cpu")
    return ref, srv, rng


def _query_both(ref, srv, U, k, method, **kw):
    want = ref.query(jnp.asarray(U), k, method, **kw)
    got = srv.query(U, k, method, **kw)
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_allclose(got.upper, np.asarray(want.upper), rtol=1e-6)
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), f)
    return got, want


def _same_ladder_stats(ref, srv, method):
    a, b = srv.stats[method], ref.stats[method]
    assert a.degradations == b.degradations
    assert a.n_uncertified == b.n_uncertified
    return a


def test_admission_ladder_downgrades_and_records():
    """A deadline too tight for ``bta`` (per the forced cost model) takes
    ``to_norm`` — exact — then, with ``norm`` slow too, ``to_budgeted``,
    whose certified slots are a prefix of the true top-K."""
    ref, srv, rng = _servers(30, 600, {"degrade_budget": 16})
    U = rng.standard_normal((8, 16)).astype(np.float32)
    exact, _ = _query_both(ref, srv, U, 5, "naive")
    for s in (ref, srv):
        s._cost_ewma.update({"bta": 10.0, "norm": 1e-9})
    res, _ = _query_both(ref, srv, U, 5, "bta", deadline_ms=50.0)
    assert _same_ladder_stats(ref, srv, "bta").degradations == {"to_norm": 1}
    np.testing.assert_allclose(res.values, exact.values, rtol=RTOL,
                               atol=ATOL)
    assert srv.stats["norm"].n_queries == ref.stats["norm"].n_queries == 8
    for s in (ref, srv):
        s._cost_ewma.update({"norm": 10.0})
    res, _ = _query_both(ref, srv, U, 5, "bta", deadline_ms=50.0)
    st = _same_ladder_stats(ref, srv, "bta")
    assert st.degradations == {"to_norm": 1, "to_budgeted": 1}
    certified = (res.upper[:, None] - res.values) <= 0
    assert st.n_uncertified == int((~certified).any(axis=1).sum()) > 0
    for q in range(U.shape[0]):
        c = int(certified[q].sum())
        np.testing.assert_allclose(res.values[q, :c], exact.values[q, :c],
                                   rtol=RTOL, atol=ATOL)
    # the budgeted variant learned its own cost entry, as the reference's
    assert set(srv._cost_ewma) == set(ref._cost_ewma)


def test_expired_deadline_sheds_with_sentinels():
    ref, srv, rng = _servers(31, 400)
    U = rng.standard_normal((10, 16)).astype(np.float32)
    res, _ = _query_both(ref, srv, U, 5, "norm", deadline_ms=0.0)
    assert (res.indices == -1).all() and (res.values == -np.inf).all()
    assert (res.upper == np.inf).all()              # nothing certified
    st = _same_ladder_stats(ref, srv, "norm")
    assert st.degradations == {"shed": 2} and st.n_uncertified == 10
    # shed_on_overload=False: the expired deadline downgrades instead
    for s in (ref, srv):
        s.policy.shed_on_overload = False
    res, _ = _query_both(ref, srv, U, 5, "norm", deadline_ms=0.0)
    assert (res.indices[:, 0] >= 0).all()
    st = _same_ladder_stats(ref, srv, "norm")
    assert st.degradations == {"shed": 2, "to_budgeted": 2}


def test_overload_sheds_at_max_inflight():
    ref, srv, rng = _servers(32, 400, {"max_inflight": 0})
    U = rng.standard_normal((4, 16)).astype(np.float32)
    res, _ = _query_both(ref, srv, U, 5, "norm")
    assert (res.indices == -1).all()
    assert _same_ladder_stats(ref, srv, "norm").degradations == {"shed": 1}
    for s in (ref, srv):
        s.policy.max_inflight = 8
    res, _ = _query_both(ref, srv, U, 5, "norm")
    assert (res.indices[:, 0] >= 0).all()
    assert srv._inflight == ref._inflight == 0


def test_no_deadline_path_is_unchanged_and_fully_certified():
    ref, srv, rng = _servers(33, 500)
    U = rng.standard_normal((8, 16)).astype(np.float32)
    res, _ = _query_both(ref, srv, U, 5, "norm")
    st = _same_ladder_stats(ref, srv, "norm")
    assert st.degradations == {} and st.n_uncertified == 0
    assert ((res.upper[:, None] - res.values) <= 0).all()


def test_policy_deadline_is_the_default_and_a_call_overrides_it():
    policy = {"deadline_ms": 0.0}
    ref, srv, rng = _servers(34, 300, policy)
    U = rng.standard_normal((8, 16)).astype(np.float32)
    res, _ = _query_both(ref, srv, U, 5, "naive")
    assert (res.indices == -1).all()
    assert _same_ladder_stats(ref, srv, "naive").degradations == {"shed": 1}
    res, _ = _query_both(ref, srv, U, 5, "naive", deadline_ms=1e6)
    assert (res.indices[:, 0] >= 0).all()
    assert _same_ladder_stats(ref, srv, "naive").degradations == {"shed": 1}
    assert dataclasses.asdict(AdmissionPolicy()) == dataclasses.asdict(
        RefPolicy())


def test_the_same_inputs_are_refused():
    ref, srv, rng = _servers(35, 200)
    U = rng.standard_normal((4, 16)).astype(np.float32)
    for kw, match in (({"deadline_ms": -1.0}, "deadline_ms must be"),
                      ({"budget": 0}, "budget must be")):
        for s, u in ((ref, jnp.asarray(U)), (srv, U)):
            with pytest.raises(ValueError, match=match):
                s.query(u, 5, "norm", **kw)
    for s in (ref, srv):
        with pytest.raises(ValueError, match="k must be"):
            s.query(U, 0, "norm", deadline_ms=5.0)


def test_warmup_primes_the_ladders_fallback():
    """With ``_cost_ewma`` empty the ladder reads the warmed cost table:
    an engine measured as slow is downgraded on the first query."""
    rng = np.random.default_rng(5)
    T = rng.standard_normal((517, 20)).astype(np.float32)
    U = rng.standard_normal((8, 20)).astype(np.float32)
    srv = TopKServer(SepLRModel(T, device="cpu"), max_batch=8,
                     policy=AdmissionPolicy(deadline_ms=50.0), device="cpu")
    srv.warmup(5, batch_sizes=(1, 8), engines=["bta", "norm"],
               budgets=(64,))
    ct = srv.cost_table
    assert ct.engine_cost("bta") is not None
    assert ct.predict("norm@budget", 8, "", granular_only=True) is not None
    # the ladder's reads pinned, so that no wall-clock cost that warmup
    # measured on a loaded host decides the rung: bta far over the 50 ms
    # deadline, norm (the first fallback) far under it
    for _ in range(64):
        ct.observe("bta", 8, "", 10.0)
        ct.observe("norm", 8, "", 1e-9)
    assert not srv._cost_ewma
    res = srv.query(U, 5, "bta")
    assert sum(srv.stats["bta"].degradations.values()) == 1
    exact = np.sort(U.astype(np.float64) @ T.T.astype(np.float64),
                    axis=1)[:, ::-1][:, :5]
    np.testing.assert_allclose(res.values, exact, rtol=RTOL, atol=ATOL)


def test_server_host_oracle_methods():
    """The host oracles serve by name, their values equal ``ta``'s and
    the reference server's."""
    rng = np.random.default_rng(11)
    ref_model = ref_random_model(rng, 300, 8, "lowrank_spectrum")
    ref = RefServer(ref_model, max_batch=4, block_size=16)
    srv = TopKServer(SepLRModel(np.array(ref_model.targets), device="cpu"),
                     max_batch=4, block_size=16, device="cpu")
    U = np.random.default_rng(12).standard_normal((4, 8)).astype(np.float32)
    r_ta = srv.query(U, 5, "ta")
    for oracle in ("fagin", "partial"):
        got, _ = _query_both(ref, srv, U, 5, oracle)
        np.testing.assert_allclose(got.values, r_ta.values, rtol=RTOL,
                                   atol=ATOL)
        assert srv.stats[oracle].n_queries == 4
    np.testing.assert_array_equal(srv.stats["partial"].n_scored,
                                  srv.stats["ta"].n_scored)
