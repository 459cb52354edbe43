"""Kernel B5, the fixed-arity EmbeddingBag, and the ragged EmbeddingBag of
``models/embedding.py``: the port's plain PyTorch versions (what a CPU
tensor runs) against the reference, on the same inputs made with numpy.

B5 is held against the reference's ``embedding_bag_ref`` and not against
``embedding_bag_pallas``: that kernel calls ``pl.load``/``pl.store``,
which the installed jax no longer has. Tolerances are the reference's own
(``tests/test_kernels.py``): 1e-5 for float32 (two summation orders over
at most 39 rows), 2e-2 for float16 (the reference may sum in float16, the
port sums in float32 and rounds once). The CUDA kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import embedding_bag_ref as ref_bag
from repro.models.embedding import embedding_bag as ref_ragged_bag
from repro.models.embedding import embedding_lookup as ref_lookup
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (SMEM_WORDS, WARPS,
                                               embedding_bag,
                                               embedding_bag_plain,
                                               launch_plan)
from repro_torch.kernels.ref import embedding_bag_ref
from repro_torch.models.embedding import embedding_bag as ragged_bag
from repro_torch.models.embedding import embedding_lookup

from _torch_parity import host

TOL = {np.float32: 1e-5, np.float16: 2e-2}


def _assert_close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(host(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("b,f,v,d", [(8, 4, 100, 8), (13, 26, 500, 16),
                                     (32, 39, 200, 10), (32, 39, 200, 1)])
def test_fixed_bag_matches_reference(b, f, v, d, dtype, mode):
    """The sweep of ``tests/test_kernels.py`` in both modes, plus d = 1
    (the first-order term's ``[V, 1]`` table)."""
    rng = np.random.default_rng(b * f + d)
    table = rng.standard_normal((v, d)).astype(dtype)
    ids = rng.integers(0, v, (b, f)).astype(np.int32)
    want = ref_bag(jnp.asarray(table), jnp.asarray(ids), mode=mode)
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for fn in (embedding_bag_plain, ops.embedding_bag):
        got = fn(t, i, mode)
        assert got.shape == (b, d) and got.dtype == t.dtype
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_oracle_matches_reference_oracle_with_weights(mode):
    rng = np.random.default_rng(5)
    table = rng.standard_normal((60, 6)).astype(np.float32)
    ids = rng.integers(0, 60, (9, 7)).astype(np.int32)
    w = rng.random((9, 7)).astype(np.float32)
    for weights in (None, w):
        want = ref_bag(jnp.asarray(table), jnp.asarray(ids),
                       None if weights is None else jnp.asarray(weights),
                       mode=mode)
        got = embedding_bag_ref(
            torch.from_numpy(table), torch.from_numpy(ids),
            None if weights is None else torch.from_numpy(weights), mode)
        _assert_close(got, want, np.float32)


def test_ids_follow_jnp_take_and_cpu_is_not_a_launch():
    """``[-V, 0)`` counts from the end; ids outside ``[-V, V)`` make their
    bag NaN, in the reference and in the port, and a CPU call launches
    nothing."""
    rng = np.random.default_rng(9)
    table = rng.standard_normal((20, 3)).astype(np.float32)
    ids = np.array([[0, 1, 2], [-1, -20, 5], [20, 0, 1], [3, -21, 4]],
                   np.int32)
    want = np.asarray(ref_bag(jnp.asarray(table), jnp.asarray(ids)))
    assert np.isnan(want[2:]).all() and np.isfinite(want[:2]).all()
    before = embedding_bag.launches
    for mode in ("sum", "mean"):
        got = host(embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids), mode))
        assert np.isnan(got[2:]).all()
        ref = np.asarray(ref_bag(jnp.asarray(table), jnp.asarray(ids),
                                 mode=mode))
        np.testing.assert_allclose(got[:2], ref[:2], rtol=1e-6, atol=1e-6)
    assert embedding_bag.launches == before
    np.testing.assert_array_equal(
        host(embedding_lookup(torch.from_numpy(table),
                              torch.from_numpy(ids))),
        np.asarray(ref_lookup(jnp.asarray(table), jnp.asarray(ids))))


def test_fixed_bag_checks_its_operands():
    t = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="ids \\[B, F\\]"):
        embedding_bag(t, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown mode"):
        embedding_bag(t, torch.zeros((2, 3), dtype=torch.int32), "max")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_ragged_bag_matches_reference(mode, weighted):
    """Unsorted segments, an empty bag (sum 0, mean 0, max -inf) and an
    entry whose segment is out of range (dropped)."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((40, 5)).astype(np.float32)
    n, bags = 30, 7
    flat = rng.integers(0, 40, n).astype(np.int32)
    seg = rng.integers(0, bags, n).astype(np.int32)
    seg[seg == 3] = 4                    # bag 3 stays empty
    seg[0] = bags                        # dropped
    w = rng.random(n).astype(np.float32) if weighted else None
    want = ref_ragged_bag(jnp.asarray(table), jnp.asarray(flat),
                          jnp.asarray(seg), bags, mode=mode,
                          weights=None if w is None else jnp.asarray(w))
    got = ragged_bag(torch.from_numpy(table), torch.from_numpy(flat),
                     torch.from_numpy(seg), bags, mode=mode,
                     weights=None if w is None else torch.from_numpy(w))
    assert got.shape == (bags, 5)
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_ragged_bag_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        ragged_bag(torch.zeros((4, 2)), torch.zeros(3, dtype=torch.int32),
                   torch.zeros(3, dtype=torch.int32), 2, mode="min")


@pytest.mark.parametrize("b,f,d", [
    (262144, 39, 1), (262144, 39, 10),    # serve_bulk's two calls
    (512, 39, 1), (512, 39, 10),          # serve_p99's
    (33, 7, 64), (5, 0, 3), (3, 5, 300), (7, 20000, 1), (1000, 38, 16),
])
def test_launch_plan(b, f, d):
    """The path by d; on the bags path, a block's 8 warps x 2 buffers of
    odd-length rows fit SMEM_WORDS, a chunk takes every field where they
    fit, and 32-bag tasks cover the batch; on the cols path, a thread per
    output."""
    plan = launch_plan(b, f, d)
    if d != 1 or f == 0:
        assert plan.path == "cols" and plan.smem == 0
        assert plan.tasks * 256 >= b * d > (plan.tasks - 1) * 256
        return
    FC = plan.fields
    assert plan.path == "bags" and 1 <= FC <= f
    assert plan.buf_words >= 32 * (FC | 1) + 3 and plan.buf_words % 4 == 0
    assert plan.smem == 4 * 2 * WARPS * plan.buf_words <= 4 * SMEM_WORDS
    assert FC == f or 32 * ((FC + 1) | 1) + 6 > SMEM_WORDS // (2 * WARPS)
    assert plan.tasks == -(-b // 32)
