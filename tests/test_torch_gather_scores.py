"""Kernel B4, gather-fused scoring: the port's plain PyTorch version (what
a CPU tensor runs) against the reference's ``gather_scores_pallas`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it), on
the same inputs made with numpy.

Expected agreement: 1e-5 relative (``_torch_parity``): both sum R fp32
products, in different orders. The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_mips import gather_scores_pallas
from repro_torch.kernels.gather_scores import (gather_scores,
                                               gather_scores_plain)

from _torch_parity import assert_values, host


def _ids(rng, m, shape):
    """Ids with repeats: random draws plus both catalogue ends twice."""
    ids = rng.integers(0, m, shape).astype(np.int32)
    flat = ids.reshape(-1)
    flat[:4] = [0, 0, m - 1, m - 1]
    return ids


@pytest.mark.parametrize("m,r,c", [(256, 24, 34), (300, 17, 40),
                                   (128, 100, 7), (64, 32, 1)])
def test_one_query_matches_reference(m, r, c):
    rng = np.random.default_rng(m + r + c)
    T = rng.standard_normal((m, r)).astype(np.float32)
    u = rng.standard_normal(r).astype(np.float32)
    ids = _ids(rng, m, (max(c, 4),))
    want = gather_scores_pallas(jnp.asarray(T), jnp.asarray(ids),
                                jnp.asarray(u))
    got = gather_scores(torch.from_numpy(T), torch.from_numpy(ids),
                        torch.from_numpy(u))
    assert got.shape == ids.shape and got.dtype == torch.float32
    assert_values(got, want)


@pytest.mark.parametrize("b,r", [(3, 8), (5, 50)])
def test_lane_form_matches_vmapped_reference(b, r):
    """``[B, C]`` ids against ``[B, R]`` queries: the reference's form
    under ``vmap`` (how its list tail calls the kernel)."""
    rng = np.random.default_rng(22 + b + r)
    T = rng.standard_normal((64, r)).astype(np.float32)
    U = rng.standard_normal((b, r)).astype(np.float32)
    ids = _ids(rng, 64, (b, 10))
    fn = jax.jit(jax.vmap(
        lambda i, u: gather_scores_pallas(jnp.asarray(T), i, u)))
    want = fn(jnp.asarray(ids), jnp.asarray(U))
    got = gather_scores(torch.from_numpy(T), torch.from_numpy(ids),
                        torch.from_numpy(U))
    assert got.shape == (b, 10)
    assert_values(got, want)
    # each lane equals the one-query form on that lane
    for lane in range(b):
        assert_values(got[lane], gather_scores(
            torch.from_numpy(T), torch.from_numpy(ids[lane]),
            torch.from_numpy(U[lane])))


def test_out_of_range_ids_score_nan_and_cpu_is_not_a_launch():
    rng = np.random.default_rng(3)
    T = torch.from_numpy(rng.standard_normal((20, 6)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    ids = torch.tensor([0, -1, 20, 19], dtype=torch.int32)
    before = gather_scores.launches
    out = host(gather_scores(T, ids, u))
    assert gather_scores.launches == before
    assert np.isnan(out[[1, 2]]).all()
    np.testing.assert_allclose(out[[0, 3]], host(T[[0, 19]] @ u), rtol=1e-6)


def test_shape_and_device_checks():
    T = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="ids \\[C\\] with u"):
        gather_scores_plain(T, torch.zeros((2, 3), dtype=torch.int32),
                            torch.zeros(4))
    with pytest.raises(ValueError, match="lanes"):
        gather_scores(T, torch.zeros((2, 3), dtype=torch.int32),
                      torch.zeros((3, 4)))
    with pytest.raises(ValueError, match="query rank"):
        gather_scores(T, torch.zeros(3, dtype=torch.int32), torch.zeros(5))
    with pytest.raises(ValueError, match="T must be"):
        gather_scores(torch.zeros(10), torch.zeros(3, dtype=torch.int32),
                      torch.zeros(4))
