"""Shared assertions for the parity tests between ``repro`` (the JAX
reference) and ``repro_torch`` (the port): results cross as numpy."""

import numpy as np
import torch

# Both packages score in fp32 but sum the R products in different orders
# (XLA:CPU vs PyTorch's CPU GEMM): a few ulps, so 1e-5 relative; the small
# absolute term covers scores that cancel to near zero.
RTOL, ATOL = 1e-5, 1e-6


def host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_values(got, want):
    np.testing.assert_allclose(host(got), host(want), rtol=RTOL, atol=ATOL)


def assert_ids_where_distinct(got_ids, want_ids, want_vals):
    """Ids equal at every slot whose score is distinct from its
    neighbours' (a tie may legitimately permute equal scores)."""
    got_ids, want_ids = host(got_ids), host(want_ids)
    v = np.atleast_2d(host(want_vals)).astype(np.float64)
    tol = ATOL + RTOL * np.abs(v)
    gaps = np.abs(np.diff(v, axis=-1))
    inf = np.full(v.shape[:-1] + (1,), np.inf)
    near = np.minimum(np.concatenate([inf, gaps], -1),
                      np.concatenate([gaps, inf], -1)) <= tol
    distinct = ~near.reshape(np.shape(want_ids))
    np.testing.assert_array_equal(got_ids[distinct], want_ids[distinct])


def assert_topk_equal(got, want):
    """(values, ids) of two top-K results, values within tolerance."""
    assert_values(got[0], want[0])
    assert_ids_where_distinct(got[1], want[1], want[0])
