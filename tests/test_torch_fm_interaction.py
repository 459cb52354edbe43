"""Kernel B6, the FM sum-square interaction: the port's plain PyTorch
version (what a CPU tensor runs) and ``ops.fm_interaction`` against the
reference's ``fm_interaction_pallas`` (in interpret mode, through the
reference's ``ops.fm_interaction``, as ``tests/test_kernels.py`` runs it)
and against its ``fm_interaction_ref``, on the same inputs made with
numpy.

Tolerances are the reference's own (``tests/test_kernels.py``): 1e-3 for
float32 (the result sums F * d squares and cancels them against the
square of the sum), 5e-2 for float16 (one rounding of the output to
float16). The CUDA kernel itself is held against the plain version on
the card by ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import fm_interaction as ref_fm_pallas
from repro.kernels.ref import fm_interaction_ref as ref_fm
from repro_torch.kernels import ops
from repro_torch.kernels.fm_interaction import (fm_interaction,
                                                fm_interaction_plain)
from repro_torch.kernels.ref import fm_interaction_ref

from _torch_parity import host

TOL = {np.float32: 1e-3, np.float16: 5e-2}


def _assert_close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(host(got).astype(np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("b,f,d", [(16, 4, 8), (50, 39, 10), (128, 26, 16),
                                   (7, 2, 3), (100, 39, 10)])
def test_matches_pallas_kernel_and_oracle(b, f, d, dtype):
    """``tests/test_kernels.py``'s sweep, plus B = 100 (not a multiple of
    the reference's default ``block_b`` of 64: its ``ops`` pads)."""
    rng = np.random.default_rng(b + f + d)
    emb = (rng.standard_normal((b, f, d)) * 0.5).astype(dtype)
    pallas = ref_fm_pallas(jnp.asarray(emb))
    oracle = ref_fm(jnp.asarray(emb).astype(jnp.float32))
    e = torch.from_numpy(emb)
    for fn in (fm_interaction_plain, ops.fm_interaction):
        got = fn(e)
        assert got.shape == (b,) and got.dtype == e.dtype
        _assert_close(got, pallas, dtype)
        _assert_close(got, oracle, dtype)


def test_matches_explicit_pairwise():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((4, 6, 5)).astype(np.float32)
    out = host(fm_interaction(torch.from_numpy(emb)))
    for b in range(4):
        explicit = sum(float(emb[b, i] @ emb[b, j])
                       for i in range(6) for j in range(i + 1, 6))
        assert abs(out[b] - explicit) < 1e-3


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_oracle_matches_reference_oracle(dtype):
    rng = np.random.default_rng(4)
    emb = (rng.standard_normal((9, 5, 4)) * 0.5).astype(dtype)
    got = fm_interaction_ref(torch.from_numpy(emb))
    assert got.dtype == torch.from_numpy(emb).dtype
    _assert_close(got, ref_fm(jnp.asarray(emb)), dtype)


def test_cpu_is_not_a_launch_and_operands_are_checked():
    before = fm_interaction.launches
    fm_interaction(torch.zeros((3, 2, 4)))
    assert fm_interaction.launches == before
    with pytest.raises(ValueError, match="emb must be"):
        fm_interaction(torch.zeros((3, 4)))
