"""Kernel B4, gather-fused scoring: the port's plain PyTorch version (what
a CPU tensor runs) against the reference's ``gather_scores_pallas`` (the
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it), on
the same inputs made with numpy.

Expected agreement: 1e-5 relative (``_torch_parity``): both sum R fp32
products, in different orders. The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``; its launch plan
(path, lane group, grid) is a plain function, tested here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk_mips import gather_scores_pallas
from repro_torch.kernels.gather_scores import (FEW_LANES, LANE_COLS,
                                               gather_scores,
                                               gather_scores_plain,
                                               launch_plan)

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


def _lane_cover(plan, B, C):
    """How many times the lane path's threads reach each (lane, column):
    block (x, y), thread t and its p-th column, as the kernel maps them."""
    seen = np.zeros((B, C), np.int64)
    G, cols = plan.group, plan.cols
    t = np.arange(plan.threads)
    g, sub = t % G, t // G
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            for p in range(LANE_COLS):
                b = y * G + g
                c = x * cols + sub + p * (plan.threads // G)
                ok = (b < B) & (c < min(C, (x + 1) * cols))
                np.add.at(seen, (b[ok], c[ok]), 1)
    return seen


@pytest.mark.parametrize("B", [1, 4, 64])
@pytest.mark.parametrize("R", [10, 100, 4096])
def test_launch_plan(R, B):
    """The path by B, the lane group G (the power of two from 4 to 32
    that B needs), the widest row load R allows, shared memory under the
    48 KB a launch takes without opting in, and a grid whose threads
    reach every (lane, column) exactly once."""
    C = 2560
    plan = launch_plan(B, C, R)
    assert plan.path == ("rows" if B < FEW_LANES else "lanes")
    if plan.path == "rows":
        assert plan.grid == (-(-C // 32), B) and plan.smem == 4 * R
        return
    G = plan.group
    assert G & (G - 1) == 0 and 4 <= G <= 32 and (G < 2 * B or G == 4)
    assert plan.smem <= 48 * 1024
    assert plan.vec == (4 if R % 4 == 0 else 2 if R % 2 == 0 else 1)
    assert plan.threads == plan.cols * G // LANE_COLS
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    assert plan.grid == (-(-C // plan.cols), -(-B // G))
    assert (_lane_cover(plan, B, C) == 1).all()


def test_launch_plan_expected_groups_and_overrides():
    main = launch_plan(64, 25600, 100)                  # the main path
    assert (main.group, main.vec, main.cols, main.threads) == (32, 4, 32, 256)
    assert launch_plan(64, 25600, 4096).group == 32
    assert launch_plan(5, 100, 100, path="lanes").group == 8
    assert launch_plan(64, 25600, 100, address=8).vec == 2
    assert launch_plan(64, 25600, 100, address=4).vec == 1
    assert launch_plan(64, 100, 50, path="rows").path == "rows"
    lanes = launch_plan(1, 1000, 17, path="lanes")
    assert lanes.path == "lanes" and lanes.group == 4 and lanes.vec == 1
    assert (_lane_cover(lanes, 1, 1000) == 1).all()
    # a small grid gets a narrower tile, down to 16 columns
    assert launch_plan(64, 2560, 10).cols == 16
    for B, C in ((300, 2560), (33, 1000), (64, 16), (5, 3000)):
        plan = launch_plan(B, C, 10)
        assert (_lane_cover(plan, B, C) == 1).all()
    with pytest.raises(ValueError, match="unknown path"):
        launch_plan(4, 10, 10, path="cols")
