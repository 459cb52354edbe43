"""The ``topk_mips``, ``gather_scores``, ``embedding_bag`` and
``fm_interaction`` CUDA kernels against their plain PyTorch versions, on
the card, and the engines and server paths that launch them (``ta``,
``auto``, the admission ladder) against the same paths on the CPU; and
the MoE feed-forward (``moe_ffn``, ``moe_ffn_ep`` on card meshes of
logical shards) and the LM's top-K head (unsharded and vocab-sharded),
which run no kernel, on the card against the CPU. These
tests need a CUDA device (the kernels have no CPU mode) and skip with a
reason where there is none; the file
imports no jax, so it also runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Agreement: ``topk_mips`` values within 1e-5 relative (the kernel sums
each row in lane order, the plain version in cuBLAS's), ids equal
wherever scores are distinct, stats equal exactly. ``gather_scores``
scores every candidate, near-zero sums included, so it is held, as in
``chip_smoke.py``, to 1e-5 relative plus 1e-4 absolute: two fp32
summation orders over R <= 200 products of magnitude ~1 differ by a few
ulps of the largest partial sum (about 2e-6 measured at R = 100).
``embedding_bag`` and ``fm_interaction`` are held to the same 1e-5
relative plus 1e-4 absolute in float32 (fp32 sums in another order). In
float16 both versions sum in fp32 and round the output once, so they may
differ by one float16 ulp (at most 2**-10 relative): they are held to 2e-3
relative plus 1e-3 of the case's largest finite value (for outputs that
cancel to near zero), far inside the reference's 5e-2, so a wrong scale
or an output of zeros fails. The MoE runs are held at fp32 to 1e-5
relative plus 1e-4 absolute (cuBLAS against the CPU's GEMMs, TF32 off)
and at bf16 to 3% of the largest value (``tests/test_torch_moe.py``'s
``BF16_TOL``), with the same experts chosen and drop rates within 1e-6
(fp32 rounding of ``1 -`` a sum of kept shares; one assignment moves the
rate by 1/384); the
head's values to 1e-5 relative plus 1e-4 absolute and its ids id for
id. The recsys training path's gradients (B5's, the field lookup's and
B6's backward passes, plain PyTorch behind the kernels' forward, and a
DeepFM training step) are held to the CPU's at 1e-5 relative plus 1e-6
absolute (the same algorithm; fp32 sums in other orders), the table
gradients also to a float64 sum within a pairwise sum's rounding (rows
that zipf ids reach thousands of times: a fixed relative tolerance does
not bound such sums in another order), and two identical backward passes
or steps on the card must be bitwise equal: the table gradient's scatter
is a stable sort and a segmented sum in a fixed order, with no atomics.
The LM's token lookup (``index_rows``) is held the same way, and the LM
``loss_fn`` (remat, chunked head) at the smoke configs to the CPU's
within 1e-5 normwise at fp32 and 5e-2 at bf16 (the CPU tests' limits
against the reference), two card passes bitwise equal; the MoE config at
bf16 with its routing held up to each row's first flip, a near-tie, and
its gradient to the CPU's fp32 one. The PNA GNN's ``loss_fn`` (no kernel)
at the smoke config, node and graph tasks: the loss and every gradient
leaf within 1e-5 normwise of the CPU's or 10 times the CPU's own fp32
error against its float64 run, two card passes bitwise equal; and
``hashed_lookup``'s rows and gradient bitwise the CPU's."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.kernels.embedding_bag import launch_plan as bag_plan
from repro_torch.kernels.fm_interaction import (fm_interaction,
                                                fm_interaction_plain)
from repro_torch.kernels.gather_scores import (FEW_LANES, gather_scores,
                                               gather_scores_plain,
                                               launch_plan)
from repro_torch.kernels.ops import MIPSCatalog
from repro_torch.kernels.topk_mips import (MODES, query_slices, topk_mips,
                                          topk_mips_plain, walk_path)

from _torch_parity import assert_topk_equal

B4_RTOL, B4_ATOL = 1e-5, 1e-4
F16_RTOL, F16_ATOL_OF_MAX = 2e-3, 1e-3


def _assert_b4(got, want):
    torch.testing.assert_close(got, want, rtol=B4_RTOL, atol=B4_ATOL,
                               equal_nan=True)


def _fp32_sum_excess(got, terms):
    """How far ``got`` (any shape) lies outside the tolerance around the
    float64 sum of ``terms`` (its shape plus a last axis of n summands);
    <= 0 inside. The tolerance is sqrt(n) * 2**-24 * sum |term|, plus one
    ulp for the final rounding: each of an fp32 order's n additions
    rounds within 2**-24 of a partial sum no larger than sum |term|, and
    the roundings add up like a random walk (Higham's sqrt(n) rule of
    thumb). The worst case of any order, n * 2**-24 * sum |term|, is too
    wide for these sums: at F = 20,000 it would pass a dropped field
    chunk. For sums too long for the fixed 1e-5 relative + 1e-4 absolute
    (R = 4096, F = 20,000)."""
    exact = terms.double().sum(-1)
    n = terms.shape[-1]
    tol = n ** 0.5 * 2.0 ** -24 * terms.double().abs().sum(-1) \
        + 2.0 ** -23 * exact.abs()
    return float(((got.double() - exact).abs() - tol).max())


def _assert_fp32_sum(got, terms):
    excess = _fp32_sum_excess(got, terms)
    assert excess <= 0, excess

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _catalogue(rng, m, r, kind):
    """decaying norms, flat (unit) norms, or decaying with every row
    duplicated (ties within and across tiles)."""
    T = rng.standard_normal((m, r)).astype(np.float32)
    if kind == "flat":
        return T / np.linalg.norm(T, axis=1, keepdims=True)
    T *= ((1.0 / (1.0 + np.arange(m)))[:, None] ** 0.3).astype(np.float32)
    if kind == "dup":      # runs of 3 straddle the tile boundaries
        T = np.repeat(T[: m // 3], 3, axis=0)
    return T


@pytest.mark.parametrize("m,r,k,block,b,kind", [
    (20000, 50, 10, 256, 33, "decaying"),  # the pre-screen cuts the scan
    (3000, 17, 3, 64, 33, "decaying"),     # R with no 16-byte row alignment
    (5, 8, 10, 256, 33, "decaying"),       # fewer real rows than k
    (4000, 24, 100, 64, 33, "decaying"),   # k > block_m: whole-tile lists
    (600, 4096, 10, 64, 33, "decaying"),   # R = 4096: a few rows a stage
    (20000, 100, 10, 256, 1, "decaying"),  # B = 1 (MIPSCatalog.query)
    (3000, 50, 10, 64, 33, "dup"),         # ties within and across tiles
    (5000, 100, 10, 128, 130, "flat"),     # nearly every tile visited; B > 64
    (3000, 17, 5, 50, 33, "decaying"),     # block_m * R % 4 != 0: cp.async
])
def test_cuda_kernel_matches_plain_version(m, r, k, block, b, kind):
    _need_card()
    rng = np.random.default_rng(m + r)
    T = _catalogue(rng, m, r, kind)
    cat = MIPSCatalog(T, block_m=block, superblock=8, device="cuda")
    U = rng.standard_normal((b, r)).astype(np.float32)
    for mode in MODES:
        args = cat.kernel_args(U, k, mode)
        before = topk_mips.launches
        got = topk_mips(**args)
        assert topk_mips.launches == before + 1     # one per call
        want = topk_mips_plain(**args)
        torch.cuda.synchronize()
        assert_topk_equal(got[:2], want[:2])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


def test_cuda_kernel_takes_any_tile_bounds():
    """Non-monotone bounds: every tile up to n_tiles is gated on its own
    bound (no early stop), on the card as in the plain version."""
    _need_card()
    rng = np.random.default_rng(3)
    T = _catalogue(rng, 6000, 20, "decaying")
    cat = MIPSCatalog(T, block_m=64, superblock=4, device="cuda")
    U = rng.standard_normal((40, 20)).astype(np.float32)
    for mode in MODES:
        args = cat.kernel_args(U, 7, mode)
        perm = torch.from_numpy(rng.permutation(cat.n_blocks)).cuda()
        scale = torch.from_numpy(rng.uniform(0.3, 1.5, cat.n_blocks)
                                 .astype(np.float32)).cuda()
        args["tile_bounds"] = (args["tile_bounds"][:, perm]
                               * scale).contiguous()
        got = topk_mips(**args)
        want = topk_mips_plain(**args)
        torch.cuda.synchronize()
        assert_topk_equal(got[:2], want[:2])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


def test_cuda_kernel_runs_a_batch_in_scratch_bounded_slices():
    """A batch whose phase-1 scratch exceeds the wrapper's budget runs in
    several query slices over one scratch, still one launch per call."""
    _need_card()
    rng = np.random.default_rng(5)
    T = _catalogue(rng, 4096, 16, "decaying")
    cat = MIPSCatalog(T, block_m=64, superblock=4, device="cuda")
    U = rng.standard_normal((20000, 16)).astype(np.float32)
    assert len(query_slices(20000, cat.n_blocks, 64)) > 1
    for mode in MODES:
        args = cat.kernel_args(U, 100, mode)
        before = topk_mips.launches
        got = topk_mips(**args)
        assert topk_mips.launches == before + 1
        want = topk_mips_plain(**args)
        torch.cuda.synchronize()
        assert_topk_equal(got[:2], want[:2])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    T = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    cat = MIPSCatalog(T, block_m=64, device="cuda")
    args = cat.kernel_args(np.ones((2, 8), np.float32), 5, "single_level")
    wide = MIPSCatalog(np.ones((64, 4097), np.float32), block_m=64,
                       device="cuda")
    with pytest.raises(ValueError, match="kernel limits"):
        topk_mips(**wide.kernel_args(np.ones((2, 4097), np.float32), 5,
                                     "single_level"))
    with pytest.raises(ValueError, match="float32"):
        topk_mips(**{**args, "U": args["U"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        topk_mips(**{**args, "tile_bounds": args["tile_bounds"].t()
                     .contiguous().t()})
    with pytest.raises(ValueError, match="one device"):
        topk_mips(**{**args, "U": args["U"].cpu()})
    flat = torch.empty(512 * 8 + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        topk_mips(**{**args, "T_sorted": flat[1:].view(512, 8)})


@pytest.mark.parametrize("m,r,b,c", [
    (5000, 100, 8, 2560),   # the list tail's shape at R = 100, few lanes
    (3000, 50, 3, 1000),    # R = 50: rows not 16-byte aligned
    (700, 17, 1, 45),       # C not a multiple of the 32 rows of a block
    (100, 200, 2, 9),       # R past one 128-column pass
])
def test_gather_scores_kernel_matches_plain_version(m, r, b, c):
    _need_card()
    rng = np.random.default_rng(m + r)
    T = torch.from_numpy(rng.standard_normal((m, r)).astype(np.float32))
    U = torch.from_numpy(rng.standard_normal((b, r)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, m, (b, c)).astype(np.int32))
    ids[:, :2] = 0                       # repeats within and across lanes
    T, U, ids = T.cuda(), U.cuda(), ids.cuda()
    before = gather_scores.launches
    got = gather_scores(T, ids, U)
    torch.cuda.synchronize()
    _assert_b4(got, gather_scores_plain(T, ids, U))
    one = gather_scores(T, ids[0].contiguous(), U[0].contiguous())
    torch.cuda.synchronize()
    _assert_b4(one, gather_scores_plain(T, ids[0], U[0]))
    assert gather_scores.launches == before + 2


def test_gather_scores_kernel_scores_out_of_range_ids_nan():
    _need_card()
    T = torch.randn((40, 9), device="cuda")
    u = torch.randn((9,), device="cuda")
    ids = torch.tensor([3, -1, 40, 2 ** 31 - 1, 39], dtype=torch.int32,
                       device="cuda")
    out = gather_scores(T, ids, u)
    assert torch.isnan(out[[1, 2, 3]]).all()
    _assert_b4(out[[0, 4]], T[[3, 39]] @ u)


def test_gather_scores_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    T = torch.randn((64, 8), device="cuda")
    U = torch.randn((2, 8), device="cuda")
    ids = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        gather_scores(T.double(), ids, U)
    with pytest.raises(ValueError, match="int32"):
        gather_scores(T, ids.long(), U)
    with pytest.raises(ValueError, match="contiguous"):
        gather_scores(T, torch.zeros((5, 2), dtype=torch.int32,
                                     device="cuda").t(), U)
    with pytest.raises(ValueError, match="one device"):
        gather_scores(T, ids, U.cpu())
    with pytest.raises(ValueError, match="kernel limits"):
        gather_scores(torch.zeros((4, 5000), device="cuda"),
                      torch.zeros(2, dtype=torch.int32, device="cuda"),
                      torch.zeros(5000, device="cuda"))


def _tail_ids(T, U, block, step):
    """The ids of list-walk block ``step`` for every lane, as the ``bta``
    tail enumerates them: each list's order at the block's depths, walked
    backwards where the lane's weight is negative, so a column holds at
    most two distinct ids across the lanes."""
    M, R = T.shape
    order = torch.argsort(-T, dim=0, stable=True).t().contiguous()   # [R, M]
    cols = torch.clamp(step * block + torch.arange(block, device=T.device),
                       max=M - 1)
    cols = torch.where((U < 0)[:, :, None], M - 1 - cols, cols)
    flat = torch.arange(R, device=T.device)[None, :, None] * M + cols
    return order.reshape(-1)[flat].reshape(U.shape[0], R * block) \
        .to(torch.int32).contiguous()


@pytest.mark.parametrize("path", [None, "rows", "lanes"])
def test_gather_scores_kernel_on_tail_pattern_ids(path):
    """64 lanes over a tail block's ids (two ids a column), by the chosen
    path and by each path forced; a NaN id among valid ids of one column
    scores NaN for its own lane only."""
    _need_card()
    rng = np.random.default_rng(17)
    T = torch.from_numpy(rng.standard_normal((5000, 100)).astype(
        np.float32)).cuda()
    U = torch.from_numpy(rng.standard_normal((64, 100)).astype(
        np.float32)).cuda()
    ids = _tail_ids(T, U, 64, 3)
    per_col = torch.tensor([len(set(ids[:, c].tolist()))
                            for c in range(0, ids.shape[1], 97)])
    assert int(per_col.max()) == 2
    _assert_b4(gather_scores(T, ids, U, path), gather_scores_plain(T, ids, U))
    bad = ids.clone()
    bad[5, 7], bad[9, 7], bad[40, 7] = -1, 5000, 2 ** 31 - 1
    got = gather_scores(T, bad, U, path)
    torch.cuda.synchronize()
    nan = torch.isnan(got)
    assert nan[[5, 9, 40], 7].all() and int(nan.sum()) == 3
    _assert_b4(got, gather_scores_plain(T, bad, U))


@pytest.mark.parametrize("r", [10, 17, 50, 100, 4096])
@pytest.mark.parametrize("b", [1, FEW_LANES - 1, FEW_LANES, 100, 300])
def test_gather_scores_kernel_paths_by_lanes_and_rank(b, r):
    """B = 1, just below and at the few-lanes threshold, and more lanes
    than one lane group; every rank of the vector-load cases and R =
    4096 (a few lanes a group). Both paths, forced, agree too."""
    _need_card()
    b = max(b, 1)
    rng = np.random.default_rng(b * 7 + r)
    m, c = (300, 300) if r == 4096 else (3000, 1000)
    T = torch.from_numpy(rng.standard_normal((m, r)).astype(
        np.float32)).cuda()
    U = torch.from_numpy(rng.standard_normal((b, r)).astype(
        np.float32)).cuda()
    ids = torch.from_numpy(rng.integers(0, m, (b, c)).astype(np.int32))
    ids[:, :3] = 0                      # repeats within and across lanes
    ids = ids.cuda()
    want = gather_scores_plain(T, ids, U)
    assert launch_plan(b, c, r).path == ("rows" if b < FEW_LANES
                                         else "lanes")
    before = gather_scores.launches
    for path in (None, "rows", "lanes"):
        got = gather_scores(T, ids, U, path)
        torch.cuda.synchronize()
        if r <= 200:
            _assert_b4(got, want)
        else:          # 4,096 products: the fp32 bound of any order
            _assert_fp32_sum(got, T[ids.long()] * U[:, None, :])
    assert gather_scores.launches == before + 3


def _assert_recsys(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        rtol, atol = 1e-5, 1e-4
    else:
        finite = want.float()[torch.isfinite(want)]
        scale = float(finite.abs().max()) if finite.numel() else 0.0
        rtol, atol = F16_RTOL, F16_ATOL_OF_MAX * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("b,f,v,d", [
    (512, 39, 39000, 10),   # the query tower's shape at DeepFM's field count
    (512, 39, 39000, 1),    # the first-order term: a [V, 1] table
    (33, 7, 500, 64),       # a bag spanning two warps, B not a block multiple
    (5, 0, 10, 3),          # no fields: sum 0, mean NaN (0 / 0)
])
def test_embedding_bag_kernel_matches_plain_version(b, f, v, d, dtype):
    _need_card()
    rng = np.random.default_rng(b + f + d)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    table = table.to(dtype).cuda()
    ids = torch.from_numpy(rng.integers(0, v, (b, f)).astype(np.int32)).cuda()
    before = embedding_bag.launches
    for mode in ("sum", "mean"):
        got = embedding_bag(table, ids, mode)
        torch.cuda.synchronize()
        _assert_recsys(got, embedding_bag_plain(table, ids, mode))
    assert embedding_bag.launches == before + 2


def test_embedding_bag_kernel_ids_follow_jnp_take():
    _need_card()
    table = torch.randn((40, 9), device="cuda")
    ids = torch.tensor([[3, -1, 39], [-40, 0, 1], [40, 1, 2], [-41, 0, 0],
                        [2 ** 31 - 1, 0, 0]], dtype=torch.int32,
                       device="cuda")
    for mode in ("sum", "mean"):
        out = embedding_bag(table, ids, mode)
        assert torch.isnan(out[2:]).all() and torch.isfinite(out[:2]).all()
        _assert_recsys(out, embedding_bag_plain(table, ids, mode))
    _assert_recsys(embedding_bag(table, ids)[0], table[[3, 39, 39]].sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("d", [1, 10, 16])
@pytest.mark.parametrize("f", [1, 39, 100])
@pytest.mark.parametrize("b", [1000, 70001])
def test_embedding_bag_kernel_block_runs_and_field_chunks(b, f, d, dtype):
    """Bag counts that are no multiple of a warp's 32 (the d = 1 path), one
    field, DeepFM's 39 and 100 (two and five field chunks at d = 1), d =
    10 and 16 (a thread per output), with ids following jnp.take (some in
    [-V, 0)) and one bag made NaN by an id past the table's end."""
    _need_card()
    v = 5000
    rng = np.random.default_rng(b + f + d)
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    table = table.to(dtype).cuda()
    ids = rng.integers(-v, v, (b, f)).astype(np.int32)
    ids[b // 2, f - 1] = v
    ids = torch.from_numpy(ids).cuda()
    for mode in ("sum", "mean"):
        got = embedding_bag(table, ids, mode)
        torch.cuda.synchronize()
        nan = torch.isnan(got.float()).any(1)
        assert bool(nan[b // 2]) and int(nan.sum()) == 1
        _assert_recsys(got, embedding_bag_plain(table, ids, mode))


def test_embedding_bag_kernel_chunks_many_fields_at_d1():
    """F far past what a warp's ids buffer holds: many field chunks at
    d = 1 (869 full ones and a short tail), held to the fp32 tolerance of
    a 20,000-term sum, which a sum without its first chunk or without its
    tail fails."""
    _need_card()
    rng = np.random.default_rng(8)
    table = torch.randn((3000, 1), device="cuda")
    ids = torch.from_numpy(rng.integers(0, 3000, (300, 20000)).astype(
        np.int32)).cuda()
    terms = table[ids.long(), 0]                          # [B, F]
    fc = bag_plan(300, 20000, 1).fields
    assert 1 < fc < 20000 and 20000 % fc
    exact = terms.double().sum(-1)
    for dropped in (terms[:, :fc], terms[:, 20000 - 20000 % fc:]):
        assert _fp32_sum_excess(exact - dropped.double().sum(-1), terms) > 0
    got = embedding_bag(table, ids, "sum")
    torch.cuda.synchronize()
    _assert_fp32_sum(got[:, 0], terms)
    got = embedding_bag(table, ids, "mean")
    torch.cuda.synchronize()
    _assert_fp32_sum(got[:, 0].double() * 20000, terms)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("b,f,d", [
    (512, 39, 10),     # DeepFM's serve_p99 shape
    (100, 39, 1),      # d = 1: 256 bags a block
    (7, 2, 3),         # B not a multiple of a block's 85 bags
    (3, 5, 300),       # d past 256: one bag a block
])
def test_fm_interaction_kernel_matches_plain_version(b, f, d, dtype):
    _need_card()
    rng = np.random.default_rng(b + f + d)
    emb = torch.from_numpy(
        (rng.standard_normal((b, f, d)) * 0.5).astype(np.float32))
    emb = emb.to(dtype).cuda()
    before = fm_interaction.launches
    got = fm_interaction(emb)
    torch.cuda.synchronize()
    _assert_recsys(got, fm_interaction_plain(emb))
    assert fm_interaction.launches == before + 1


def test_recsys_kernels_count_cuda_launches_only_and_check_operands():
    _need_card()
    before = (embedding_bag.launches, fm_interaction.launches)
    embedding_bag(torch.zeros((4, 2)), torch.zeros((3, 2), dtype=torch.int32))
    fm_interaction(torch.zeros((3, 2, 4)))
    assert (embedding_bag.launches, fm_interaction.launches) == before
    table = torch.zeros((4, 2), device="cuda")
    ids = torch.zeros((3, 2), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="float32 or float16"):
        embedding_bag(table.double(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32,
                                         device="cuda").t())
    with pytest.raises(ValueError, match="one device"):
        embedding_bag(table, ids.cpu())
    with pytest.raises(ValueError, match="kernel limits"):
        fm_interaction(torch.zeros((2, 3, 2000), device="cuda"))
    with pytest.raises(ValueError, match="float32 or float16"):
        fm_interaction(torch.zeros((2, 3, 4), device="cuda",
                                   dtype=torch.float64))


# ---------------------------------------------------------------------------
# The ta engine on the card against the same engine on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 300])
def test_ta_engine_on_the_card_matches_the_cpu(budget):
    """Chunked TA (32 rounds a step) over a 256-round list prefix that
    every query outlives, its tail scored by B4 on the card and by B4's
    plain version on the CPU: equal values (fp32 sums in two orders), ids
    where scores are distinct, and equal ``n_scored``, ``depth`` and
    ``upper`` bound; a budget of 300 rounds halts inside a chunk past the
    prefix."""
    _need_card()
    from repro_torch.core.engines import EngineContext, get_engine
    rng = np.random.default_rng(71)
    T = rng.standard_normal((20000, 32)).astype(np.float32)
    U = rng.standard_normal((40, 32)).astype(np.float32)
    U[:8] = np.abs(U[:8])
    U[8:16, ::3] = 0.0
    contexts = [EngineContext(T, prefix_depth=256, device=dev)
                for dev in ("cuda", "cpu")]
    before = gather_scores.launches
    card, cpu = (get_engine("ta").run(ctx, U, 10, budget=budget)
                 for ctx in contexts)
    torch.cuda.synchronize()
    steps = contexts[0].scan_steps
    assert steps["tail"] > 0
    assert gather_scores.launches - before == steps["tail"]
    assert_topk_equal((card.values.cpu(), card.indices.cpu()),
                      (cpu.values, cpu.indices))
    for f in ("n_scored", "depth"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    torch.testing.assert_close(card.upper.cpu(), cpu.upper, rtol=1e-5,
                               atol=1e-6)
    if budget is not None:
        assert int(card.depth.max()) == budget
    else:
        assert int(card.depth.min()) > 256


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,r,k,block,b,kind,walk", [
    # just past k = 256
    (20000, 50, 257, 256, 70, "decaying", "walk_shared"),
    # the streaming ladder's third rung at k = 10
    (20000, 50, 522, 256, 70, "decaying", "walk_shared"),
    (20000, 100, 1500, 128, 70, "decaying", "walk_shared"),
    # the whole catalogue (the ladder's last rung)
    (3000, 17, 3000, 64, 70, "decaying", "walk_shared"),
    # the tile-wide sort past kk = 16, ties within and across tiles, one
    # and two query groups, the smallest and largest tiles
    (6000, 50, 42, 256, 70, "dup", "walk_shared"),
    (6000, 50, 42, 256, 8, "dup", "walk_shared"),
    (6000, 50, 138, 256, 8, "dup", "walk_shared"),
    (6000, 50, 522, 256, 70, "dup", "walk_shared"),
    (6000, 50, 522, 256, 8, "dup", "walk_shared"),
    (20000, 50, 42, 64, 8, "dup", "walk_shared"),
    (20000, 50, 600, 1024, 70, "dup", "walk_shared"),
    (20000, 20, 13488, 1024, 8, "decaying", "walk_shared"),  # limit
    (20000, 20, 13489, 1024, 8, "decaying", "walk_global"),  # past
    (20000, 50, 15000, 256, 70, "dup", "walk_global"),
])
def test_cuda_kernel_past_the_shared_carry_matches_plain_version(
        m, r, k, block, b, kind, walk):
    """kk > 16 selects each tile's list by a warp's sort; the walk keeps
    each query's carry in shared memory up to ``CARRY_SMEM_BYTES``, in
    global memory past it. Every mode still equals the plain version,
    values, ids and stats, and each call adds one to its selection's and
    its walk's ``path_launches`` and to its k's ``k_launches``."""
    _need_card()
    rng = np.random.default_rng(m + k)
    T = _catalogue(rng, m, r, kind)
    cat = MIPSCatalog(T, block_m=block, superblock=8, device="cuda")
    U = rng.standard_normal((b, r)).astype(np.float32)
    kk = min(k, block)
    assert walk_path(k, kk) == walk
    for mode in MODES:
        args = cat.kernel_args(U, k, mode)
        before = topk_mips.launches
        paths = dict(topk_mips.path_launches)
        at_k = topk_mips.k_launches.get(k, 0)
        got = topk_mips(**args)
        assert topk_mips.launches == before + 1
        grew = {p: n - paths[p] for p, n in topk_mips.path_launches.items()
                if n != paths[p]}
        assert grew == {"select_sort": 1, walk: 1}, grew
        assert topk_mips.k_launches[k] == at_k + 1
        want = topk_mips_plain(**args)
        torch.cuda.synchronize()
        assert_topk_equal(got[:2], want[:2])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


def test_cuda_kernel_launches_refuse_a_path_they_do_not_take():
    """The wrapper names each phase's path and the launch runs it or
    fails: the register lists past kk = 16 and a shared-memory carry past
    ``CARRY_SMEM_BYTES`` are refused (cudaErrorInvalidValue); the same
    shapes on a path that takes them launch."""
    _need_card()
    from repro_torch.kernels._build import load
    lib = load("topk_mips")
    B, R, block_m = 2, 4, 1024
    single_level = MODES.index("single_level")
    T = torch.zeros((block_m, R), device="cuda")
    U = torch.ones((B, R), device="cuda")
    bounds = torch.ones((B, 1), device="cuda")

    def scratch(kk):
        return (torch.zeros((B, 1, kk), device="cuda"),
                torch.zeros((B, 1, kk), dtype=torch.int32, device="cuda"),
                torch.zeros((B, 1), device="cuda"))

    def score(kk, sort):
        lv, li, tm = scratch(kk)
        err = lib.topk_mips_score_launch(
            T.data_ptr(), U.data_ptr(), None, lv.data_ptr(), li.data_ptr(),
            tm.data_ptr(), B, R, 1, block_m, 1, kk, block_m, single_level,
            sort, None)
        torch.cuda.synchronize()
        return err

    def walk(k, kk, carry=False):
        lv, li, tm = scratch(kk)
        vals = torch.empty((B, k), device="cuda")
        idx = torch.empty((B, k), dtype=torch.int32, device="cuda")
        stats = torch.empty((B, 3), dtype=torch.int32, device="cuda")
        gcarry = torch.empty((B, 4 * k), device="cuda") if carry else None
        err = lib.topk_mips_walk_launch(
            bounds.data_ptr(), None, lv.data_ptr(), li.data_ptr(),
            tm.data_ptr(), vals.data_ptr(), idx.data_ptr(), stats.data_ptr(),
            None if gcarry is None else gcarry.data_ptr(), B, 1, block_m, 1,
            k, kk, single_level, None)
        torch.cuda.synchronize()
        return err

    assert score(17, 0) != 0
    assert score(16, 0) == 0 and score(17, 1) == 0
    assert walk(13_488, 1024) == 0
    assert walk(13_489, 1024) != 0
    assert walk(13_489, 1024, carry=True) == 0


# auto and the admission ladder on the card against the CPU
# ---------------------------------------------------------------------------


def _card_and_cpu_servers(T, **kw):
    from repro_torch.core.seplr import SepLRModel
    from repro_torch.serving.server import TopKServer
    return [TopKServer(SepLRModel(T, device=dev), max_batch=16,
                       block_size=64, device=dev, **kw)
            for dev in ("cuda", "cpu")]


def test_auto_on_the_card_matches_the_cpu():
    """Cold routes over 48 queries (dense, sparse, dense chunks): the card
    picks what the CPU picks with ``norm`` read as ``topk_mips``, launches
    the kernel engine's kernel, and serves the CPU's values and ids."""
    _need_card()
    from repro_torch.core.engines import select_engine
    rng = np.random.default_rng(72)
    T = rng.standard_normal((3000, 24)).astype(np.float32)
    U = rng.standard_normal((48, 24)).astype(np.float32)
    U[16:32] = 0.0
    U[16:32, :3] = 1.0
    card, cpu = _card_and_cpu_servers(T)
    for i in range(0, 48, 16):
        picks = [select_engine(s.ctx, U[i:i + 16]).name for s in (card, cpu)]
        assert picks[0] == ("topk_mips" if picks[1] == "norm"
                            else picks[1])
    before = topk_mips.launches
    got, want = (s.query(U, 10, method="auto") for s in (card, cpu))
    assert topk_mips.launches > before
    assert_topk_equal((torch.from_numpy(got.values),
                       torch.from_numpy(got.indices)),
                      (torch.from_numpy(want.values),
                       torch.from_numpy(want.indices)))
    assert card.stats["topk_mips"].n_queries == cpu.stats["norm"].n_queries
    assert card.stats["ta"].n_queries == cpu.stats["ta"].n_queries == 16


@pytest.mark.parametrize("forced,rung", [
    ({"bta": 10.0, "norm": 1e-9}, "to_norm"),
    ({"bta": 10.0, "norm": 10.0}, "to_budgeted"),
])
def test_forced_ladder_rungs_on_the_card_match_the_cpu(forced, rung):
    """The same forced cost model takes the same rung on both devices;
    the budgeted rung's values, ids and certificate bounds agree, and
    ``n_uncertified`` counts the same queries."""
    _need_card()
    from repro_torch.serving.server import AdmissionPolicy
    rng = np.random.default_rng(73)
    T = (rng.standard_normal((4000, 16))
         / np.sqrt(1.0 + np.arange(4000))[:, None]).astype(np.float32)
    U = rng.standard_normal((16, 16)).astype(np.float32)
    servers = _card_and_cpu_servers(
        T, policy=AdmissionPolicy(degrade_budget=64))
    out = []
    for s in servers:
        s._cost_ewma.update(forced)
        out.append(s.query(U, 10, method="bta", deadline_ms=50.0))
    card, cpu = servers
    assert card.stats["bta"].degradations == cpu.stats["bta"].degradations \
        == {rung: 1}
    assert card.stats["bta"].n_uncertified == cpu.stats["bta"].n_uncertified
    got, want = out
    assert_topk_equal((torch.from_numpy(got.values),
                       torch.from_numpy(got.indices)),
                      (torch.from_numpy(want.values),
                       torch.from_numpy(want.indices)))
    np.testing.assert_allclose(got.upper, want.upper, rtol=1e-6)
    for f in ("n_scored", "depth"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    shed = card.query(U, 10, method="bta", deadline_ms=0.0)
    assert (shed.indices == -1).all() and (shed.upper == np.inf).all()


# the streaming server on the card against the CPU
# ---------------------------------------------------------------------------


def _streamed_pair(**kw):
    """Card and CPU servers over one catalogue, both warmed for topk_mips
    and bta, then 40 inserts, 20 updates and 120 deletes of which 140
    tombstones sit in query 0's top 140: its fetch climbs 42 -> 138 ->
    522 (past the kernel's shared-memory carry)."""
    rng = np.random.default_rng(74)
    T = rng.standard_normal((5000, 16)).astype(np.float32)
    U = rng.standard_normal((8, 16)).astype(np.float32)
    servers = _card_and_cpu_servers(T, delta_capacity=64,
                                    max_tombstones=1000, **kw)
    top = np.argsort(-(T.astype(np.float64) @ U[0]), kind="stable")[:140]
    rows = rng.standard_normal((60, 16)).astype(np.float32)
    for s in servers:
        s.warmup(10, batch_sizes=(8,), engines=["topk_mips", "bta"])
        s.add_targets(rows[:40])
        s.update_targets(top[:20], rows[40:])
        s.delete_targets(top[20:])
    return servers, U, rng


def _assert_same_streamed(card, cpu, U, method, k=10):
    """One segmented query on both: results and QueryInfo equal."""
    from repro_torch.core.engines import get_engine
    (got, gi), (want, wi) = (s.catalogue.query(get_engine(method), U, k)
                             for s in (card, cpu))
    torch.cuda.synchronize()
    assert_topk_equal((got.values.cpu(), got.indices.cpu()),
                      (want.values, want.indices))
    for f in ("n_scored", "depth"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
    assert gi == wi
    return gi


def test_streaming_server_on_the_card_matches_the_cpu():
    """Mutations, the escalation ladder past 256 through kernel B1, bta
    through kernel B4, a synchronous compaction: the card answers as the
    CPU does, counts and QueryInfo included, and the compaction loads no
    kernel library (engine_compiles_total 0)."""
    _need_card()
    from repro_torch.kernels.gather_scores import gather_scores
    (card, cpu), U, rng = _streamed_pair()
    b1, b4 = topk_mips.launches, gather_scores.launches
    info = _assert_same_streamed(card, cpu, U, "topk_mips")
    assert info.retried and info.overfetch_k == 522
    assert topk_mips.launches - b1 == 3           # one launch a rung
    _assert_same_streamed(card, cpu, U, "bta")
    assert gather_scores.launches > b4
    _assert_same_streamed(card, cpu, U, "naive")
    rows = rng.standard_normal((10, 16)).astype(np.float32)
    for s in (card, cpu):
        s.add_targets(rows)                       # 70 > 64: a compaction
        assert s.catalogue.version == 1
    info = _assert_same_streamed(card, cpu, U, "topk_mips")
    assert info.version == 1 and not info.retried
    assert card.mutation_stats["engine_compiles_total"] == 0
    assert card.ctx.device.type == "cuda" and card.ctx.version == 1
    got = card.query(U, 10, method="topk_mips")
    want = cpu.query(U, 10, method="topk_mips")
    np.testing.assert_allclose(got.values, want.values, rtol=1e-5)


def test_streaming_background_and_failed_builds_on_the_card():
    """A compact_async build with queries during it, then a build failed
    by the fault point and healed by a retry: the card answers as the CPU
    does after each, and no kernel library loads in any build."""
    _need_card()
    from repro_torch.core import faults
    (card, cpu), U, rng = _streamed_pair(compact_async=True)
    rows = rng.standard_normal((10, 16)).astype(np.float32)
    for s in (card, cpu):
        s.add_targets(rows)                       # 70 > 64: async build
    during = card.query(U, 10, method="topk_mips")   # may race the build
    assert np.isfinite(during.values).all()
    for s in (card, cpu):
        s.catalogue.flush()
        assert s.catalogue.version == 1
    _assert_same_streamed(card, cpu, U, "topk_mips")
    rows = rng.standard_normal((5, 16)).astype(np.float32)
    for s in (card, cpu):
        s.add_targets(rows)
        with faults.injected("compaction.build", error=RuntimeError):
            with pytest.raises(RuntimeError, match="compaction build"):
                s.catalogue.compact(wait=True)
        assert s.catalogue.version == 1 and s.catalogue.l0_chain_len == 1
    _assert_same_streamed(card, cpu, U, "topk_mips")
    for s in (card, cpu):
        s.catalogue.compact(wait=True)            # the retry heals
        assert s.catalogue.version == 2
        assert s.mutation_stats["n_failed_compactions"] == 1
    _assert_same_streamed(card, cpu, U, "topk_mips")
    assert card.mutation_stats["engine_compiles_total"] == 0


# the async front end over the LSM ladder on the card
# ---------------------------------------------------------------------------

ASYNC_WAIT_S = 120


def _async_pair(T, **kw):
    from repro_torch.core.seplr import SepLRModel
    from repro_torch.serving.pipeline import AsyncTopKServer
    return [AsyncTopKServer(SepLRModel(T, device=dev), max_batch=16,
                            block_size=64, device=dev, **kw)
            for dev in ("cuda", "cpu")]


def test_async_ladder_on_the_card_matches_the_cpu():
    """AsyncTopKServer over a 4-shard ladder: single requests (a batch of
    one on both devices) through folds, kills in the L1 runs and the
    base, a promotion and a bta request; the card answers as the CPU
    does, counts included, and launches kernel B1."""
    _need_card()
    rng = np.random.default_rng(75)
    T = rng.standard_normal((4000, 16)).astype(np.float32)
    U = rng.standard_normal((12, 16)).astype(np.float32)
    card, cpu = _async_pair(T, method="topk_mips", delta_capacity=16,
                            n_shards=4)
    rows = rng.standard_normal((120, 16)).astype(np.float32)

    def ask(u, method=None):
        got, want = (s.submit(u, 10, method=method).result(
            timeout=ASYNC_WAIT_S) for s in (card, cpu))
        assert_topk_equal((torch.from_numpy(got.values),
                           torch.from_numpy(got.indices)),
                          (torch.from_numpy(want.values),
                           torch.from_numpy(want.indices)))
        for f in ("n_scored", "depth"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))

    with card, cpu:
        b1 = topk_mips.launches
        for s in (card, cpu):
            gids = s.add_targets(rows[:50])   # three folds
        assert card.catalogue.stats.n_l1_folds == 3 \
            == cpu.catalogue.stats.n_l1_folds
        for u in U[:4]:
            ask(u)
        assert topk_mips.launches > b1
        l1_gid = int(gids[0])
        assert card.catalogue._locate(l1_gid)[0] == "l1"
        for s in (card, cpu):
            s.delete_targets([l1_gid, 7])
            s.update_targets([11], rows[50:51])
        for u in U[4:8]:
            ask(u)
        ask(U[8], method="bta")
        for s in (card, cpu):
            s.catalogue.promote(wait=True)
            assert s.catalogue.l1_rows == 0
        for u in U[8:]:
            ask(u)
    assert card.mutation_stats["engine_compiles_total"] == 0


def test_async_stress_concurrent_mutations_on_the_card():
    """8 submitting threads while another thread mutates the ladder
    (folds, promotions on a background build): each result equals the
    dense top-k of SOME state the catalogue passed through, and nothing
    hangs. A tensor read before the work that wrote it shows here as a result
    of no state."""
    import threading
    _need_card()
    rng = np.random.default_rng(76)
    T = rng.standard_normal((20000, 32)).astype(np.float32)
    U = rng.standard_normal((64, 32)).astype(np.float32)
    card, _ = _async_pair(T, method="topk_mips", delta_capacity=16,
                          n_shards=4, l1_capacity=32, compact_async=True)
    card.warmup(10, engines=["topk_mips", "norm"])
    states = [card.catalogue.as_dense()]
    results, errors = [], []

    def mutate():
        try:
            for _ in range(30):
                rows = 3.0 * rng.standard_normal((8, 32)).astype(np.float32)
                card.add_targets(rows)
                states.append(card.catalogue.as_dense())
                gids = states[-1][1]
                card.delete_targets(rng.choice(gids, 2, replace=False))
                states.append(card.catalogue.as_dense())
        except Exception as exc:              # reported below
            errors.append(exc)

    def client(j):
        try:
            for i in range(16):
                q = (j * 16 + i) % len(U)
                res = card.submit(U[q], 10).result(timeout=ASYNC_WAIT_S)
                results.append((q, res))
        except Exception as exc:              # reported below
            errors.append(exc)

    with card:
        threads = [threading.Thread(target=mutate)] + [
            threading.Thread(target=client, args=(j,)) for j in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(ASYNC_WAIT_S)
        assert not any(t.is_alive() for t in threads), "a thread hung"
        card.catalogue.flush()
    assert not errors, errors
    assert len(results) == 128
    assert card.catalogue.stats.n_l1_folds > 0
    Ud = U.astype(np.float64)
    oracles = []
    for rows, gids in states:
        s = Ud @ rows.astype(np.float64).T
        top = np.argsort(-s, axis=1, kind="stable")[:, :10]
        oracles.append((np.take_along_axis(s, top, 1), gids[top]))
    for q, res in results:
        ok = any(np.allclose(res.values[0], ov[q], rtol=1e-5, atol=1e-4)
                 and set(res.indices[0].tolist()) == set(og[q].tolist())
                 for ov, og in oracles)
        assert ok, f"query {q}: a result of no state the catalogue had"


MOE_BF16_TOL = 3e-2


def _need_card_to_compare():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (holds the card's run against the "
                    "CPU's)")


def _moe_case(dtype):
    from repro_torch.models import moe
    rng = np.random.default_rng(11)
    p = moe.init_moe(torch.Generator().manual_seed(3), 64, 96, 16, "cpu")
    h = torch.from_numpy(rng.standard_normal((4, 24, 64)).astype(
        np.float32)).to(dtype)
    return moe, p, h


def _moe_close(got, want, dtype):
    got, want = got.float().cpu(), want.float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        torch.testing.assert_close(
            got, want, rtol=0, atol=MOE_BF16_TOL * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_the_card_matches_the_cpu(dtype):
    """``moe_ffn`` (top-4 of 16, a capacity that drops some tokens) and
    ``moe_ffn_ep`` on card meshes of 4 logical shards, ``(1, 4)`` and
    ``(2, 2)`` over ``("data", "model")``, against the same calls on the
    CPU."""
    _need_card_to_compare()
    from repro_torch.core.mesh import make_mesh
    moe, p, h = _moe_case(dtype)
    dev = torch.device("cuda")
    pc = moe.MoEParams(*(t.to(dev) for t in p))
    want, want_aux = moe.moe_ffn(p, h.reshape(-1, 64), 4, 1.0)
    got, aux = moe.moe_ffn(pc, h.reshape(-1, 64).to(dev), 4, 1.0)
    assert got.device.type == "cuda" and got.dtype == dtype
    _moe_close(got, want, dtype)
    assert torch.equal(aux["expert_ids"].cpu(), want_aux["expert_ids"])
    assert float(want_aux["drop_rate"]) > 0
    # the same kept count (one assignment is 1/384 of the rate); the mean's
    # last bits are the reduction order's
    torch.testing.assert_close(aux["drop_rate"].cpu(), want_aux["drop_rate"],
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(aux["aux_loss"].cpu(), want_aux["aux_loss"],
                               rtol=1e-5, atol=0)
    for shape in ((1, 4), (2, 2)):
        cpu = make_mesh(shape, ("data", "model"), ["cpu"] * 4)
        card = make_mesh(shape, ("data", "model"), ["cuda"] * 4)
        want, want_aux = moe.moe_ffn_ep(p, h, 4, 1.0, mesh=cpu)
        got, aux = moe.moe_ffn_ep(pc, h.to(dev), 4, 1.0, mesh=card)
        _moe_close(got, want, dtype)
        assert torch.equal(aux["expert_ids"].cpu(), want_aux["expert_ids"])
        torch.testing.assert_close(aux["drop_rate"].cpu(),
                                   want_aux["drop_rate"], rtol=0, atol=1e-6)


def test_topk_logits_on_the_card_matches_the_cpu():
    """The head, unsharded and over card meshes whose tp axis splits the
    vocab (and one that does not divide it: the fallback), against the
    CPU's, and sharded against unsharded id for id on the card."""
    _need_card_to_compare()
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import transformer
    rng = np.random.default_rng(12)
    h = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    dev = torch.device("cuda")
    for V in (50304, 50302):
        w = torch.from_numpy(rng.standard_normal((256, V)).astype(
            np.float32))
        hc, wc = h.to(dev), w.to(dev)
        want = transformer.topk_logits(h, w, 8)
        flat = transformer.topk_logits(hc, wc, 8)
        torch.testing.assert_close(flat[0].cpu(), want[0], rtol=1e-5,
                                   atol=1e-4)
        assert torch.equal(flat[1].cpu(), want[1])
        for shape in ((1, 4), (2, 2)):
            card = make_mesh(shape, ("data", "model"), ["cuda"] * 4)
            vals, ids = transformer.topk_logits(hc, wc, 8, mesh=card)
            assert ids.dtype == torch.int32 and ids.device.type == "cuda"
            torch.testing.assert_close(vals.cpu(), want[0], rtol=1e-5,
                                       atol=1e-4)
            assert torch.equal(ids, flat[1])


# ---------------------------------------------------------------------------
# The recsys training path: gradients through B5 and B6
# ---------------------------------------------------------------------------

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _zipf_ids(rng, b, f, v):
    """Ids with heavy duplicates (zipf), some in ``[-V, 0)`` and two out of
    range: an atomic scatter would add each row's many terms in an order
    that changes from run to run."""
    ids = (rng.zipf(1.3, (b, f)) % v).astype(np.int32)
    ids[::3, 0] -= v
    ids[5, 1], ids[7, 2] = v, -v - 1
    return torch.from_numpy(ids)


def _grad_of(fn, x, g):
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, x, g)[0]


def _assert_tree_sums(got, ids, terms, v):
    """``got [v, d]`` against the float64 sum of ``terms [N, d]`` into the
    rows ``ids [N]`` (``V + id`` below 0; out of range dropped), each row
    within a pairwise sum's rounding: (ceil(log2 n) + 1) * 2**-24 * its
    sum of |term| plus one ulp, for its n terms (the doubling scan adds
    partial sums in a tree of that depth; the 1 covers the terms' own
    rounding, as g / F in mean mode)."""
    row = torch.where(ids < 0, ids + v, ids).long()
    keep = (row >= 0) & (row < v)
    row, terms = row[keep], terms[keep].double()
    d = terms.shape[1]
    exact = torch.zeros((v, d), dtype=torch.float64).index_add_(0, row, terms)
    mass = torch.zeros((v, d), dtype=torch.float64).index_add_(
        0, row, terms.abs())
    n = torch.zeros(v, dtype=torch.float64).index_add_(
        0, row, torch.ones_like(row, dtype=torch.float64))
    depth = torch.ceil(torch.log2(n.clamp(min=1))) + 1
    tol = depth[:, None] * 2.0 ** -24 * mass + 2.0 ** -23 * exact.abs()
    excess = ((got.double().cpu() - exact).abs() - tol).max()
    assert float(excess) <= 0, float(excess)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 10])
def test_embedding_bag_backward_on_the_card(mode, d):
    """B5's gradient on the card: equal to the CPU's (the same sort and
    scan), within a pairwise sum's rounding of the float64 sum (rows
    reached up to ~16,000 times by zipf ids), and bitwise equal across
    two passes; the forward launched the kernel."""
    _need_card()
    rng = np.random.default_rng(d)
    v, b, f = 5000, 65536, 39
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ids = _zipf_ids(rng, b, f, v)
    g = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    tc, ic, gc = table.cuda(), ids.cuda(), g.cuda()
    before = embedding_bag.launches
    got = _grad_of(lambda x: embedding_bag(x, ic, mode), tc, gc)
    assert embedding_bag.launches == before + 1
    again = _grad_of(lambda x: embedding_bag(x, ic, mode), tc, gc)
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.cpu(), _grad_of(lambda x: embedding_bag(x, ids, mode), table, g),
        rtol=GRAD_RTOL, atol=GRAD_ATOL)
    terms = g.double() / (f if mode == "mean" else 1)
    _assert_tree_sums(got, ids.reshape(-1),
                      terms.repeat_interleave(f, 0), v)


def test_take_rows_and_fm_interaction_backward_on_the_card():
    """The field lookup's gradient (the embedding table's) and B6's on the
    card: equal to the CPU's, B6's to autograd through its plain version,
    and each bitwise equal across two passes."""
    _need_card()
    from repro_torch.kernels.embedding_bag import take_rows
    rng = np.random.default_rng(5)
    v, b, f, d = 5000, 16384, 39, 10
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ids = _zipf_ids(rng, b, f, v)
    g = torch.from_numpy(rng.standard_normal((b, f, d)).astype(np.float32))
    got = _grad_of(lambda x: take_rows(x, ids.cuda()), table.cuda(),
                   g.cuda())
    assert torch.equal(got, _grad_of(lambda x: take_rows(x, ids.cuda()),
                                     table.cuda(), g.cuda()))
    torch.testing.assert_close(got.cpu(), _grad_of(
        lambda x: take_rows(x, ids), table, g), rtol=GRAD_RTOL,
        atol=GRAD_ATOL)
    _assert_tree_sums(got, ids.reshape(-1), g.reshape(-1, d), v)
    emb = torch.from_numpy((rng.standard_normal((b, f, d)) * 0.5).astype(
        np.float32))
    gb = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
    before = fm_interaction.launches
    got = _grad_of(fm_interaction, emb.cuda(), gb.cuda())
    assert fm_interaction.launches == before + 1
    assert torch.equal(got, _grad_of(fm_interaction, emb.cuda(), gb.cuda()))
    torch.testing.assert_close(got.cpu(), _grad_of(fm_interaction, emb, gb),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    torch.testing.assert_close(got, _grad_of(fm_interaction_plain,
                                             emb.cuda(), gb.cuda()),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_deepfm_training_step_on_the_card_matches_the_cpu():
    """The DeepFM smoke config's loss gradient on the card (B5 and B6 in
    the forward) against the CPU's from the same parameters, leaf for
    leaf; two AdamW steps through ``make_train_step`` with the CPU's
    losses; and a second card run of the steps bitwise equal."""
    _need_card()
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import OptimizerConfig, init_state
    from repro_torch.train.trainer import make_train_step
    from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten
    cfg = get_arch("deepfm").make_smoke_config()
    opt = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    step = make_train_step(lambda p, b: recsys.loss_fn(p, b, cfg), opt)
    cpu0 = recsys.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for _, b in
               zip(range(2), recsys_batches(0, 0, cfg.n_sparse,
                                            cfg.vocab_per_field, 4096))]

    def on(dev, tree):
        return tree_map(lambda x: x.to(dev, copy=True), tree)

    def grads(dev):
        leaves = [x.requires_grad_() for x in tree_leaves(on(dev, cpu0))]
        loss, _ = recsys.loss_fn(tree_unflatten(cpu0, leaves),
                                 on(dev, batches[0]), cfg)
        return torch.autograd.grad(loss, leaves)

    def run(dev):
        p = on(dev, cpu0)
        st = init_state(opt, p)
        losses = []
        for b in batches:
            p, st, m = step(p, st, on(dev, b))
            losses.append(float(m["loss"]))
        return (p, st), losses

    before = (embedding_bag.launches, fm_interaction.launches)
    for a, b in zip(grads(torch.device("cuda")), grads(torch.device("cpu"))):
        torch.testing.assert_close(a.cpu(), b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    card, card_losses = run(torch.device("cuda"))
    assert embedding_bag.launches - before[0] == 3
    assert fm_interaction.launches - before[1] == 3
    _, cpu_losses = run(torch.device("cpu"))
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    again, _ = run(torch.device("cuda"))
    for a, b in zip(tree_leaves(card), tree_leaves(again)):
        assert torch.equal(a, b)


def test_index_rows_backward_on_the_card():
    """The LM token lookup's gradient (the ``embed`` table's) on the card:
    bitwise equal across two passes, equal to the CPU's, and within a
    pairwise sum's rounding of the float64 sum (zipf tokens; ids outside
    ``[-V, V)`` add nothing)."""
    _need_card()
    from repro_torch.models.embedding import index_rows
    rng = np.random.default_rng(6)
    v, b, s, d = 5000, 8, 1024, 64
    table = torch.from_numpy(rng.standard_normal((v, d)).astype(np.float32))
    ids = _zipf_ids(rng, b, s, v)
    g = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32))
    got = _grad_of(lambda x: index_rows(x, ids.cuda()), table.cuda(),
                   g.cuda())
    assert torch.equal(got, _grad_of(lambda x: index_rows(x, ids.cuda()),
                                     table.cuda(), g.cuda()))
    torch.testing.assert_close(got.cpu(), _grad_of(
        lambda x: index_rows(x, ids), table, g), rtol=GRAD_RTOL,
        atol=GRAD_ATOL)
    _assert_tree_sums(got, ids.reshape(-1), g.reshape(-1, d), v)


LM_NEAR_TIE = 3e-2


def _lm_first_flips_are_near_ties(card_aux, cpu_aux, b, s, k):
    """The card's and the CPU's MoE routing of the same ``[b, s]`` tokens,
    layer by layer: each row's first token routed to another expert set,
    in the first layer where it differs, must be a near-tie on the CPU
    (its k-th and (k+1)-th router logits within ``LM_NEAR_TIE`` of the
    largest magnitude, as ``tests/test_torch_lm_train.py`` holds the
    reference's). Later positions of the row are not held: a flip changes
    its token's hidden state and, through attention, every later one's."""
    sets = [torch.stack([a["expert_ids"].reshape(b, s, k).sort(-1).values
                         .cpu() for a in aux]) for aux in (card_aux, cpu_aux)]
    diff = (sets[0] != sets[1]).any(-1)                        # [L, b, s]
    for row in range(b):
        hit = diff[:, row].any(0).nonzero()
        if not hit.numel():
            continue
        pos = int(hit[0])
        layer = int(diff[:, row, pos].nonzero()[0])
        logits = cpu_aux[layer]["router_logits"].reshape(b, s, -1)[row, pos]
        top = logits.double().sort(descending=True).values
        assert float(top[k - 1] - top[k]) <= \
            LM_NEAR_TIE * float(top.abs().max()), (row, pos, layer)


@pytest.mark.parametrize("arch,dtype", [
    ("gemma-2b", torch.float32), ("gemma-2b", torch.bfloat16),
    ("olmoe-1b-7b", torch.float32), ("olmoe-1b-7b", torch.bfloat16)])
def test_lm_loss_and_gradient_on_the_card_match_the_cpu(arch, dtype):
    """``models/transformer.py: loss_fn`` (remat, two head chunks) at the
    smoke config on the card against the CPU from the same parameters:
    the loss and every leaf's gradient within 1e-5 normwise at fp32 and
    5e-2 at bf16 (the CPU tests' limits against the reference), two card
    passes bitwise equal, and no kernel launched. olmoe-1b-7b at bf16 may
    route a near-tied token to another expert set on the card than on the
    CPU, and a flip moves the whole gradient, so it is held as
    ``tests/test_torch_lm_train.py`` holds the port against the reference:
    the routing up to each row's first flip, which must be a near-tie, the
    loss to the CPU's bf16 loss within 5e-2 relative, and every leaf of
    the gradient to the CPU's fp32 gradient within 5e-2 normwise."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten
    b, s = 2, 128
    cfg = dataclasses.replace(get_arch(arch).make_smoke_config(),
                              compute_dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    flips = cfg.moe and dtype == torch.bfloat16
    cpu0 = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_batches(0, cfg.vocab_size, b, s)).items()}

    def grads(dev, c=cfg):
        leaves = [x.to(dev, copy=True).requires_grad_()
                  for x in tree_leaves(cpu0)]
        loss, _ = tf.loss_fn(tree_unflatten(cpu0, leaves),
                             tree_map(lambda x: x.to(dev), batch), c)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    def routing(dev):
        aux = []
        with torch.no_grad():
            tf.forward(tree_map(lambda x: x.to(dev), cpu0),
                       batch["tokens"].to(dev), cfg, moe_aux=aux)
        return aux

    def normwise(a, b):
        return float((a.cpu().double() - b.double()).norm()
                     / b.double().norm())

    before = (topk_mips.launches, gather_scores.launches,
              embedding_bag.launches, fm_interaction.launches)
    card = grads(torch.device("cuda"))
    assert (topk_mips.launches, gather_scores.launches,
            embedding_bag.launches, fm_interaction.launches) == before
    for x, y in zip(card, grads(torch.device("cuda"))):
        assert torch.equal(x, y)
    cpu = grads(torch.device("cpu"))
    if flips:
        _lm_first_flips_are_near_ties(routing(torch.device("cuda")),
                                      routing(torch.device("cpu")), b, s,
                                      cfg.moe_top_k)
        assert normwise(card[0], cpu[0]) <= tol
        card, cpu = card[1:], grads(torch.device("cpu"), dataclasses.replace(
            cfg, compute_dtype=torch.float32))[1:]
    for x, y in zip(card, cpu):
        err = normwise(x, y)
        assert err <= tol, err


PNA_TOL, PNA_F32_FACTOR = 1e-5, 10


@pytest.mark.parametrize("task", ["node", "graph"])
def test_pna_loss_and_gradient_on_the_card_match_the_cpu(task):
    """``models/gnn.py: loss_fn`` at the smoke config (a power-law graph
    for the node task, a molecule batch for the graph task) on the card
    against the CPU from the same parameters: the loss and every leaf's
    gradient within ``PNA_TOL`` normwise or ``PNA_F32_FACTOR`` times the
    CPU's own fp32 error against its float64 run, whichever is larger
    (``tests/test_torch_gnn.py``'s rule against the reference: the std
    aggregator cancels), two card passes bitwise equal, and no kernel
    launched."""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import molecule_batch, random_graph
    from repro_torch.models import gnn
    from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten
    cfg = get_arch("pna").make_smoke_config()
    if task == "graph":
        cfg = dataclasses.replace(cfg, task="graph", d_in=14, n_classes=2)
        graph = molecule_batch(np.random.default_rng(2), 8, 10, 20, 14, 2)
    else:
        graph = random_graph(np.random.default_rng(0), 64, 256, 8, 3)
    cpu0 = gnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def grads(dev, dtype=torch.float32):
        leaves = [x.to(dev, dtype, copy=True).requires_grad_()
                  for x in tree_leaves(cpu0)]
        g = {k: v if k == "n_graphs" else torch.as_tensor(v).to(dev)
             for k, v in graph.items()}
        g["nodes"] = g["nodes"].to(dtype)
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        loss, _ = gnn.loss_fn(tree_unflatten(cpu0, leaves), g, c)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    def normwise(a, b):
        return float((a.cpu().double() - b.double()).norm()
                     / b.double().norm())

    before = (topk_mips.launches, gather_scores.launches,
              embedding_bag.launches, fm_interaction.launches)
    card = grads(torch.device("cuda"))
    assert (topk_mips.launches, gather_scores.launches,
            embedding_bag.launches, fm_interaction.launches) == before
    for x, y in zip(card, grads(torch.device("cuda"))):
        assert torch.equal(x, y)
    cpu, cpu64 = grads("cpu"), grads("cpu", torch.float64)
    for x, y, z in zip(card, cpu, cpu64):
        assert normwise(x, y) <= max(PNA_TOL,
                                     PNA_F32_FACTOR * normwise(y, z))


def test_hashed_lookup_on_the_card_is_bitwise_the_cpu():
    """``models/embedding.py: hashed_lookup`` (1 to 3 probes) over ids
    spread over the int32 range, edge ids included: the rows and the
    table's gradient (``row_grad``'s fixed-order sum) bitwise the CPU's."""
    _need_card()
    from repro_torch.models.embedding import hashed_lookup
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((99_991, 10))
                             .astype(np.float32))
    ids = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (4096, 39),
                                        dtype=np.int64).astype(np.int32))
    ids[0, :4] = torch.tensor([0, -1, 2 ** 31 - 1, -2 ** 31])
    cot = torch.from_numpy(rng.standard_normal((4096, 39, 10))
                           .astype(np.float32))
    for n in (1, 2, 3):
        out = []
        for dev in ("cuda", "cpu"):
            t = table.to(dev).requires_grad_()
            rows = hashed_lookup(t, ids.to(dev), n)
            g, = torch.autograd.grad(rows, t, cot.to(dev))
            out.append((rows.detach().cpu(), g.cpu()))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])
