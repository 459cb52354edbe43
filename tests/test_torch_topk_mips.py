"""The port's ``MIPSCatalog`` (CPU tensors: the kernel's plain PyTorch
version) against the reference's ``MIPSCatalog`` (Pallas kernels in
interpret mode), over identical state carried with ``from_reference``.

Expected agreement: values within 1e-5 relative (fp32 sums in another
order), ids equal wherever scores are distinct, and all three stats
columns equal. The CUDA kernel itself is held against its plain version
on the card by ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import MIPSCatalog as RefCatalog
from repro.kernels.topk_mips import (topk_mips_pallas,
                                     topk_mips_pallas_batched)
from repro_torch.convert import CATALOG_FIELDS, from_reference
from repro_torch.kernels.ops import MIPSCatalog
from repro_torch.kernels.ref import topk_mips_ref
from repro_torch.kernels.topk_mips import query_slices, topk_mips

from _torch_parity import assert_topk_equal, host


def _port(ref: RefCatalog) -> MIPSCatalog:
    arrays = {f: getattr(ref, f) for f in CATALOG_FIELDS}
    arrays = {f: (np.asarray(v) if not isinstance(v, int) else v)
              for f, v in arrays.items()}
    return from_reference(arrays, device="cpu")


def _assert_same(got, want):
    assert_topk_equal(got[:2], want[:2])
    np.testing.assert_array_equal(host(got[2]), np.asarray(want[2]))


def _decaying(m, r, power, seed):
    rng = np.random.default_rng(seed)
    T = rng.standard_normal((m, r)).astype(np.float32)
    return T * ((1.0 / (1.0 + np.arange(m)))[:, None] ** power).astype(
        np.float32)


@pytest.fixture(scope="module")
def two_level():
    """tests/test_kernels.py's two-level catalogue (decaying norms,
    block_m 128, superblock 4) and a query batch."""
    T = _decaying(2048, 16, 0.7, 9)
    ref = RefCatalog(T, block_m=128, superblock=4)
    rng = np.random.default_rng(9)
    U = rng.standard_normal((4, 16)).astype(np.float32)
    return T, ref, _port(ref), U


@pytest.mark.parametrize("m,r,k,block", [
    (256, 8, 1, 64), (512, 32, 10, 128), (1000, 64, 5, 256),
    (128, 128, 16, 128), (300, 17, 3, 64),
])
def test_query_matches_reference_shapes(m, r, k, block):
    rng = np.random.default_rng(m + r)
    T = rng.standard_normal((m, r)).astype(np.float32)
    u = rng.standard_normal(r).astype(np.float32)
    ref = RefCatalog(T, block_m=block)
    _assert_same(_port(ref).query(u, k), ref.query(jnp.asarray(u), k))


def test_catalogue_preparation_matches_reference():
    T = _decaying(1000, 12, 0.5, 1)
    ref = RefCatalog(T, block_m=64, superblock=4)
    got = MIPSCatalog(T, block_m=64, superblock=4, device="cpu")
    for f in ("T_sorted", "order", "block_max_norm", "super_max_norm"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(ref, f)), f)
    for f in ("num_real", "block_m", "superblock", "n_blocks", "n_super",
              "head_rows"):
        assert getattr(got, f) == getattr(ref, f), f


def test_decaying_catalogue_prunes_like_reference():
    T = _decaying(4096, 16, 0.5, 0)
    ref = RefCatalog(T, block_m=128)
    u = np.random.default_rng(0).standard_normal(16).astype(np.float32)
    got = _port(ref).query(u, 5)
    _assert_same(got, ref.query(jnp.asarray(u), 5))
    assert int(got[2][1]) < 4096 // 128          # visited < all tiles


def test_two_level_batch_matches_reference(two_level):
    T, ref, cat, U = two_level
    got = cat.query_batch(U, 5)
    _assert_same(got, ref.query_batch(jnp.asarray(U), 5))
    stats = host(got[2])
    assert np.all(stats[:, 2] < cat.n_blocks), "pre-screen skipped nothing"
    assert np.all(stats[:, 1] <= stats[:, 2])


def test_two_level_single_query_matches_reference(two_level):
    T, ref, cat, U = two_level
    _assert_same(cat.query(U[0], 5), ref.query(jnp.asarray(U[0]), 5))


def test_flat_norms_stay_exact():
    rng = np.random.default_rng(10)
    T = rng.standard_normal((512, 8)).astype(np.float32)
    T /= np.linalg.norm(T, axis=1, keepdims=True)
    ref = RefCatalog(T, block_m=64, superblock=4)
    U = rng.standard_normal((3, 8)).astype(np.float32)
    _assert_same(_port(ref).query_batch(U, 5), ref.query_batch(
        jnp.asarray(U), 5))


def test_fewer_real_rows_than_k():
    """num_real < k: empty slots hold (-1e30, -1) in both packages."""
    rng = np.random.default_rng(4)
    T = rng.standard_normal((3, 4)).astype(np.float32)
    ref = RefCatalog(T, block_m=64)
    U = rng.standard_normal((2, 4)).astype(np.float32)
    got = _port(ref).query_batch(U, 5)
    _assert_same(got, ref.query_batch(jnp.asarray(U), 5))
    np.testing.assert_array_equal(host(got[1])[:, 3:], -1)


def test_all_negative_catalogue():
    rng = np.random.default_rng(6)
    T = -np.abs(rng.standard_normal((300, 4))).astype(np.float32)
    U = np.abs(rng.standard_normal((2, 4))).astype(np.float32)
    ref = RefCatalog(T, block_m=64, superblock=2)
    got = _port(ref).query_batch(U, 5)
    _assert_same(got, ref.query_batch(jnp.asarray(U), 5))
    assert np.all(host(got[0]) < 0)


def test_single_level_matches_pallas_single_query(two_level):
    """Pre-screen off: the single_level mode against topk_mips_pallas."""
    T, ref, cat, U = two_level
    u = U[1]
    bounds = np.linalg.norm(u) * np.asarray(ref.block_max_norm)
    want = topk_mips_pallas(ref.T_sorted, jnp.asarray(bounds),
                            jnp.asarray(u), 5, ref.block_m,
                            num_real=ref.num_real)
    args = cat.kernel_args(u[None, :], 5, "single_level")
    v, i, s = topk_mips(**args)
    _assert_same((v[0], i[0], s[0]), want)
    # the catalogue's pre-screen-off path returns the same, in catalogue ids
    cv, ci, cs = cat.query(u, 5, prescreen=False)
    np.testing.assert_array_equal(host(cs), host(s[0]))
    np.testing.assert_array_equal(host(ci), host(cat._to_catalogue_ids(i[0])))


def test_single_level_matches_pallas_batched(two_level):
    """Pre-screen off over a batch: against topk_mips_pallas_batched."""
    T, ref, cat, U = two_level
    bounds = (np.linalg.norm(U, axis=1)[:, None]
              * np.asarray(ref.block_max_norm)[None, :]).astype(np.float32)
    want = topk_mips_pallas_batched(ref.T_sorted, jnp.asarray(bounds),
                                    jnp.asarray(U), 5, ref.block_m,
                                    num_real=ref.num_real)
    got = topk_mips(**cat.kernel_args(U, 5, "single_level"))
    _assert_same(got, want)
    # scored/visited equal the two-level mode's: the pre-screen only drops
    # tiles the runtime test drops anyway
    two = cat.query_batch(U, 5)
    np.testing.assert_array_equal(host(two[2])[:, :2], host(got[2])[:, :2])


def test_plain_version_matches_the_oracle_and_validates(two_level):
    T, ref, cat, U = two_level
    vals, idx, _ = topk_mips(**cat.kernel_args(U, 5, "two_level_tile"))
    for b in range(U.shape[0]):
        rv, ri = topk_mips_ref(cat.T_sorted, torch.from_numpy(U[b]), 5)
        assert_topk_equal((vals[b], idx[b]), (rv, ri))
    args = cat.kernel_args(U, 5, "two_level_batched")
    with pytest.raises(ValueError, match="unknown mode"):
        topk_mips(**{**args, "mode": "two_level"})
    with pytest.raises(ValueError, match="live counts"):
        topk_mips(**{**args, "live": None})
    with pytest.raises(ValueError, match="tile_bounds"):
        topk_mips(**{**args, "tile_bounds": args["tile_bounds"][:, :-1]})


def _decomposed(T_sorted, U, tile_bounds, live, k, block_m, mode,
                superblock=1, num_real=-1):
    """The CUDA kernel's two phases in numpy. Phase 1: every (query, tile)
    of the live prefix scored, its top min(k, block_m) rows kept in
    (value desc, row asc) order, and its maximum. Phase 2: per query, walk
    tiles 0 .. n_tiles-1; a tile with bound > K-th best is visited, and
    its list entries strictly above the K-th best merged, the carry
    winning ties."""
    T_sorted, U, tile_bounds = (host(x).astype(np.float32)
                                for x in (T_sorted, U, tile_bounds))
    M_pad = T_sorted.shape[0]
    n_blocks = M_pad // block_m
    num_real = M_pad if num_real < 0 else num_real
    kk = min(k, block_m)
    B = U.shape[0]
    if mode == "single_level":
        n_tiles = np.full(B, n_blocks)
    else:
        scale = superblock if mode == "two_level_batched" else 1
        n_tiles = np.clip(host(live).astype(np.int64) * scale, 0, n_blocks)
    lists, tmax = {}, {}
    for t in range(int(n_tiles.max(initial=0))):
        rows = np.arange(t * block_m, (t + 1) * block_m)
        sc = U @ T_sorted[rows].T
        sc = np.where(rows[None, :] < num_real, sc, np.float32(-1e30))
        for b in range(B):
            order = np.lexsort((rows, -sc[b].astype(np.float64)))[:kk]
            lists[b, t] = [(sc[b, i], int(rows[i])) for i in order]
            tmax[b, t] = sc[b].max()
    vals = np.full((B, k), -1e30, np.float32)
    ids = np.full((B, k), -1, np.int32)
    stats = np.zeros((B, 3), np.int32)
    for b in range(B):
        carry = [(np.float32(-1e30), -1)] * k
        visited = 0
        for t in range(n_tiles[b]):
            lb = carry[-1][0]
            if not tile_bounds[b, t] > lb:
                continue
            visited += 1
            if tmax[b, t] > lb:
                cands = [(v, r) for v, r in lists[b, t] if v > lb]
                keyed = ([(-v, 0, j, v, r) for j, (v, r) in enumerate(carry)]
                         + [(-v, 1, p, v, r) for p, (v, r) in
                            enumerate(cands)])
                carry = [e[3:] for e in sorted(keyed)[:k]]
        vals[b] = [v for v, _ in carry]
        ids[b] = [r for _, r in carry]
        stats[b] = (visited * block_m, visited, n_tiles[b])
    return vals, ids, stats


@pytest.mark.parametrize("case,m,r,k,block,sb", [
    ("decaying", 2048, 16, 5, 128, 4),
    ("flat", 512, 8, 5, 64, 4),
    ("k>block_m", 1024, 12, 100, 64, 2),
    ("num_real<k", 3, 4, 5, 64, 1),
    ("duplicates", 900, 10, 7, 64, 4),
    ("non-monotone", 2048, 16, 5, 128, 4),
])
def test_kernel_decomposition_matches_plain_version(case, m, r, k, block,
                                                    sb):
    """The two-phase algorithm of the CUDA kernel (per-tile top-k lists,
    then the gated walk) equals the plain version in every mode, values,
    ids and all three stats columns; with the catalogue's own bounds the
    two-level modes also equal the reference: two_level_batched its
    query_batch (the batched Pallas prefetch kernel in interpret mode),
    two_level_tile its single-query query, row by row (the single-query
    prefetch kernel in interpret mode)."""
    rng = np.random.default_rng(m + k)
    T = (_decaying(m, r, 0.5, m) if case != "flat"
         else rng.standard_normal((m, r)).astype(np.float32))
    if case == "flat":
        T /= np.linalg.norm(T, axis=1, keepdims=True)
    if case == "duplicates":        # runs of 3 straddle the tile boundaries
        T = np.repeat(T[: m // 3], 3, axis=0)
    ref = RefCatalog(T, block_m=block, superblock=sb)
    cat = _port(ref)
    U = rng.standard_normal((5, r)).astype(np.float32)
    for mode in ("two_level_batched", "two_level_tile", "single_level"):
        args = cat.kernel_args(U, k, mode)
        if case == "non-monotone":
            perm = torch.from_numpy(rng.permutation(cat.n_blocks))
            scale = torch.from_numpy(
                rng.uniform(0.3, 1.5, cat.n_blocks).astype(np.float32))
            args["tile_bounds"] = (args["tile_bounds"][:, perm]
                                   * scale).contiguous()
        got = _decomposed(**args)
        want = topk_mips(**args)
        _assert_same(got, want)
        if case == "non-monotone" or mode == "single_level":
            continue
        ids = cat._to_catalogue_ids(torch.from_numpy(got[1]))
        if mode == "two_level_batched":
            _assert_same((got[0], ids, got[2]),
                         ref.query_batch(jnp.asarray(U), k))
        else:
            for b in range(U.shape[0]):
                _assert_same((got[0][b], ids[b], got[2][b]),
                             ref.query(jnp.asarray(U[b]), k))


@pytest.mark.parametrize("B,n_blocks,kk,budget", [
    (64, 1272, 10, 256 << 20),     # LSHTC-like at k = 10: one slice
    (100_000, 1272, 100, 256 << 20),
    (1000, 64, 64, 330_240),       # 10 queries a slice
    (5, 10_000, 256, 1000),        # one query's scratch over the budget
    (130, 8, 4, 8 * 36 * 64),      # exactly 64 queries a slice
])
def test_query_slices_bound_the_kernel_scratch(B, n_blocks, kk, budget):
    """The wrapper's query slices cover the batch in order, each within
    the scratch budget (or one query), in whole groups of 64 where a
    slice holds 64 or more."""
    slices = query_slices(B, n_blocks, kk, budget)
    assert slices[0][0] == 0 and slices[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    per_query = n_blocks * (8 * kk + 4)
    rows = slices[0][1] - slices[0][0]
    assert all(b1 - b0 <= rows for b0, b1 in slices)
    assert rows == 1 or rows * per_query <= budget
    assert rows < 64 or rows % 64 == 0 or rows == B
    if B * per_query > budget:
        assert len(slices) > 1


def test_k_past_the_shared_memory_carry_matches_reference():
    """k = 300: the CUDA gate walk keeps its carry in global memory past
    256 rows. The engine (plain version on the CPU) equals the
    reference's ``pallas`` engine, and the kernel's two-phase
    decomposition equals the plain version in every mode."""
    from repro.core.engines import EngineContext as RefContext
    from repro.core.engines import get_engine as ref_get_engine
    from repro_torch.core.engines import EngineContext, get_engine
    T = _decaying(1500, 12, 0.3, 4)
    rng = np.random.default_rng(4)
    U = rng.standard_normal((3, 12)).astype(np.float32)
    got = get_engine("topk_mips").run(
        EngineContext(T, block_size=128, device="cpu"), U, 300)
    want = ref_get_engine("pallas").run(RefContext(T, block_size=128),
                                        jnp.asarray(U), 300)
    assert_topk_equal(got[:2], want[:2])
    for field in ("n_scored", "depth"):
        np.testing.assert_array_equal(host(getattr(got, field)),
                                      np.asarray(getattr(want, field)))
    cat = _port(RefCatalog(T, block_m=128, superblock=2))
    for mode in ("two_level_batched", "two_level_tile", "single_level"):
        args = cat.kernel_args(U, 300, mode)
        _assert_same(_decomposed(**args), topk_mips(**args))


@pytest.mark.parametrize("B,n_blocks,kk,k,budget", [
    (64, 1272, 256, 522, 256 << 20),    # LSHTC-like, the ladder's k = 522
    (10, 64, 64, 100_000, 4 << 20),     # the carry alone past the budget
])
def test_query_slices_count_the_global_carry(B, n_blocks, kk, k, budget):
    """Past 256 the slices also hold each query's global carry of
    ``4 k + 2 kk`` words within the budget."""
    slices = query_slices(B, n_blocks, kk, budget, k=k)
    assert slices[0][0] == 0 and slices[-1][1] == B
    per_query = n_blocks * (8 * kk + 4) + 4 * (4 * k + 2 * kk)
    rows = slices[0][1] - slices[0][0]
    assert rows == 1 or rows * per_query <= budget
    assert query_slices(B, n_blocks, kk, budget, k=256) == query_slices(
        B, n_blocks, kk, budget)
