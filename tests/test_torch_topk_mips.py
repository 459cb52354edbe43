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
from repro_torch.kernels.topk_mips import topk_mips

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
