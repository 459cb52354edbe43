"""The ``topk_mips`` CUDA kernel against its plain PyTorch version, on the
card. These tests need a CUDA device (the kernel has no CPU mode) and skip
with a reason where there is none; the file imports no jax, so it also
runs where only PyTorch is installed:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Agreement: values within 1e-5 relative (the kernel sums each row in lane
order, the plain version in cuBLAS's), ids equal wherever scores are
distinct, stats equal exactly."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ops import MIPSCatalog
from repro_torch.kernels.topk_mips import MODES, topk_mips, topk_mips_plain

from _torch_parity import assert_topk_equal

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.parametrize("m,r,k,block", [
    (20000, 50, 10, 256),   # decaying norms: the pre-screen cuts the scan
    (3000, 17, 3, 64),      # R with no 16-byte row alignment
    (5, 8, 10, 256),        # fewer real rows than k
])
def test_cuda_kernel_matches_plain_version(m, r, k, block):
    _need_card()
    rng = np.random.default_rng(m + r)
    T = rng.standard_normal((m, r)).astype(np.float32)
    T *= ((1.0 / (1.0 + np.arange(m)))[:, None] ** 0.3).astype(np.float32)
    cat = MIPSCatalog(T, block_m=block, superblock=8, device="cuda")
    U = rng.standard_normal((33, r)).astype(np.float32)
    before = topk_mips.launches
    for mode in MODES:
        args = cat.kernel_args(U, k, mode)
        got = topk_mips(**args)
        want = topk_mips_plain(**args)
        torch.cuda.synchronize()
        assert_topk_equal(got[:2], want[:2])
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    assert topk_mips.launches == before + len(MODES)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    T = np.random.default_rng(0).standard_normal((512, 8)).astype(np.float32)
    cat = MIPSCatalog(T, block_m=64, device="cuda")
    args = cat.kernel_args(np.ones((2, 8), np.float32), 5, "single_level")
    with pytest.raises(ValueError, match="kernel limits"):
        topk_mips(**{**args, "k": 257})
    with pytest.raises(ValueError, match="float32"):
        topk_mips(**{**args, "U": args["U"].double()})
    with pytest.raises(ValueError, match="contiguous"):
        topk_mips(**{**args, "tile_bounds": args["tile_bounds"].t()
                     .contiguous().t()})
    with pytest.raises(ValueError, match="one device"):
        topk_mips(**{**args, "U": args["U"].cpu()})
