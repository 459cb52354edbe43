"""Parity of the port's foundation (model, index, naive top-K, certificates,
state conversion) with the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_index as ref_build_index
from repro.core import random_model as ref_random_model
from repro.core.naive import TopKResult as RefTopKResult
from repro.core.naive import certificate_gaps as ref_certificate_gaps
from repro.core.naive import certified_counts as ref_certified_counts
from repro.core.naive import naive_topk as ref_naive_topk
from repro.core.seplr import from_cosine_similarity as ref_from_cosine
from repro_torch import resolve_device
from repro_torch.convert import INDEX_FIELDS, from_reference
from repro_torch.core.index import TopKIndex, build_index
from repro_torch.core.layout import build_layout, layout_names
from repro_torch.core.naive import (TopKResult, certificate_gaps,
                                    certified_counts, naive_topk)
from repro_torch.core.seplr import (SepLRModel, from_cosine_similarity,
                                    random_model)

from _torch_parity import assert_topk_equal, assert_values, host

ROOT = Path(__file__).resolve().parents[1]


def _catalogue(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.standard_normal((300, 12)).astype(np.float32)
    if kind == "tied":
        # few distinct values per column and repeated rows: every sort
        # has ties, which must go to the lower id in both packages
        T = rng.integers(-2, 3, (200, 6)).astype(np.float32)
        T[50:60] = T[0]
        return T
    return -np.abs(rng.standard_normal((150, 8))).astype(np.float32) - 0.1


@pytest.mark.parametrize("kind", ["random", "tied", "all_negative"])
def test_build_index_matches_reference_field_for_field(kind):
    T = _catalogue(kind)
    ref = ref_build_index(jnp.asarray(T))
    got = build_index(torch.from_numpy(T), device="cpu")
    for f in sorted(INDEX_FIELDS):
        a, b = host(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)   # exact: same sorts


@pytest.mark.parametrize("kind", ["random", "tied", "all_negative"])
def test_naive_topk_matches_reference(kind):
    T = _catalogue(kind)
    rng = np.random.default_rng(3)
    U = rng.standard_normal((5, T.shape[1])).astype(np.float32)
    k = 7
    ref = ref_naive_topk(jnp.asarray(T), jnp.asarray(U), k)
    got = naive_topk(torch.from_numpy(T), torch.from_numpy(U), k)
    assert_topk_equal((got.values, got.indices), (ref.values, ref.indices))
    for f in ("n_scored", "depth", "upper"):
        np.testing.assert_array_equal(host(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    # a single query keeps the scalar shapes
    one = naive_topk(torch.from_numpy(T), torch.from_numpy(U[0]), k)
    assert one.values.shape == (k,) and one.n_scored.shape == ()


def test_certificates_match_reference_including_pad_slots():
    vals = np.array([[3.0, 2.0, 1.0, -np.inf], [5.0, 4.0, -1.0, -2.0]],
                    np.float32)
    ids = np.array([[4, 1, 0, -1], [2, 3, 7, 8]], np.int32)
    upper = np.array([1.5, -np.inf], np.float32)
    n = np.zeros(2, np.int32)
    ref = RefTopKResult(jnp.asarray(vals), jnp.asarray(ids), n, n,
                        upper=jnp.asarray(upper))
    got = TopKResult(torch.from_numpy(vals), torch.from_numpy(ids),
                     torch.from_numpy(n), torch.from_numpy(n),
                     upper=torch.from_numpy(upper))
    gaps = host(certificate_gaps(got))
    np.testing.assert_array_equal(gaps, np.asarray(ref_certificate_gaps(ref)))
    assert gaps[0, 3] == np.inf            # pad slot: +inf, never nan
    np.testing.assert_array_equal(host(certified_counts(got)),
                                  np.asarray(ref_certified_counts(ref)))
    with pytest.raises(ValueError):
        certificate_gaps(got._replace(upper=None))


@pytest.mark.parametrize("dist,sparsity", [("normal", 0.0),
                                           ("lognormal", 0.9),
                                           ("lowrank_spectrum", 0.0)])
def test_random_model_draws_the_reference_catalogue(dist, sparsity):
    ref = ref_random_model(np.random.default_rng(11), 64, 9, dist, sparsity)
    got = random_model(np.random.default_rng(11), 64, 9, dist, sparsity,
                       device="cpu")
    np.testing.assert_array_equal(host(got.targets), np.asarray(ref.targets))
    assert got.name == ref.name and got.rank == 9 and got.num_targets == 64


def test_adapters_and_scoring_match_reference():
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((40, 6)).astype(np.float32)
    Y[3] = 0.0                              # a zero row keeps norm 1
    ref = ref_from_cosine(jnp.asarray(Y))
    got = from_cosine_similarity(Y, device="cpu")
    assert_values(got.targets, ref.targets)
    u = rng.standard_normal(6).astype(np.float32)
    assert_values(got.score_all(torch.from_numpy(u)),
                  ref.score_all(jnp.asarray(u)))
    ids = np.array([0, 5, 5, 39])
    assert_values(got.score(torch.from_numpy(u), torch.from_numpy(ids)),
                  ref.score(jnp.asarray(u), jnp.asarray(ids)))


def test_from_reference_carries_model_and_index_state():
    T = _catalogue("random")
    ref_index = ref_build_index(jnp.asarray(T))
    arrays = {f: np.asarray(getattr(ref_index, f)) for f in INDEX_FIELDS}
    idx = from_reference(arrays, device="cpu")
    assert isinstance(idx, TopKIndex) and idx.num_targets == 300
    for f in INDEX_FIELDS:
        np.testing.assert_array_equal(host(getattr(idx, f)), arrays[f])
    model = from_reference({"targets": T}, device="cpu")
    assert isinstance(model, SepLRModel)
    np.testing.assert_array_equal(host(model.targets), T)
    with pytest.raises(ValueError, match="unrecognised"):
        from_reference({"targets": T, "extra": 1}, device="cpu")


def test_layouts_reuse_the_index_norm_order():
    T = _catalogue("tied")
    idx = build_index(torch.from_numpy(T), device="cpu")
    assert layout_names() == ["list_major", "norm_major", "norm_sharded",
                              "row_major"]
    with_index = build_layout("norm_major", T, idx)
    without = build_layout("norm_major", T, device="cpu")
    for f in ("norm_order", "norms_sorted", "targets_by_norm"):
        np.testing.assert_array_equal(host(getattr(with_index, f)),
                                      host(getattr(without, f)))
    dealt = build_layout("norm_sharded", T, idx, n_shards=1)
    np.testing.assert_array_equal(host(dealt.ids_sharded),
                                  host(with_index.norm_order))
    with pytest.raises(ValueError, match="unknown layout"):
        build_layout("norm_shard", T, idx)


def test_entry_points_default_to_the_card():
    """device=None means cuda: it raises where there is no card, and
    never quietly runs on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        random_model(np.random.default_rng(0), 8, 3)
    with pytest.raises(RuntimeError):
        build_index(np.zeros((4, 2), np.float32))


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert files, "src/repro_torch has no modules"
    return files + [ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_reference():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, bad
