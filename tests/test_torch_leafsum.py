"""The leaf refit's sums of lightgbm_tpu_torch on the CPU: the plain twin
of the card's grouping (`leaf_group_plain`, a counting sort) against a
stable sort of the leaf ids with `searchsorted`, and the arithmetic of
the card's sums kernel (each leaf's chain over whole 512-row chunks of
(g, h) pairs from the pair that holds its first row, the rows outside
the leaf +0) against the twin of the sums, `index_add_` on the CPU.
The card runs of both kernels are in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops.leafsum import (leaf_group_plain, leaf_sums,
                                            leaf_sums_plain)

# (n, L, how the ids are drawn)
CASES = {
    "uniform_empty_leaves": (5_003, 64, "uniform"),
    "one_leaf_holds_every_row": (2_048, 16, "one"),
    "padding_leaf": (4_100, 33, "padding"),
    "one_leaf_in_all": (1_000, 1, "uniform"),
    "no_rows": (0, 8, "uniform"),
    "4096_leaves": (20_000, 4096, "uniform"),
    "skewed": (9_999, 255, "skewed"),
}


def _operands(n, L, how, seed=21):
    rng = np.random.default_rng(seed)
    if how == "one":
        ids = np.full(n, L // 2, np.int32)
    else:
        # the last three leaves stay empty unless a case fills them
        ids = rng.integers(0, max(L - 3, 1), size=n).astype(np.int32)
    if how == "padding":
        ids[n - n // 5:] = L - 1       # the grower's padding rows
    if how == "skewed":
        ids[rng.random(n) < 0.9] = 7
    vals = np.stack([rng.normal(size=n), rng.random(n) * 0.25]
                    ).astype(np.float32)
    vals[0, rng.random(n) < 0.05] = -0.0
    return torch.from_numpy(ids), torch.from_numpy(vals)


@pytest.mark.parametrize("case", list(CASES))
def test_grouping_twin_is_the_stable_sort(case):
    n, L, how = CASES[case]
    ids, vals = _operands(n, L, how)
    grouped, offsets = leaf_group_plain(ids, vals, L)
    sorted_ids, order = torch.sort(ids, stable=True)
    assert torch.equal(grouped, vals[:, order].T)
    assert offsets.dtype == torch.int32 and offsets.shape == (L + 1,)
    assert torch.equal(offsets, torch.searchsorted(
        sorted_ids, torch.arange(L + 1, dtype=torch.int32), out_int32=True))


def _added_rows(s, e, chunk_vecs=256):
    """The rows, in add order, that the sums kernel adds for the leaf
    [s, e), None for a +0 of the padding: whole chunks of chunk_vecs
    float4s (two rows each) from the float4 holding row s, the rows
    outside the leaf +0."""
    q0, q1 = s >> 1, (e + 1) >> 1
    chunks = -(-(q1 - q0) // chunk_vecs) if e > s else 0
    return [r if s <= r < e else None
            for q in range(q0, q0 + chunks * chunk_vecs)
            for r in (2 * q, 2 * q + 1)]


@pytest.mark.parametrize("case", ["uniform_empty_leaves", "padding_leaf",
                                  "one_leaf_in_all", "no_rows", "skewed"])
def test_zero_padded_chains_are_the_twins_sums(case):
    n, L, how = CASES[case]
    ids, vals = _operands(n, L, how)
    grouped, offsets = leaf_group_plain(ids, vals, L)
    off = offsets.tolist()
    pairs = grouped.numpy()
    out = np.zeros((2, L), np.float32)
    for leaf in range(L):
        rows = _added_rows(off[leaf], off[leaf + 1])
        for v in range(2):
            acc = np.float32(0.0)
            for r in rows:
                acc = np.float32(acc + (pairs[r, v] if r is not None
                                        else np.float32(0.0)))
            out[v, leaf] = acc
    # bitwise, -0.0 included: the +0 of the padding change no sum
    want = leaf_sums_plain(ids, vals, L)
    assert torch.equal(torch.from_numpy(out).view(torch.int32),
                       want.view(torch.int32))
    assert torch.equal(leaf_sums(ids, vals, L), want)


@pytest.mark.parametrize("s,e", [(0, 1), (1, 2), (3, 4), (0, 512), (1, 513),
                                 (2, 1026), (5, 9001), (512, 1024)])
def test_padded_chunks_add_the_leaf_rows_once_in_order(s, e):
    rows = _added_rows(s, e)
    assert [r for r in rows if r is not None] == list(range(s, e))
    assert len(rows) % 512 == 0 and len(rows) < (e - s) + 2 * 512


def test_grouping_twin_refuses_ids_past_the_leaves():
    ids = torch.tensor([0, 3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        leaf_group_plain(ids, torch.ones(2, 3), 4)
