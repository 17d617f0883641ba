"""The plain parts of lightgbm_tpu_torch's grouped histogram kernels (B1,
B2): the launch plan, the row-major bin copy and the grouping of rows by
slot, each against numpy on the CPU.  The kernels themselves are held to
these on the card in tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as TH

# NVIDIA H100 SXM: SMs, opt-in shared memory of a block, of an SM
H100 = (132, 232448, 233472)
N_PATH = 1_007_616          # the Higgs-1M path's padded rows

PLAN_CASES = [
    # (name, F, K, S, B, n, scan, floats)
    ("hilo_path", 32, 25, 5, 255, N_PATH, False, True),
    ("int8_root", 32, 25, 3, 255, N_PATH, False, False),
    ("b2_path", 32, 25, 3, 255, N_PATH, True, False),
    ("f32_stats", 32, 25, 3, 255, N_PATH, False, True),
    ("k50", 8, 50, 5, 255, 1 << 16, False, True),
    ("k254", 32, 254, 5, 256, 5000, False, True),
    ("b256_s5", 32, 25, 5, 256, N_PATH, False, True),
    ("two_chunks", 64, 25, 5, 255, 100_000, False, True),
    ("f40", 40, 5, 3, 255, 30_000, True, False),
    ("small", 7, 3, 5, 13, 5000, False, True),
    ("one_row", 1, 1, 3, 2, 1, True, False),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: c[0])
def test_hist_plan_fits_and_covers(case):
    _, F, K, S, B, n, scan, floats = case
    sms, smem_max, smem_sm = H100
    p = TH.hist_plan(F, K, S, B, n, sms, smem_max, smem_sm, scan=scan,
                     floats=floats)
    # a block's shared memory fits the card, and the blocks an SM is
    # planned to hold fit it together
    per_sm = p.grid // sms
    assert p.grid == per_sm * sms and per_sm in (1, 2)
    assert p.smem <= smem_max
    assert per_sm * (p.smem + 1024) <= smem_sm
    assert p.threads * per_sm <= 2048 and p.threads % 256 == 0
    # the sums of one slot, 32 features at a time, and the grouping's
    # tables fit the block's shared memory
    sums = B * S * (32 if floats else 33)
    assert 4 * sums < p.smem
    assert 4 * (2 * (p.threads // 32) * K + K) < p.smem
    # feature chunks of 32 cover every feature once
    assert (p.chunks - 1) * 32 < F <= p.chunks * 32
    # the blocks' tiles cover every row once; each warp takes an equal
    # part of its block's tile in steps of 4 x 32 rows
    assert p.tile_rows * p.grid >= n
    assert p.tile_rows % (4 * p.threads) == 0
    # packed stats, rows, [K, grid] counts, [K + 1] offsets
    assert p.scratch_words == 5 * n + p.grid * K + K + 1
    assert p.seg_rows == 512
    # a block alone: only the wide plans cluster
    assert p.cluster == 1 and p.bin_tile == B


def test_hist_plan_chunks_features_too_large_for_a_block():
    sms, smem_max, smem_sm = H100
    F, K, S, B = 64, 25, 5, 255
    assert F * B * S * 4 > smem_max
    p = TH.hist_plan(F, K, S, B, 10_000, sms, smem_max, smem_sm, floats=True)
    assert p.chunks == 2
    p1 = TH.hist_plan(32, K, S, B, 10_000, sms, smem_max, smem_sm,
                      floats=True)
    assert p1.chunks == 1 and p1.smem == p.smem


@pytest.mark.parametrize("bad", [dict(K=255), dict(S=6), dict(B=257),
                                 dict(F=0), dict(n=0), dict(K=0)])
def test_hist_plan_refuses_what_the_kernel_cannot_take(bad):
    args = dict(F=32, K=25, S=5, B=255, n=1000)
    args.update(bad)
    with pytest.raises(ValueError):
        TH.hist_plan(args["F"], args["K"], args["S"], args["B"], args["n"],
                     *H100)


@pytest.mark.parametrize("F", [1, 7, 28, 32, 40])
def test_row_major_bins_matches_numpy(F):
    rng = np.random.default_rng(F)
    n = 1000
    bins = rng.integers(0, 256, size=(F, n)).astype(np.uint8)
    t = torch.from_numpy(bins)
    rows = TH.row_major_bins(t)
    fr = -(-F // 32) * 32
    want = np.zeros((n, fr), np.uint8)
    want[:, :F] = bins.T
    assert rows.dtype == torch.uint8 and rows.is_contiguous()
    np.testing.assert_array_equal(rows.numpy(), want)
    # kept with the matrix: the same copy again, a new one after an
    # in-place change
    assert TH.row_major_bins(t) is rows
    t[0, 0] = (int(bins[0, 0]) + 1) % 256
    again = TH.row_major_bins(t)
    assert again is not rows and int(again[0, 0]) == int(t[0, 0])


def _group_numpy(leaf, slots):
    """Rows grouped by slot, in row order, each under the first slot
    holding its leaf id; [K+1] offsets."""
    rows, offsets = [], [0]
    for k, s in enumerate(slots):
        first = s >= 0 and s not in slots[:k]
        mine = np.nonzero(leaf == s)[0] if first else np.zeros(0, int)
        rows.extend(mine.tolist())
        offsets.append(len(rows))
    return np.asarray(rows, np.int32), np.asarray(offsets, np.int32)


@pytest.mark.parametrize("leaves,slots", [
    (60, list(range(0, 48, 2)) + [-1]),       # random, a dead slot
    (1, [0] + [-1] * 24),                     # the root call
    (6, [2, 5, 2, -1, 4]),                    # a leaf id in two slots
    (6, [1, 77, 3]),                          # a live slot with no rows
    (6, [-1, -1, -1]),                        # all slots dead
    (3, [1]),                                 # K = 1
])
def test_group_rows_plain_matches_numpy(leaves, slots):
    rng = np.random.default_rng(len(slots))
    leaf = rng.integers(0, leaves, size=3001).astype(np.int32)
    rows, offsets = TH.group_rows_plain(
        torch.from_numpy(leaf), torch.tensor(slots, dtype=torch.int32))
    want_rows, want_off = _group_numpy(leaf, np.asarray(slots))
    assert rows.dtype == torch.int32 and offsets.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), want_rows)
    np.testing.assert_array_equal(offsets.numpy(), want_off)


def test_grouping_gives_the_twins_histogram():
    """The grouped list and the per-slot sums over it are the batched
    histogram's (the duplicate slot copied from the first)."""
    rng = np.random.default_rng(5)
    F, n, B = 5, 2000, 13
    slots = [3, 0, 3, -1]
    bins = torch.from_numpy(rng.integers(0, B, size=(F, n)).astype(np.uint8))
    stats = torch.from_numpy(rng.integers(-9, 10, size=(3, n))
                             .astype(np.int8))
    leaf = torch.from_numpy(rng.integers(0, 5, size=n).astype(np.int32))
    sl = torch.tensor(slots, dtype=torch.int32)
    rows, offsets = TH.group_rows_plain(leaf, sl)
    raw = torch.zeros((F, B, len(slots), 3), dtype=torch.int32)
    for k in range(len(slots)):
        first = [j for j in range(len(slots)) if slots[j] == slots[k]][0]
        r = rows[offsets[first]:offsets[first + 1]].long()
        for f in range(F):
            raw[f, :, k].index_add_(0, bins[f, r].long(),
                                    stats[:, r].T.to(torch.int32))
    assert torch.equal(raw, TH.hist_batched_plain(bins, stats, leaf, sl, B))
