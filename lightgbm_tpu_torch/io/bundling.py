"""EFB: exclusive feature bundling.

A copy of `lightgbm_tpu/io/bundling.py` (host numpy): the port's learner
plans the same bundles from the same strided row sample, so both
packages train on the same bundle columns; `find_bundles_multihost`
agrees one plan across the processes of a `torch.distributed` group.

Plays the role of the reference's `FindGroups` / `FastFeatureBundling`
(reference src/io/dataset.cpp:91-263) + `FeatureGroup` storage (reference
include/LightGBM/feature_group.h:37-53): (almost-)mutually-exclusive
sparse features share one bundle column, shrinking the column axis that
the histogram kernels sweep.

Scheme (simplified relative to the reference, same math contract):
* only features whose MOST FREQUENT bin is bin 0 are bundling candidates
  (the sparse/one-hot case the reference optimizes; dense features keep
  their own column);
* greedy first-fit by descending nonzero count, with a per-bundle
  conflict budget of max_conflict_rate * n rows (reference
  dataset.cpp:115-157) and a bin-capacity cap;
* bundle column value: 0 when every member is at bin 0, else
  offset_i + bin (bins 1..num_bin_i-1 of member i map to
  [offset_i+1, offset_i+num_bin_i-1]); on a (budgeted) conflict the
  later member wins, like the reference's sequential push;
* the per-feature bin-0 row is NOT recoverable from the bundle column:
  the grower reconstructs it per leaf as total - sum(other bins), the
  analog of Dataset::FixHistogram (reference src/io/dataset.cpp:
  1044-1063).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


# default row-sample quota the bundling greedy counts conflicts on; the
# learner pre-samples through TrainingData.strided_row_sample with the
# SAME constant, so the device matrix is never fetched whole for it
EFB_SAMPLE_ROWS = 100_000


class BundlePlan(NamedTuple):
    # per bundle: list of used-feature positions (len 1 = untouched column)
    groups: List[List[int]]
    # per used feature: bundle index and bin offset within it
    bundle_idx: np.ndarray      # [F] int32
    bin_offset: np.ndarray      # [F] int32 (0 for singleton columns)
    needs_fix: np.ndarray       # [F] bool: bin 0 must be reconstructed
    num_bin: np.ndarray         # [G] int32 bins per bundle column

    @property
    def num_columns(self) -> int:
        return len(self.groups)

    @property
    def is_trivial(self) -> bool:
        return all(len(g) == 1 for g in self.groups)


def _stride_sample(bins: np.ndarray, quota: int) -> np.ndarray:
    """Deterministic strided row sample (TrainingData.strided_row_sample
    takes the same rows from the device matrix)."""
    n = bins.shape[0]
    if n > quota:
        step = n // quota
        return bins[::step][:quota]
    return bins


def find_bundles(bins: np.ndarray, num_bin: np.ndarray,
                 most_freq_is_zero: np.ndarray, max_conflict_rate: float,
                 max_bundle_bins: int, sample_rows: int = EFB_SAMPLE_ROWS
                 ) -> BundlePlan:
    """Greedy conflict-budget bundling over the binned [n, F] matrix.

    num_bin / most_freq_is_zero are per used feature; conflicts are
    counted on a row sample like the reference's sampled FindGroups.
    """
    n, F = bins.shape
    sample = _stride_sample(bins, sample_rows)
    ns = sample.shape[0]
    budget_total = max_conflict_rate * ns

    nz = sample != 0                      # [ns, F] non-default mask
    nz_count = nz.sum(axis=0)
    candidates = [f for f in range(F)
                  if most_freq_is_zero[f] and num_bin[f] <= max_bundle_bins]
    # densest first so heavy features anchor bundles (reference sorts by
    # conflict count, dataset.cpp:133)
    candidates.sort(key=lambda f: -int(nz_count[f]))

    groups: List[List[int]] = []
    occupied: List[np.ndarray] = []       # [ns] bool per bundle
    conflicts: List[int] = []
    bin_used: List[int] = []
    for f in candidates:
        placed = False
        for gi in range(len(groups)):
            if bin_used[gi] + int(num_bin[f]) - 1 > max_bundle_bins - 1:
                continue
            c = int((nz[:, f] & occupied[gi]).sum())
            if conflicts[gi] + c <= budget_total:
                groups[gi].append(f)
                occupied[gi] |= nz[:, f]
                conflicts[gi] += c
                bin_used[gi] += int(num_bin[f]) - 1
                placed = True
                break
        if not placed:
            groups.append([f])
            occupied.append(nz[:, f].copy())
            conflicts.append(0)
            bin_used.append(int(num_bin[f]) - 1)

    # drop singleton "bundles" back into plain columns; order: real
    # bundles first, then untouched features in original order
    real = [g for g in groups if len(g) > 1]
    bundled_feats = {f for g in real for f in g}
    final: List[List[int]] = real + [[f] for f in range(F)
                                     if f not in bundled_feats]

    bundle_idx = np.zeros(F, np.int32)
    bin_offset = np.zeros(F, np.int32)
    needs_fix = np.zeros(F, bool)
    g_bins = np.zeros(len(final), np.int32)
    for gi, g in enumerate(final):
        if len(g) == 1:
            f = g[0]
            bundle_idx[f] = gi
            bin_offset[f] = 0
            g_bins[gi] = num_bin[f]
            continue
        off = 0
        for f in g:
            bundle_idx[f] = gi
            bin_offset[f] = off
            needs_fix[f] = True
            off += int(num_bin[f]) - 1
        g_bins[gi] = off + 1
    return BundlePlan(groups=final, bundle_idx=bundle_idx,
                      bin_offset=bin_offset, needs_fix=needs_fix,
                      num_bin=g_bins)


def find_bundles_multihost(local_bins: np.ndarray, num_bin: np.ndarray,
                           local_zero_frac: np.ndarray, local_rows: int,
                           sparse_threshold: float,
                           max_conflict_rate: float,
                           max_bundle_bins: int,
                           sample_rows: int = EFB_SAMPLE_ROWS) -> BundlePlan:
    """Bundling plan agreed across the processes of the group.

    EVERYTHING plan-determining reduces globally inside this function —
    callers pass only LOCAL statistics (zero fractions and row count
    from this rank's rows), so no half of the agreement contract can be
    forgotten at a call site.  The candidate filter comes from the
    globally weighted zero fractions; the greedy's per-bundle occupancy
    is a UNION over sample rows, so a consistent plan cannot come from
    locally-found plans or pairwise count sums: every rank contributes
    an equal quota of its local rows, the samples allgather (ragged,
    integer transport — never demoted; uint16 normally, widened to
    uint32 when any feature's bin ids exceed the uint16 range so the
    gather cannot silently truncate them), and the IDENTICAL greedy
    runs on the identical global sample everywhere.  Single-process
    groups degrade to the local find.
    """
    from ..parallel.topology import process_count

    nproc = process_count()
    if nproc <= 1:
        return find_bundles(local_bins, num_bin,
                            local_zero_frac >= sparse_threshold,
                            max_conflict_rate, max_bundle_bins,
                            sample_rows=sample_rows)
    from ..parallel.topology import host_allgather, ragged_all_gather

    # globally weighted zero fractions decide the candidate set; both
    # exchanges ride distributed bin finding's own fault point so chaos
    # runs can target ingest separately from train-loop sync
    zf = host_allgather(
        np.concatenate([np.asarray(local_zero_frac, np.float64)
                        * local_rows, [local_rows]]).astype(np.float32),
        name="efb_zero_frac", point="binning_allgather")
    tot = zf.sum(axis=0)
    mfz = tot[:-1] / max(tot[-1], 1) >= sparse_threshold
    samp = _stride_sample(local_bins, max(1, sample_rows // nproc))
    # transport dtype must hold every bin id: uint16 truncates silently
    # past 65535, so wide-bin features ride uint32 instead (num_bin is
    # plan input on every rank, so all ranks agree on the widening)
    transport = (np.uint32
                 if int(np.asarray(num_bin).max(initial=0))
                 > int(np.iinfo(np.uint16).max)
                 else np.uint16)
    sample_global = ragged_all_gather(np.ascontiguousarray(
        samp, dtype=transport), name="efb_bundle_exchange",
        point="binning_allgather")
    return find_bundles(sample_global, num_bin, mfz,
                        max_conflict_rate, max_bundle_bins,
                        sample_rows=sample_global.shape[0])


def apply_bundles(bins: np.ndarray, plan: BundlePlan) -> np.ndarray:
    """[n, F] feature bins -> [n, G] bundle columns."""
    n = bins.shape[0]
    out = np.zeros((n, plan.num_columns), dtype=np.int32)
    for gi, g in enumerate(plan.groups):
        if len(g) == 1:
            out[:, gi] = bins[:, g[0]]
            continue
        col = np.zeros(n, np.int32)
        for f in g:
            b = bins[:, f].astype(np.int32)
            nzr = b != 0
            # later members overwrite on (budgeted) conflict rows
            col[nzr] = b[nzr] + plan.bin_offset[f]
        out[:, gi] = col
    return out
