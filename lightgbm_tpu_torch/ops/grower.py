"""Leaf-wise tree growth in batched frontier rounds, on the device.

The port of the serial, dense, numerical branch of
`lightgbm_tpu/ops/grower.py:_build_grower`; its module docstring explains
the design.  In short: leaf assignment is an [n] int32 vector; each round
picks the top-K leaves by stored best gain, partitions all K leaves' rows
in one pass, histograms all K smaller children in one batched pass
(kernel B1 on the card), derives the siblings by subtraction from a
dense [L, F, B, 3] histogram pool, and searches the best split of all 2K
children at once.  Step records go into an [L-1, W] buffer that the host
replays into a `Tree` later.

The JAX grower is one `lax.while_loop`.  Here the rounds are a host loop
of launches on PyTorch's stream: every per-round value (leaf ids, pool,
stored splits, the split counter) stays in device tensors, and the host
waits on the device once per loop round, for the stop test.  The frontier
ramp's pre-rounds run unconditionally, as in the JAX grower, and need no
stop test.  `grow` returns the number of those waits, so callers can
count host syncs.

Every state vector carries one extra trailing slot (index L): the slot
updates of dead slots land there, where the JAX grower drops
out-of-bounds scatter indices.  Nothing reads it back.

The quantized precisions (int8/int16) follow the JAX grower's quantized
branch: grad/hess are rounded once per tree onto an integer grid (max-abs
scales, stochastic rounding seeded from the tree's threefry key), the
histograms, the pool and sibling subtraction stay exact int32, and the
split search runs int32 prefix sums before it dequantizes.  With
hist_impl="fused" each round's histograms, subtraction and split scan
are one call (kernel B2 on the card), whose per-feature records the
round reduces to each child's best split.  quant_refit recomputes the
final leaf outputs from the f32 grad/hess sums of each leaf's rows.

With packed_bins the matrix is 4-bit packed [F, n_pad/2] in row blocks
of the JAX grower's size (grower.py:585-591): the histograms read it
packed (B1's packed variant on the card), and the select-family
partitions unpack the columns they test (`unpack2d`), as the JAX grower
does (grower.py:1238-1241,1277-1278,1303-1304).

With feature_fraction_bynode < 1 every node's split search sees its own
Bernoulli draw of the tree's features (grower.py:616-623): the root's
from a split of the tree key, each round's 2K children's from the next
split, `jax.random.uniform` over the padded feature axis, computed on
the host (`utils.prng.uniform`) and queued to the device.  As in the JAX
grower, the per-node masks take the fused scan away ("fused" then runs
the B1 histogram and the torch split search every round) and the
frontier ramp with it.

With has_cat (categorical features, grower.py:475-545 of the JAX
package) every split search merges the numerical search, over the
numerical features, with the categorical one
(`split.per_feature_best_split_categorical`), over the categorical
features; a categorical winner carries its [B] mask of the bins routed
left, which the stored best splits, the partition (a row goes left where
its bin's mask entry is set) and the records (16 + B columns) carry on.
As in the JAX grower, categorical data takes the grower off B2's
in-launch scan and the int precisions off the int32 bin prefix sums: the
histograms are dequantized before the search.

With has_bundles (EFB, grower.py:625-660,1197-1206 of the JAX package)
bins_t holds G bundle columns, fewer than the F features: the
histograms, the pool and the sibling subtraction stay [.., G, B, 3], and
every split search first expands them to [.., F, B, 3]
(`expand_bundles`: one gather of each feature's bins out of its bundle
column, one mask, and each bundled feature's bin 0 rebuilt as the leaf
totals minus its other bins, summed in XLA's order).  The feature mask,
the per-node draws, the search and the records stay in feature space;
the partition reads a split feature's bundle column and maps it back to
the feature's bins (`fused.fix_bundle_col`).  Bundles take the grower
off B2's scan and the int32 prefix sums, as categorical data does, and
are refused with B3 (tpu_partition_impl=kernel) and with packed bins.

Monotone constraints (grower.py:1391-1402 of the JAX package): each leaf
carries bounds on its output, [-1e30, 1e30] at the root; a split on a
constrained feature puts the midpoint of its two outputs between the
children (the left child's max and the right child's min for +1, the
other way for -1), and every search clips the children's outputs to
their bounds and vetoes splits whose outputs break the feature's
direction.  The bounds are set before the histograms, since B2's scan
reads them in its ctx rows; the quantized refit clips to them too.
Without a constrained feature (params.has_mono false) no bounds are
kept: every leaf's would stay [-1e30, 1e30].

CEGB (grower.py:690-707,1482-1530): every search subtracts from each
candidate gain the split penalty times the leaf's rows, the coupled
penalty of the features no split has used yet and, with lazy penalties,
the lazy penalty times the leaf's rows that have not yet paid for the
feature.  The used [F] and paid [F, n_pad] state comes in through meta
and goes out with the tree (the learner keeps it across trees); each
round marks the applied splits' features used, lets their parents' rows
pay (one masked scatter), and re-credits the coupled penalty to the
stored best splits of the other leaves on a feature just used.  CEGB
leaves B2's scan.

Forced splits (grower.py:1624-1717): before the best-gain rounds, each
(parent leaf, feature, threshold bin) of params.forced splits as a round
of its own, K wide with slot 0 alone live, its left sums read off the
pool at the threshold; a split whose gain is negative, or with an empty
side, stops it and every later one.  No frontier ramp, no B2.

deterministic=true ("f64"): f64 stats, histograms (`histogram.
hist_batched_f64`, torch ops in one fixed order, no kernel), pool and
candidate math, cast to f32 once in `split.finalize_split`; the leaf
totals are summed in f64 and kept f32, as in the JAX grower.

With has_sparse (tpu_sparse_threshold, grower.py:1002-1074,1254-1321 of
the JAX package) bins_t holds only the dense features' columns, and the
sparse features' (row, bin) entries ride meta: each round's histograms
are the dense columns' (B1 on the card) and the entries' (torch ops:
`sparse_histograms`, summed in a fixed order under f64), merged into
feature order (`merged_histograms`), so the pool, the sibling
subtraction and the records stay in feature space.  The sparse
features' zero bins are missing there until every search rebuilds them
from a dense feature's totals (`expand_sparse`); the partition rebuilds
each sparse split feature's column from its entries.  Float precisions
only, no bundles, no packing, a select-family partition.

Under a sharded learner (data_axis / feature_axis / voting_k,
grower.py:294-470,713-925 of the JAX package) every shard runs this
function in its own thread (`parallel/strategies.py`) and the
collectives of `parallel/topology.py` join them: the histograms
aggregate over the row axes (psum, or a reduce-scatter to column slices
with a best-split sync; voting aggregates only its voted features), a
feature axis syncs each shard's best split, and the leaf totals, the
quantization scales and the refit's sums reduce over the row axes.  No
B2 there, as in the JAX grower.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils.prng import fold_in, split, uniform
from .fused import (CTX_COUNT, CTX_MAX_C, CTX_MIN_C, CTX_SUM_G, CTX_SUM_H,
                    CTX_USE_SMALL, CTX_WIDTH, fix_bundle_col, fused_hist_scan,
                    partition_rows, partition_rows_plain)
from .histogram import (INT_PRECISIONS, _unpack_hist,
                        build_histogram_batched_t, key_words, pack_stats,
                        quant_limit, quantize_values, unpack2d)
from .leafsum import leaf_sums
from .predict import upload
from .split import (K_MIN_SCORE, MISSING_NAN, MISSING_ZERO, SplitResult,
                    argbest, finalize_split, leaf_output, leaf_split_gain,
                    numeric_go_left, per_feature_best_split,
                    per_feature_best_split_categorical, reduce_sum,
                    unpack_pf_records)

# record-row field indices (lightgbm_tpu/ops/grower.py REC_*); rows are 16
# wide, plus a trailing [B] categorical bin mask when has_cat
REC_LEAF, REC_FEATURE, REC_THRESHOLD, REC_DEFAULT_LEFT, REC_GAIN, \
    REC_LEFT_OUTPUT, REC_RIGHT_OUTPUT, REC_LEFT_COUNT, REC_RIGHT_COUNT, \
    REC_LEFT_WEIGHT, REC_RIGHT_WEIGHT, REC_INTERNAL_VALUE, \
    REC_INTERNAL_WEIGHT, REC_INTERNAL_COUNT, REC_DID_SPLIT, \
    REC_IS_CAT = range(16)
REC_WIDTH = 16  # the categorical mask starts here

PARTITION_IMPLS = ("select", "vselect", "kernel")


class GrowerParams(NamedTuple):
    """Grower configuration (the serial dense subset of the JAX
    package's GrowerParams)."""
    num_leaves: int
    num_bins: int          # bin-axis size B
    precision: str
    l1: float
    l2: float
    max_delta_step: float
    min_data_in_leaf: float
    min_sum_hessian: float
    min_gain_to_split: float
    max_depth: int
    # categorical split search (feature_histogram.hpp:118-279); has_cat
    # leaves the whole categorical path out for numerical data
    has_cat: bool = False
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    # leaves split per round; 1 = strict reference best-first order
    split_batch: int = 16
    # batch only leaves whose gain >= alpha * the round's best gain
    split_batch_alpha: float = 0.0
    # "select" (K scalar passes), "vselect" (one [K, n] block, plain
    # torch) or "kernel" (kernel B3 on the card)
    partition_impl: str = "select"
    # frontier ramp: pre-rounds at K' = 1, s, s^2, ... < K before the
    # full-K loop; bit-identical trees, less dead-slot work
    ramp: bool = False
    ramp_step: int = 2
    # batched histogram: "pallas" (kernel B4 on the card), "fused" (the
    # grow megakernel B2 for int8/int16; the perfeature histogram
    # otherwise), anything else the perfeature kernel B1
    hist_impl: str = "pallas2"
    # bins stored 4-bit packed two rows a byte, in row blocks of
    # min(block_rows, n_pad) rows (the learner's layout)
    packed_bins: bool = False
    block_rows: int = 8192
    # int8/int16 only: grad/hess rounding ("stochastic" or "nearest"),
    # and the leaf refit from the f32 sums
    quant_round: str = "stochastic"
    quant_refit: bool = False
    # per-node feature sampling: each node's split search sees a
    # Bernoulli(fraction) subset of the tree's features, drawn over the
    # first `bynode_width` features (0: the whole padded axis)
    feature_fraction_bynode: float = 1.0
    bynode_width: int = 0
    # EFB: bins_t holds bundle columns; meta carries each feature's
    # bundle_idx / bin_offset / needs_fix, and every search expands the
    # bundle histograms back to features
    has_bundles: bool = False
    # CEGB (reference cost_effective_gradient_boosting.hpp): every search
    # charges each feature's gain the split penalty times the leaf's
    # rows, the coupled penalty of a feature no tree has used yet
    # (meta cegb_coupled, state meta cegb_used [F]) and, with lazy
    # penalties, the per-row cost of the leaf's rows that have not paid
    # for the feature (meta cegb_lazy, state meta cegb_paid [F, n_pad])
    has_cegb: bool = False
    has_cegb_lazy: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    # forced splits (reference ForceSplits, serial_tree_learner.cpp:
    # 607-769): BFS-ordered (parent_leaf, feature, threshold bin) triples
    # run as rounds of their own before the best-gain rounds
    forced: tuple = ()
    # some feature has a monotone constraint (meta monotone != 0); without
    # one every leaf's bounds stay [-1e30, 1e30], so none are tracked
    has_mono: bool = False
    # sparse train-time storage (tpu_sparse_threshold): bins_t holds the
    # dense features' columns only; the sparse features' (row, bin)
    # entries ride meta (sp_rows, sp_key, sp_off, hist_perm and the
    # per-feature is_sparse/sparse_slot/dense_col/dense_ref); the
    # longest feature's entry count is the partition's gather window
    has_sparse: bool = False
    sparse_window: int = 0
    # the sharded learners' histogram aggregation over the row axes:
    # "psum" (every shard the whole aggregate) or "scatter" (each shard
    # its contiguous 1/P column slice, then a best-split sync)
    hist_agg: str = "psum"


def resolve_split_batch(split_batch: int, num_leaves: int) -> int:
    """Auto-pick the per-round split batch K (lightgbm_tpu's rule: small
    trees stay nearly sequential, wide trees use K=25)."""
    if split_batch > 0:
        return split_batch
    return max(1, num_leaves // 16) if num_leaves < 192 else 25


def pad_rows(n: int, block_rows: int) -> int:
    """Rows padded up to a whole number of histogram blocks."""
    block = min(block_rows, max(n, 1))
    return ((n + block - 1) // block) * block


def _top_k(x: torch.Tensor, k: int):
    """`lax.top_k`: the k largest values, descending, ties by lower
    index first (a stable descending sort keeps that order)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)


def expand_bundles(hist_g: torch.Tensor, sg: torch.Tensor, sh: torch.Tensor,
                   cnt: torch.Tensor, meta: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
    """[C, G, B, 3] f32 bundle-column histograms -> [C, F, B, 3] feature
    histograms (grower.py:625-660 of the JAX package, vmapped over the C
    leaves there); sg/sh/cnt: [C] leaf totals.

    Each bundled feature's bins live at bin_offset+1..+num_bin-1 of its
    bundle column; its bin 0 (the shared all-default bin) is the leaf
    totals minus its other bins, the FixHistogram identity (reference
    src/io/dataset.cpp:1044-1063), with the bins summed in XLA's order
    (`split.reduce_sum`).  Unbundled features take their column whole."""
    G, B = hist_g.shape[1], hist_g.shape[2]
    bi = meta["bundle_idx"].clamp(0, G - 1).long()              # [F]
    fix = meta["needs_fix"] > 0                                 # [F]
    iota_b = torch.arange(B, dtype=torch.int32, device=hist_g.device)
    src = (meta["bin_offset"][:, None] + iota_b).clamp(0, B - 1).long()
    hist_f = hist_g[:, bi[:, None], src]                        # [C, F, B, 3]
    in_range = (iota_b >= 1) & (iota_b < meta["num_bin"][:, None])
    keep = in_range | ~fix[:, None]
    hist_f = torch.where(keep[None, :, :, None], hist_f, 0.0)
    totals = torch.stack([sg, sh, cnt], dim=-1)                 # [C, 3]
    bin0 = totals[:, None, :] - reduce_sum(hist_f, 2)           # [C, F, 3]
    hist_f[:, :, 0] = torch.where(fix[None, :, None], bin0, hist_f[:, :, 0])
    return hist_f


def expand_sparse(hist: torch.Tensor, meta: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """[C, F, B, 3] feature histograms whose sparse features lack their
    zero bin (the rows no entry stores) -> the full histograms
    (grower.py:661-687 of the JAX package, vmapped over the C leaves
    there): each sparse feature's default bin becomes the leaf's totals
    minus its other bins, the FixHistogram identity (reference
    src/io/dataset.cpp:1044-1063).  The totals are a dense feature's
    (dense_ref) bins summed, in the histogram's own dtype, so that f64
    sparse storage gives the dense histograms' bits; sums in XLA's
    order (`split.reduce_sum`)."""
    B = hist.shape[2]
    totals = reduce_sum(hist[:, meta["dense_ref"][0].long()], 1)  # [C, 3]
    iota_b = torch.arange(B, dtype=torch.int32, device=hist.device)
    at_db = ((meta["is_sparse"] > 0)[:, None]
             & (iota_b[None, :] == meta["default_bin"][:, None]))   # [F, B]
    at_db = at_db[None, :, :, None]
    zeroed = torch.where(at_db, 0.0, hist)
    bin0 = totals[:, None, :] - reduce_sum(zeroed, 2)              # [C, F, 3]
    return torch.where(at_db, bin0[:, :, None, :], zeroed)


def sparse_histograms(meta: Dict[str, torch.Tensor], sp_stats: torch.Tensor,
                      leaf_ids: torch.Tensor, slot_leaf_ids: torch.Tensor,
                      num_bins: int, num_leaves: int, precision: str
                      ) -> torch.Tensor:
    """[K, Gs, B, 3] histograms of the sparse features' stored entries
    (the JAX package's `build_histogram_sparse`, histogram.py:340, an XLA
    program there, torch ops here): each entry's leaf is read at its row,
    and its row's stats (`sp_stats` [E, S], gathered once a tree) are
    added at (slot, feature, bin); entries of rows in no slot go to a
    trash slot.  The rows no entry stores are missing: `expand_sparse`
    puts them back."""
    K = slot_leaf_ids.shape[0]
    Gs = meta["sp_off"].shape[0] - 1
    B = int(num_bins)
    dev = leaf_ids.device
    # leaf id -> slot (K: none), the dead slots written past the leaves
    table = torch.full((num_leaves + 1,), K, dtype=torch.int64, device=dev)
    live = slot_leaf_ids >= 0
    table[torch.where(live, slot_leaf_ids, table.shape[0] - 1).long()] = \
        torch.arange(K, device=dev)
    k_e = table[leaf_ids[meta["sp_rows"].long()].long()]          # [E]
    flat = k_e * (Gs * B) + meta["sp_key"].long()
    size = (K + 1) * Gs * B
    if precision == "f64":
        raw = fixed_order_index_sum(flat, sp_stats, size)
    else:
        raw = torch.zeros((size, sp_stats.shape[1]), dtype=sp_stats.dtype,
                          device=dev)
        raw.index_add_(0, flat, sp_stats)
    raw = raw[:K * Gs * B].view(K, Gs, B, -1)
    return _unpack_hist(raw.permute(3, 0, 1, 2), precision)


def fixed_order_index_sum(index: torch.Tensor, values: torch.Tensor,
                          size: int) -> torch.Tensor:
    """[size, S]: the rows of values [E, S] summed at index [E] in one
    fixed order on every device, for the f64 histograms of
    deterministic=true (`index_add_` adds through atomics on CUDA, in
    arrival order; `hist_batched_f64` keeps the dense columns' order
    fixed the same way).  The entries are sorted stably by index, then
    each run of equal indices is summed by a segmented scan of log2(E)
    elementwise steps: at step d an entry adds the partial sum d places
    back when that entry has its index.  The last entry of each run then
    holds the run's sum."""
    key, order = torch.sort(index, stable=True)
    v = values[order]
    E = key.shape[0]
    d = 1
    while d < E:
        same = (key[d:] == key[:-d])[:, None]
        v = torch.cat([v[:d], v[d:] + torch.where(same, v[:-d], 0.0)])
        d *= 2
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    out = torch.zeros((size + 1, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    # every entry but a run's last writes to the trash row `size`
    out[torch.where(last, key, size)] = v
    return out[:size]


def merged_histograms(dense_hist: torch.Tensor, meta: Dict[str, torch.Tensor],
                      sp_stats: torch.Tensor, leaf_ids: torch.Tensor,
                      slot_leaf_ids: torch.Tensor, num_bins: int,
                      num_leaves: int, precision: str) -> torch.Tensor:
    """[K, F, B, 3]: the dense columns' histograms [K, G, B, 3] and the
    sparse features' (`sparse_histograms`) merged into feature order
    (grower.py:1038-1056 of the JAX package); the sparse features' zero
    bins are still missing (`expand_sparse`)."""
    sp = sparse_histograms(meta, sp_stats, leaf_ids, slot_leaf_ids,
                           num_bins, num_leaves, precision)
    return torch.cat([dense_hist, sp], dim=1)[:, meta["hist_perm"]]


def check_params(params: GrowerParams) -> None:
    """The JAX grower's refusals of parameter combinations
    (grower.py:359-421 of the JAX package, on the serial learner), which
    the learner also makes at set-up."""
    quantized = params.precision in INT_PRECISIONS
    if params.has_bundles and params.forced:
        # grower.py:363-365
        raise ValueError("EFB bundling does not compose with forced splits; "
                         "set enable_bundle=false")
    if params.packed_bins and (
            params.has_bundles
            or params.partition_impl not in ("select", "vselect")
            or not params.hist_impl.startswith("pallas")):
        # grower.py:366-372
        raise ValueError(
            "packed 4-bit bins require the pallas histogram impl, a "
            "select-family partition lowering, and no EFB bundling")
    if params.has_sparse and (
            params.has_bundles or params.packed_bins
            or params.partition_impl not in ("select", "vselect")):
        # grower.py:373-382
        raise ValueError(
            "sparse train-time storage (tpu_sparse_threshold) requires "
            "tree_learner=serial/data/voting, a select-family partition "
            "lowering, and no EFB bundling / 4-bit packing")
    if params.partition_impl == "kernel" and (
            params.has_cat or params.has_bundles or params.has_sparse):
        # grower.py:384-390
        raise ValueError(
            "tpu_partition_impl=kernel (the pallas row-partition) covers "
            "plain dense numerical columns only — categorical splits, EFB "
            "bundles, sparse storage, and 4-bit packing keep the "
            "select-family lowerings")
    if quantized and params.forced:
        # grower.py:397-399
        raise ValueError("quantized histogram precisions do not compose "
                         "with forced splits")
    if quantized and params.has_sparse:
        # grower.py:400-403
        raise ValueError(
            "quantized histogram precisions do not compose with "
            "sparse train-time storage (tpu_sparse_threshold)")
    if quantized and params.quant_round not in ("stochastic", "nearest"):
        raise ValueError(f"tpu_quant_round={params.quant_round!r}; expected "
                         "stochastic or nearest")
    if params.precision == "f64" and params.forced:
        # the JAX grower's forced round writes its f64 sums into the f32
        # records and fails there with this exception type
        raise TypeError("forced splits do not compose with deterministic="
                        "true (f64 histograms): the forced round's sums "
                        "are f64 and the split records f32")
    if params.partition_impl not in PARTITION_IMPLS:
        raise NotImplementedError(
            f"tpu_partition_impl={params.partition_impl!r} is not ported "
            f"to lightgbm_tpu_torch yet (ported: {PARTITION_IMPLS})")
    if params.ramp_step < 2:
        raise ValueError(f"ramp_step={params.ramp_step}; the frontier "
                         "bound needs a growth factor >= 2")


def check_sharded(params: GrowerParams, data_axis, feature_axis,
                  voting_k: int) -> None:
    """The sharded grower's refusals (grower.py:353-362,423-433 of the
    JAX package), and what this port's sharded grower does not carry."""
    if voting_k and not data_axis:
        raise ValueError("voting requires a data axis")
    if voting_k and feature_axis:
        raise ValueError("voting does not compose with a feature axis")
    if params.hist_agg not in ("psum", "scatter"):
        raise ValueError(f"hist_agg={params.hist_agg!r}; expected psum or "
                         "scatter (the learner resolves 'auto' upstream)")
    off = [name for name, on in (
        ("sparse COO storage", params.has_sparse),
        ("categorical features", params.has_cat),
        ("CEGB", params.has_cegb), ("forced splits", bool(params.forced)),
        ("monotone constraints", params.has_mono),
        ("feature_fraction_bynode", params.feature_fraction_bynode < 1.0),
        ("deterministic=true", params.precision == "f64")) if on]
    if off:
        raise NotImplementedError(
            f"{off[0]} under a sharded tree learner is not ported to "
            "lightgbm_tpu_torch yet (ROADMAP A9c)")


def grow(params: GrowerParams, bins_t: Optional[torch.Tensor],
         grad: torch.Tensor, hess: torch.Tensor, row_mask: torch.Tensor,
         feature_mask: torch.Tensor, meta: Dict[str, torch.Tensor],
         key: Optional[np.ndarray] = None,
         stream=None, data_axis=None, feature_axis=None, voting_k: int = 0,
         num_shards: int = 1, hist_bins: Optional[torch.Tensor] = None
         ) -> Dict[str, torch.Tensor]:
    """Grow one tree.

    bins_t: [G, n_pad] uint8, or int32 when a feature has more than 256
    bins (padding rows and columns hold bin 0), or [G, n_pad/2] packed
    with params.packed_bins; its G columns are the F features, EFB
    bundle columns under params.has_bundles, or the dense features'
    columns under params.has_sparse;
    grad/hess/row_mask: [n_pad] f32 (padding rows zero); feature_mask:
    [F] f32; meta: per-feature int32 num_bin/missing_type/default_bin/
    monotone and f32 penalty (and is_categorical under has_cat, and
    bundle_idx/bin_offset/needs_fix under has_bundles); key: the
    tree's threefry key (uint32[2], `utils.prng`), which seeds the
    stochastic rounding of int8/int16.  Under params.has_cegb meta also
    carries cegb_coupled/cegb_lazy [F] f32 and the state cegb_used [F]
    f32 (and cegb_paid [F, n_pad] bool with lazy penalties, updated in
    place).

    Returns records [L-1, 16] ([L-1, 16 + B] under has_cat, the bins
    routed left by each categorical split), leaf_ids [n_pad], leaf_output [L],
    leaf_cnt [L], leaf_sum_h [L] (device tensors), syncs (int) and, under
    CEGB, the state for the next tree: cegb_used (and cegb_paid).

    stream: the streamed layout's block loop (`ops/stream.py:
    StreamGrower`), with bins_t None: the rows' bins live in host blocks,
    and each histogram pass streams them, partitioning every block's
    rows for the round's splits before its histogram (the JAX package's
    `block_step`); the rest of every round is the code below.  No ramp
    and no B2 scan there, as in the JAX package's streamed programs.

    data_axis / feature_axis / voting_k / num_shards: one shard of a
    sharded learner (grower.py:294-470 of the JAX package), run in a
    shard thread of `parallel/strategies.py`, whose collectives
    (`parallel/topology.py`) address these axes.  Under `data_axis` the
    shard's rows are its row shard (grad etc. [n_pad local]); the
    histograms aggregate over the row axes by psum, or under
    params.hist_agg="scatter" by reduce-scatter to this shard's G/P
    column slice, searched and then synced as one best-split record;
    the leaf totals and the refit's sums are psummed; the quantization
    scales are the row axes' max, and the stochastic rounding keys on
    the global row.  Voting (`voting_k`) keeps the pool local, votes the
    top 2k features of each leaf with the local thresholds at 1/P, and
    aggregates only the k voted features' histograms (reduce-scattered
    under scatter).  Under `feature_axis` the bins are every row's and
    every feature's: the shard histograms its F/P feature slice
    (`hist_bins`, its own tensor, else sliced from bins_t), partitions
    from the full matrix, and syncs its best split over the feature
    axis.  The meta arrays and the feature mask stay global.  No B2."""
    quantized = params.precision in INT_PRECISIONS
    check_params(params)
    sharded = data_axis is not None or feature_axis is not None
    if sharded:
        check_sharded(params, data_axis, feature_axis, voting_k)
        from ..parallel.topology import (axis_best_split_sync, axis_index,
                                         axis_pmax, axis_psum,
                                         axis_psum_scatter, axis_size)
    if quantized and key is None:
        raise ValueError("the quantized precisions need the tree's key")
    dev = grad.device
    L = params.num_leaves
    B = params.num_bins
    FG = feature_mask.shape[0]
    meta_l, fmask_l, f_lo, bins_h = meta, feature_mask, 0, bins_t
    if feature_axis:
        # this shard's feature slice [f_lo, f_lo + F) of the global axis
        F = FG // axis_size(feature_axis)
        f_lo = axis_index(feature_axis) * F
        meta_l = {k: (v[f_lo:f_lo + F]
                      if v.dim() == 1 and v.shape[0] == FG else v)
                  for k, v in meta.items()}
        fmask_l = feature_mask[f_lo:f_lo + F]
        bins_h = hist_bins if hist_bins is not None \
            else bins_t[f_lo:f_lo + F].contiguous()
    # the column axis of the pool: the bins' columns, or with sparse
    # storage the features (dense columns and sparse entries merged); the
    # features are feature_mask's axis
    G = (meta["hist_perm"].shape[0] if params.has_sparse
         else stream.num_columns if stream is not None
         else bins_h.shape[0])
    # scatter aggregation (grower.py:436-452): the pool holds this shard's
    # contiguous column slice [dax * SG, (dax + 1) * SG); voting keeps its
    # pool local and scatters only the voted block
    scatter_on = (params.hist_agg == "scatter" and data_axis is not None
                  and num_shards > 1)
    pool_scatter = scatter_on and not voting_k
    vote_scatter = scatter_on and bool(voting_k)
    if pool_scatter and G % num_shards != 0:
        raise ValueError(
            f"hist_agg=scatter needs the histogram column count {G} padded "
            f"to a multiple of the data-shard count {num_shards}")
    SG = G // num_shards if pool_scatter else G
    dax = axis_index(data_axis) if scatter_on else 0

    def preduce(x):
        """A sum of the shard's rows, reduced over the row axes."""
        return axis_psum(x, data_axis) if data_axis else x

    def agg_hist(x):
        """Local [.., G, B, 3] histograms aggregated over the row axes
        (grower.py:454-466): psum, or the reduce-scatter to this shard's
        column slice; voting's stay local."""
        if not data_axis or voting_k:
            return x
        if pool_scatter:
            return axis_psum_scatter(x, data_axis, x.dim() - 3)
        return axis_psum(x, data_axis)
    # rows come from grad, not bins_t: packed bins hold two rows a byte
    n_pad = grad.shape[0]
    block = min(params.block_rows, n_pad)
    block = n_pad // max(n_pad // block, 1)
    pblock = block if params.packed_bins else 0
    K = max(1, min(int(params.split_batch), L - 1))
    f32, i32 = torch.float32, torch.int32
    split_kw = dict(l1=params.l1, l2=params.l2,
                    max_delta_step=params.max_delta_step,
                    min_data_in_leaf=params.min_data_in_leaf,
                    min_sum_hessian=params.min_sum_hessian,
                    min_gain_to_split=params.min_gain_to_split)
    out_kw = dict(l1=params.l1, l2=params.l2,
                  max_delta_step=params.max_delta_step)
    # voting's local search: min data and hessian at 1/P of the global
    # thresholds (voting_parallel_tree_learner.cpp:58-59)
    local_kw = dict(split_kw)
    if voting_k:
        local_kw["min_data_in_leaf"] = params.min_data_in_leaf / num_shards
        local_kw["min_sum_hessian"] = params.min_sum_hessian / num_shards

    # per-node feature masks reshape the split search, so the megakernel's
    # in-launch scan (one mask for every child) is left, as the JAX
    # grower leaves it (grower.py:557-562): "fused" then rides B1
    bynode = params.feature_fraction_bynode < 1.0
    if bynode and key is None:
        raise ValueError("feature_fraction_bynode needs the tree's key")
    # categorical data, bundles, CEGB and forced splits reshape the search
    # too (grower.py:553-563)
    fused_scan = (params.hist_impl == "fused" and quantized and not bynode
                  and not params.has_cat and not params.has_bundles
                  and not params.has_cegb and not params.forced
                  and stream is None and not sharded)
    # the int32 bin prefix sums serve the plain numerical search alone:
    # with categorical features or bundles the histograms rescale to f32
    # first (grower.py:845-848)
    int_scan = quantized and not params.has_cat and not params.has_bundles
    qscale = None
    FG = feature_mask.shape[0]
    FW = params.bynode_width or FG
    if FW > FG:
        raise ValueError(f"bynode_width {FW} exceeds the feature axis {FG}")
    frac_node = np.float32(params.feature_fraction_bynode)

    def bynode_masks(k, shape_prefix):
        """Per-node feature masks (grower.py:616-623): Bernoulli(fraction)
        over the tree's mask from `jax.random.uniform` of the feature
        axis the JAX learner pads to (`bynode_width`), the tree's mask
        where a draw is empty.  The draw is
        made on the host from the key and queued to the device; the rest
        stays there."""
        draw = np.zeros(shape_prefix + (FG,), np.float32)
        draw[..., :FW] = uniform(k, shape_prefix + (FW,)) < frac_node
        samp = upload(draw, dev) * (feature_mask > 0)
        nonempty = samp.sum(dim=-1, keepdim=True) > 0
        return torch.where(nonempty, samp, feature_mask)

    def best_of(pf, sg, sh, min_c, max_c):
        """Each child's best feature (the lowest index among equal gains)
        and its finalized split (no categorical flag or mask)."""
        bf = torch.argmax(pf.gain, dim=-1).to(i32)
        return finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                              max_constraint=max_c, **out_kw), None, None

    def apply_delta(gain, delta):
        """The CEGB charge on the valid candidates' gains
        (grower.py:709-711)."""
        if delta is None:
            return gain
        return torch.where(gain > K_MIN_SCORE / 2, gain - delta, gain)

    def cegb_delta(used, cnt, unpaid=None):
        """[M, F] CEGB charges (DetlaGain, cost_effective_gradient_boosting
        .hpp:50-62; grower.py:696-707): the split penalty times each
        leaf's rows, the coupled penalty of the features not used yet,
        and the lazy penalty times each leaf's rows that have not paid
        for the feature; all times the tradeoff."""
        d = (split_pen * cnt[:, None]
             + meta["cegb_coupled"][None, :] * (1.0 - used)[None, :])
        if unpaid is not None:
            d = d + meta["cegb_lazy"][None, :] * unpaid
        return tradeoff * d

    def select(hist, sg, sh, cnt, min_c, max_c, fmask, delta=None):
        """Best split of each leaf of the batch: hist [C, G, B, 3] (int32
        sums under the quantized precisions, rescaled after the bin
        prefix sums, or before the search with categorical features or
        bundles, whose columns are expanded to the features first);
        min_c/max_c: the leaves' monotone bounds, [C] (or scalars);
        fmask [F], or [C, F] (one mask a leaf); delta: the CEGB charges,
        [C, F] (or [F]), or None.  Returns (SplitResult, is_cat [C]
        bool, cat_mask [C, B] f32), the last two None without
        categorical features."""
        if quantized and not int_scan:
            hist = hist.to(f32) * qscale
        if params.has_bundles:
            hist = expand_bundles(hist, sg, sh, cnt, meta)
        if params.has_sparse:
            hist = expand_sparse(hist, meta)
        if not params.has_cat:
            pf = per_feature_best_split(
                hist, sg, sh, cnt, meta["num_bin"], meta["missing_type"],
                meta["default_bin"], meta["monotone"], meta["penalty"],
                fmask, min_constraint=min_c, max_constraint=max_c,
                acc_scale=qscale if int_scan else None, **split_kw)
            return best_of(pf._replace(gain=apply_delta(pf.gain, delta)),
                           sg, sh, min_c, max_c)
        # the merged search (grower.py:509-543): numerical features
        # through the numerical search, categorical ones through theirs
        catf = meta["is_categorical"].to(f32)
        pf = per_feature_best_split(
            hist, sg, sh, cnt, meta["num_bin"], meta["missing_type"],
            meta["default_bin"], meta["monotone"], meta["penalty"],
            fmask * (1.0 - catf), min_constraint=min_c,
            max_constraint=max_c, **split_kw)
        pfc = per_feature_best_split_categorical(
            hist, sg, sh, cnt, meta["num_bin"], meta["missing_type"],
            meta["penalty"], fmask * catf, cat_l2=params.cat_l2,
            cat_smooth=params.cat_smooth,
            max_cat_threshold=params.max_cat_threshold,
            max_cat_to_onehot=params.max_cat_to_onehot,
            min_data_per_group=params.min_data_per_group,
            min_constraint=min_c, max_constraint=max_c, **split_kw)
        is_cat = meta["is_categorical"] > 0
        gain = apply_delta(torch.where(is_cat, pfc.gain, pf.gain), delta)
        bf = torch.argmax(gain, dim=-1).to(i32)
        resn = finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                              max_constraint=max_c, **out_kw)
        c = is_cat[bf.long()]

        def pick(a):
            return torch.gather(a, -1, bf[..., None].long())[..., 0]

        res = SplitResult(
            gain=pick(gain), feature=bf,
            threshold=torch.where(c, 0, resn.threshold).to(i32),
            default_left=resn.default_left & ~c,
            left_sum_g=torch.where(c, pick(pfc.left_sum_g), resn.left_sum_g),
            left_sum_h=torch.where(c, pick(pfc.left_sum_h), resn.left_sum_h),
            left_count=torch.where(c, pick(pfc.left_count),
                                   resn.left_count),
            left_output=torch.where(c, pick(pfc.left_output),
                                    resn.left_output),
            right_output=torch.where(c, pick(pfc.right_output),
                                     resn.right_output))
        mask = torch.gather(pfc.cat_mask, -2, bf.long()[..., None, None]
                            .expand(*bf.shape, 1, B))[..., 0, :]
        return res, c, mask * c[..., None].to(f32)

    def dequant(hh):
        return hh.to(f32) * qscale if quantized else hh

    def sync_best(res: SplitResult, gfeat, axis) -> SplitResult:
        """The global best of the shards' best splits along `axis`, one
        record a leaf (grower.py:713-743): `gfeat` is each leaf's winning
        feature in the frame common to the axis, and becomes the
        feature."""
        payload = dict(default_left=res.default_left.to(i32),
                       left_sum_g=res.left_sum_g, left_sum_h=res.left_sum_h,
                       left_count=res.left_count,
                       left_output=res.left_output,
                       right_output=res.right_output)
        gain, feat, thr, w = axis_best_split_sync(
            axis, res.gain, gfeat.to(i32), res.threshold, payload)
        return SplitResult(
            gain=gain, feature=feat, threshold=thr.to(i32),
            default_left=w["default_left"] > 0, left_sum_g=w["left_sum_g"],
            left_sum_h=w["left_sum_h"], left_count=w["left_count"],
            left_output=w["left_output"], right_output=w["right_output"])

    def pf_search(hist, sg, sh, cnt, fmeta, fmask, min_c, max_c, kw,
                  acc=None):
        return per_feature_best_split(
            hist, sg, sh, cnt, fmeta["num_bin"], fmeta["missing_type"],
            fmeta["default_bin"], fmeta["monotone"], fmeta["penalty"],
            fmask, min_constraint=min_c, max_constraint=max_c,
            acc_scale=acc, **kw)

    def per_feature(fmeta, idx):
        """The per-feature meta arrays at feature indices idx."""
        return {k: fmeta[k][idx] for k in ("num_bin", "missing_type",
                                           "default_bin", "monotone",
                                           "penalty")}

    def vote(hist, sg, sh, cnt, min_c, max_c):
        """Voting's search of C leaves (grower.py:757-840): hist [C, F,
        B, 3] is each leaf's LOCAL histogram.  The local search (min data
        and hessian at 1/P) votes each leaf's top 2k features, weighted
        by gain; the psummed votes pick the k features whose histograms
        alone are aggregated (reduce-scattered under scatter) and
        searched against the global totals; the lowest global feature
        id wins a tie."""
        C, F = hist.shape[0], hist.shape[1]
        # each leaf's local totals from feature 0's bins (every row lands
        # in one bin of every feature): exact int32, or in XLA's order
        loc = dequant(hist[:, 0].sum(1) if quantized
                      else reduce_sum(hist[:, 0], 1))          # [C, 3]
        gain_loc = pf_search(dequant(hist), loc[:, 0], loc[:, 1],
                             loc[:, 2], meta_l, fmask_l, min_c, max_c,
                             local_kw).gain                    # [C, F]
        order = torch.sort(gain_loc, dim=-1, descending=True, stable=True)
        k2 = min(2 * voting_k, F)
        vals, idx = order.values[:, :k2], order.indices[:, :k2]
        contrib = torch.zeros((C, F), dtype=f32, device=dev)
        contrib.scatter_add_(1, idx, torch.where(vals > K_MIN_SCORE / 2,
                                                 vals, 0.0))
        score = axis_psum(contrib, data_axis)
        kk = min(voting_k, F)
        sel = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[:, :kk]            # [C, kk]
        gat = sel[:, :, None, None].expand(C, kk, *hist.shape[2:])
        if vote_scatter:
            # the voted set padded to a shard multiple with copies of its
            # first feature, masked off: each shard receives kp/P of the
            # aggregated block
            kp = -(-kk // num_shards) * num_shards
            sel_p = torch.cat([sel, sel[:, :1].expand(C, kp - kk)], 1)
            vmask = (torch.arange(kp, device=dev) < kk).to(f32)
            gat = sel_p[:, :, None, None].expand(C, kp, *hist.shape[2:])
            sel_hist = axis_psum_scatter(torch.gather(hist, 1, gat),
                                         data_axis, 1)
            W = kp // num_shards
            sel_loc = sel_p[:, dax * W:(dax + 1) * W]
            fmask_sel = fmask_l[sel_loc] * vmask[dax * W:(dax + 1) * W]
        else:
            sel_loc = sel
            sel_hist = axis_psum(torch.gather(hist, 1, gat), data_axis)
            fmask_sel = fmask_l[sel]
        pf = pf_search(dequant(sel_hist), sg, sh, cnt,
                       per_feature(meta_l, sel_loc), fmask_sel, min_c,
                       max_c, split_kw)
        bi = argbest(pf.gain, sel_loc)
        res = finalize_split(pf, bi, sg, sh, min_constraint=min_c,
                             max_constraint=max_c, **out_kw)
        feat = torch.gather(sel_loc, 1, bi[:, None].long())[:, 0]
        res = res._replace(feature=feat.to(i32))
        if vote_scatter:
            res = sync_best(res, feat, data_axis)
        return res

    def select_sharded(hist, sg, sh, cnt, min_c, max_c, *_):
        """A sharded learner's search of C leaves (grower.py:745-925):
        hist [C, SG, B, 3] is the aggregated histogram (this shard's
        column slice under scatter, its feature slice under a feature
        axis; each shard's local one under voting).  Returns
        (SplitResult with global feature ids, None, None)."""
        if voting_k:
            return vote(hist, sg, sh, cnt, min_c, max_c), None, None
        if params.has_bundles:
            return bundle_search(hist, sg, sh, cnt, min_c, max_c), None, None
        acc = qscale if quantized else None
        if pool_scatter:
            # the features of this shard's column slice, against the
            # global leaf totals; the winner synced over the row axes
            SF = SG
            s0 = dax * SF
            pf = pf_search(hist, sg, sh, cnt,
                           per_feature(meta_l, slice(s0, s0 + SF)),
                           fmask_l[s0:s0 + SF], min_c, max_c, split_kw, acc)
            bf = torch.argmax(pf.gain, dim=-1).to(i32)
            res = finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                                 max_constraint=max_c, **out_kw)
            res = sync_best(res, s0 + bf, data_axis)
        else:
            pf = pf_search(hist, sg, sh, cnt, meta_l, fmask_l, min_c, max_c,
                           split_kw, acc)
            bf = torch.argmax(pf.gain, dim=-1).to(i32)
            res = finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                                 max_constraint=max_c, **out_kw)
        if feature_axis:
            # contiguous feature slices keep f_lo + local ids ascending,
            # so the tie-break is the serial lowest-feature rule
            res = sync_best(res, f_lo + res.feature, feature_axis)
        return res, None, None

    def bundle_search(hist, sg, sh, cnt, min_c, max_c):
        """EFB under data (grower.py:845-925): the bundle columns are
        rescaled to f32 and expanded to the features bundled into them
        (FixHistogram against the global leaf totals) before the search;
        under scatter this shard's column slice [dax*SG, (dax+1)*SG) and
        the features of its `scatter_feat` row, the winner synced over
        the row axes as one record."""
        hist = dequant(hist)
        if not pool_scatter:
            hist = expand_bundles(hist, sg, sh, cnt, meta_l)
            pf = pf_search(hist, sg, sh, cnt, meta_l, fmask_l, min_c, max_c,
                           split_kw)
            bf = torch.argmax(pf.gain, dim=-1).to(i32)
            return finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                                  max_constraint=max_c, **out_kw)
        sfeat = meta["scatter_feat"][dax]                  # [SF], -1 pads
        sidx = sfeat.clamp(min=0).long()
        fmask_s = fmask_l[sidx] * (sfeat >= 0).to(f32)
        meta_s = {k: meta_l[k][sidx] for k in (
            "num_bin", "missing_type", "default_bin", "monotone", "penalty",
            "bin_offset", "needs_fix")}
        meta_s["bundle_idx"] = meta_l["bundle_idx"][sidx] - dax * SG
        hist = expand_bundles(hist, sg, sh, cnt, meta_s)
        pf = pf_search(hist, sg, sh, cnt, meta_s, fmask_s, min_c, max_c,
                       split_kw)
        bf = torch.argmax(pf.gain, dim=-1).to(i32)
        res = finalize_split(pf, bf, sg, sh, min_constraint=min_c,
                             max_constraint=max_c, **out_kw)
        return sync_best(res, sfeat[bf.long()], data_axis)

    search = select_sharded if sharded else select

    # ---- root ------------------------------------------------------------
    g = grad * row_mask
    h = hess * row_mask
    if quantized:
        # per-tree discretization (grower.py:937-984 of the JAX package):
        # max-abs scales capped by quant_limit so no int32 bin overflows,
        # stochastic rounding from the tree key folded with 0x5154, and
        # the leaf totals from the same integers the histograms add
        # (sharded: the grid and the scales over the global rows, the
        # rounding keyed on the global row index, grower.py:944-960)
        qmax = quant_limit(params.precision,
                           n_pad * (num_shards if data_axis else 1))
        # XLA rewrites the JAX grower's division by the constant qmax
        # into a product with its f32 reciprocal; so does this
        inv_q = torch.tensor(np.float32(1.0) / np.float32(qmax), device=dev)
        floor = torch.tensor(1e-30, dtype=f32, device=dev)
        amax = torch.stack([g.abs().max(), h.abs().max()])
        if data_axis:
            amax = axis_pmax(amax, data_axis)
        g_scale = torch.maximum(amax[0], floor) * inv_q
        h_scale = torch.maximum(amax[1], floor) * inv_q
        seed_a, seed_b = key_words(fold_in(key, 0x5154))
        row0 = axis_index(data_axis) * n_pad if data_axis else 0
        g_q = quantize_values(g, g_scale, qmax, params.quant_round, seed_a,
                              seed_b, row0, salt=0x9E3779B9)
        h_q = quantize_values(h, h_scale, qmax, params.quant_round, seed_a,
                              seed_b, row0, salt=0x85EBCA6B)
        qscale = torch.stack([g_scale, h_scale,
                              torch.ones((), dtype=f32, device=dev)])
        tot = preduce(torch.stack([g_q.sum(dtype=i32), h_q.sum(dtype=i32),
                                   row_mask.to(i32).sum(dtype=i32)]))
        sum_g = tot[0].to(f32) * g_scale
        sum_h = tot[1].to(f32) * h_scale
        cnt = tot[2].to(f32)
        stats = pack_stats(g_q, h_q, row_mask, params.precision).contiguous()
    else:
        # deterministic=true ("f64"): the leaf totals are summed in f64
        # too, then kept f32 as the JAX grower keeps them (:989-992)
        sum_t = torch.float64 if params.precision == "f64" else f32
        tot = preduce(torch.stack([g.sum(dtype=sum_t), h.sum(dtype=sum_t),
                                   row_mask.sum(dtype=sum_t)]))
        sum_g, sum_h, cnt = tot[0].to(f32), tot[1].to(f32), tot[2].to(f32)
        stats = pack_stats(g, h, row_mask, params.precision).contiguous()
    if stream is not None:
        # each block's [S, rows] stats contiguous, in place of [S, n_pad]
        stats = stream.block_stats(stats)
    if params.has_sparse:
        # each entry's row stats, gathered once a tree (grower.py:1038-
        # 1056 gathers them every round)
        sp_stats = stats[:, meta["sp_rows"].long()].to(
            torch.float64 if params.precision == "f64" else f32).T \
            .contiguous()                                       # [E, S]

    def histograms(leaf_vec, slot_ids):
        """[K, G, B, 3]: the dense columns' histograms of the slots (B1
        on the card) and, with sparse storage, the sparse features',
        merged into feature order (grower.py:1038-1056); the sparse
        features' zero bins are rebuilt at the search."""
        h = build_histogram_batched_t(
            bins_h, stats, leaf_vec, slot_ids, B, params.precision,
            params.hist_impl, pblock)
        if not params.has_sparse:
            return h
        return merged_histograms(h, meta, sp_stats, leaf_vec, slot_ids, B,
                                 L, params.precision)

    leaf_ids = torch.zeros(n_pad, dtype=i32, device=dev)
    root_slots = torch.full((K,), -1, dtype=i32, device=dev)
    root_slots[0] = 0
    root_hist = (stream.root_histogram(stats, leaf_ids, root_slots)
                 if stream is not None
                 else agg_hist(histograms(leaf_ids, root_slots)[0]))
    big = torch.tensor(1e30, dtype=f32, device=dev)
    root_fmask = feature_mask
    node_key = key
    if bynode:
        # the rounding seed above folds the tree key without advancing it;
        # the node draws split it (grower.py:1084-1086)
        node_key, k_root = split(node_key)
        root_fmask = bynode_masks(k_root, ())
    delta0 = None
    if params.has_cegb:
        # the CEGB state lives across trees (grower.py:1087-1104): the
        # features any earlier split used, and with lazy penalties which
        # rows have paid for which feature
        tradeoff = torch.tensor(np.float32(params.cegb_tradeoff), device=dev)
        split_pen = torch.tensor(np.float32(params.cegb_penalty_split),
                                 device=dev)
        used0 = meta["cegb_used"]
        unpaid_root = None
        if params.has_cegb_lazy:
            paid0 = meta["cegb_paid"]                       # [F, n_pad] bool
            live_rows = row_mask > 0
            unpaid_root = torch.clamp(
                cnt - (paid0 & live_rows).sum(dim=1, dtype=i32).to(f32),
                min=0.0)[None, :]
        delta0 = cegb_delta(used0, cnt.reshape(1), unpaid_root)[0]
    root, root_iscat, root_cmask = search(
        root_hist[None], sum_g[None], sum_h[None], cnt[None], -big, big,
        root_fmask, delta0)
    if fused_scan:
        # the megakernel's per-feature tables (the JAX package's fused.py
        # layout); no per-node masks on this path, so the feature mask
        # is baked in
        zi = torch.zeros(G, dtype=i32, device=dev)
        fmeta_i = torch.stack(
            [meta["num_bin"], meta["missing_type"], meta["default_bin"],
             meta["monotone"], zi, zi, zi, zi], dim=1).to(i32).contiguous()
        zf = torch.zeros(G, dtype=f32, device=dev)
        fmeta_f = torch.stack(
            [meta["penalty"].to(f32), feature_mask.to(f32), zf, zf, zf, zf,
             zf, zf], dim=1).contiguous()

    def vec(fill, dtype=f32, first=None):
        v = torch.full((L + 1,), fill, dtype=dtype, device=dev)
        if first is not None:
            v[0] = first
        return v

    st = {
        # int32 under the quantized precisions: subtraction stays exact;
        # f64 under deterministic=true
        "pool": torch.zeros((L + 1, SG, B, 3), dtype=root_hist.dtype,
                            device=dev),
        "leaf_sum_g": vec(0.0, first=sum_g),
        "leaf_sum_h": vec(0.0, first=sum_h),
        "leaf_cnt": vec(0.0, first=cnt),
        "leaf_depth": vec(0, i32),
        "leaf_output": vec(0.0, first=leaf_output(sum_g, sum_h, **out_kw)),
        "bs_gain": vec(K_MIN_SCORE, first=root.gain[0]),
        "bs_feat": vec(0, i32, first=root.feature[0]),
        "bs_thr": vec(0, i32, first=root.threshold[0]),
        "bs_dleft": vec(False, torch.bool, first=root.default_left[0]),
        "bs_lg": vec(0.0, first=root.left_sum_g[0]),
        "bs_lh": vec(0.0, first=root.left_sum_h[0]),
        "bs_lc": vec(0.0, first=root.left_count[0]),
        "bs_lo": vec(0.0, first=root.left_output[0]),
        "bs_ro": vec(0.0, first=root.right_output[0]),
    }
    if params.has_mono:
        # each leaf's monotone bounds on its output, narrowed at every
        # split on a constrained feature (grower.py:1161-1163)
        st["leaf_min"] = vec(-1e30)
        st["leaf_max"] = vec(1e30)
    if params.has_cat:
        # the categorical best-split carry: flag and bins-going-left mask
        st["bs_iscat"] = vec(False, torch.bool, first=root_iscat[0])
        st["bs_catmask"] = torch.zeros((L + 1, B), dtype=f32, device=dev)
        st["bs_catmask"][0] = root_cmask[0]
    if params.has_cegb:
        st["used"] = used0
        if params.has_cegb_lazy:
            st["paid"] = paid0
    st["pool"][0] = root_hist
    # K slack rows so the last round's full-width write stays in bounds
    RW = REC_WIDTH + (B if params.has_cat else 0)
    records = torch.zeros((L - 1 + K, RW), dtype=f32, device=dev)
    n_splits = torch.zeros((), dtype=i32, device=dev)
    if params.has_cegb_lazy:
        iota_n = torch.arange(n_pad, dtype=torch.int64, device=dev)

    def cand_gains():
        gains = st["bs_gain"][:L]
        if params.max_depth <= 0:
            return gains
        return torch.where(st["leaf_depth"][:L] < params.max_depth, gains,
                           K_MIN_SCORE)

    if params.has_sparse:
        win = torch.arange(max(params.sparse_window, 1), device=dev)
        n_entries = meta["sp_rows"].shape[0]

    def feature_columns(sel_feat):
        """[Kr, n_pad] int32 bins of the features sel_feat [Kr]: each
        dense one's column, each sparse one's default bin with its stored
        entries written over it.  A feature's entries are read through a
        window of the longest feature's length from its start; the
        window's entries past its end write to a trash column."""
        f = sel_feat.long()
        sp = (meta["is_sparse"][f] > 0)[:, None]
        cols = torch.zeros((f.shape[0], n_pad + 1), dtype=i32, device=dev)
        cols[:, :n_pad] = torch.where(
            sp, meta["default_bin"][f].to(i32)[:, None],
            bins_t[meta["dense_col"][f].long()].to(i32))          # [Kr, n]
        slot = meta["sparse_slot"][f].long()
        pos = meta["sp_off"][slot][:, None] + win                 # [Kr, M]
        e = pos.clamp(max=n_entries - 1)
        # a dense feature's window writes to the trash column only
        rows = torch.where(sp & (pos < meta["sp_off"][slot + 1][:, None]),
                           meta["sp_rows"][e].long(), n_pad)
        cols.scatter_(1, rows, (meta["sp_key"][e] - slot[:, None] * B)
                      .to(i32))
        return cols[:, :n_pad]

    def partition(sel, new_ids, do_k, sel_feat, sel_thr, sel_dleft,
                  sel_iscat, cmask_sel):
        mt = meta["missing_type"][sel_feat]
        nbf = meta["num_bin"][sel_feat]
        db = meta["default_bin"][sel_feat]
        if params.partition_impl == "kernel":
            return partition_rows(bins_t, sel_feat, leaf_ids, sel, new_ids,
                                  sel_thr, sel_dleft, mt, nbf, db, do_k)
        if params.has_sparse:
            # the split features' columns, the sparse ones rebuilt from
            # their entries (grower.py:1254-1273,1306-1321)
            cols = feature_columns(sel_feat)
            if params.partition_impl == "vselect":
                return partition_rows_plain(
                    cols, torch.arange(cols.shape[0], device=dev), leaf_ids,
                    sel, new_ids, sel_thr, sel_dleft, mt, nbf, db, do_k, 0,
                    sel_iscat, cmask_sel)
        # EFB: each split feature's bundle column, mapped back to its bins
        bundle = None
        if params.has_bundles:
            bundle = (meta["bundle_idx"][sel_feat],
                      meta["bin_offset"][sel_feat],
                      meta["needs_fix"][sel_feat] > 0)
        if params.partition_impl == "vselect":
            return partition_rows_plain(bins_t, sel_feat, leaf_ids, sel,
                                        new_ids, sel_thr, sel_dleft, mt,
                                        nbf, db, do_k, pblock, sel_iscat,
                                        cmask_sel, bundle)
        # "select": one scalar-broadcast pass per slot
        new_leaf = leaf_ids
        for k in range(sel.shape[0]):
            if params.has_sparse:
                col = cols[k]
            else:
                col = bins_t[(sel_feat if bundle is None
                              else bundle[0])[k].long()]
            if pblock:
                col = unpack2d(col, pblock)
            col = col.to(i32)
            if bundle is not None:
                col = fix_bundle_col(col, bundle[1][k], nbf[k], bundle[2][k])
            go_left = numeric_go_left(col, mt[k], nbf[k], db[k],
                                      sel_thr[k], sel_dleft[k])
            if params.has_cat:
                # the bins in the stored mask go left, every other (the
                # NaN bin too) right (grower.py:1283-1287)
                go_left = torch.where(sel_iscat[k],
                                      cmask_sel[k][col.long()] > 0.5,
                                      go_left)
            move = (leaf_ids == sel[k]) & do_k[k] & ~go_left
            new_leaf = torch.where(move, new_ids[k], new_leaf)
        return new_leaf

    def cegb_round(Kr, prev_leaf_ids, sel_feat, do_k, at_sel, at_new, lc,
                   rc):
        """The round's CEGB update (grower.py:1482-1530): the applied
        splits' features become used (and, lazily, every row of their
        parents pays for them), the 2K children's charges, and the
        re-credit of the coupled penalty to the stored best splits of
        the other leaves whose feature was just used."""
        prev_used = st["used"]
        # one extra slot takes the dead slots' writes
        upd = torch.zeros(FG + 1, dtype=f32, device=dev)
        upd.index_fill_(0, torch.where(do_k, sel_feat, FG).long(), 1.0)
        used = torch.maximum(prev_used, upd[:FG])
        st["used"] = used
        cnt_children = torch.cat([lc, rc])
        unpaid = None
        if params.has_cegb_lazy:
            paid = st["paid"]
            live_rows = row_mask > 0
            # pay first, with the parents' rows before the partition
            # (one masked scatter: each row marks its parent's feature)
            slot_of = torch.full((L + 1,), Kr, dtype=torch.int64,
                                 device=dev)
            kar = torch.arange(Kr, dtype=torch.int64, device=dev)
            slot_of[at_sel] = torch.where(do_k, kar, Kr)
            row_slot = slot_of[prev_leaf_ids.long()]
            pays = (row_slot < Kr) & live_rows
            feat_of_row = torch.cat([sel_feat.long(), kar.new_zeros(1)])[
                row_slot]
            flat = paid.view(-1)
            at = feat_of_row * n_pad + iota_n
            flat[at] = flat[at] | pays
            # the children's rows that have not paid, a feature each: a
            # [2K, n] membership times the [n, F] paid matrix, as the JAX
            # grower's einsum (an f32 matmul: counts below 2^24 are exact
            # in any order, and no atomics crowd onto 2K x F sums)
            child_of = torch.full((L + 1,), 2 * Kr, dtype=torch.int64,
                                  device=dev)
            child_of[at_sel] = torch.where(do_k, kar, 2 * Kr)
            child_of[at_new] = torch.where(do_k, Kr + kar, 2 * Kr)
            row_child = torch.where(live_rows, child_of[leaf_ids.long()],
                                    2 * Kr)
            memb = (row_child[None, :] == torch.arange(
                2 * Kr, device=dev)[:, None]).to(f32)
            paid_sum = memb @ paid.to(f32).T                   # [2K, F]
            unpaid = torch.clamp(cnt_children[:, None] - paid_sum, min=0.0)
        delta = cegb_delta(used, cnt_children, unpaid)
        newly = used - prev_used
        bf = st["bs_feat"].long()
        credit = tradeoff * meta["cegb_coupled"][bf] * newly[bf]
        st["bs_gain"] = st["bs_gain"] + torch.where(
            st["bs_gain"] > K_MIN_SCORE / 2, credit, 0.0)
        return delta

    def exec_round(sel, vals, do_k, sel_feat, sel_thr, sel_dleft,
                   sel_iscat, cmask_sel, lg, lh, lc, lo, ro) -> None:
        """Up to Kr splits, slot k splitting leaf sel[k] on sel_feat[k]
        (grower.py:1241-1598): partition, the children's bounds and
        histograms, their search, the state and the records.  Shared by
        the best-gain rounds, the ramp's and the forced splits'."""
        nonlocal leaf_ids, n_splits, node_key
        Kr = sel.shape[0]
        kar = torch.arange(Kr, dtype=i32, device=dev)
        sl = sel.long()
        num_do = do_k.sum(dtype=i32)
        new_ids = n_splits + 1 + kar
        pg, ph, pc = (st["leaf_sum_g"][sl], st["leaf_sum_h"][sl],
                      st["leaf_cnt"][sl])
        rg, rh, rc = pg - lg, ph - lh, pc - lc

        prev_leaf_ids = leaf_ids
        if stream is None:
            leaf_ids = partition(sel, new_ids, do_k, sel_feat, sel_thr,
                                 sel_dleft, sel_iscat, cmask_sel)

        ch_min, ch_max = -big, big
        if params.has_mono:
            # the children's monotone bounds (grower.py:1391-1402), before
            # the histograms: B2's scan reads them
            p_min, p_max = st["leaf_min"][sl], st["leaf_max"][sl]
            mono_k = meta["monotone"][sel_feat.long()]
            mid = (lo + ro) / 2.0
            l_min = torch.where(mono_k < 0, mid, p_min)
            l_max = torch.where(mono_k > 0, mid, p_max)
            r_min = torch.where(mono_k > 0, mid, p_min)
            r_max = torch.where(mono_k < 0, mid, p_max)
            ch_min = torch.cat([l_min, r_min])
            ch_max = torch.cat([l_max, r_max])

        # all K smaller children in one pass, siblings by subtraction
        smaller_is_left = lc <= rc
        smaller_ids = torch.where(
            do_k, torch.where(smaller_is_left, sel, new_ids), -1).to(i32)
        parent_hist = st["pool"][sl]                      # [Kr, G, B, 3]
        if fused_scan:
            # histograms + subtraction + split scan of all 2K children in
            # one call (grower.py:1410-1436); dead slots carry garbage
            # records that land in the trash slot
            C = 2 * Kr
            ctx = torch.zeros((C + 1, CTX_WIDTH), dtype=f32, device=dev)
            ctx[:C, CTX_SUM_G] = torch.cat([lg, rg])
            ctx[:C, CTX_SUM_H] = torch.cat([lh, rh])
            ctx[:C, CTX_COUNT] = torch.cat([lc, rc])
            ctx[:C, CTX_MIN_C] = ch_min
            ctx[:C, CTX_MAX_C] = ch_max
            ctx[:C, CTX_USE_SMALL] = torch.cat(
                [smaller_is_left, ~smaller_is_left]).to(f32)
            ctx[C, :3] = qscale
            hist_small, srecs = fused_hist_scan(
                bins_t, stats, leaf_ids, smaller_ids, parent_hist, ctx,
                fmeta_i, fmeta_f, B, params.precision, split_kw=split_kw)
        elif stream is not None:
            # each block partitioned, then its smaller children's
            # histograms added (the JAX package's block_step)
            leaf_ids, hist_small = stream.round_histograms(
                stats, leaf_ids, sel, new_ids, do_k, sel_feat, sel_thr,
                sel_dleft, smaller_ids, meta)
        else:
            hist_small = agg_hist(histograms(leaf_ids, smaller_ids))
        hist_large = parent_hist - hist_small
        sil = smaller_is_left[:, None, None, None]
        hist_left = torch.where(sil, hist_small, hist_large)
        hist_right = torch.where(sil, hist_large, hist_small)
        # live slots write their leaves, dead ones the trash slot L
        at_sel = torch.where(do_k, sel, L).long()
        at_new = torch.where(do_k, new_ids, L).long()

        def put(key, left, right):
            st[key].index_copy_(0, at_sel, left.to(st[key].dtype))
            st[key].index_copy_(0, at_new, right.to(st[key].dtype))

        put("pool", hist_left, hist_right)

        # best splits of all 2K children
        child_masks = feature_mask
        if bynode:
            # one mask a child, from the round's split of the key
            # (grower.py:1476-1479)
            node_key, k_nodes = split(node_key)
            child_masks = bynode_masks(k_nodes, (2 * Kr,))
        delta = None
        if params.has_cegb:
            delta = cegb_round(Kr, prev_leaf_ids, sel_feat, do_k, at_sel,
                               at_new, lc, rc)
        if fused_scan:
            # the megakernel's records: argmax over the per-feature gains,
            # then finalize_split (grower.py:1532-1551)
            ch, ch_iscat, ch_cmask = best_of(
                unpack_pf_records(srecs), torch.cat([lg, rg]),
                torch.cat([lh, rh]), ch_min, ch_max)
        else:
            ch, ch_iscat, ch_cmask = search(
                torch.cat([hist_left, hist_right]), torch.cat([lg, rg]),
                torch.cat([lh, rh]), torch.cat([lc, rc]), ch_min, ch_max,
                child_masks, delta)

        # the record block reads the parent's output before it changes
        rec = torch.stack([
            sel.to(f32), sel_feat.to(f32), sel_thr.to(f32),
            sel_dleft.to(f32), vals, lo, ro, lc, rc, lh, rh,
            st["leaf_output"][sl], ph, pc, do_k.to(f32),
            (sel_iscat.to(f32) if params.has_cat
             else torch.zeros(Kr, dtype=f32, device=dev))], dim=1)
        if params.has_cat:
            rec = torch.cat([rec, cmask_sel], dim=1)      # [Kr, 16 + B]
        for key, li, ri in (("leaf_sum_g", lg, rg), ("leaf_sum_h", lh, rh),
                            ("leaf_cnt", lc, rc), ("leaf_output", lo, ro)):
            put(key, li, ri)
        if params.has_mono:
            put("leaf_min", l_min, r_min)
            put("leaf_max", l_max, r_max)
        d_child = st["leaf_depth"][sl] + 1
        put("leaf_depth", d_child, d_child)
        for key, cv in (("bs_gain", ch.gain), ("bs_feat", ch.feature),
                        ("bs_thr", ch.threshold),
                        ("bs_dleft", ch.default_left),
                        ("bs_lg", ch.left_sum_g), ("bs_lh", ch.left_sum_h),
                        ("bs_lc", ch.left_count), ("bs_lo", ch.left_output),
                        ("bs_ro", ch.right_output)):
            put(key, cv[:Kr], cv[Kr:])
        if params.has_cat:
            put("bs_iscat", ch_iscat[:Kr], ch_iscat[Kr:])
            put("bs_catmask", ch_cmask[:Kr], ch_cmask[Kr:])
        records.index_copy_(0, (n_splits + kar).long(), rec)
        n_splits = n_splits + num_do

    def best_round(Kr: int) -> None:
        """A best-gain round: the top-Kr leaves by stored gain split on
        their stored best splits (grower.py:1600-1622)."""
        vals, sel = _top_k(cand_gains(), Kr)
        kar = torch.arange(Kr, dtype=i32, device=dev)
        budget = (L - 1) - n_splits
        # vals descend, so do_k is a prefix: this round's records are
        # contiguous
        do_k = (vals > 0.0) & (kar < budget)
        if params.split_batch_alpha > 0.0 and K > 1:
            alpha = min(params.split_batch_alpha, 0.999)
            do_k &= vals >= alpha * vals[0]
        sl = sel.long()
        exec_round(sel, vals, do_k, st["bs_feat"][sl], st["bs_thr"][sl],
                   st["bs_dleft"][sl],
                   st["bs_iscat"][sl] if params.has_cat else None,
                   st["bs_catmask"][sl] if params.has_cat else None,
                   st["bs_lg"][sl], st["bs_lh"][sl], st["bs_lc"][sl],
                   st["bs_lo"][sl], st["bs_ro"][sl])

    def forced_round(ok, parent: int, feat: int, thr: int):
        """One forced split (grower.py:1624-1708): leaf `parent` splits on
        (feat, thr) whatever its best split, its left sums read off the
        pooled histogram at the threshold; a negative gain stops this
        split and every later one.  Run as a K-wide round whose slot 0
        alone may split, as the JAX grower runs it, so the round's width
        (and under bynode its mask draw) is the best-gain rounds'.
        Returns whether the split was made."""
        iota_b = torch.arange(B, dtype=i32, device=dev)
        mt = meta["missing_type"][feat]
        nb_f = meta["num_bin"][feat]
        db_f = meta["default_bin"][feat]
        nan_excl = (mt == MISSING_NAN) & (iota_b == nb_f - 1)
        mask_b = ((iota_b <= thr) & (iota_b < nb_f) & ~nan_excl).to(f32)
        sums = reduce_sum(st["pool"][parent, feat] * mask_b[:, None], 0)
        lg0, lh0, lc0 = sums[0], sums[1], sums[2]
        pg0, ph0, pc0 = (st["leaf_sum_g"][parent], st["leaf_sum_h"][parent],
                         st["leaf_cnt"][parent])
        rg0, rh0, rc0 = pg0 - lg0, ph0 - lh0, pc0 - lc0
        min_c, max_c = ((st["leaf_min"][parent], st["leaf_max"][parent])
                        if params.has_mono else (-big, big))
        lo0 = torch.minimum(torch.maximum(
            leaf_output(lg0, lh0, **out_kw), min_c), max_c)
        ro0 = torch.minimum(torch.maximum(
            leaf_output(rg0, rh0, **out_kw), min_c), max_c)
        shift = leaf_split_gain(pg0, ph0 + 2e-15, **out_kw)
        gain0 = (leaf_split_gain(lg0, lh0, **out_kw)
                 + leaf_split_gain(rg0, rh0, **out_kw)
                 - shift - params.min_gain_to_split)
        do0 = ok & (gain0 >= 0.0) & (lc0 > 0) & (rc0 > 0)
        first = torch.arange(K, device=dev) == 0

        def bcast(v, fill=0.0):
            return torch.where(first, v, fill)

        dleft0 = (mt == MISSING_ZERO) & (db_f <= thr)
        exec_round(
            torch.full((K,), parent, dtype=i32, device=dev),
            bcast(gain0, K_MIN_SCORE), first & do0,
            torch.full((K,), feat, dtype=i32, device=dev),
            torch.full((K,), thr, dtype=i32, device=dev),
            dleft0.repeat(K),
            torch.zeros(K, dtype=torch.bool, device=dev)
            if params.has_cat else None,
            torch.zeros((K, B), dtype=f32, device=dev)
            if params.has_cat else None,
            bcast(lg0), bcast(lh0), bcast(lc0), bcast(lo0), bcast(ro0))
        return do0

    # forced splits first, one round each (grower.py:1710-1715)
    forced_ok = torch.ones((), dtype=torch.bool, device=dev)
    for parent, feat, thr in params.forced:
        forced_ok = forced_round(forced_ok, int(parent), int(feat), int(thr))
    if (params.ramp and not params.forced and not bynode and K > 1
            and stream is None):
        # after r rounds the frontier holds at most 2^r leaves, so a
        # pre-round of width K' >= 2^r splits exactly the leaves the
        # full-K round would: the tree is the same, the dead-slot work
        # of the first rounds goes.  Not under bynode: its draws take
        # the round's width, which would change the masks; not after
        # forced splits, whose frontier the bound does not cover
        kr = 1
        while kr < K:
            best_round(kr)
            kr *= int(params.ramp_step)
    syncs = 0
    while True:
        go = (n_splits < L - 1) & (cand_gains().max() > 0.0)
        syncs += 1
        if not bool(go):      # the one host wait of the round
            break
        best_round(K)
    if quantized and params.quant_refit:
        # leaf refit (grower.py:1733-1755): the structure came from the
        # integer histograms, the outputs come from the f32 sums, clipped
        # to each leaf's monotone bounds
        # per-leaf sums in row order, as XLA:CPU's scatter adds them (a
        # fixed-order kernel on the card: ops/leafsum.py)
        # (sharded: each shard's sums, psummed over the row axes; in f32
        # the shard order can move the last ulp, grower.py:1736-1740)
        rg, rh = preduce(leaf_sums(leaf_ids, torch.stack([g, h]), L + 1))
        lo_b, hi_b = ((st["leaf_min"], st["leaf_max"]) if params.has_mono
                      else (-big, big))
        refit = torch.minimum(torch.maximum(
            leaf_output(rg, rh + 2e-15, **out_kw), lo_b), hi_b)
        st["leaf_output"] = torch.where(st["leaf_cnt"] > 0, refit,
                                        st["leaf_output"])
    out = {"records": records[:L - 1], "leaf_ids": leaf_ids,
           "leaf_output": st["leaf_output"][:L],
           "leaf_cnt": st["leaf_cnt"][:L],
           "leaf_sum_h": st["leaf_sum_h"][:L], "syncs": syncs,
           # the two largest per-tree buffers, for utils/membudget.py
           "buffer_bytes": {"histogram_pool": int(st["pool"].nbytes),
                            "stats_planes": int(stats.nbytes)}}
    if params.has_cegb:
        # the state the next tree starts from (grower.py:1767-1773)
        out["cegb_used"] = st["used"]
        if params.has_cegb_lazy:
            out["cegb_paid"] = st["paid"]
    return out
