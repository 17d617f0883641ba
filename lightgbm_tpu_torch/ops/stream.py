"""Out-of-core streamed tree growth: host-resident bins, blocked copies.

The port of `lightgbm_tpu/ops/stream.py`.  The binned matrix stays in
host memory as fixed-size row blocks (`make_host_blocks`, sized by
`resolve_stream_rows`), and each histogram pass of a tree streams the
blocks through two device slots, block i+1's copy riding under block
i's histogram (`StreamGrower._stream_blocks`).

Each host block is made once, at set-up, in the histogram kernels' own
operand layout: `[rows, FR]` uint8 (int16 for wide bins) with FR the
column count rounded up to 32, `histogram.row_major_bins`' layout, so
kernels B1 and B4 read a device slot as it is (`histogram.
build_histogram_rows`) and nothing is transposed on the card per block.
On a CUDA device the blocks sit in pinned memory; the copies run on a
side stream with `non_blocking`, a CUDA event after each copy that the
compute stream waits on, and an event after each block's last use that
the copy stream waits on before it overwrites that slot.  The slots are
the grower's for its lifetime.  `tpu_stream_double_buffer=false` copies
on the compute stream.  On the CPU the same loop copies into two CPU
slots.

The JAX package splits a round into a family of jitted programs at the
histogram seam (its `prep`, `root_block`, `block_step`, `root_finish`,
`round_head`, `round_update`, `finish`).  Here the rounds are
`ops/grower.py:grow`'s own code, which this module drives through three
hooks: `block_stats` (the packed stats laid out block by block once a
tree, so each block's `[S, rows]` stats are contiguous for the kernel:
`S * n_pad` bytes, the same as the `[S, n_pad]` planes they replace),
`root_histogram` (the root's histogram added block by block,
`root_block`) and `round_histograms` (each block's rows partitioned for
the round's K splits by torch ops on the row-major block, a row reading
its split's feature column and a [B] go-left table of the split, then
its smaller children's histograms added: `block_step`).  The grower runs no frontier ramp and no B2 scan here,
as the JAX package's streamed programs do not: every round is K wide
and every histogram is B1 (or B4 under ``tpu_hist_impl=pallas``), once
per block per round.

Bitwise contract (the JAX package's): int8/int16 histograms are int32
sums, associative across blocks, with the resident layout's row padding,
quantization grid and rounding hash, so a streamed model is
byte-identical to a resident one on the sync path.  Float precisions
reassociate at the block seam and are close, not equal.  GOSS block
sampling (`tpu_stream_goss_top/other`) keys each block's uniform on its
first global row, so it is invariant to the copy schedule; its skipped
blocks get their leaf ids by a replay of the tree's records
(`replay_block`) after the tree.

`last_stats` times the copies by CUDA events: ``h2d_wall_s`` (and
``copy_est_s``) is the copies' device time, ``h2d_stall_s`` the time
the compute stream waited on them, and ``overlap_pct`` the share of
copy time hidden under compute.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..utils.prng import fold_in
from . import grower as G
from .histogram import (INT_PRECISIONS, build_histogram_rows,
                        hashed_uniform, key_words)
from .leafsum import leaf_sums
from .split import numeric_go_left


def stream_supported(params: "G.GrowerParams") -> Optional[str]:
    """None when the streamed layout can serve these grower params, else
    the reason it cannot (the JAX package's texts)."""
    if params.has_cat:
        return "categorical features"
    if params.has_bundles:
        return "EFB bundling (enable_bundle)"
    if params.has_sparse:
        return "sparse COO storage (tpu_sparse_threshold)"
    if params.has_cegb or params.has_cegb_lazy:
        return "CEGB penalties"
    if params.forced:
        return "forced splits"
    if params.feature_fraction_bynode < 1.0:
        return "feature_fraction_bynode"
    if params.packed_bins:
        return "packed 4-bit bins (tpu_pack_bins)"
    return None


def _acc_dtype(precision: str) -> torch.dtype:
    """The histograms' and the pool's dtype (the JAX `pool_dtype`)."""
    if precision in INT_PRECISIONS:
        return torch.int32
    return torch.float64 if precision == "f64" else torch.float32


def _hist_geometry(params: "G.GrowerParams", rows: int):
    """The JAX package's inner scan blocking of a stream block (which the
    block widths must divide into): (blocks, rows a block)."""
    block = min(params.block_rows, rows)
    nbi = max(rows // block, 1)
    return nbi, rows // nbi


def resolve_stream_rows(cfg_rows: int, n_pad: int, bytes_per_row: int,
                        inner_block: int,
                        budget_bytes: Optional[int] = None) -> int:
    """tpu_stream_block_rows resolved to the stream block's rows (the
    JAX package's rule): a multiple of the grower's inner histogram
    block, in [inner_block, n_pad]; cfg_rows=0 (auto) sizes two slots
    to about 1/8 of the device budget, at least 65,536 rows."""
    b0 = max(1, min(int(inner_block), int(n_pad)))
    if cfg_rows > 0:
        r = int(cfg_rows)
    else:
        r = 65536
        if budget_bytes and bytes_per_row > 0:
            r = max(r, int((budget_bytes // 8) // (2 * bytes_per_row)))
    r = min(max(r, b0), int(n_pad))
    return max(r // b0, 1) * b0


def make_host_blocks(bins_t: torch.Tensor, stream_rows: int, n_pad: int,
                     columns: int, pin: bool = False) -> List[torch.Tensor]:
    """The [F, n] bin matrix (on any device) as host row blocks of
    stream_rows rows ([rows_i, columns], the last one shorter), the
    blocks of the JAX package's `make_host_blocks` transposed: row-major
    uint8, or int16 holding the low 16 bits of int32 (wide) bins, with
    the padding rows past n and the padding columns past F at bin 0.
    columns: the layout's column count, a multiple of 32.  pin: pinned
    host memory (for a CUDA device; it needs CUDA).  One block is made
    on the matrix's device at a time."""
    F, n = bins_t.shape
    if columns % 32 or columns < F:
        raise ValueError(f"{columns} columns: a multiple of 32 and at "
                         f"least the matrix's {F}")
    dtype = torch.int16 if bins_t.dtype == torch.int32 else torch.uint8
    out = []
    for row0 in range(0, n_pad, stream_rows):
        rows = min(stream_rows, n_pad - row0)
        blk = torch.zeros((rows, columns), dtype=dtype, device=bins_t.device)
        m = max(min(rows, n - row0), 0)
        if m:
            # int32 -> int16 keeps the low 16 bits (a two's-complement wrap)
            blk[:m, :F] = bins_t[:, row0:row0 + m].t()
        host = torch.empty((rows, columns), dtype=dtype, pin_memory=pin)
        host.copy_(blk)
        out.append(host)
    return out


class StreamGrower:
    """Host loop of the streamed tree growth: the block copies through
    two device slots, the GOSS block plan, the grower's hooks and the
    per-tree telemetry."""

    def __init__(self, params: "G.GrowerParams", num_columns: int,
                 n_pad: int, stream_rows: int, device,
                 double_buffer: bool = True, goss_top: float = 0.0,
                 goss_other: float = 0.0):
        reason = stream_supported(params)
        if reason is not None:
            raise NotImplementedError(
                f"streamed training layout does not support {reason}; "
                "set tpu_stream_mode=resident")
        if stream_rows <= 0:
            raise ValueError(f"stream_rows={stream_rows} must be positive")
        self.params = params
        self.num_columns = int(num_columns)
        self.n_pad = int(n_pad)
        self.R = min(int(stream_rows), self.n_pad)
        self.nbs = -(-self.n_pad // self.R)
        tail = self.n_pad - (self.nbs - 1) * self.R
        for rows in sorted({self.R, tail}):
            nbi, blk = _hist_geometry(params, rows)
            if nbi * blk != rows:
                raise ValueError(
                    f"stream block of {rows} rows does not decompose "
                    f"into whole histogram scan blocks "
                    f"(block_rows={params.block_rows}); use "
                    "resolve_stream_rows() to size tpu_stream_block_rows")
        self.device = torch.device(device)
        self.double_buffer = bool(double_buffer)
        self.goss_top = float(goss_top)
        self.goss_other = float(goss_other)
        self.goss_on = self.goss_top > 0.0 or self.goss_other > 0.0
        # the two device slots (made at the first tree, kept for good),
        # the side stream of the copies, each slot's last-use event, and
        # the slot the next copy takes
        self.slots: Optional[List[torch.Tensor]] = None
        self._copy_stream = None
        self._free: List = [None, None]
        self._next_slot = 0
        self.last_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _block_bounds(self, i: int):
        row0 = i * self.R
        return row0, min(self.R, self.n_pad - row0)

    def _ensure_slots(self, host_blocks: List[torch.Tensor]) -> None:
        if self.slots is not None:
            return
        shape = (self.R, host_blocks[0].shape[1])
        self.slots = [torch.empty(shape, dtype=host_blocks[0].dtype,
                                  device=self.device) for _ in range(2)]
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)

    def slot_bytes(self) -> int:
        """Bytes of the two device slots (0 before the first tree)."""
        return 0 if self.slots is None else sum(int(s.nbytes)
                                                for s in self.slots)

    def _goss_weights(self, grad, hess, row_mask, key) -> np.ndarray:
        """The GOSS block plan (the JAX package's `goss_plan` and
        `_goss_weights`): [nbs] weights, 0 for a skipped block.  Each
        block's score is its sum of |g * h| over real rows, added in row
        order (`leaf_sums`: XLA:CPU's scatter-add order); each block's
        uniform hashes its first global row; ties order by block index."""
        nbs = self.nbs
        v = (grad * hess).abs() * row_mask
        iota = torch.arange(self.n_pad, device=v.device)
        bidx = torch.clamp(iota // self.R, max=nbs - 1).to(torch.int32)
        scores = leaf_sums(bidx, torch.stack([v, torch.zeros_like(v)]),
                           nbs)[0].cpu().numpy()
        seed_a, seed_b = key_words(fold_in(key, 0x51B5))
        starts = torch.arange(nbs, dtype=torch.int64) * self.R
        u = hashed_uniform(starts, seed_a, seed_b, 0x60553).numpy()
        top_k = int(np.ceil(self.goss_top * nbs)) if self.goss_top > 0 \
            else 0
        order = np.argsort(-scores, kind="stable")
        w = np.zeros(nbs, np.float32)
        w[order[:top_k]] = 1.0
        rest = order[top_k:]
        if self.goss_other > 0 and len(rest):
            amp = (1.0 - self.goss_top) / self.goss_other
            w[rest[u[rest] < self.goss_other]] = np.float32(amp)
        if not (w > 0).any():
            # degenerate fractions: the highest-scored block always
            # streams, or the tree would see no rows
            w[order[0]] = 1.0
        return w

    def _stream_blocks(self, host_blocks: List[torch.Tensor], indices,
                       consume, **tags) -> None:
        """consume(i, device block, row0) over the listed blocks, each
        copied into a slot first: on the card, block i+1's copy is issued
        on the side stream before block i is consumed (double-buffered),
        or on the compute stream (not); on the CPU a plain copy.  tags:
        more tags of each block's `stream_block` span."""
        indices = list(indices)
        if not indices:
            return
        cuda = self.device.type == "cuda"
        compute = torch.cuda.current_stream(self.device) if cuda else None
        side = self._copy_stream if self.double_buffer else compute

        def issue(i):
            slot = self._next_slot
            self._next_slot ^= 1 if self.double_buffer else 0
            dst = self.slots[slot][:host_blocks[i].shape[0]]
            with obs.span("stream_h2d", block=i,
                          bytes=int(host_blocks[i].nbytes)):
                if not cuda:
                    t0 = time.perf_counter()
                    dst.copy_(host_blocks[i])
                    return slot, dst, time.perf_counter() - t0
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(side):
                    if self._free[slot] is not None and side is not compute:
                        side.wait_event(self._free[slot])
                    start.record(side)
                    dst.copy_(host_blocks[i], non_blocking=True)
                    end.record(side)
            return slot, dst, (start, end)

        pending = {0: issue(indices[0])}
        for pos, i in enumerate(indices):
            if self.double_buffer and pos + 1 < len(indices):
                pending[pos + 1] = issue(indices[pos + 1])
            if pos not in pending:
                pending[pos] = issue(i)
            slot, dst, timing = pending.pop(pos)
            self._bytes += int(host_blocks[i].nbytes)
            if cuda:
                w0 = torch.cuda.Event(enable_timing=True)
                w1 = torch.cuda.Event(enable_timing=True)
                w0.record(compute)
                compute.wait_event(timing[1])
                w1.record(compute)
                self._timings.append((timing, (w0, w1)))
            else:
                self._timings.append((timing, timing))
            row0, _ = self._block_bounds(i)
            with obs.span("stream_block", block=i, **tags):
                consume(i, dst, row0)
            if cuda and side is not compute:
                ev = torch.cuda.Event()
                ev.record(compute)
                self._free[slot] = ev

    def _block_stats(self, i: int) -> torch.Tensor:
        row0, rows = self._block_bounds(i)
        S = self._S
        return self._stats_flat[S * row0:S * (row0 + rows)].view(S, rows)

    # -- the grower's hooks -------------------------------------------------
    def block_stats(self, stats: torch.Tensor) -> torch.Tensor:
        """[S, n_pad] packed stats -> the same bytes laid out block by
        block, each block's [S, rows] contiguous (one copy a tree)."""
        self._S = int(stats.shape[0])
        self._stats_flat = torch.cat([
            stats[:, r0:r0 + self.R].reshape(-1)
            for r0 in range(0, self.n_pad, self.R)])
        return self._stats_flat

    def root_histogram(self, stats, leaf_ids, root_slots) -> torch.Tensor:
        """[G, B, 3]: the root's histogram, the sampled blocks' added in
        block order (`root_block`)."""
        p = self.params
        acc = torch.zeros((self.num_columns, p.num_bins, 3),
                          dtype=_acc_dtype(p.precision),
                          device=leaf_ids.device)
        box = [acc]

        def consume(i, blk, row0):
            rows = blk.shape[0]
            box[0] = box[0] + build_histogram_rows(
                blk, self.num_columns, self._block_stats(i),
                leaf_ids[row0:row0 + rows], root_slots, p.num_bins,
                p.precision, p.hist_impl)[0]

        with obs.span("hist_build", streamed=True, phase="root"):
            self._stream_blocks(self._host_blocks, self._sampled, consume)
        return box[0]

    def _split_plan(self, leaf, feat, thr, dleft, new_id, meta):
        """The lookup tables of a set of splits that partition disjoint
        rows (one round's, or a batch of records): slot [L + 1] of each
        leaf id (the split count for a leaf no split takes), and the
        feature, the [B] go-left table (`split.numeric_go_left` of every
        bin) and the new leaf id of each slot, one more slot that keeps
        its rows.  leaf/feat/thr/dleft/new_id: [S] device tensors; leaf
        is L (the trash slot) where a split is not made."""
        p = self.params
        dev = leaf.device
        S, L = leaf.shape[0], p.num_leaves
        slot_of = torch.full((L + 1,), S, dtype=torch.int64, device=dev)
        slot_of[leaf.long()] = torch.arange(S, device=dev)
        f = feat.long()
        bins = torch.arange(p.num_bins, device=dev)[None, :]
        table = numeric_go_left(bins, meta["missing_type"][f][:, None],
                                meta["num_bin"][f][:, None],
                                meta["default_bin"][f][:, None],
                                thr[:, None], dleft[:, None])
        keep = torch.ones((1, p.num_bins), dtype=torch.bool, device=dev)
        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        return (slot_of, torch.cat([f, zero]), torch.cat([table, keep]),
                torch.cat([new_id.to(torch.int32),
                           zero.to(torch.int32)]))

    @staticmethod
    def _partition_block(blk, leaf_blk, plan) -> None:
        """Move a block's rows of the plan's split leaves to the new ids
        where their bin of the split feature does not go left (leaf_blk
        updated in place): each row reads its slot, that slot's feature
        column of the row-major block, and the slot's go-left table."""
        slot_of, feat, table, new_id = plan
        rs = slot_of[leaf_blk.long()]
        b = blk.gather(1, feat[rs][:, None])[:, 0].long()
        if blk.dtype == torch.int16:
            b = b & 0xFFFF       # wide bins: the low 16 bits, unsigned
        leaf_blk.copy_(torch.where(table[rs, b], leaf_blk, new_id[rs]))

    def round_histograms(self, stats, leaf_ids, sel, new_ids, do_k,
                         sel_feat, sel_thr, sel_dleft, smaller_ids, meta):
        """One round over the sampled blocks (`block_step`): each block's
        rows of the K split leaves move to the new ids where their bin
        does not go left (leaf_ids updated in place), then the block's
        histograms of the K smaller children are added.  Returns
        (leaf_ids, [K, G, B, 3])."""
        p = self.params
        self._rounds += 1
        plan = self._split_plan(
            torch.where(do_k, sel, p.num_leaves), sel_feat, sel_thr,
            sel_dleft, new_ids, meta)
        box = [torch.zeros((sel.shape[0], self.num_columns, p.num_bins, 3),
                           dtype=_acc_dtype(p.precision),
                           device=leaf_ids.device)]

        def consume(i, blk, row0):
            leaf_blk = leaf_ids[row0:row0 + blk.shape[0]]
            self._partition_block(blk, leaf_blk, plan)
            box[0] = box[0] + build_histogram_rows(
                blk, self.num_columns, self._block_stats(i), leaf_blk,
                smaller_ids, p.num_bins, p.precision, p.hist_impl)

        with obs.span("hist_build", streamed=True, round=self._rounds):
            self._stream_blocks(self._host_blocks, self._sampled, consume)
        return leaf_ids, box[0]

    def _replay(self, host_blocks, skipped, records, leaf_ids, meta) -> None:
        """Leaf ids of the GOSS-skipped blocks (`replay_block`): the
        tree's split records replayed in order over each block's rows
        (record j created leaf j + 1), in batches of consecutive records
        of which none splits a leaf that an earlier one of the batch
        split or made: a batch's splits take disjoint rows, so applying
        them at once is applying them in order."""
        rec = records.cpu().numpy()
        batches, cur, touched = [], [], set()
        for j, r in enumerate(rec):
            if r[G.REC_DID_SPLIT] < 0.5:
                continue
            parent = int(r[G.REC_LEAF])
            if parent in touched:
                batches.append(cur)
                cur, touched = [], set()
            cur.append((parent, int(r[G.REC_FEATURE]),
                        int(r[G.REC_THRESHOLD]),
                        bool(r[G.REC_DEFAULT_LEFT] > 0.5), j + 1))
            touched.update((parent, j + 1))
        if cur:
            batches.append(cur)
        dev = leaf_ids.device
        plans = []
        for batch in batches:
            cols = [torch.tensor(c, device=dev) for c in zip(*batch)]
            plans.append(self._split_plan(*cols, meta))

        def consume(i, blk, row0):
            lb = leaf_ids[row0:row0 + blk.shape[0]]
            for plan in plans:
                self._partition_block(blk, lb, plan)

        with obs.span("hist_build", streamed=True, phase="replay"):
            self._stream_blocks(host_blocks, skipped, consume, replay=True)

    # ------------------------------------------------------------------
    def grow(self, host_blocks: List[torch.Tensor], grad, hess, row_mask,
             feature_mask, meta, key) -> Dict:
        """Grow one tree over the host blocks (`make_host_blocks`):
        `ops/grower.py:grow`'s out dict, its leaf ids those of every
        row, the skipped blocks' replayed."""
        t_tree = time.perf_counter()
        self._ensure_slots(host_blocks)
        self._host_blocks = host_blocks
        self._timings = []
        self._bytes = 0
        self._rounds = 0
        if self.goss_on:
            w = self._goss_weights(grad, hess, row_mask, key)
            # per-row block weights: the JAX prep's grad * w * mask, mask
            # * (w > 0), with the grower's own product by the mask last
            iota = torch.arange(self.n_pad, device=grad.device)
            w_row = torch.as_tensor(w, device=grad.device)[
                torch.clamp(iota // self.R, max=self.nbs - 1)]
            grad, hess = grad * w_row, hess * w_row
            row_mask = row_mask * (w_row > 0).to(torch.float32)
        else:
            w = np.ones(self.nbs, np.float32)
        self._sampled = [i for i in range(self.nbs) if w[i] > 0]
        skipped = [i for i in range(self.nbs) if w[i] <= 0]
        t_hist = time.perf_counter()
        out = G.grow(self.params, None, grad, hess, row_mask, feature_mask,
                     meta, key, stream=self)
        t_hist = time.perf_counter() - t_hist
        if skipped:
            self._replay(host_blocks, skipped, out["records"],
                         out["leaf_ids"], meta)
        self._stats_flat = None
        self.last_stats = self._telemetry(time.perf_counter() - t_tree,
                                          t_hist, len(skipped))
        obs.event("stream_tree", **self.last_stats)
        return out

    def _telemetry(self, wall: float, t_hist: float, skipped: int) -> Dict:
        """The tree's telemetry (the JAX package's keys, plus h2d_bytes
        and h2d_stall_s): on the card each copy's device time from its
        events and each wait of the compute stream on a copy, read once
        the tree is done; on the CPU each copy's host wall."""
        copy_s = stall_s = hidden = 0.0
        for timing, wait in self._timings:
            if isinstance(timing, float):
                c = s = timing
            else:
                wait[1].synchronize()
                c = timing[0].elapsed_time(timing[1]) / 1e3
                s = wait[0].elapsed_time(wait[1]) / 1e3
                if not self.double_buffer:
                    # the copy sits in the compute stream's order: all of
                    # it is waited for
                    s = c
            copy_s += c
            stall_s += s
            hidden += max(0.0, c - s)
        self._timings = []
        rounds = self._rounds
        return {
            "tree_wall_s": wall,
            "h2d_wall_s": copy_s,
            "h2d_stall_s": stall_s,
            "h2d_bytes": float(self._bytes),
            "hist_wall_s": max(t_hist - stall_s, 0.0),
            "copy_est_s": copy_s,
            "overlap_pct": 100.0 * hidden / copy_s if copy_s > 0 else 0.0,
            "rounds": float(rounds),
            "blocks_streamed": float(len(self._sampled)),
            "blocks_skipped": float(skipped),
            "rows_per_sec": (self.n_pad * max(rounds, 1)) / max(wall, 1e-9),
        }
