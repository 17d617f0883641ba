"""Per-leaf f32 sums in row order: the leaf refit of int8/int16 training.

The quantized grower takes its final leaf outputs from the f32 gradient
and hessian sums of each leaf's rows (lightgbm_tpu/ops/grower.py:
1745-1748, two XLA scatter-adds).  XLA:CPU adds each leaf's rows in row
order, and so does `index_add_` on the CPU, which is `leaf_sums_plain`,
the plain twin.  On a CUDA tensor `index_add_` adds with atomics in
arrival order, so `leaf_sums` launches the two kernels of
`csrc/leafsum.cu` there instead: `leaf_group` (the rows' (g, h) pairs
grouped by leaf id, stable in row order, and the [L + 1] offsets of the
leaves; its twin `leaf_group_plain`, a counting sort) and `leaf_sums`
(each leaf's pairs added in order, one chain a leaf).  Its sums are
bitwise the twin's, and the refit-on model text is the same on every
run.

`Booster.refit` takes the same sums in f64 (`out_dtype=torch.float64`):
the JAX package's `np.bincount` of the f64 gradients (gbdt.py:2039-2041)
adds each leaf's rows in row order too.  The twin is `index_add_` in f64
on the CPU, and on the card `leaf_group` feeds the sums kernel's double
instance (counter `leaf_sums_f64`), bitwise the twin's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..utils import compile_ledger
from . import kernels

# rows of the grouping twin's chunk (a one-hot of at most this square)
_PLAIN_CHUNK = 2048


def leaf_sums_plain(leaf_ids: torch.Tensor, vals: torch.Tensor,
                    num_leaves: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[V, L] of out_dtype (f32 or f64): out[v, l] = the sum from +0, in
    row order, of vals[v, r] over the rows r with leaf_ids[r] == l, each
    value widened to out_dtype first.  leaf_ids: [n] int32 in [0, L);
    vals: [V, n] f32."""
    ids = leaf_ids.long()
    return torch.stack([
        torch.zeros(num_leaves, dtype=out_dtype,
                    device=vals.device).index_add_(0, ids, v.to(out_dtype))
        for v in vals])


def leaf_group_plain(leaf_ids: torch.Tensor, vals: torch.Tensor,
                     num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grouped [n, V], offsets [L + 1] int32): row r's values
    vals[:, r] at its place in leaf order, stable in row order, so that
    leaf l's rows are grouped[offsets[l]:offsets[l + 1]].  A counting
    sort: a row's place is its leaf's start plus the rows of its leaf
    before it, counted a chunk of rows at a time over the leaves the
    chunk holds.  leaf_ids: [n] int32 in [0, L); vals: [V, n]."""
    L = int(num_leaves)
    ids = leaf_ids.long()
    dev = leaf_ids.device
    counts = torch.bincount(ids, minlength=L)
    if counts.numel() > L:
        raise ValueError(f"leaf ids must lie in [0, {L})")
    offsets = torch.zeros(L + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    grouped = torch.zeros((ids.numel(), vals.shape[0]), dtype=vals.dtype,
                          device=dev)
    nxt = offsets[:-1].clone()
    for c0 in range(0, ids.numel(), _PLAIN_CHUNK):
        part = ids[c0:c0 + _PLAIN_CHUNK]
        held, local = torch.unique(part, return_inverse=True)
        onehot = torch.nn.functional.one_hot(local, held.numel())
        before = onehot.cumsum(0).gather(1, local[:, None])[:, 0] - 1
        grouped[nxt[part] + before] = vals[:, c0:c0 + _PLAIN_CHUNK].T
        nxt[held] += onehot.sum(0)
    return grouped, offsets.to(torch.int32)


def _check_operands(leaf_ids: torch.Tensor, vals: torch.Tensor,
                    name: str) -> None:
    if leaf_ids.device.type != "cuda":
        raise ValueError(f"kernel {name} takes CUDA tensors, got "
                         f"{leaf_ids.device}")
    if leaf_ids.dtype != torch.int32 or leaf_ids.dim() != 1 \
            or vals.dtype != torch.float32 or vals.dim() != 2 \
            or vals.shape[0] != 2 or vals.shape[1] != leaf_ids.shape[0] \
            or vals.device != leaf_ids.device:
        raise ValueError("leaf_ids must be [n] int32 and vals [2, n] f32 "
                         "(g, h) on the same device")
    if leaf_ids.shape[0] >= 2 ** 31:
        raise ValueError("the card's leaf sums take fewer than 2^31 rows")


def leaf_group_kernel(leaf_ids: torch.Tensor, vals: torch.Tensor,
                      num_leaves: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`leaf_group_plain`'s contract on the card (kernel leaf_group, one
    cooperative launch), for V = 2.  The grouped pairs' buffer holds
    n rounded up to even rows (the sums read it 16 bytes at a time);
    the view returned is its first n."""
    _check_operands(leaf_ids, vals, "leaf_group")
    n = leaf_ids.shape[0]
    L = int(num_leaves)
    if L < 1:
        raise ValueError(f"num_leaves must be at least 1, got {L}")
    dev = leaf_ids.device
    leaf_ids, vals = leaf_ids.contiguous(), vals.contiguous()
    with torch.cuda.device(dev):
        # grid, rows a block, shared memory, counters' place, scratch
        plan = (ctypes.c_int * 5)()
        kernels.check(kernels.library().lgbt_leaf_group_plan(n, L, plan),
                      "leaf_group plan")
        grouped = torch.empty((n + (n & 1), 2), dtype=torch.float32,
                              device=dev)
        offsets = torch.empty(L + 1, dtype=torch.int32, device=dev)
        scratch = torch.empty(plan[4], dtype=torch.int32, device=dev)
        with compile_ledger.launch("leaf_group", "leaf_group", plan,
                                   int(scratch.nbytes)):
            code = kernels.library().lgbt_leaf_group(
                leaf_ids.data_ptr(), vals.data_ptr(), n, L,
                grouped.data_ptr(), offsets.data_ptr(), scratch.data_ptr(),
                plan, torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "leaf_group launch")
    kernels.count("leaf_group")
    return grouped[:n], offsets


# the sums kernel's instance of each output type: (entry, launch counter)
_SUMS = {torch.float32: ("lgbt_leaf_sums", "leaf_sums"),
         torch.float64: ("lgbt_leaf_sums_f64", "leaf_sums_f64")}


def leaf_sums_kernel(leaf_ids: torch.Tensor, vals: torch.Tensor,
                     num_leaves: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`leaf_sums_plain`'s contract on the card, for V = 2: kernel
    leaf_group, then the sums kernel's f32 or f64 instance (two warps a
    leaf)."""
    if out_dtype not in _SUMS:
        raise ValueError(f"the leaf sums are f32 or f64, not {out_dtype}")
    entry, counter = _SUMS[out_dtype]
    grouped, offsets = leaf_group_kernel(leaf_ids, vals, num_leaves)
    L = int(num_leaves)
    out = torch.empty((2, L), dtype=out_dtype, device=vals.device)
    with torch.cuda.device(vals.device), compile_ledger.launch(
            "leaf_sums", counter, (L,)):
        code = getattr(kernels.library(), entry)(
            grouped.data_ptr(), offsets.data_ptr(), out.data_ptr(), L,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, f"{counter} launch")
    kernels.count(counter)
    return out


def leaf_sums(leaf_ids: torch.Tensor, vals: torch.Tensor,
              num_leaves: int,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Per-leaf sums in row order: the kernels on a CUDA tensor, the
    plain twin on a CPU one."""
    if leaf_ids.device.type == "cuda":
        return leaf_sums_kernel(leaf_ids, vals, num_leaves, out_dtype)
    if leaf_ids.device.type == "cpu":
        return leaf_sums_plain(leaf_ids, vals, num_leaves, out_dtype)
    raise ValueError(f"unsupported device {leaf_ids.device}")
