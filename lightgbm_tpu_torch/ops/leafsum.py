"""Per-leaf f32 sums in row order: the leaf refit of int8/int16 training.

The quantized grower takes its final leaf outputs from the f32 gradient
and hessian sums of each leaf's rows (lightgbm_tpu/ops/grower.py:
1745-1748, two XLA scatter-adds).  XLA:CPU adds each leaf's rows in row
order, and so does `index_add_` on the CPU, which is `leaf_sums_plain`,
the plain twin.  On a CUDA tensor `index_add_` adds with atomics in
arrival order, so `leaf_sums` launches `csrc/leafsum.cu` there instead:
a stable sort of the leaf ids, then one thread per (leaf, value row)
walking that leaf's rows in order.  Its sums are bitwise the twin's, and
the refit-on model text is the same on every run.
"""

from __future__ import annotations

import torch

from . import kernels


def leaf_sums_plain(leaf_ids: torch.Tensor, vals: torch.Tensor,
                    num_leaves: int) -> torch.Tensor:
    """[V, L] f32: out[v, l] = the sum, in row order, of vals[v, r] over
    the rows r with leaf_ids[r] == l.  leaf_ids: [n] int32 in [0, L);
    vals: [V, n] f32."""
    ids = leaf_ids.long()
    return torch.stack([
        torch.zeros(num_leaves, dtype=torch.float32,
                    device=vals.device).index_add_(0, ids, v)
        for v in vals])


def leaf_sums_kernel(leaf_ids: torch.Tensor, vals: torch.Tensor,
                     num_leaves: int) -> torch.Tensor:
    """`leaf_sums_plain`'s contract on the card (kernel leaf_sums)."""
    if leaf_ids.device.type != "cuda":
        raise ValueError(f"kernel leaf_sums takes CUDA tensors, got "
                         f"{leaf_ids.device}")
    if leaf_ids.dtype != torch.int32 or vals.dtype != torch.float32 \
            or vals.dim() != 2 or vals.shape[1] != leaf_ids.shape[0] \
            or vals.device != leaf_ids.device:
        raise ValueError("leaf_ids must be [n] int32 and vals [V, n] f32 on "
                         "the same device")
    V, n = vals.shape
    L = int(num_leaves)
    sorted_ids, order = torch.sort(leaf_ids, stable=True)
    sorted_vals = vals[:, order].contiguous()
    offsets = torch.searchsorted(
        sorted_ids, torch.arange(L + 1, dtype=torch.int32,
                                 device=leaf_ids.device),
        out_int32=True)
    out = torch.empty((V, L), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        code = kernels.library().lgbt_leaf_sums(
            sorted_vals.data_ptr(), offsets.data_ptr(), out.data_ptr(), V, L,
            n, torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "leaf_sums launch")
    kernels.launches["leaf_sums"] += 1
    return out


def leaf_sums(leaf_ids: torch.Tensor, vals: torch.Tensor,
              num_leaves: int) -> torch.Tensor:
    """Per-leaf sums in row order: the kernel on a CUDA tensor, the
    plain twin on a CPU one."""
    if leaf_ids.device.type == "cuda":
        return leaf_sums_kernel(leaf_ids, vals, num_leaves)
    if leaf_ids.device.type == "cpu":
        return leaf_sums_plain(leaf_ids, vals, num_leaves)
    raise ValueError(f"unsupported device {leaf_ids.device}")
