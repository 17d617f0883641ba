"""The row-partition kernel (tpu_partition_impl=kernel).

The port of `lightgbm_tpu/ops/fused.py:partition_rows`: the K-way
frontier partition in one pass over the rows.  On a CUDA tensor it
launches kernel B3 (`csrc/partition.cu`); on a CPU tensor it runs
`partition_rows_plain`, the "vselect" integer math in plain PyTorch.
Both are bitwise equal to the "vselect" lowering.

The grow megakernel of the JAX module (`fused_hist_scan`) is not ported
yet.
"""

from __future__ import annotations

import torch

from . import kernels
from .split import numeric_go_left


def partition_rows_plain(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                         dleft, mt, nbf, db, do_k) -> torch.Tensor:
    """The "vselect" partition: [n] int32 updated leaf ids.

    bins_t: [F, n] bins; sel_feat/sel/new_ids/thr/mt/nbf/db: [K] int32;
    dleft/do_k: [K] bool."""
    cols = bins_t[sel_feat.long()].to(torch.int32)              # [K, n]
    go_left = numeric_go_left(cols, mt[:, None], nbf[:, None], db[:, None],
                              thr[:, None], dleft[:, None])
    move = (leaf_ids[None, :] == sel[:, None]) & do_k[:, None] & ~go_left
    # each row sits in at most one frontier leaf: the max over slots is
    # its unique new id, -1 = stay
    moved_to = torch.where(move, new_ids[:, None].to(torch.int32),
                           -1).amax(dim=0)
    return torch.where(moved_to >= 0, moved_to, leaf_ids)


def partition_rows_kernel(bins_t, sel_feat, leaf_ids, sel, new_ids, thr,
                          dleft, mt, nbf, db, do_k) -> torch.Tensor:
    """Kernel B3 on the card."""
    F, n = bins_t.shape
    K = sel.shape[0]
    if bins_t.device.type != "cuda":
        raise ValueError(f"kernel B3 takes CUDA tensors, got {bins_t.device}")
    if bins_t.dtype != torch.uint8 or not bins_t.is_contiguous():
        raise ValueError("bins_t must be a contiguous uint8 [F, n] tensor")
    if leaf_ids.dtype != torch.int32 or leaf_ids.shape != (n,) \
            or not leaf_ids.is_contiguous():
        raise ValueError("leaf_ids must be a contiguous int32 [n] tensor")
    for name, t in (("sel_feat", sel_feat), ("sel", sel),
                    ("new_ids", new_ids), ("thr", thr), ("dleft", dleft),
                    ("mt", mt), ("nbf", nbf), ("db", db), ("do_k", do_k)):
        if t.shape != (K,) or t.device != bins_t.device:
            raise ValueError(f"{name} must be a [{K}] tensor on "
                             f"{bins_t.device}")
    ints = torch.stack([sel, new_ids, thr, dleft, mt, nbf, db, do_k],
                       dim=1).to(torch.int32).contiguous()       # [K, 8]
    feat = sel_feat.to(torch.int32).contiguous()
    out = torch.empty_like(leaf_ids)
    lib = kernels.library()
    with torch.cuda.device(bins_t.device):
        code = lib.lgbt_partition_rows(
            bins_t.data_ptr(), n, feat.data_ptr(), ints.data_ptr(),
            leaf_ids.data_ptr(), out.data_ptr(), K,
            torch.cuda.current_stream().cuda_stream)
    kernels.check(code, "partition_rows launch")
    kernels.launches["partition_rows"] += 1
    return out


def partition_rows(bins_t, sel_feat, leaf_ids, sel, new_ids, thr, dleft,
                   mt, nbf, db, do_k) -> torch.Tensor:
    """Row->leaf partition of K splits at once: [n] int32 leaf ids.

    Slot k moves the rows of leaf sel[k] whose bin in feature
    sel_feat[k] does not go left to new_ids[k], when do_k[k]."""
    if bins_t.device.type == "cuda":
        return partition_rows_kernel(bins_t, sel_feat, leaf_ids, sel,
                                     new_ids, thr, dleft, mt, nbf, db, do_k)
    if bins_t.device.type == "cpu":
        return partition_rows_plain(bins_t, sel_feat, leaf_ids, sel,
                                    new_ids, thr, dleft, mt, nbf, db, do_k)
    raise ValueError(f"unsupported device {bins_t.device}")
