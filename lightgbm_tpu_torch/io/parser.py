"""Text data loading: CSV / TSV / LibSVM with autodetection.

A copy of `lightgbm_tpu/io/parser.py` (host only, numpy and pandas): the
port keeps its own because importing `lightgbm_tpu` imports JAX.

Mirrors the reference parser behavior (reference src/io/parser.cpp:222 and
src/io/dataset_loader.cpp:168-330): delimiter + format autodetect from the
first lines, optional header, label column by index or `name:<col>`, and
side-car `.weight` / `.query` / `.init` files next to the data file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _detect_format(first_lines: List[str]) -> Tuple[str, str]:
    """Return (kind, delimiter) with kind in {'libsvm','csv','tsv','space'}."""
    for line in first_lines:
        toks = line.strip().split()
        if len(toks) >= 2 and ":" in toks[1]:
            parts = toks[1].split(":")
            if len(parts) == 2:
                try:
                    int(parts[0]); float(parts[1])
                    return "libsvm", " "
                except ValueError:
                    pass
        if "\t" in line:
            return "tsv", "\t"
        if "," in line:
            return "csv", ","
    return "space", " "


def _has_header(line: str, delim: str) -> bool:
    toks = [t for t in line.strip().split(delim) if t != ""]
    for t in toks:
        try:
            float(t)
            return False
        except ValueError:
            continue
    return len(toks) > 0


def load_text_file(path: str, label_column: Optional[str] = "",
                   header: Optional[bool] = None, num_features_hint: int = 0
                   ) -> Tuple[np.ndarray, Optional[np.ndarray],
                              Optional[np.ndarray], Optional[np.ndarray],
                              Optional[np.ndarray], List[str]]:
    """Load a training/prediction text file.

    Returns (X [n,F] float64 w/ NaN for missing, y [n], weight or None,
    group_sizes or None, init_score or None, feature_names).
    label_column=None: a CSV/TSV file without a label column, every
    column a feature, and y None (a LibSVM line always starts with its
    label).
    """
    with open(path) as f:
        head = []
        for _ in range(5):
            line = f.readline()
            if not line:
                break
            if line.strip():
                head.append(line)
    if not head:
        raise ValueError(f"empty data file {path}")
    kind, delim = _detect_format(head)

    label_idx = 0
    label_name = None
    if label_column:
        if str(label_column).startswith("name:"):
            label_name = str(label_column)[5:]
        elif str(label_column) != "":
            label_idx = int(label_column)

    feature_names: List[str] = []
    if kind == "libsvm":
        X, y = _load_libsvm(path, num_features_hint)
        feature_names = [f"Column_{i}" for i in range(X.shape[1])]
    else:
        import pandas as pd
        use_header = _has_header(head[0], delim) if header is None else header
        df = pd.read_csv(path, sep=delim, header=0 if use_header else None,
                         na_values=["", "NA", "N/A", "nan", "NaN", "null"])
        arr = df.to_numpy(dtype=np.float64)
        if label_column is None:
            feature_names = ([str(c) for c in df.columns] if use_header
                             else [f"Column_{i}" for i in range(df.shape[1])])
            X, y = arr, None
        else:
            if use_header:
                cols = [str(c) for c in df.columns]
                if label_name is not None:
                    label_idx = cols.index(label_name)
                feature_names = [c for i, c in enumerate(cols)
                                 if i != label_idx]
            else:
                feature_names = [f"Column_{i}"
                                 for i in range(df.shape[1] - 1)]
            y = arr[:, label_idx].copy()
            X = np.delete(arr, label_idx, axis=1)

    weight, group_arr, init_score = load_sidecars(path)
    return X, y, weight, group_arr, init_score, feature_names


def load_sidecars(path):
    """(weight, group_sizes int64 or None, init_score) side-car files
    next to the data file (reference dataset_loader.cpp metadata files)."""
    weight = _load_sidecar(path + ".weight")
    group = _load_sidecar(path + ".query")
    if group is None:
        group = _load_sidecar(path + ".group")
    init_score = _load_sidecar(path + ".init")
    group_arr = group.astype(np.int64) if group is not None else None
    return weight, group_arr, init_score


def _load_sidecar(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    vals = np.loadtxt(path, dtype=np.float64, ndmin=1)
    return vals


def _load_libsvm(path: str, num_features_hint: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    labels: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = -1
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            toks = line.split()
            labels.append(float(toks[0]))
            row: Dict[int, float] = {}
            for tok in toks[1:]:
                k, v = tok.split(":")
                idx = int(k)
                row[idx] = float(v)
                max_idx = max(max_idx, idx)
            rows.append(row)
    nf = max(max_idx + 1, num_features_hint)
    X = np.zeros((len(rows), nf), dtype=np.float64)
    for i, row in enumerate(rows):
        for k, v in row.items():
            X[i, k] = v
    return X, np.asarray(labels, dtype=np.float64)


class NoStreamingReader(ValueError):
    """TextChunkReader's refusal of a file it does not stream (LibSVM);
    two-round loading then falls back to the one-pass load."""


class TextChunkReader:
    """Streaming chunk reader for CSV/TSV/space files (two-round loading).

    The reference's two_round path never holds the raw matrix: one pass
    samples rows for bin finding, a second streams rows straight into bins
    (reference src/io/dataset_loader.cpp:188-216).  LibSVM files fall back
    to one-pass loading (load_text_file) — the sparse format is small on
    disk by construction.
    """

    def __init__(self, path: str, label_column: str = "",
                 header: Optional[bool] = None, chunk_rows: int = 200_000):
        self.path = path
        self.chunk_rows = int(chunk_rows)
        with open(path) as f:
            head = []
            for _ in range(5):
                line = f.readline()
                if not line:
                    break
                if line.strip():
                    head.append(line)
        if not head:
            raise ValueError(f"empty data file {path}")
        self.kind, self.delim = _detect_format(head)
        if self.kind == "libsvm":
            raise NoStreamingReader("TextChunkReader does not stream libsvm")
        self.use_header = (_has_header(head[0], self.delim)
                           if header is None else header)
        self.label_idx = 0
        label_name = None
        if label_column:
            if str(label_column).startswith("name:"):
                label_name = str(label_column)[5:]
            elif str(label_column) != "":
                self.label_idx = int(label_column)
        if self.use_header:
            # pandas-parsed names (quoting/padding aware) so the streaming
            # path resolves label names exactly like load_text_file
            import pandas as pd

            cols = [str(c) for c in pd.read_csv(
                path, sep=self.delim, nrows=0).columns]
            if label_name is not None:
                self.label_idx = cols.index(label_name)
            self.feature_names = [c for i, c in enumerate(cols)
                                  if i != self.label_idx]
        else:
            ncol = len([t for t in head[0].strip().split(self.delim)
                        if t != ""])
            self.feature_names = [f"Column_{i}" for i in range(ncol - 1)]

    def chunks(self):
        """Yield (X_chunk [m,F] f64, y_chunk [m]) in file order."""
        import pandas as pd

        reader = pd.read_csv(
            self.path, sep=self.delim,
            header=0 if self.use_header else None,
            na_values=["", "NA", "N/A", "nan", "NaN", "null"],
            chunksize=self.chunk_rows)
        for df in reader:
            arr = df.to_numpy(dtype=np.float64)
            y = arr[:, self.label_idx].copy()
            X = np.delete(arr, self.label_idx, axis=1)
            yield X, y
