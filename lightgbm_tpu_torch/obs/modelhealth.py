"""Training reference profiles: the `tpu_feature_profile:` model trailer.

A copy of the host-only half of `lightgbm_tpu/obs/modelhealth.py` (the
JAX package imports JAX from its package root, so the port keeps its own
copy): per-feature bin occupancy from each used mapper's `cnt_in_bin`,
NaN and zero fractions, label stats and the end-of-training raw-score
histogram, captured when the model is saved and written as one JSON
line after the `tpu_bin_mappers:` trailer.  The payload's key order is
fixed, so the line round-trips byte for byte through save and load, and
a model of either package carries the same line for the same training.
The serving-side drift monitor of the JAX module is not ported.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

#: model-string trailer marker (same convention as ``tpu_bin_mappers:``)
PROFILE_MARKER = "tpu_feature_profile:"

#: default raw-score histogram resolution (``tpu_profile_score_bins``)
DEFAULT_SCORE_BINS = 32


def _proportions(counts: np.ndarray, smooth: float) -> np.ndarray:
    c = np.asarray(counts, np.float64) + np.float64(smooth)
    return c / c.sum()


def psi(expected: Sequence[float], observed: Sequence[float]) -> float:
    """Population Stability Index between two count vectors.

    ``sum((o_i - e_i) * ln(o_i / e_i))`` over add-0.5-smoothed,
    normalized proportions, in float64.  Returns 0.0 when either side
    carries no counts (no evidence is not drift)."""
    e = np.asarray(expected, np.float64)
    o = np.asarray(observed, np.float64)
    if e.size == 0 or e.sum() <= 0 or o.sum() <= 0:
        return 0.0
    ep = _proportions(e, 0.5)
    op = _proportions(o, 0.5)
    return float(np.sum((op - ep) * np.log(op / ep)))


def js_divergence(expected: Sequence[float],
                  observed: Sequence[float]) -> float:
    """Jensen-Shannon divergence (natural log, so the bound is ln 2)
    between two count vectors, float64, no smoothing — zero bins
    contribute 0 by the 0*log(0)=0 convention."""
    e = np.asarray(expected, np.float64)
    o = np.asarray(observed, np.float64)
    if e.size == 0 or e.sum() <= 0 or o.sum() <= 0:
        return 0.0
    p = e / e.sum()
    q = o / o.sum()
    m = 0.5 * (p + q)
    with np.errstate(divide="ignore", invalid="ignore"):
        kl_p = np.where(p > 0, p * np.log(p / m), 0.0)
        kl_q = np.where(q > 0, q * np.log(q / m), 0.0)
    return float(0.5 * kl_p.sum() + 0.5 * kl_q.sum())


def bin_occupancy(bins: np.ndarray, num_bin: int) -> np.ndarray:
    """Exact int64 occupancy of one already-binned column."""
    return np.bincount(np.asarray(bins, np.int64),
                       minlength=int(num_bin)).astype(np.int64)


def score_hist_counts(edges: Sequence[float],
                      values: np.ndarray) -> np.ndarray:
    """int64 histogram of `values` over fixed `edges` (len B+1); out-of-
    range values clip into the boundary bins, non-finite values drop."""
    e = np.asarray(edges, np.float64)
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0 or e.size < 2:
        return np.zeros(max(e.size - 1, 0), np.int64)
    idx = np.clip(np.searchsorted(e[1:-1], v, side="right"),
                  0, e.size - 2)
    return np.bincount(idx, minlength=e.size - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# training reference profile
# ---------------------------------------------------------------------------
class FeatureProfile:
    """The training-time statistical reference a drift monitor compares
    against.  Payload layout is deterministic (fixed key order, plain
    int/float JSON scalars) so `to_line()` bytes survive
    save -> load -> save unchanged."""

    def __init__(self, features: Dict[int, Dict], label: Dict,
                 score_edges: List[float], score_counts: List[List[int]]):
        self.features = features          # real feature idx -> stats
        self.label = label
        self.score_edges = score_edges
        self.score_counts = score_counts  # one count row per class

    # -- capture --------------------------------------------------------
    @classmethod
    def from_training(cls, td, feature_names: Sequence[str],
                      raw_scores: np.ndarray,
                      score_bins: int = DEFAULT_SCORE_BINS
                      ) -> Optional["FeatureProfile"]:
        """Capture from a live TrainingData + the end-of-training raw
        scores ([k, n] float).  Occupancy comes from each used mapper's
        ``cnt_in_bin`` (the reference's own sample counts); mappers
        without counts (deserialized) are skipped.  Returns None when
        nothing is capturable."""
        from ..io.bin_mapper import MissingType

        features: Dict[int, Dict] = {}
        used = list(getattr(td, "used_feature_idx", []))
        for c in used:
            m = td.mappers[c]
            cnt = [int(x) for x in m.cnt_in_bin]
            if m.is_trivial or not cnt:
                continue
            total = max(sum(cnt), 1)
            # the last bin is a NaN bin only when one actually exists:
            # numerical NAN mappers always reserve it, but a TRUNCATED
            # categorical sets missing_type=NAN with the last bin being
            # a real category plus the rare-tail remainder — counting
            # that as NaN mass would bias every nan_delta afterwards
            if int(m.bin_type) == 0:
                has_nan_bin = m.missing_type == MissingType.NAN
            else:
                has_nan_bin = (bool(m.bin_2_categorical)
                               and m.bin_2_categorical[-1] == -1)
            nan_frac = cnt[-1] / total if has_nan_bin else 0.0
            zero_frac = (cnt[m.default_bin] / total
                         if int(m.bin_type) == 0
                         and 0 <= m.default_bin < len(cnt) else 0.0)
            name = (str(feature_names[c]) if c < len(feature_names)
                    else f"Column_{c}")
            features[int(c)] = {
                "name": name, "bin_type": int(m.bin_type),
                "num_bin": int(m.num_bin), "cnt": cnt,
                "nan_frac": float(nan_frac),
                "zero_frac": float(zero_frac)}
        if not features:
            return None
        y = np.asarray(td.metadata.label, np.float64)
        label = {"n": int(y.size),
                 "mean": float(y.mean()) if y.size else 0.0,
                 "std": float(y.std()) if y.size else 0.0,
                 "min": float(y.min()) if y.size else 0.0,
                 "max": float(y.max()) if y.size else 0.0}
        s = np.asarray(raw_scores, np.float64)
        if s.ndim == 1:
            s = s[None, :]
        fin = s[np.isfinite(s)]
        lo = float(fin.min()) if fin.size else 0.0
        hi = float(fin.max()) if fin.size else 1.0
        if hi <= lo:
            hi = lo + 1.0
        nb = max(int(score_bins), 2)
        edges = [float(x) for x in np.linspace(lo, hi, nb + 1)]
        counts = [[int(x) for x in score_hist_counts(edges, row)]
                  for row in s]
        return cls(features, label, edges, counts)

    # -- serialization --------------------------------------------------
    def to_payload(self) -> Dict:
        """JSON payload, deterministic key order (features sorted by
        index) — the byte-identity contract of the trailer."""
        return {
            "version": 1,
            "features": {str(c): {
                "name": f["name"], "bin_type": int(f["bin_type"]),
                "num_bin": int(f["num_bin"]),
                "cnt": [int(x) for x in f["cnt"]],
                "nan_frac": float(f["nan_frac"]),
                "zero_frac": float(f["zero_frac"]),
            } for c, f in sorted(self.features.items())},
            "label": {k: (int(self.label[k]) if k == "n"
                          else float(self.label[k]))
                      for k in ("n", "mean", "std", "min", "max")},
            "score": {"edges": [float(x) for x in self.score_edges],
                      "counts": [[int(x) for x in row]
                                 for row in self.score_counts]},
        }

    @classmethod
    def from_payload(cls, payload: Dict) -> "FeatureProfile":
        features = {int(c): {
            "name": str(f["name"]), "bin_type": int(f["bin_type"]),
            "num_bin": int(f["num_bin"]),
            "cnt": [int(x) for x in f["cnt"]],
            "nan_frac": float(f["nan_frac"]),
            "zero_frac": float(f["zero_frac"]),
        } for c, f in payload["features"].items()}
        label = {k: (int(payload["label"][k]) if k == "n"
                     else float(payload["label"][k]))
                 for k in ("n", "mean", "std", "min", "max")}
        score = payload["score"]
        return cls(features, label,
                   [float(x) for x in score["edges"]],
                   [[int(x) for x in row] for row in score["counts"]])

    def to_line(self) -> str:
        """The full trailer line, newline-terminated."""
        return PROFILE_MARKER + json.dumps(self.to_payload()) + "\n"

    def summary(self) -> Dict:
        """Compact human-facing digest (model_report)."""
        return {
            "features": len(self.features),
            "label": dict(self.label),
            "score_bins": len(self.score_edges) - 1,
            "score_classes": len(self.score_counts),
            "nan_frac_max": max((f["nan_frac"]
                                 for f in self.features.values()),
                                default=0.0),
        }


def split_profile_trailer(text: str):
    """Split a model string into (model_text, FeatureProfile | None) —
    the ``tpu_feature_profile:`` analog of `_split_mapper_snapshot`."""
    marker = "\n" + PROFILE_MARKER
    pos = text.rfind(marker)
    if pos < 0:
        return text, None
    line_end = text.find("\n", pos + 1)
    payload = text[pos + len(marker): len(text) if line_end < 0
                   else line_end].strip()
    rest = "" if line_end < 0 else text[line_end:]
    try:
        prof = FeatureProfile.from_payload(json.loads(payload))
    except (json.JSONDecodeError, KeyError, ValueError, TypeError) as exc:
        raise ValueError(
            f"corrupt tpu_feature_profile line in model: {payload[:80]!r}"
        ) from exc
    return text[:pos] + rest, prof

