"""Clustering quality metrics: NMI and ARI (paper §V, Table III).

Pure numpy implementations (evaluation is host-side); definitions match the
standard ones (NMI with arithmetic-mean normalization, ARI per Hubert &
Arabie 1985). Inputs to NMI/ARI are
integer label vectors; ``-1`` labels (unassigned) are dropped from both
vectors. Degenerate inputs — every point filtered out, or fewer than two
points/clusters surviving, where mutual information and the adjusted Rand
numerator are identically zero — score 0.0 by definition (no information
recovered), never NaN.
"""

from __future__ import annotations

import numpy as np

__all__ = ["contingency", "nmi", "ari", "cocluster_scores"]


def _clean(a, b):
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label shape mismatch: {a.shape} vs {b.shape}")
    keep = (a >= 0) & (b >= 0)
    return a[keep], b[keep]


def contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Contingency table (k_a, k_b) of two label vectors."""
    a, b = _clean(a, b)
    ka = int(a.max()) + 1 if a.size else 1
    kb = int(b.max()) + 1 if b.size else 1
    table = np.zeros((ka, kb), np.int64)
    np.add.at(table, (a, b), 1)
    return table


def nmi(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized mutual information, arithmetic normalization in [0, 1].

    Degenerate inputs score 0.0: an empty intersection (every point
    filtered as unassigned) carries no information, and a single-cluster
    labeling has zero entropy — MI is identically 0 and the normalizer
    vanishes, so the 0/0 is *defined* as 0.0 rather than NaN (the
    boundary the overlap mode's outlier filtering can actually reach).
    """
    t = contingency(a, b).astype(np.float64)
    n = t.sum()
    if n == 0:
        return 0.0
    pa = t.sum(1) / n
    pb = t.sum(0) / n
    pab = t / n
    with np.errstate(divide="ignore", invalid="ignore"):
        mi_terms = pab * (np.log(pab) - np.log(pa[:, None]) - np.log(pb[None, :]))
    mi = np.nansum(mi_terms)
    ha = -np.sum(pa * np.where(pa > 0, np.log(np.where(pa > 0, pa, 1.0)), 0.0))
    hb = -np.sum(pb * np.where(pb > 0, np.log(np.where(pb > 0, pb, 1.0)), 0.0))
    denom = 0.5 * (ha + hb)
    if denom <= 0:
        return 0.0
    return float(np.clip(mi / denom, 0.0, 1.0))


def ari(a: np.ndarray, b: np.ndarray) -> float:
    """Adjusted Rand index in [-1, 1].

    Degenerate inputs score 0.0 (chance level): fewer than two surviving
    points have no pairs to agree on, and the both-single-cluster /
    all-singletons boundary has ``max_index == expected`` — the adjusted
    numerator and denominator are both identically zero, so the 0/0 is
    defined as 0.0 rather than a division error.
    """
    t = contingency(a, b).astype(np.float64)
    n = t.sum()
    if n < 2:
        return 0.0
    comb = lambda x: x * (x - 1.0) / 2.0
    sum_ij = comb(t).sum()
    sum_a = comb(t.sum(1)).sum()
    sum_b = comb(t.sum(0)).sum()
    expected = sum_a * sum_b / comb(n)
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:
        return 0.0
    return float((sum_ij - expected) / (max_index - expected))


def cocluster_scores(
    row_pred, col_pred, row_true, col_true
) -> dict[str, float]:
    """Joint co-clustering quality: average of row and column NMI/ARI
    (the convention used for Table III-style reporting)."""
    return {
        "row_nmi": nmi(row_pred, row_true),
        "col_nmi": nmi(col_pred, col_true),
        "row_ari": ari(row_pred, row_true),
        "col_ari": ari(col_pred, col_true),
        "nmi": 0.5 * (nmi(row_pred, row_true) + nmi(col_pred, col_true)),
        "ari": 0.5 * (ari(row_pred, row_true) + ari(col_pred, col_true)),
    }
