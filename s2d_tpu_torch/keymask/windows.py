"""Visibility windows, the port of `s2d_tpu/keymask/windows.py`: cluster the
curves into putative objects and find their visible ranges.

  1. binarize the (N, T) visibility curves at `threshold` (0.3);
  2. DBSCAN(eps=0.2, min_samples=5, hamming) over the binary curves
     (`dbscan.dbscan_hamming`);
  3. per cluster, a per-frame majority vote of its members is the
     cluster's visibility; its contiguous visible stretches are the ranges;
  4. a range's winners are the members visible on more than
     `winner_threshold` (30%) of it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .dbscan import dbscan_hamming


def binarize_curves(curves: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    return np.asarray(curves) >= threshold


def cluster_curves(binary: np.ndarray, eps: float = 0.2, min_samples: int = 5) -> np.ndarray:
    """DBSCAN on hamming distance; returns labels (N,), -1 = noise."""
    return dbscan_hamming(binary, eps, min_samples)


def contiguous_ranges(visible: np.ndarray) -> List[Tuple[int, int]]:
    """Boolean (T,) -> list of [start, end] inclusive visible stretches."""
    ranges = []
    start = None
    for i, v in enumerate(visible):
        if v and start is None:
            start = i
        elif not v and start is not None:
            ranges.append((start, i - 1))
            start = None
    if start is not None:
        ranges.append((start, len(visible) - 1))
    return ranges


def visibility_windows(
    curves: np.ndarray,  # (N, T) float
    threshold: float = 0.3,
    eps: float = 0.2,
    min_samples: int = 5,
    winner_threshold: float = 0.3,
) -> List[dict]:
    """Returns one record per (cluster, range):
    {cluster, range: (start, end), winners: member row indices}."""
    binary = binarize_curves(curves, threshold)
    labels = cluster_curves(binary, eps, min_samples)
    out = []
    for cluster in sorted(set(labels.tolist()) - {-1}):
        members = np.flatnonzero(labels == cluster)
        votes = binary[members].mean(axis=0) >= 0.5  # per-frame majority
        for start, end in contiguous_ranges(votes):
            frac = binary[members, start:end + 1].mean(axis=1)
            out.append(
                {
                    "cluster": int(cluster),
                    "range": (int(start), int(end)),
                    "winners": members[frac > winner_threshold].tolist(),
                }
            )
    return out
