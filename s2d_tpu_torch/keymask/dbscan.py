"""DBSCAN with the hamming metric, giving exactly the `labels_` of
scikit-learn 1.x's `DBSCAN(eps, min_samples, metric="hamming")`; the JAX
package calls scikit-learn, which the port does not need.

scikit-learn's semantics, which this follows step by step:
  * j is a neighbour of i when (differing features) / n_features <= eps,
    in float64; every point is its own neighbour, and counts toward
    `min_samples`;
  * a core point has at least `min_samples` neighbours;
  * clusters are the connected components of the core points under the
    neighbour relation, numbered 0, 1, ... in order of their lowest core
    index (`dbscan_inner` starts a depth-first search at each unlabelled
    core point in index order);
  * a non-core point takes the label of the first such cluster with a core
    neighbour of it (the first search to reach it), else -1 (noise).
"""
from __future__ import annotations

import numpy as np


def hamming_neighbours(x: np.ndarray, eps: float) -> np.ndarray:
    """(N, F) -> (N, N) bool: the hamming distance of rows i, j <= eps."""
    x = np.asarray(x)
    n, f = x.shape
    if f == 0:
        return np.ones((n, n), bool)
    differ = np.zeros((n, n), np.int64)
    for j in range(f):  # one feature at a time: N^2 work, no (N, N, F) array
        col = x[:, j]
        differ += col[:, None] != col[None, :]
    return differ / np.float64(f) <= eps


def dbscan_hamming(x: np.ndarray, eps: float = 0.5, min_samples: int = 5) -> np.ndarray:
    """Labels (N,) int64 of the rows of `x` (N, F); -1 is noise."""
    x = np.asarray(x)
    n = len(x)
    if n == 0:
        return np.zeros((0,), np.int64)
    nbr = hamming_neighbours(x, eps)
    core = nbr.sum(axis=1) >= min_samples
    labels = np.full(n, -1, np.int64)
    label = 0
    for i in np.flatnonzero(core):
        if labels[i] != -1:
            continue
        labels[i] = label
        stack = [i]
        while stack:  # the component of i over core-core edges
            k = stack.pop()
            for j in np.flatnonzero(nbr[k] & core & (labels == -1)):
                labels[j] = label
                stack.append(j)
        label += 1
    for i in np.flatnonzero(~core):
        near = labels[nbr[i] & core]
        if len(near):
            labels[i] = near.min()
    return labels
