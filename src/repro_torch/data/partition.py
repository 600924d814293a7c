"""Non-iid client partitioning (paper §5.1: "non-i.i.d setting")."""

from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float = 0.3,
                        *, seed: int = 0, min_per_client: int = 8) -> list[np.ndarray]:
    """Standard Dirichlet(alpha) label-skew partition.

    Smaller alpha => more heterogeneous clients (paper Assumption 3's phi
    grows).  Returns per-client index arrays covering the dataset.
    """
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for ix in idx_by_class:
        rng.shuffle(ix)
    for attempt in range(100):
        props = rng.dirichlet([alpha] * n_clients, n_classes)  # (C, N)
        client_bins: list[list[np.ndarray]] = [[] for _ in range(n_clients)]
        for c, ix in enumerate(idx_by_class):
            cuts = (np.cumsum(props[c])[:-1] * len(ix)).astype(int)
            for i, part in enumerate(np.split(ix, cuts)):
                client_bins[i].append(part)
        parts = [np.concatenate(b) if b else np.empty(0, int) for b in client_bins]
        if min(len(p) for p in parts) >= min_per_client:
            break
    for p in parts:
        rng.shuffle(p)
    return parts


def heterogeneity_phi(labels: np.ndarray, parts: list[np.ndarray]) -> float:
    """Empirical proxy for Assumption 3's phi: mean TV distance of client
    label distributions from the global one."""
    n_classes = int(labels.max()) + 1
    glob = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for p in parts:
        if len(p) == 0:
            continue
        loc = np.bincount(labels[p], minlength=n_classes) / len(p)
        tvs.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tvs))
