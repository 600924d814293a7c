"""Batching pipelines: per-client mini-batches for the FL simulator and
token batches for the pod trainer."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientBatcher:
    """Per-client mini-batch sampler over a partition (deterministic)."""

    data: np.ndarray            # (n, ...) features
    labels: np.ndarray          # (n,)
    parts: list                 # per-client index arrays
    batch: int                  # M in the paper
    seed: int = 0

    def sample_round(self, round_idx: int, cohort: np.ndarray):
        """Returns (x (len(cohort), M, ...), y (len(cohort), M)) stacked."""
        xs, ys = [], []
        for ci in cohort:
            rng = np.random.default_rng((self.seed, int(ci), round_idx))
            part = self.parts[int(ci)]
            take = rng.choice(part, self.batch, replace=len(part) < self.batch)
            xs.append(self.data[take])
            ys.append(self.labels[take])
        return np.stack(xs), np.stack(ys)


@dataclasses.dataclass
class TokenBatcher:
    """Contiguous LM batches: (clients, per_client_batch, seq+1) slices."""

    tokens: np.ndarray
    seq_len: int
    seed: int = 0

    def sample_round(self, round_idx: int, n_clients: int, per_client: int):
        rng = np.random.default_rng((self.seed, round_idx))
        total = n_clients * per_client
        max_start = len(self.tokens) - self.seq_len - 1
        starts = rng.integers(0, max_start, total)
        windows = np.stack([self.tokens[s : s + self.seq_len + 1] for s in starts])
        windows = windows.reshape(n_clients, per_client, self.seq_len + 1)
        return {"tokens": windows[..., :-1].astype(np.int32),
                "labels": windows[..., 1:].astype(np.int32)}
