"""Deterministic synthetic datasets (offline container: no downloads).

* :class:`SyntheticImages` — CIFAR-like labelled images whose classes are
  separable (class-dependent means + structured noise), so training curves
  behave like the paper's Fig. 2 (loss decreases, quantization hurts in a
  controlled way) while staying fully reproducible.
* :class:`SyntheticTokens` — a Zipf-ish Markov token stream for LM-family
  end-to-end runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImages:
    n: int = 50_000
    n_classes: int = 10
    hw: int = 32
    channels: int = 3
    seed: int = 0

    def generate(self):
        """Returns (images f32 (n, hw, hw, c), labels int32 (n,))."""
        rng = np.random.default_rng(self.seed)
        labels = rng.integers(0, self.n_classes, self.n).astype(np.int32)
        # class templates: low-frequency patterns
        yy, xx = np.mgrid[0:self.hw, 0:self.hw] / self.hw
        templates = np.stack([
            np.sin(2 * np.pi * ((k % 3 + 1) * xx + (k % 5) * yy + k / self.n_classes))
            for k in range(self.n_classes)
        ])  # (K, hw, hw)
        imgs = templates[labels][..., None].repeat(self.channels, -1)
        imgs = imgs * (0.5 + 0.1 * (labels % 4))[:, None, None, None]
        imgs = imgs + 0.22 * rng.standard_normal(imgs.shape)
        return imgs.astype(np.float32), labels


@dataclasses.dataclass
class SyntheticTokens:
    n_tokens: int = 2_000_000
    vocab: int = 512
    seed: int = 0

    def generate(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        # sparse Markov chain over a Zipf marginal
        ranks = np.arange(1, self.vocab + 1)
        marginal = 1.0 / ranks
        marginal /= marginal.sum()
        # each token deterministically biases the next towards (t*7+3) % V
        out = np.empty(self.n_tokens, np.int32)
        t = 0
        base = rng.choice(self.vocab, self.n_tokens, p=marginal)
        jump = rng.random(self.n_tokens) < 0.65
        for i in range(self.n_tokens):
            t = (t * 7 + 3) % self.vocab if jump[i] else int(base[i])
            out[i] = t
        return out
