"""Synthetic token pipeline for LM training and serving, draw for draw
the reference's (``data/synthetic.py``): batch i is a pure function of
(seed, i) through numpy's ``default_rng((seed, i))``, so the tokens are
bitwise the reference's. Tokens follow a truncated Zipf law. Batches are
CPU tensors (tokens int32); the caller moves them to its device."""
from __future__ import annotations

import numpy as np
import torch


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                 alpha: float = 1.1) -> np.ndarray:
    # inverse-CDF sampling of a truncated zipf via uniform -> rank
    u = rng.random(shape)
    ranks = np.exp(np.log1p(u * (vocab ** (1 - alpha) - 1)) / (1 - alpha))
    return np.clip(ranks.astype(np.int64), 0, vocab - 1)


class TokenStream:
    """Seekable stream of LM batches: {"tokens": (B, T+1) int32}."""

    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0,
                 zipf_alpha: float = 1.1):
        self.vocab, self.batch, self.seq_len = vocab, batch, seq_len
        self.seed, self.alpha = seed, zipf_alpha

    def batch_at(self, index: int) -> dict:
        rng = np.random.default_rng((self.seed, index))
        toks = _zipf_tokens(rng, (self.batch, self.seq_len + 1), self.vocab,
                            self.alpha)
        return {"tokens": torch.from_numpy(toks.astype(np.int32))}


def make_train_batch(cfg, shape, *, n_tiers: int = 0, seed: int = 0,
                     index: int = 0) -> dict:
    """A train batch {"tokens": (B, T+1)}, or (n_tiers, B/n_tiers, T+1)
    when n_tiers > 0. For VLM also "patches" (..., P, D) in
    ``cfg.dtype``, drawn first, and T - P + 1 text tokens, so that
    patches and text fill T positions. Audio batches are not ported."""
    if cfg.family == "audio":
        raise NotImplementedError("audio batches are not ported yet: "
                                  "ROADMAP queue 1 item 15")
    rng = np.random.default_rng((seed, index))
    b, t = shape.global_batch, shape.seq_len
    lead = (n_tiers, b // n_tiers) if n_tiers else (b,)
    batch = {}
    if cfg.family == "vlm":
        t -= cfg.num_patches
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (*lead, cfg.num_patches, cfg.d_model))).to(
                getattr(torch, cfg.dtype))
    toks = _zipf_tokens(rng, (int(np.prod(lead)), t + 1), cfg.vocab_size)
    batch["tokens"] = torch.from_numpy(
        toks.astype(np.int32).reshape(*lead, t + 1))
    return batch
