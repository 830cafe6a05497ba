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


def stub_input(cfg):
    """(batch key, positions) of the stub embeddings a family takes beside
    its tokens: audio frames, VLM patches; None for the others."""
    return {"audio": ("frames", cfg.encoder_seq),
            "vlm": ("patches", cfg.num_patches)}.get(cfg.family)


def make_train_batch(cfg, shape, *, n_tiers: int = 0, seed: int = 0,
                     index: int = 0) -> dict:
    """A train batch {"tokens": (B, T+1)}, or (n_tiers, B/n_tiers, T+1)
    when n_tiers > 0. For audio also "frames" (..., encoder_seq, D) and
    for VLM "patches" (..., P, D), in ``cfg.dtype`` and drawn before the
    tokens; VLM takes T - P + 1 text tokens, so that patches and text
    fill T positions."""
    rng = np.random.default_rng((seed, index))
    b, t = shape.global_batch, shape.seq_len
    lead = (n_tiers, b // n_tiers) if n_tiers else (b,)
    batch = {}
    stub = stub_input(cfg)
    if stub is not None:
        name, n = stub
        batch[name] = torch.from_numpy(rng.standard_normal(
            (*lead, n, cfg.d_model))).to(getattr(torch, cfg.dtype))
    if cfg.family == "vlm":
        t -= cfg.num_patches
    toks = _zipf_tokens(rng, (int(np.prod(lead)), t + 1), cfg.vocab_size)
    batch["tokens"] = torch.from_numpy(
        toks.astype(np.int32).reshape(*lead, t + 1))
    return batch
