"""Model registry: one uniform interface per architecture family.

``get_model(cfg)`` returns a namespace with:
  init(key, device=None)                          -> params
  loss_fn(params, batch, *, num_groups)           -> scalar loss      (train)
  prefill(params, batch, *, window, num_groups)   -> (logits, cache)  (prefill)
  decode_step(params, cache, tokens, pos, *, num_groups)
                                                  -> (logits, cache)  (decode)
  init_cache(batch, cache_len, device=None)       -> cache dict

The decoder's families (dense, MoE, VLM) are ported; the others raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

from repro_torch.models import decoder

_NOT_PORTED = {
    "ssm": "item 13 (xLSTM family)",
    "hybrid": "item 14 (Zamba hybrid family)",
    "audio": "item 15 (Whisper encoder-decoder)",
}


def get_model(cfg) -> SimpleNamespace:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"the {fam} family is not ported yet: "
                                  f"ROADMAP queue 1 {_NOT_PORTED[fam]}")
    if fam not in ("dense", "moe", "vlm"):
        raise ValueError(f"unknown family {fam!r}")

    def prefill(params, batch, *, window=0, num_groups=1):
        return decoder.prefill(params, batch["tokens"], cfg,
                               patches=batch.get("patches"), window=window,
                               num_groups=num_groups)

    return SimpleNamespace(
        cfg=cfg,
        init=functools.partial(decoder.init, cfg=cfg),
        loss_fn=functools.partial(decoder.loss_fn, cfg=cfg),
        prefill=prefill,
        decode_step=functools.partial(decoder.decode_step, cfg=cfg),
        init_cache=functools.partial(decoder.init_cache, cfg),
    )
