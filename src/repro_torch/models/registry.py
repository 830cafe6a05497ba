"""Model registry: one uniform interface per architecture family.

``get_model(cfg)`` returns a namespace with:
  init(key, device=None)                          -> params
  loss_fn(params, batch, *, num_groups)           -> scalar loss      (train)
  prefill(params, batch, *, window, num_groups)   -> (logits, cache)  (prefill)
  decode_step(params, cache, tokens, pos, *, window, num_groups)
                                                  -> (logits, cache)  (decode)
  init_cache(batch, cache_len, device=None)       -> cache dict

The decoder's families (dense, MoE, VLM), xLSTM (``ssm``) and the Zamba
hybrid (``hybrid``) are ported; ``audio`` raises ``NotImplementedError``
naming its ROADMAP item.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

from repro_torch.models import decoder, xlstm, zamba

_NOT_PORTED = {
    "audio": "item 15 (Whisper encoder-decoder)",
}

_MODULES = {"dense": decoder, "moe": decoder, "vlm": decoder,
            "ssm": xlstm, "hybrid": zamba}


def get_model(cfg) -> SimpleNamespace:
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(f"the {fam} family is not ported yet: "
                                  f"ROADMAP queue 1 {_NOT_PORTED[fam]}")
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]

    def prefill(params, batch, *, window=0, num_groups=1):
        if mod is decoder:
            return decoder.prefill(params, batch["tokens"], cfg,
                                   patches=batch.get("patches"),
                                   window=window, num_groups=num_groups)
        return mod.prefill(params, batch["tokens"], cfg, window=window,
                           num_groups=num_groups)

    return SimpleNamespace(
        cfg=cfg,
        init=functools.partial(mod.init, cfg=cfg),
        loss_fn=functools.partial(mod.loss_fn, cfg=cfg),
        prefill=prefill,
        decode_step=functools.partial(mod.decode_step, cfg=cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
    )
