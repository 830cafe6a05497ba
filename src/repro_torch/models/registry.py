"""Model registry: one uniform interface per architecture family.

``get_model(cfg)`` returns a namespace with:
  init(key, device=None)                          -> params
  loss_fn(params, batch, *, num_groups)           -> scalar loss      (train)
  prefill(params, batch, *, window, num_groups)   -> (logits, cache)  (prefill)
  decode_step(params, cache, tokens, pos, *, window, num_groups)
                                                  -> (logits, cache)  (decode)
  init_cache(batch, cache_len, device=None)       -> cache dict

The decoder's families (dense, MoE, VLM), xLSTM (``ssm``), the Zamba
hybrid (``hybrid``) and the Whisper encoder-decoder (``audio``, whose
prefill takes the whole batch: ``frames`` and ``tokens``).
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

from repro_torch.models import decoder, whisper, xlstm, zamba

_MODULES = {"dense": decoder, "moe": decoder, "vlm": decoder,
            "ssm": xlstm, "hybrid": zamba, "audio": whisper}


def get_model(cfg) -> SimpleNamespace:
    fam = cfg.family
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]

    def prefill(params, batch, *, window=0, num_groups=1):
        if mod is whisper:
            return whisper.prefill(params, batch, cfg, window=window,
                                   num_groups=num_groups)
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
