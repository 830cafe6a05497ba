"""Serving compressed models: deploy the same global model to the device
tiers and compare outputs, payload sizes, and decode agreement.

  PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]

The params and the prompt are drawn from the port's generators (init
seed 0 on the run's device, prompt ``torch.Generator().manual_seed(1)``),
so the tokens are the port's own; ``decode`` takes the reference's
params and prompt where a caller wants its tokens.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.compression import DEVICE_TIERS, payload_bits
from repro_torch.core.scenario import resolve_device
from repro_torch.core.steps import compress_for_serving, make_serve_step
from repro_torch.models import get_model

ARCH = "granite-3-2b"
GEN = 24
PROMPT_LEN = 8
TIERS = ("high", "mid", "low", "embedded")


def make_prompt(vocab_size: int, device) -> torch.Tensor:
    """The (1, PROMPT_LEN) int32 prompt."""
    return torch.randint(0, vocab_size, (1, PROMPT_LEN),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32).to(device)


def decode(model, serve, params: dict, prompt: torch.Tensor,
           gen: int, device=None):
    """Replay ``prompt`` token by token into a fresh cache, then decode
    ``gen`` tokens greedily. Returns the tokens (gen,) and, for each, the
    gap between the two largest logits it was chosen from."""
    cache = model.init_cache(1, prompt.shape[1] + gen, device=device)
    pos = 0
    for i in range(prompt.shape[1]):
        logits, cache = serve(params, cache, prompt[:, i:i + 1], pos)
        pos += 1
    toks, gaps = [], []
    for i in range(gen):
        if i:
            logits, cache = serve(params, cache, toks[-1], pos)
            pos += 1
        last = logits[:, -1:].float()
        top2 = torch.topk(last[0, 0], 2).values
        gaps.append(top2[0] - top2[1])
        toks.append(torch.argmax(last, -1).to(torch.int32))
    return torch.cat(toks, dim=1)[0], torch.stack(gaps)


def serve_tiers(model, params: dict, prompt: torch.Tensor, device) -> dict:
    """The hub's decode (the uncompressed params), then each tier's from
    its compressed params. Per tier: ``plan``, ``bits``
    (``payload_bits``), ``tokens``, ``gaps``, ``agree`` (the share of
    tokens equal to the hub's) and ``params`` (the compressed ones)."""
    serve = make_serve_step(model)
    base, base_gaps = decode(model, serve, params, prompt, GEN, device)
    hub = DEVICE_TIERS["hub"]
    out = {"hub": {"plan": hub, "bits": payload_bits(params, hub),
                   "tokens": base, "gaps": base_gaps, "agree": 1.0,
                   "params": params}}
    for tier in TIERS:
        plan = DEVICE_TIERS[tier]
        cp = compress_for_serving(params, plan)
        toks, gaps = decode(model, serve, cp, prompt, GEN, device)
        out[tier] = {"plan": plan, "bits": payload_bits(params, plan),
                     "tokens": toks, "gaps": gaps,
                     "agree": (toks == base).float().mean().item(),
                     "params": cp}
    return out


def report(tiers: dict) -> list[str]:
    """The script's lines: payload, ratio to the hub's, token agreement
    and the first 12 tokens of each tier."""
    base_bits = tiers["hub"]["bits"]
    lines = [f"hub (fp32 full):  payload {base_bits / 8e3:.0f}kB",
             f"  tokens: {tiers['hub']['tokens'][:12].tolist()}"]
    for tier in TIERS:
        t, plan = tiers[tier], tiers[tier]["plan"]
        lines.append(
            f"{tier:9s} (density={plan.density}, quant={plan.quant}, "
            f"k={plan.cluster_k}): payload {t['bits'] / 8e3:.0f}kB "
            f"({base_bits / t['bits']:.1f}x smaller), token agreement "
            f"{t['agree']:.2f}")
        lines.append(f"  tokens: {t['tokens'][:12].tolist()}")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init(0, device=device)
    tiers = serve_tiers(model, params, make_prompt(cfg.vocab_size, device),
                        device)
    for line in report(tiers):
        print(line)
    return tiers


if __name__ == "__main__":
    main()
