"""Serving entry point: run a model AS DEPLOYED on an IoT device tier —
compress once with the tier's plan, prefill a batch of prompts (for VLM
behind stub patch embeddings), replay the prompt's text into a fresh
ring cache, decode greedily.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --smoke --tier low --batch 4 --prompt-len 64 --gen 32 --device cpu

Runs on ``cuda`` unless ``--device`` says otherwise, and raises without
a GPU rather than drop to the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.compression import DEVICE_TIERS
from repro_torch.core.scenario import resolve_device
from repro_torch.core.steps import (compress_for_serving, make_prefill_step,
                                    make_serve_step)
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import get_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg, tier: str = "mid", *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, window: int = 0, seed: int = 0, device=None,
          params: dict | None = None) -> dict:
    """Compress ``params`` (random from ``seed`` if None) for ``tier``,
    prefill ``batch`` prompts of ``prompt_len`` tokens (VLM: behind
    ``num_patches`` f32 patch embeddings drawn from ``seed`` on the
    device), replay the text into a cache of prompt_len + gen slots and
    decode ``gen`` tokens greedily, as the reference does.
    Returns the tokens (B, gen + 1), prefill's last-token logits, the
    logits of the replay's last step (prefill's last position; for VLM
    the last text position without the patches before it), and the wall
    times of compression, prefill and decode."""
    device = resolve_device(device)
    model = get_model(cfg)
    if params is None:
        params = model.init(seed, device=device)
    _sync(device)
    t0 = time.perf_counter()
    cparams = compress_for_serving(params, DEVICE_TIERS[tier])
    _sync(device)
    t_compress = time.perf_counter() - t0
    prompt = TokenStream(cfg.vocab_size, batch, prompt_len, seed=seed) \
        .batch_at(0)["tokens"][:, :prompt_len].to(device)
    inputs = {"tokens": prompt}
    if cfg.family == "vlm":
        inputs["patches"] = torch.randn(
            (batch, cfg.num_patches, cfg.d_model), dtype=torch.float32,
            device=device,
            generator=torch.Generator(device=device).manual_seed(seed))
    prefill = make_prefill_step(model, window=window)
    step = make_serve_step(model)

    _sync(device)
    t0 = time.perf_counter()
    logits, _ = prefill(cparams, inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    # decode continues in a fresh cache for prompt + gen, primed by
    # replaying the prompt through decode steps
    cache = model.init_cache(batch, prompt_len + gen, device=device)
    for i in range(prompt_len):
        replay, cache = step(cparams, cache, prompt[:, i:i + 1], i)
    out = [torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]]
    _sync(device)
    t1 = time.perf_counter()
    for pos in range(prompt_len, prompt_len + gen):
        step_logits, cache = step(cparams, cache, out[-1], pos)
        out.append(torch.argmax(step_logits[:, -1, :], dim=-1)
                   .to(torch.int32)[:, None])
    _sync(device)
    t_decode = time.perf_counter() - t1
    return {"tokens": torch.cat(out, dim=1), "prefill_logits": logits,
            "replay_logits": replay, "compress_s": t_compress,
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tier", default="mid", choices=list(DEVICE_TIERS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu for tests)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    plan = DEVICE_TIERS[args.tier]
    print(f"arch={cfg.name} tier={args.tier} "
          f"(density={plan.density}, quant={plan.quant}, "
          f"cluster_k={plan.cluster_k})")
    res = serve(cfg, args.tier, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, window=args.window, seed=args.seed,
                device=args.device)
    print(f"compress for {args.tier}: {res['compress_s']:.3f}s")
    print(f"prefill {args.prompt_len} tok x{args.batch}: "
          f"{res['prefill_s']:.3f}s")
    print(f"decode {args.gen} tok x{args.batch}: {res['decode_s']:.3f}s "
          f"({args.gen * args.batch / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())
    return res


if __name__ == "__main__":
    main()
