"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase "recurrent train"   # that phase alone

With ``--phase`` (repeatable) the build runs and then only the phases
named, each printing its seconds; the kernels and result lines below are
left out, so only the run with no arguments is the whole check. A phase
that reads an earlier one's output (async and faults read slice's,
checkpoint reads faults') needs that one named too.

1. Builds the port's five CUDA sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, in parallel) and prints the compiler's
   resource report.
2. Phase "kernels": calls every kernel at the shapes its paths give it
   and holds it against its plain PyTorch version on the card:
   - the grouped aggregation kernel (fleet_aggregate) through the
     reference's one-leaf APIs at the FL round's shapes (the paper MLP,
     the 256-wide width-fleet MLP, a ragged size, scalar masks):
     structured_scatter bitwise its plain version, grad_aggregate
     bitwise the port's accumulate_cohort -> finalize chain and to atol
     1e-6 against its plain version, each call's launches counted; then
     llama3.2-3b's ``layers.mlp.wi.w`` (3072, 8192) at T = 4 with full
     0/1 masks and as its width twin, bitwise, with the achieved TB/s;
     the event time of a one-element ``x.add_(0)`` as the launch floor;
     and the grouped launch captured in a CUDA graph and replayed,
     bitwise the eager call, also after its inputs change in place;
   - fake_quant bitwise against the plain ``quantize_em`` for every
     format with e > 0, at every compressible leaf shape of llama3.2-3b
     and of granite-moe-1b-a400m (full configs; the MoE expert leaves are
     4-D, (24, 32, 1024, 512) and (24, 32, 512, 1024)), of qwen3-moe-30b-a3b
     and llava-next-34b at full width and the one layer the MoE serve
     phase runs (expert leaves (1, 128, 2048, 768); llava's projector
     (7168, 7168)), of xlstm-1.3b and zamba2-2.7b at their full configs
     (xLSTM's 5-D r_gates (6, 4, 4, 512, 512) and its (6, 7, 4096, 12288)
     qkv of 2.11e9 elements; Zamba's stacked (54, 80) vectors; a leaf past
     2^30 elements launched whole and held against the plain version
     slice by slice along its leading axis), of whisper-tiny's full config
     (31 compressible leaves: its tied (51865, 384) embedding, the stacked
     norms and MLP biases), and the paper MLP's leaf and upload shapes,
     with specials and f32 subnormals mixed in;
   - flash_attention at the train shape (B 2, T = S 1024, H 24, Hkv 8,
     hd 128) in f32 (atol/rtol 2e-5) and bf16 (one bf16 quantum of the
     plain version's f32 result, plus 2e-5), and in each dtype with a
     window, a q_offset with a ragged S and a ragged non-causal case;
     in bf16 also granite-3-2b's widths (hd 64), a q_offset < 0 whose
     blind rows must be exactly 0, the MoE train phase's shapes
     (granite-moe-1b-a400m's 16 / 8 heads at hd 64, B 2, T = S 1024;
     llava-next-34b's 56 / 8 heads at hd 128, B 1, T = S 2048), the
     recurrent train phase's zamba2-2.7b shared block (32 / 32 heads at
     hd 80, B 2, T = S 1024), the local heads of llama3.2-3b on each of
     phase mesh's two model ranks (12 / 4 at hd 128, B 2, T = S 1024),
     the audio train phase's whisper-tiny shapes
     (6 heads of 64, B 2: the encoder's non-causal T = S = 1500, whose
     last 64-key tile holds 28 keys; the cross-attention's 1024 queries
     over the 1500 frames, non-causal; the decoder's causal T = S = 1024)
     and the smoke config's hd 32. Each
     case's launch must take its route: bf16 at hd 64 and 128 the
     tensor-core kernel (wgmma), f32, hd 80 and hd 32 the CUDA-core one
     (simt);
   then times kernel and plain version with CUDA events (median), the
   kernel's device time from the profiler, the bound (the larger of
   bytes / 3.35 TB/s and operations / 989 TFLOP/s bf16, 67 TFLOP/s f32)
   and, for attention, PyTorch's scaled_dot_product_attention as a
   yardstick (the train bf16 and f32 rows are flash_attention's two
   routes in the kernels line; the granite, granite-moe, llava, zamba
   and whisper rows are printed only);
   - masked_matmul and codebook_matmul through the public kernel API at
     llama3.2-3b's MLP widths (one layer's wi (3072, 8192) and wo (8192,
     3072), x at M = 256 and 8192), plus a ragged shape and the paper
     MLP's: masked_matmul under the low tier's mask in f32 and bf16,
     forward and both gradients by autograd against the plain version's
     autograd (f32: rtol 1e-4, atol 1e-4 x sqrt(contraction length);
     bf16: one quantum plus 16 f32 unit roundoffs of the sum of the
     products' magnitudes), dw exactly 0 where the mask is 0; in bf16
     also a mask of 0 or uniform values in [0, 1) (dw bitwise the
     kernel's own x^T @ g rounded and masked in bf16), a ragged shape
     TMA describes and one it refuses; each case's launches per route
     (every bf16 case but the refused shape on the wgmma kernel);
     codebook_matmul on the embedded tier's k = 16 clustering (int8,
     int32, int64 narrowed by the wrapper) and k = 256 (int32), f32 x
     and (int8 k = 16, int32 k = 256) bf16 x, within the same bars (bf16:
     of sum |x||c|), each case's launch on its route (every case at
     llama3.2-3b's widths on the wgmma kernel; idx rows padded to N + 4
     bytes, the ragged and the paper-MLP shapes on the CUDA cores).
     Those calls are the matmuls' main path: counters zeroed just
     before, read just after. Then each forward is timed against its
     plain version and ``torch.matmul`` on the decoded or masked weight
     (in f32 for codebook_matmul, the product the function is), with
     the bound at the operands' peak: 67 TFLOP/s for f32 (CUDA cores),
     989 TFLOP/s for bf16 (tensor cores; codebook_matmul's wgmma route
     counts its three or six bf16 products); the f32 and the bf16 train
     rows are masked_matmul's two routes in the kernels line, the padded
     f32 and the int8 bf16 train rows codebook_matmul's.
3. Phase "slice": ``simulate`` on the card at the 256-client bench fleet,
   20 rounds each: the masked fleet (eager, scan, scan_pallas), its
   width-sliced twin (scan, scan_pallas) and, 5 rounds, FedAvg with fp8
   uploads and error feedback on the six-tier quickstart fleet (scan,
   scan_pallas).
   Launch counters are zeroed just before each scan_pallas run and read
   just after: one fleet_aggregate launch a round, none through the
   one-leaf wrappers; scan_pallas must equal scan bitwise on the masked
   and width fleets; losses must be finite and fall; a small run must
   agree with the port's CPU path. Then one real round's aggregation
   step of each fleet: the grouped call bitwise the sequential chain and
   the per-leaf route, each timed.
   Phase "examples": the five scripts of ``repro_torch.examples`` through
   their ``main`` (or the functions behind it), each one's launches
   counted (counters zeroed just before it): quickstart (5 of its 30
   rounds of the six-tier FedAvg fleet, engine scan: losses finite and
   falling);
   hetero_fl_sim at its 60 rounds (the paper's 8-device fleet per client:
   all-hub FedSGD, hetero FedSGD, FedAvg with five local steps, fp8
   uploads with EF; the cohort runs, masked against width-sliced, async;
   every line's losses finite and falling and val_acc >= 0.97 on 1000
   held-out samples, but ``async buffer=2 + jitter`` >= 0.955, the
   reference's own value on the port's draw less 0.01; the census lines
   equal the CPU's; its scan block's eager == scan to 1e-5 at 5 of its
   60 rounds; then 2 rounds of the 256-client bench fleet per client against the
   cohort runtime, params within 1e-5); paper_mlp_repro (max val_acc >=
   0.95 at n >= 1000, float64 and float32 within 0.01); serve_quantized
   (then the run from the CPU's params and prompt on the card and the
   CPU: compressed params bitwise, payload bits exactly, tokens equal up
   to the CPU's first top-2 logit gap below 1e-4); train_100m at full
   width (80,753,152 params, 8 x 512 over 4 tiers, 10 of the
   reference's 300 steps; losses finite, the last below the first,
   s/step, tokens/s and peak memory; a checkpoint at steps 5 and 10,
   the last restoring bitwise to the live state).
   Phase "async": the 256-client bench fleet and its width twin under
   AsyncBuffered(64, 0.5, jitter 0.2), 20 windows eager and scan
   (bitwise equal), then the full-buffer, no-discount limit against the
   sync-wait cohort run (1e-6).
   Phase "faults": the bench fleet under a FaultPolicy. (a)
   availability, churn and dropouts (seed 5, period 24, duty 0.7, churn
   0.05, dropout 0.1), 20 rounds eager, scan and scan_pallas on the
   masked and width fleets: scan_pallas bitwise scan, one fleet_aggregate
   launch per round with participants (counted into the grad_aggregate /
   structured_scatter rows), scan within 1e-5 of eager, participant,
   dropout and deadline-drop counts equal across the engines, rounds
   with fewer participants than 256. (b) fp8 uploads with EF under
   repro.fl's policy (corrupt_rate 0.01) and a heavy attack (bit-flips
   in half of each of 25% of the uploads, clip 1.0), 10 rounds eager and
   scan: within 1e-5, equal counts, uploads corrupted, params finite,
   fake_quant launched; the heavy attack without guard and clip leaves
   non-finite params. (c) the async masked fleet with retried and
   corrupted uploads, 20 windows, eager and scan bitwise. Each run's ms
   per round (window) beside the clean run's.
   Phase "checkpoint": the masked fleet with fp8 EF, 10 rounds with a
   checkpoint every 5, cut at 5 and resumed (the async run: 20 windows,
   cut at 10): params bitwise and records
   equal to the uninterrupted run, under (b)'s first policy eager and
   scan, (a)'s scan_pallas, and (c)'s async run eager and scan; save and
   restore of a cohort and an async server state timed, with the npz
   bytes. Then the train launcher on granite-3-2b at full width cut to 1
   layer (bf16, flash), 4 steps with --ckpt-every 2, its step-4
   checkpoint removed (what a kill after step 2 leaves) and resumed:
   steps 3-4 bitwise (losses, tier losses, params), the state's save and
   restore timed; flash_attention 4 wgmma launches per step.
   Phase "topology": hierarchical fleets. (a) the reference's five
   topology scenarios (sync_wait at participation 0.5, sync_drop at
   0.004 s, FedAvg with 3 local steps at lr 0.5, fp8_e4m3 uploads with
   EF at participation 0.6, width) on the bench fleet over 8 contiguous
   edges, 3 rounds each eager, scan (a chunk of 2, then one of 1), scan
   with mesh=True (the one-card mesh) and, for sync_wait, quant_ef and
   width, scan on a
   4-block mesh of the one card: params, optimizer state and every
   record bitwise across them all;
   losses finite; fake_quant launched on every run and the aggregation
   kernel on none (counters zeroed just before each run);
   engine="scan_pallas" refused; a 16-client, 4-edge fleet's 3 rounds
   within 1e-5 of the port's CPU path. (b) sync_wait under (a)'s
   availability policy of phase faults, eager and scan bitwise, equal
   counts. (c) fp8 EF cut at 5 of 10 rounds and resumed, eager and
   scan, bitwise; the npz holds the (E, cap, ...) EF rows; save and
   restore timed. (d) the reference's acceptance fleet: 100,000 clients
   of the four tiers over 8 edges, FedSGD, ScanEngine(chunk_rounds=10),
   a warm chunk of 11 rounds then 10 timed: ms per round, a profiled
   round's device-busy share, seconds to build the clients and the
   grids, peak memory, the census's cross_shard_bytes_per_round (equal
   to the 256-client fleet's), and the engine's record counts, wall and
   bytes equal to an eager round's of the same server.
4. Phase "serve": llama3.2-3b at its full config (28 layers, bf16
   compute), compressed for the tiers hub (none), low (pruned + fp8) and
   embedded (k-means + fp4) through ``repro_torch.launch.serve``: batch
   4, prompt 64, 8 greedy
   tokens; fake_quant must launch 10 times per quantized tier and never
   for the hub; a profiled window of 8 decode steps on the low tier. At
   2 layers of full width in f32, the decode replay of the prompt must
   agree with prefill's last-token logits.
5. Phase "train": llama3.2-3b at full width cut to 4 layers, bf16,
   ``use_flash``, through ``repro_torch.launch.train``: 4 tiers,
   AdamW(warmup_cosine(3e-4, 2, 5)), global batch 8, seq 1024, 5 steps;
   flash_attention must launch 16 times per step, all on the wgmma
   kernel, and fake_quant 30 times per step; the
   mean loss and each tier's must fall at each of the last two steps
   (after the jump that AdamW's first updates make at this width, as in
   the reference), and the same run without flash must give the same
   losses to rtol 1e-3. On the llama smoke
   config the card's f32 step must agree with the port's CPU path over 2
   steps, its flash_attention launches all on the simt kernel.
6. Phase "moe serve": granite-moe-1b-a400m whole (24 layers, 32 experts
   top-8, 1,334,628,352 params) through ``launch.serve`` for the tiers
   of 4 (the hub over 2 tokens, the others 8), fake_quant once per
   compressible leaf (10, the router
   excluded) per quantized tier, and a profiled window of 8 decode
   steps on the low tier; then qwen3-moe-30b-a3b and llava-next-34b at
   full width cut to 1 layer (of 48 and 60), tiers hub (2 tokens) and
   low (llava's
   prefill covers 1152 patches + 64 tokens). In f32 at 2 layers of full
   width the decode replay must agree with prefill: granite-moe at
   capacity factor E / k = 4.0, which drops nothing (at 1.25 decode's
   capacity of 1 drops choices that prefill keeps), and llava against a
   prefill of the prompt without patches, which the patches must move.
7. Phase "moe train": granite-moe-1b-a400m's smoke config, the card's
   f32 step against the CPU path as in 5; then granite-moe whole, bf16,
   flash, 4 tiers, AdamW, 8 x 1024, 5 steps: losses finite, 96
   flash_attention launches per step all on the wgmma kernel (hd 64), 30
   fake_quant; then llava-next-34b at full width, 1
   layer, 4 x 2048 (896 text + 1152 patch positions), 2 steps: losses
   finite, flash on the wgmma kernel at hd 128.
8. Phase "recurrent serve": xlstm-1.3b whole (48 layers, 3,530,676,560
   params) at low and embedded and zamba2-2.7b whole (54 layers,
   2,422,670,240 params) at low, as in 6 (fake_quant 18 per
   quantized tier), each with a profiled window of 8 decode steps on the
   low tier; then, in f32 at full width and a 512-token prompt (two
   256-chunks carried), the decode replay against prefill: xLSTM at 8
   layers (one superblock), Zamba at 6 (one application of the shared
   block, a cache exactly as long as the prompt: its decode attends to
   unwritten slots, as the reference's).
9. Phase "recurrent train": both smoke configs' f32 step against the CPU
   path as in 5; then bf16, flash, 4 tiers, AdamW, 8 x 1024, 3 steps, at
   full width: xLSTM at 8 of 48 layers (one superblock), Zamba at 12 of
   54 (two applications) at peak lr 3e-5: losses finite and the mean
   loss falling over the last two steps, fake_quant 54 per step, Zamba's
   flash 8 per step on the simt kernel (hd 80).
10. Phase "audio serve": whisper-tiny whole (4 encoder + 4 decoder
   layers, 36,463,488 params, 1500 frame positions) with ``use_flash``
   through ``launch.serve`` at hub, low and embedded as in 6 (fake_quant
   31 per quantized tier; flash 8 per call, prefill's 4 encoder and 4
   cross-attentions, all on the wgmma kernel), a profiled window of 8
   decode steps on the low tier; then in f32 at the full config a fresh
   cache holding prefill's cross-KV replays the 64-token prompt to
   prefill's last-token logits, and the launcher's own replay (zero
   cross-KV, as the reference's launcher leaves it) differs from them.
11. Phase "audio train": the smoke config's f32 step against the CPU path
   as in 5; then whisper-tiny whole, bf16, flash, 4 tiers, AdamW, 8 x
   1024 tokens over 1500 frames a sample, 5 steps: losses finite, the
   mean loss falling over the last two steps, flash 48 per step (12
   attention calls x 4 tiers) all on the wgmma kernel, fake_quant 93 per
   step; one step profiled; the same run without flash gives the same
   losses to rtol 1e-3.
12. Phase "mesh": (a) whisper-tiny at full width, 2 of its 4 decoder and
   4 encoder layers, through ``launch.train`` at
   --model-parallel 2 (the host mesh over every CUDA device: (1, 1) on
   one card, the state placed by ``param_spec_tree``) and at 1, bf16,
   flash, 4 tiers, AdamW, 8 x 1024 over 1500 frames, 2 steps each: flash
   24 and fake_quant 93 per step, losses and final params bitwise
   between the two; (b) the LM dry run (``launch.dryrun.dry_run_step``,
   fake tensors on the host) of the same config and shape on that mesh,
   flash off, against a fresh real state, batch and step on the card:
   argument bytes exactly the real state's and batch's, flops exactly
   ``FlopCounterMode``'s over one real step (the card's fake_quant is no
   ATen op and does no flops), argument + temp bytes within 25% of the
   step's ``max_memory_allocated`` (reset before it); (c) the dry-run
   record of llama3.2-3b at decode_32k on the 16 x 16 production mesh:
   status ok, its flops, traffic and per-device argument bytes printed;
   (d) the decoder over two ranks that share the card (gloo: NCCL
   refuses two ranks on one device), each a process of its own
   (``chip_smoke.py --mesh-rank R``, started and waited for by the phase
   with a time limit; a rank's nonzero exit fails the phase), through
   ``launch.train`` with ``WORLD_SIZE`` 2: (d1) llama3.2-3b at full
   width, 1 layer, f32, flash (simt), 4 tiers, 8 x 128, 2 steps under
   the launcher's warmup, on meshes (1, 2) and (2, 1) against the
   one-rank launcher from the same seed: losses and tier losses rtol
   1e-4, params (below), each rank's masks at densities 0.5
   and 0.25 bitwise the one-rank masks' blocks (the one-rank f32 counts
   of the embedding, past 2^24, are printed against exact counts),
   fake_quant launches per rank the one-rank count, flash 16 simt
   launches per rank (its attention calls), each rank's placed state
   exactly ``shard_bytes``; (d2) 4 layers, bf16, flash (wgmma at the
   local 12 / 4 heads), 8 x 1024, 3 steps on (1, 2): s/step, tokens/s and
   peak memory per rank, losses within 3 x the one-rank run's own
   bf16-vs-f32 distance of its bf16 losses (the two ranks' bf16 sums
   round once, as the reference's sharded bf16 step's f32 sums do,
   tests/test_torch_parallel_bf16.py); (d3) the same two parts on
   granite-moe-1b-a400m at full width (experts split over "model", 16 a
   rank; the embedding on d_model, its vocabulary 49155 being odd; on
   (2, 1) each tier's one 512-token MoE group straddles the data ranks),
   with a profiled step's busy share and the MoE layer's share of its
   wall; (d4) (d1)'s part on (1, 2) for xlstm-1.3b at 8 layers (one
   superblock), zamba2-2.7b at 6 (one application of the shared block;
   flash simt at hd 80) and whisper-tiny whole (flash simt on the
   1500-frame encoder, the decoder and the cross-attention), and (d2)'s
   part for zamba2-2.7b; (d5) (d1)'s run on (2, 1) with the reference's
   FSDP train layout (``launch.train(fsdp=True)``: every leaf's largest
   dim left after the "model" one split over "data" too, each layer's
   leaves gathered where it runs and its gradients reduce-scattered),
   in (d1)'s rank processes, against (d1)'s one-rank run with its bars;
   each rank's placed state plus its batch rows exactly the dry run's
   argument bytes per device (``launch.specs.train_setup`` on an
   abstract (2, 1) mesh) and its step's peak below (d1)'s (2, 1) peak;
   the collectives' seconds a step printed. Each rank of (d2) and (d5)
   counts the collectives of every step it takes
   (``models.parallel.counting``), and each step's count is exactly the
   dry run's per-device census of the same config and mesh (rank 0's
   trace on fake tensors, ``launch.specs.rank_traced``, flash off), op
   by op in count and bytes; the dry run's argument + per-device temp
   bytes are within 25% of each rank's step peak
   (``max_memory_allocated``), with the share of the gap that the plain
   attention's saved scores account for printed. The f32 parts' bars past
   the losses: AdamW's first moment within 1e-3 of its leaf's largest of
   one rank's, and the params within atol 1e-5; in (d4) alone a param
   whose first moment flips sign at most 1e-3 of its leaf's largest may
   pass it by up to 2 lr (a gradient at f32 noise, whose sign AdamW's
   step turns into +-lr; counted and printed). (d6) prefill (4 x 64)
   and 8 decode steps on (1, 2) in the same rank processes, each rank
   its blocks of the deployed params and of the cache, against one rank
   and the dry run's census and bytes; (d7) the same in a second spawn
   of eight ranks on (1, 8) for whisper-tiny whole (6 heads: the
   prefill's attention on each rank's query rows) and xlstm-1.3b at 8
   layers over a 768-token prompt (4 heads: the mLSTM cell on each
   rank's block of dk), each rank's prefill s, decode tokens/s and peak
   printed beside the card's name and power limit.

Prints the card's name and power limit, per-kernel times, launches per
round and per step, ms per round and per window (clean and under
faults), checkpoint save / restore ms and bytes, val_acc, prefill s,
decode tokens/s, sec/step and peak memory, a profiled window (a
device-only trace) of each FL fleet, of the async runtime, decode steps
and train steps, then the kernels JSON line (every TPU kernel's row: grad_aggregate and
structured_scatter both from the grouped kernel; flash_attention,
masked_matmul and codebook_matmul once per route, each row with its
device ms and its max_abs_err over its route's cases in the dtype of its
ms) and, last, the ``{"ok": true, ...}`` line. Any failed check exits non-zero. Needs a
CUDA GPU and the repository's ``src/`` beside this file; exits non-zero
without either.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CARD = ""       # the card's name and power limit, as nvidia-smi gives them
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
F32_FLOP_PER_S = 67e12              # H100 SXM f32 rate outside the tensor cores
ROUNDS = 20
FEDAVG_ROUNDS = 5                   # the slice's FedAvg fleet: ~10x a FedSGD round
CKPT_ROUNDS = 10                    # the FL kill-and-resume runs, cut at half
QUICKSTART_ROUNDS = 5               # of the script's 30
LM_ARCH = "llama3.2-3b"
MOE_ARCH = "granite-moe-1b-a400m"
XLSTM = "xlstm-1.3b"
ZAMBA = "zamba2-2.7b"
WHISPER = "whisper-tiny"
TRAIN_LAYERS = 4                    # the train phase's depth cut (of 28)
TRAIN_STEPS = 5
HUGE = 1 << 30                      # fake_quant leaves checked by slices
BENCH_TIERS = ("hub", "high", "mid", "low")
QUICKSTART_TIERS = ("hub", "high", "mid", "mid", "low", "embedded")
LARGE_LEAF = (3072, 8192)           # llama3.2-3b's layers.mlp.wi.w


class CheckFailed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"check ok: {what}")


def time_ms(fn, reps: int = 15, inner: int = 20) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls each."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(n_bytes: int, flops: float = 0.0,
             flop_rate: float = BF16_FLOP_PER_S) -> float:
    """The least time for the work: the larger of moving ``n_bytes`` at
    the memory rate and doing ``flops`` at ``flop_rate``."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / flop_rate) * 1e3


def device_events(prof) -> list:
    """(name, us) of each device-side event (kernel, copy) of a profiler
    trace, read from its raw events: building the profiler's event list
    for a window of ~10^6 events takes minutes of host time."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def kernel_device_ms(fn, kernel: str, calls: int = 200):
    """Device time of the kernels whose names hold ``kernel`` per call of
    ``fn`` (all of a call's launches: masked_matmul's split-K pass runs
    two), mean over ``calls`` calls, from the profiler's device trace
    (None if the trace has no such kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [us for name, us in device_events(prof) if kernel in name]
    return sum(ev) / calls / 1e3 if ev else None


# ------------------------------------------------------------- kernels

def _mlp_params(cfg, device):
    import torch
    from repro_torch.models import mlp
    return mlp.init(torch.Generator().manual_seed(0), cfg, device)


def _grad_cases(device):
    """(label, g (T,N), m (T,N) or (T,1)) at the masked path's shapes:
    every >=2-D leaf of the paper MLP and of the wide MLP, T = 4, plus a
    ragged size and scalar masks."""
    import torch
    from repro_torch.configs.paper_mlp import MLPConfig, config
    gen = torch.Generator().manual_seed(1)
    cases = []
    for tag, cfg in (("paper", config()),
                     ("wide", MLPConfig(hidden=256, num_layers=4))):
        seen = set()
        for k, p in _mlp_params(cfg, "cpu").items():
            if p.dim() < 2 or tuple(p.shape) in seen:
                continue
            seen.add(tuple(p.shape))
            n = p.numel()
            g = torch.randn((4, n), generator=gen)
            m = (torch.rand((4, n), generator=gen) < 0.6).float()
            m[0] = 1.0                                   # the hub keeps all
            cases.append((f"{tag}{tuple(p.shape)}", g, m))
    g = torch.randn((4, 1001), generator=gen)
    cases.append(("ragged(1001,)", g,
                  (torch.rand((4, 1001), generator=gen) < 0.5).float()))
    cases.append(("scalar_mask(1001,)", g,
                  torch.tensor([[1.0], [0.0], [1.0], [1.0]])))
    return [(lbl, g.to(device), m.to(device)) for lbl, g, m in cases]


def _scatter_cases(device):
    """(label, gs, ms, out_shape) per same-signature leaf group of the
    paper MLP's and the wide MLP's width fleet (tiers hub/high/mid/low =
    widths 1, 1, 0.5, 0.25)."""
    import torch
    from repro_torch.configs.paper_mlp import MLPConfig, config
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    gen = torch.Generator().manual_seed(2)
    cases = []
    for tag, cfg in (("paper", config()),
                     ("wide", MLPConfig(hidden=256, num_layers=4))):
        params = _mlp_params(cfg, "cpu")
        specs = [submodel_spec(params, DEVICE_TIERS[t].as_width_sliced().width)
                 for t in BENCH_TIERS]
        groups: dict = {}
        for i, (k, p) in enumerate(params.items()):
            sig = (tuple(p.shape), tuple(s.local_shape(i) for s in specs))
            groups.setdefault(sig, []).append(k)
        for (shape, locals_), ks in groups.items():
            L = len(ks)
            gs = [torch.randn((L,) + loc, generator=gen) for loc in locals_]
            if len(shape) == 1:                  # biases: scalar masks
                ms = [torch.ones(L) for _ in locals_]
            else:
                ms = [(torch.rand((L,) + loc, generator=gen) < 0.7).float()
                      for loc in locals_]
            cases.append((f"{tag}{shape}x{L}", [g.to(device) for g in gs],
                          [m.to(device) for m in ms], shape))
    return cases


def _scatter_plain(gs, ms, wn, wd, shape):
    """The plain version of a batched structured_scatter call: each of
    the L leaves through the one-leaf chain."""
    import torch
    from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref
    from repro_torch.kernels.structured_scatter.ref import leaf_views
    g3s, m3s, (L, R, C) = leaf_views(gs, ms, shape)
    return torch.stack([aggregate_leaf_ref(
        (R, C), [(g[l], m[l]) for g, m in zip(g3s, m3s)], wn, wd)
        for l in range(L)]).reshape((L,) + tuple(shape))


def _large_leaf_cases(device):
    """(label, leaves) for llama3.2-3b's ``layers.mlp.wi.w`` (3072, 8192)
    at T = 4 (the bench tiers): full 0/1 masks on every tier (masked),
    and its width twin, each tier's prefix block from ``submodel_spec``
    with the leaf between two others, as in the model."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    shape = LARGE_LEAF
    meta = {"wq": torch.empty((8, shape[0]), device="meta"),
            "wi": torch.empty(shape, device="meta"),
            "wo": torch.empty((shape[1], 8), device="meta")}
    locs = {"masked": [shape] * 4,
            "width": [submodel_spec(
                meta, DEVICE_TIERS[t].as_width_sliced().width).local_shape(1)
                for t in BENCH_TIERS]}
    gen = torch.Generator(device=device).manual_seed(3)
    cases = []
    for tag, loc in locs.items():
        tiers = [(torch.randn(s, generator=gen, device=device),
                  (torch.rand(s, generator=gen, device=device) < 0.6).float())
                 for s in loc]
        cases.append((f"llama_wi_{tag}", {"layers.mlp.wi.w": (shape, tiers)}))
    return cases


def _leaves_bytes(leaves: dict) -> int:
    """Bytes a grouped call must move: each tier's update and mask read
    once (a scalar mask is 4 bytes), each output written once."""
    import math
    return sum(sum(g.numel() * 4 + m.numel() * 4 for g, m in tiers)
               + math.prod(shape) * 4 for shape, tiers in leaves.values())


def _graph_replay_check(device) -> None:
    """The grouped launch captured in a CUDA graph, replayed, bitwise the
    eager call, also after its inputs change in place."""
    import torch
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.core.compression import DEVICE_TIERS, submodel_spec
    from repro_torch.configs.paper_mlp import config
    params = _mlp_params(config(), "cpu")
    gen = torch.Generator().manual_seed(4)
    specs = [submodel_spec(params, DEVICE_TIERS[t].as_width_sliced().width)
             for t in BENCH_TIERS]
    leaves = {}
    for i, (k, p) in enumerate(params.items()):
        tiers = []
        for s in specs:
            loc = s.local_shape(i)
            m = ((torch.rand(loc, generator=gen) < 0.7).float() if p.dim() > 1
                 else torch.ones(()))
            tiers.append((torch.randn(loc, generator=gen).to(device),
                          m.to(device)))
        leaves[k] = (tuple(p.shape), tiers)
    wn, wd = [1.0, 1.0, 1.0, 1.0], [64.0, 64.0, 0.0, 64.0]
    eager = {k: v.clone() for k, v in fleet_aggregate(leaves, wn, wd).items()}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fleet_aggregate(leaves, wn, wd)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fleet_aggregate(leaves, wn, wd)
    graph.replay()
    torch.cuda.synchronize()
    check(all(torch.equal(out[k], eager[k]) for k in leaves),
          "fleet_aggregate captured in a CUDA graph: replay == eager "
          "(bitwise)")
    for _, tiers in leaves.values():
        for g, _ in tiers:
            g.mul_(-3.0)
    graph.replay()
    want = fleet_aggregate(leaves, wn, wd)
    torch.cuda.synchronize()
    check(all(torch.equal(out[k], want[k]) for k in leaves),
          "fleet_aggregate graph replay after in-place input changes == "
          "eager (bitwise)")


def phase_kernels(device) -> dict:
    import torch
    from repro_torch.core.aggregation import accumulate_cohort, f32, finalize
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.fleet_aggregate.ref import aggregate_leaf_ref
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.grad_aggregate.ref import grad_aggregate_ref
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    from repro_torch.kernels.structured_scatter.ops import structured_scatter
    w = [1.0, 1.0, 1.0, 1.0]
    counts = [64.0, 64.0, 0.0, 64.0]
    wd = [f32(f32(a) * f32(c)) for a, c in zip(w, counts)]
    rows = {}
    one = torch.zeros(1, device=device)
    floor_ms = time_ms(lambda: one.add_(0))
    print(f"kernel launch floor: x.add_(0) on one element ms={floor_ms:.6f}")

    err = 0.0
    for lbl, g, m in _grad_cases(device):
        before = fleet_aggregate.launches
        out = grad_aggregate(g, m, w, w_den=wd)
        check(fleet_aggregate.launches == before + 1,
              f"grad_aggregate {lbl}: one fleet_aggregate launch")
        plain = grad_aggregate_ref(g, m, w, wd)
        acc = ({"x": torch.zeros_like(out)},
               {"x": torch.zeros_like(out)})
        for t in range(4):
            acc = accumulate_cohort(acc, {"x": g[t]},
                                    {"x": m[t] if m.shape[1] > 1 else m[t, 0]},
                                    w[t], counts[t])
        chain = finalize(acc)["x"]
        torch.cuda.synchronize()
        check(torch.equal(out, chain),
              f"grad_aggregate {lbl} == accumulate_cohort->finalize (bitwise)")
        e = (out - plain).abs().max().item()
        check(e <= 1e-6, f"grad_aggregate {lbl} vs plain version, "
                         f"max_abs_err {e} <= 1e-6")
        err = max(err, e)
        t_n = g.shape[1]
        n_bytes = g.numel() * 4 + m.numel() * 4 + t_n * 4
        ms = time_ms(lambda: grad_aggregate(g, m, w, w_den=wd))
        pms = time_ms(lambda: grad_aggregate_ref(g, m, w, wd))
        dms = kernel_device_ms(lambda: grad_aggregate(g, m, w, w_den=wd),
                               "fleet_aggregate_kernel")
        print(f"kernel grad_aggregate {lbl} T=4 N={t_n}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.7f} "
              f"device_ms={dms} bytes={n_bytes} launches_per_call=1 "
              f"launch_floor_ms={floor_ms:.6f}")
        if lbl == "paper(10, 10)":
            rows["grad_aggregate"] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                                          bound_ms=bound_ms(n_bytes))
    rows["grad_aggregate"]["max_abs_err"] = err

    err = 0.0
    for lbl, gs, ms_, shape in _scatter_cases(device):
        before = fleet_aggregate.launches
        out = structured_scatter_batched(gs, ms_, w, wd, out_shape=shape)
        n_launch = fleet_aggregate.launches - before
        plain = _scatter_plain(gs, ms_, w, wd, shape)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"structured_scatter {lbl} == plain version (bitwise)")
        e = (out - plain).abs().max().item()
        err = max(err, e)
        n_bytes = (sum(g.numel() * 4 + m.numel() * 4 for g, m in zip(gs, ms_))
                   + out.numel() * 4)
        kms = time_ms(lambda: structured_scatter_batched(gs, ms_, w, wd,
                                                         out_shape=shape))
        pms = time_ms(lambda: _scatter_plain(gs, ms_, w, wd, shape))
        dms = kernel_device_ms(
            lambda: structured_scatter_batched(gs, ms_, w, wd, out_shape=shape),
            "fleet_aggregate_kernel")
        print(f"kernel structured_scatter {lbl} L={gs[0].shape[0]} "
              f"locals={[tuple(g.shape[1:]) for g in gs]}: ms={kms:.6f} "
              f"plain_ms={pms:.6f} bound_ms={bound_ms(n_bytes):.7f} "
              f"device_ms={dms} bytes={n_bytes} launches_per_call={n_launch}")
        if lbl == "paper(10, 10)x4":
            rows["structured_scatter"] = dict(ms=kms, plain_ms=pms,
                                              device_ms=dms,
                                              bound_ms=bound_ms(n_bytes))
    rows["structured_scatter"]["max_abs_err"] = err
    check(structured_scatter.launches > 0, "structured_scatter counts its "
                                           "launches")

    wn = [1.0, 1.0, 1.0, 1.0]
    for lbl, leaves in _large_leaf_cases(device):
        out = fleet_aggregate(leaves, wn, wd)
        for k, (shape, tiers) in leaves.items():
            plain = aggregate_leaf_ref(shape, tiers, wn, wd)
            torch.cuda.synchronize()
            check(torch.equal(out[k], plain),
                  f"fleet_aggregate {lbl} == plain version (bitwise)")
        del out, plain
        n_bytes = _leaves_bytes(leaves)
        ms = time_ms(lambda: fleet_aggregate(leaves, wn, wd), reps=10, inner=10)
        dms = kernel_device_ms(lambda: fleet_aggregate(leaves, wn, wd),
                               "fleet_aggregate_kernel", calls=50)
        locs = [tuple(g.shape) for g, _ in next(iter(leaves.values()))[1]]
        print(f"kernel fleet_aggregate {lbl} T=4 locals={locs}: ms={ms:.6f} "
              f"device_ms={dms:.6f} bound_ms={bound_ms(n_bytes):.6f} "
              f"bytes={n_bytes} TB/s={n_bytes / ms / 1e9:.3f} "
              f"device_TB/s={n_bytes / dms / 1e9:.3f}")
        del leaves
        torch.cuda.empty_cache()
    _graph_replay_check(device)
    return rows


# ---------------------------------------------------------- LM kernels

def _fq_input(shape, device, seed: int):
    """Normals over ~170 binades with specials and f32 subnormals mixed
    in, made on the card from a seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device)
    x *= torch.exp(torch.empty(shape, device=device).uniform_(
        -60.0, 60.0, generator=gen))
    flat = x.view(-1)
    n = flat.numel()
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             float("nan"), 1e-45, -1e-45, 3e38, -3e38, 481.0,
                             65520.0], device=device)
    k = min(n, specials.numel())
    flat[:k] = specials[:k]
    m = min(n - k, 1000)
    if m > 0:
        idx = torch.randint(k, n, (m,), generator=gen, device=device)
        flat[idx] = torch.randn((m,), generator=gen, device=device) * 1e-40
    return x


def _bitwise(a, b) -> bool:
    import torch
    return bool(torch.all((a.view(torch.int32) == b.view(torch.int32))
                          | (torch.isnan(a) & torch.isnan(b))))


def _max_abs_err(a, b) -> float:
    """Largest |a - b| over the elements where a and b are not both NaN
    (equal infinities count 0, a NaN against a number counts inf)."""
    import torch
    d = torch.where(a == b, 0.0, (a - b).abs())
    d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0,
                    d.nan_to_num(nan=float("inf")))
    return d.max().item()


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _route_errors(kernel: str, err: dict, rows: dict, names: dict) -> None:
    """Print ``err`` ((route, dtype) -> the largest error over that
    route's cases in that dtype) and give each kernels-line row the error
    of its own route and dtype, the dtype its ms was timed in."""
    print(f"{kernel} max_abs_err by route and dtype: " + json.dumps(
        {f"{r}/{d}": e for (r, d), e in sorted(err.items())}))
    for route, name in names.items():
        rows[name]["max_abs_err"] = err[(route, rows[name]["dtype"])]


def _fq_shapes() -> dict:
    """shape -> label: every compressible leaf shape of llama3.2-3b,
    granite-moe-1b-a400m, xlstm-1.3b, zamba2-2.7b and whisper-tiny at
    their full configs, and of qwen3-moe-30b-a3b and llava-next-34b at full width and
    the depth the MoE serve phase runs them (``WIDE_LAYERS``): the 4-D
    expert leaves, llava's projector, xLSTM's (6, 7, 4096, 12288) qkv
    (2.11e9 elements) and 5-D r_gates, Zamba's stacked (54, 80) vectors
    included, and whisper-tiny's stacked norms and MLP biases (the
    serve phases check the tables against the real params); and the paper MLP's leaf shapes and upload shapes (a
    256-client axis in front of every leaf)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_mlp import config
    from repro_torch.core.compression import compressible
    shapes = {}
    for arch, tag, layers in ((LM_ARCH, "llama", None),
                              (MOE_ARCH, "granite-moe", None),
                              (QWEN_MOE, "qwen3-moe", WIDE_LAYERS),
                              (LLAVA, "llava", WIDE_LAYERS),
                              (XLSTM, "xlstm", None),
                              (ZAMBA, "zamba", None),
                              (WHISPER, "whisper", None)):
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        for name, shape in _lm_leaf_shapes(cfg).items():
            if compressible(name, torch.empty(shape, device="meta")):
                shapes.setdefault(shape, f"{tag} {name}")
    for name, p in _mlp_params(config(), "cpu").items():
        shapes.setdefault(tuple(p.shape), f"paper-mlp {name}")
        shapes.setdefault((256,) + tuple(p.shape), f"paper-mlp upload {name}")
    return shapes


def _recurrent_leaf_shapes(cfg) -> dict:
    """name -> shape of every leaf of xLSTM (``ssm``) or the Zamba hybrid
    (``hybrid``) at ``cfg``, in the reference's flatten order."""
    d, v, w = cfg.d_model, cfg.vocab_size, cfg.conv_width
    shapes = {"embed": (v, d), "final_norm": (d,), "lm_head.w": (d, v)}
    if cfg.family == "ssm":
        nsb, nm = cfg.num_layers // cfg.slstm_every, cfg.slstm_every - 1
        d_in, h = cfg.ssm_expand * d, cfg.num_heads
        hds = d // h
        m = {"conv_b": (d_in,), "conv_w": (d_in, w), "down.w": (d_in, d),
             "gates.b": (2 * h,), "gates.w": (d_in, 2 * h), "ln": (d,),
             "mnorm": (d_in,), "qkv.w": (d_in, 3 * d_in), "skip": (d_in,),
             "up.w": (d, 2 * d_in)}
        sl = {"down.w": (d, d), "gates_x.b": (4 * d,),
              "gates_x.w": (d, 4 * d), "gnorm": (d,), "ln": (d,),
              "r_gates": (4, h, hds, hds)}
        shapes.update({f"blocks.mlstm.{k}": (nsb, nm, *s)
                       for k, s in m.items()})
        shapes.update({f"blocks.slstm.{k}": (nsb, *s) for k, s in sl.items()})
    else:
        n_layers, hd = cfg.num_layers, cfg.head_dim
        d_in = cfg.ssm_expand * d
        nh, n = d_in // cfg.ssm_headdim, cfg.ssm_state
        conv = d_in + 2 * n
        m = {"ln": (d,), "mamba.a_log": (nh,), "mamba.conv_b": (conv,),
             "mamba.conv_w": (conv, w), "mamba.d_skip": (nh,),
             "mamba.dt_bias": (nh,), "mamba.gate_norm": (d_in,),
             "mamba.in_proj.w": (d, 2 * d_in + 2 * n + nh),
             "mamba.out_proj.w": (d_in, d)}
        shapes.update({f"layers.{k}": (n_layers, *s) for k, s in m.items()})
        shapes.update({
            "shared.attn.wk.w": (d, cfg.num_kv_heads, hd),
            "shared.attn.wo.w": (cfg.num_heads * hd, d),
            "shared.attn.wq.w": (d, cfg.num_heads, hd),
            "shared.attn.wv.w": (d, cfg.num_kv_heads, hd),
            "shared.ln1": (d,), "shared.ln2": (d,),
            "shared.mlp.wg.w": (d, cfg.d_ff), "shared.mlp.wi.w": (d, cfg.d_ff),
            "shared.mlp.wo.w": (cfg.d_ff, d)})
    return dict(sorted(shapes.items()))


def _whisper_leaf_shapes(cfg) -> dict:
    """name -> shape of every leaf of the Whisper encoder-decoder at
    ``cfg``, in the reference's flatten order."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    norm = {"b": (d,), "w": (d,)}
    attn = {"wk.w": (d, cfg.num_kv_heads, hd), "wo.w": (cfg.num_heads * hd, d),
            "wq.w": (d, cfg.num_heads, hd), "wv.w": (d, cfg.num_kv_heads, hd)}
    enc = {"attn": attn, "ln1": norm, "ln2": norm,
           "mlp": {"wi.b": (f,), "wi.w": (d, f), "wo.b": (d,),
                   "wo.w": (f, d)}}
    shapes = {"embed": (cfg.vocab_size, d),
              **{f"{n}.{k}": s for n in ("enc_norm", "dec_norm")
                 for k, s in norm.items()}}
    for stack, n, blocks in (
            ("enc_layers", cfg.encoder_layers, enc),
            ("dec_layers", cfg.num_layers, {**enc, "ln_x": norm,
                                            "xattn": attn})):
        shapes.update({f"{stack}.{b}.{k}": (n, *s)
                       for b, leaves in blocks.items()
                       for k, s in leaves.items()})
    return dict(sorted(shapes.items()))


def _lm_leaf_shapes(cfg) -> dict:
    """name -> shape of every leaf of the LM at ``cfg`` (the decoder's
    dense, MoE or VLM; xLSTM; the Zamba hybrid; Whisper), in the
    reference's flatten order."""
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_leaf_shapes(cfg)
    if cfg.family == "audio":
        return _whisper_leaf_shapes(cfg)
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim
    e, f = cfg.num_experts, cfg.d_ff
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,),
              "layers.attn.wk.w": (L, d, cfg.num_kv_heads, hd),
              "layers.attn.wo.w": (L, cfg.num_heads * hd, d),
              "layers.attn.wq.w": (L, d, cfg.num_heads, hd),
              "layers.attn.wv.w": (L, d, cfg.num_kv_heads, hd),
              "layers.ln1": (L, d), "layers.ln2": (L, d)}
    if cfg.is_moe:
        shapes.update({"layers.moe.router.w": (L, d, e),
                       "layers.moe.we_g": (L, e, d, f),
                       "layers.moe.we_i": (L, e, d, f),
                       "layers.moe.we_o": (L, e, f, d)})
    else:
        shapes.update({"layers.mlp.wg.w": (L, d, f),
                       "layers.mlp.wi.w": (L, d, f),
                       "layers.mlp.wo.w": (L, f, d)})
    if not cfg.tie_embeddings:
        shapes["lm_head.w"] = (d, cfg.vocab_size)
    if cfg.family == "vlm":
        shapes["projector.w"] = (d, d)
    return dict(sorted(shapes.items()))


def _n_compressible(cfg) -> int:
    """How many leaves of the LM at ``cfg`` compress: the fake_quant
    launches of one quantized compression."""
    import torch
    from repro_torch.core.compression import compressible
    return sum(compressible(n, torch.empty(s, device="meta"))
               for n, s in _lm_leaf_shapes(cfg).items())


def _flash_cases(device):
    """(label, q, k, v, kwargs, route) at llama3.2-3b's attention widths:
    the train phase's shape in bf16 (the wgmma kernel) and f32 (the simt
    kernel), then a window, a q_offset with a ragged S and a ragged
    non-causal case in each dtype; granite-3-2b's widths (hd 64) and a
    q_offset < 0 whose first rows see no key, in bf16; the MoE train
    phase's shapes in bf16: granite-moe-1b-a400m's 16 / 8 heads at hd 64,
    batch 2 per tier over 1024 positions, and llava-next-34b's 56 / 8
    heads (a GQA ratio of 7) at hd 128, batch 1 per tier over 2048;
    zamba2-2.7b's shared block in the recurrent train phase, 32 / 32 heads
    at hd 80 (not a wgmma width, so the simt kernel), batch 2 per tier
    over 1024; llama3.2-3b's local heads on each of phase mesh's two
    model ranks, 12 / 4 at hd 128, batch 2 over 1024, and granite-moe's
    there (d3), 8 / 4 at hd 64; whisper-tiny's 6 heads of 64 at the audio train phase's
    shapes, batch 2 per tier: the encoder's non-causal self-attention over
    the 1500 frames (a ragged last 64-key tile of 28 keys), the
    cross-attention of 1024 queries over the 1500 frames (non-causal) and
    the decoder's causal self-attention over 1024; and the smoke config's
    hd 32 in bf16, which the simt kernel serves."""
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_config(LM_ARCH)
    granite = get_config("granite-3-2b")
    granite_moe, llava = get_config(MOE_ARCH), get_config(LLAVA)
    zamba, whisper = get_config(ZAMBA), get_config(WHISPER)
    smoke = get_smoke_config(LM_ARCH)
    gen = torch.Generator(device=device).manual_seed(5)

    def qkv(b, t, s, dtype, c=cfg):
        return [torch.randn(shape, generator=gen, device=device).to(dtype)
                for shape in ((b, t, c.num_heads, c.head_dim),
                              (b, s, c.num_kv_heads, c.head_dim),
                              (b, s, c.num_kv_heads, c.head_dim))]

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("train_bf16", *qkv(2, 1024, 1024, bf16), {}, "wgmma"),
             ("train_f32", *qkv(2, 1024, 1024, f32), {}, "simt")]
    for tag, dtype, rt in (("f32", f32, "simt"), ("bf16", bf16, "wgmma")):
        cases += [(f"window_{tag}", *qkv(1, 300, 300, dtype),
                   dict(window=100), rt),
                  (f"q_offset_ragged_s_{tag}", *qkv(1, 64, 1000, dtype),
                   dict(q_offset=936), rt),
                  (f"noncausal_ragged_{tag}", *qkv(2, 77, 333, dtype),
                   dict(causal=False), rt)]
    return cases + [
        ("granite_bf16", *qkv(2, 1024, 1024, bf16, granite), {}, "wgmma"),
        ("masked_rows_bf16", *qkv(1, 300, 300, bf16), dict(q_offset=-100),
         "wgmma"),
        ("granite_moe_bf16", *qkv(2, 1024, 1024, bf16, granite_moe), {},
         "wgmma"),
        ("llava_bf16", *qkv(1, 2048, 2048, bf16, llava), {}, "wgmma"),
        ("zamba_bf16", *qkv(2, 1024, 1024, bf16, zamba), {}, "simt"),
        ("whisper_enc_bf16", *qkv(2, 1500, 1500, bf16, whisper),
         dict(causal=False), "wgmma"),
        ("whisper_xattn_bf16", *qkv(2, 1024, 1500, bf16, whisper),
         dict(causal=False), "wgmma"),
        ("whisper_dec_bf16", *qkv(2, 1024, 1024, bf16, whisper), {},
         "wgmma"),
        ("local_heads_bf16", *qkv(2, 1024, 1024, bf16, cfg.replace(
            num_heads=cfg.num_heads // MESH_RANKS,
            num_kv_heads=cfg.num_kv_heads // MESH_RANKS)), {}, "wgmma"),
        ("moe_local_heads_bf16", *qkv(2, 1024, 1024, bf16,
                                      granite_moe.replace(
            num_heads=granite_moe.num_heads // MESH_RANKS,
            num_kv_heads=granite_moe.num_kv_heads // MESH_RANKS)), {},
         "wgmma"),
        ("smoke_hd32_bf16", *qkv(2, 64, 64, bf16, smoke), {}, "simt")]


def flash_work(q, k, causal=True, window=0, q_offset=0):
    """(bytes, flops) of one attention call: q, k, v read and o written
    once; 4*hd flops per (query, key) pair that this call's masks let
    through, counted from the masks."""
    import numpy as np
    b, t, h, hd = q.shape
    s = k.shape[1]
    qp = q_offset + np.arange(t)[:, None]
    kp = np.arange(s)[None, :]
    mask = np.ones((t, s), bool)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return n_bytes, 4.0 * b * h * hd * int(mask.sum())


def phase_lm_kernels(device) -> dict:
    import torch
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_forward
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.numerics import FORMATS, quantize_em
    rows = {}
    fmts = {n: f for n, f in FORMATS.items() if f.e_bits > 0}
    shapes = sorted(_fq_shapes().items(), key=lambda kv: math.prod(kv[0]))
    fq_err = 0.0
    for i, (shape, label) in enumerate(shapes):
        x = _fq_input(shape, device, seed=10 + i)
        # a leaf past HUGE elements: the plain version's temporaries do not
        # fit beside it, so the one whole-leaf launch is held against the
        # plain version slice by slice along the leading axis
        huge = x.numel() > HUGE
        bad, err = [], 0.0
        for n, f in fmts.items():
            out = fake_quant(x, f.e_bits, f.m_bits)
            pairs = ([(out[j], quantize_em(x[j], f.e_bits, f.m_bits))
                      for j in range(shape[0])] if huge
                     else [(out, quantize_em(x, f.e_bits, f.m_bits))])
            for a, b in pairs:
                if not _bitwise(a, b) and n not in bad:
                    bad.append(n)
                err = max(err, _max_abs_err(a, b))
            del out, pairs
        fq_err = max(fq_err, err)
        check(not bad, f"fake_quant {label} {shape} == quantize_em (bitwise) "
                       f"for {sorted(fmts)}{' slice by slice' * huge}; "
                       f"mismatched: {bad}, max_abs_err {err}")
        # timed: the kernel row's leaf (llama's embedding) and the leaves
        # new in kind, past HUGE elements or 5-D (every leaf until phase
        # mesh (d7) came: phase budget)
        if label != "llama embed" and not huge and x.dim() < 5:
            del x
            continue
        big = x.numel() > 10_000_000
        reps, inner = (5, 3) if big else (15, 20)
        n_bytes = 8 * x.numel()
        ms = time_ms(lambda: fake_quant(x, 4, 3), reps, inner)
        xp = x[0] if huge else x
        pms = time_ms(lambda: quantize_em(xp, 4, 3), reps, inner)
        dms = kernel_device_ms(lambda: fake_quant(x, 4, 3),
                               "fake_quant_kernel", calls=10 if big else 200)
        print(f"kernel fake_quant {label} {shape} fp8_e4m3: ms={ms:.6f} "
              f"plain_ms{'_of_one_leading_slice' * huge}={pms:.6f} "
              f"bound_ms={bound_ms(n_bytes):.6f} "
              f"device_ms={dms} bytes={n_bytes}")
        if label == "llama embed":
            rows["fake_quant"] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                                      bound_ms=bound_ms(n_bytes),
                                      bound_by="bytes", library_ms=None)
        del x
    rows["fake_quant"]["max_abs_err"] = fq_err

    # flash_attention: each case's launch must take its route
    err = {}                            # (route, dtype) -> max_abs_err
    routes = flash_attention.route_launches
    for label, q, k, v, kw, want in _flash_cases(device):
        before = dict(routes)
        out = flash_attention_forward(q, k, v, **kw).float()
        took = {r: routes[r] - before[r] for r in routes}
        ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        check(took == {r: int(r == want) for r in routes},
              f"flash_attention {label}: one launch on the {want} kernel, "
              f"took {took}")
        e = (out - ref).abs().max().item()
        if q.dtype == torch.float32:
            ok, tol = torch.allclose(out, ref, rtol=2e-5, atol=2e-5), \
                "rtol/atol 2e-5"
        else:
            _, ex = torch.frexp(ref)
            quantum = torch.ldexp(torch.ones_like(ref), ex - 8)
            ok = bool(torch.all((out - ref).abs() <= quantum + 2e-5))
            tol = "one bf16 quantum of the f32 result + 2e-5"
        check(ok, f"flash_attention {label} {tuple(q.shape)} vs plain "
                  f"version within {tol}, max_abs_err {e}")
        if kw.get("q_offset", 0) < 0:
            blind = out[:, :-kw["q_offset"]]
            check(not bool(blind.any()),
                  f"flash_attention {label}: the {blind.shape[1]} rows that "
                  f"see no key are exactly 0")
        key = (want, _dtype_name(q.dtype))
        err[key] = max(err.get(key, 0.0), e)
        if label not in ("train_bf16", "train_f32", "granite_bf16",
                         "granite_moe_bf16", "llava_bf16", "zamba_bf16",
                         "whisper_enc_bf16", "whisper_xattn_bf16",
                         "whisper_dec_bf16", "local_heads_bf16",
                         "moe_local_heads_bf16"):
            continue
        n_bytes, flops = flash_work(q, k, **kw)
        rate = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else F32_FLOP_PER_S
        bms = bound_ms(n_bytes, flops, rate)
        by = "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / rate \
            else "operations"
        ms = time_ms(lambda: flash_attention_forward(q, k, v, **kw))
        pms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), 7, 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw.get("causal", True),
                enable_gqa=True)
        # the yardstick is SDPA at its fastest: main() turns deterministic
        # algorithms on for the bitwise checks, which may steer SDPA to a
        # slower backend, so it is timed with them off, and on for the record
        lms_det = time_ms(sdpa)
        torch.use_deterministic_algorithms(False)
        try:
            lms = time_ms(sdpa)
        finally:
            torch.use_deterministic_algorithms(True)
        dms = kernel_device_ms(lambda: flash_attention_forward(q, k, v, **kw),
                               "flash_attention_kernel", calls=20)
        print(f"kernel flash_attention {label} route={want} "
              f"{tuple(q.shape)} kv {tuple(k.shape)}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} sdpa_ms={lms:.6f} "
              f"sdpa_deterministic_ms={lms_det:.6f} bound_ms={bms:.6f} "
              f"({by}) device_ms={dms} tflops_useful="
              f"{flops / ms / 1e9:.3f} bytes={n_bytes} flops={flops:.0f}")
        name = {"train_bf16": "flash_attention_wgmma",
                "train_f32": "flash_attention"}.get(label)
        if name:
            rows[name] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                              bound_ms=bms, bound_by=by, library_ms=lms,
                              dtype=_dtype_name(q.dtype))
    _route_errors("flash_attention", err, rows, {
        "wgmma": "flash_attention_wgmma", "simt": "flash_attention"})
    return rows


# ------------------------------------------------------ matmul kernels

def _mm_weights(device) -> dict:
    """One layer's ``layers.mlp.wi.w`` (3072, 8192) and
    ``layers.mlp.wo.w`` (8192, 3072) of llama3.2-3b, from the seeded init
    of a one-layer cut of the full config."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    p = get_model(get_config(LM_ARCH).replace(num_layers=1)).init(
        0, device=device)
    out = {"wi": p["layers.mlp.wi.w"][0].clone(),
           "wo": p["layers.mlp.wo.w"][0].clone()}
    del p
    return out


def _masked_cases(ws, device):
    """(label, x, w, mask, g) for masked_matmul: wi and wo under the low
    tier's mask (density 0.25, the port's magnitude_mask), x at M = 256
    (serve: batch 4 x prompt 64) and M = 8192 (train: 8 x 1024), f32 and
    bf16; then a ragged shape and the paper MLP's (16, 10) @ (10, 10) in
    f32; in bf16 a mask that is 0 or uniform in [0, 1) at (256, 3072) @
    (3072, 512), a ragged shape TMA describes, (136, 264) @ (264, 200),
    and one it refuses, (130, 257) @ (257, 129)."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, magnitude_mask
    density = DEVICE_TIERS["low"].density
    gen = torch.Generator(device=device).manual_seed(21)
    cases = []
    for wname, w in ws.items():
        mask = magnitude_mask(w, density)
        for tag, m in (("serve", 256), ("train", 8192)):
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x, g = (torch.randn(shape, generator=gen, device=device)
                        .to(dtype) for shape in ((m, w.shape[0]),
                                                 (m, w.shape[1])))
                cases.append((f"{tag}_{wname}_{dt}", x, w.to(dtype),
                              mask.to(dtype), g))
    for tag, (m, k, n) in (("ragged", (130, 257, 129)),
                           ("paper_mlp", (16, 10, 10))):
        x, w, g = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((m, k), (k, n), (m, n)))
        cases.append((f"{tag}_f32", x, w, magnitude_mask(w, density), g))
    for tag, (m, k, n) in (("nonbinary", (256, 3072, 512)),
                           ("ragged_tma", (136, 264, 200)),
                           ("ragged", (130, 257, 129))):
        x, w, g = (torch.randn(shape, generator=gen, device=device)
                   for shape in ((m, k), (k, n), (m, n)))
        if tag == "nonbinary":
            mask = torch.where(torch.rand((k, n), generator=gen,
                                          device=device) < 0.5, 0.0,
                               torch.rand((k, n), generator=gen,
                                          device=device))
        else:
            mask = magnitude_mask(w, density)
        cases.append((f"{tag}_bf16", *(t.to(torch.bfloat16)
                                       for t in (x, w, mask, g))))
    return cases


def _expected_route(label: str) -> str:
    """The masked_matmul kernel each case's three launches must take:
    bf16 at llama3.2-3b's shapes and the TMA-describable ragged and
    non-binary shapes on the tensor cores, the rest on the CUDA cores."""
    return ("simt" if label.endswith("_f32") or label == "ragged_bf16"
            else "wgmma")


def _codebook_cases(ws, device):
    """(label, x, idx, codebook) for codebook_matmul: wi (and wo) pruned
    like the embedded tier and clustered by the port's kmeans_codebook /
    assign_codebook at its k = 16 (int8 and int32 indices) and at k = 256
    (int32), x at M = 256 and 8192 in f32 (and in bf16 for int8 k = 16
    and int32 k = 256); then the train int8 case with idx rows padded to
    N + 4 bytes (which TMA refuses), a ragged shape and the paper MLP's."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, magnitude_mask
    from repro_torch.core.compression.clustering import (assign_codebook,
                                                         kmeans_codebook)
    emb = DEVICE_TIERS["embedded"]
    gen = torch.Generator(device=device).manual_seed(22)

    def clustered(w, k):
        w = w * magnitude_mask(w, emb.density)
        cb = kmeans_codebook(w, k)
        return assign_codebook(w, cb), cb

    cases, xs = [], {}
    i16, cb16 = clustered(ws["wi"], emb.cluster_k)
    i256, cb256 = clustered(ws["wi"], 256)
    i8, i32, i256 = i16.to(torch.int8), i16.to(torch.int32), i256.int()
    for tag, m in (("serve", 256), ("train", 8192)):
        x = xs[tag] = torch.randn((m, ws["wi"].shape[0]), generator=gen,
                                  device=device)
        xb = x.to(torch.bfloat16)
        cases += [(f"{tag}_wi_k16_int8", x, i8, cb16),
                  (f"{tag}_wi_k16_int32", x, i32, cb16),
                  (f"{tag}_wi_k256_int32", x, i256, cb256),
                  (f"{tag}_wi_k16_int8_bf16", xb, i8, cb16),
                  (f"{tag}_wi_k256_int32_bf16", xb, i256, cb256)]
    k, n = i8.shape
    padded = torch.zeros((k, n + 4), dtype=torch.int8, device=device)
    cases.append(("train_wi_k16_int8_padded", xs["train"],
                  padded[:, :n].copy_(i8), cb16))
    iwo, cbwo = clustered(ws["wo"], emb.cluster_k)
    cases.append(("serve_wo_k16_int64", torch.randn(
        (256, ws["wo"].shape[0]), generator=gen, device=device), iwo, cbwo))
    for tag, (m, k, n) in (("ragged", (130, 257, 129)),
                           ("paper_mlp", (16, 10, 10))):
        idx, cb = clustered(torch.randn((k, n), generator=gen,
                                        device=device), emb.cluster_k)
        cases.append((f"{tag}_k16_int8", torch.randn(
            (m, k), generator=gen, device=device), idx.to(torch.int8), cb))
    return cases


def _codebook_route(label: str) -> str:
    """The codebook_matmul kernel each case must take: every case at
    llama3.2-3b's widths on the tensor cores, f32 x or bf16, int8 read in
    place or int32 / int64 narrowed; the padded idx rows, the ragged
    shape's (257 f32 and 129 int8 elements) and the paper MLP's (10)
    rows, which TMA refuses, on the CUDA cores."""
    return ("simt" if label.startswith(("ragged", "paper_mlp"))
            or label.endswith("_padded") else "wgmma")


F32_UNIT_ROUNDOFF = 2.0 ** -24
SUM_ROUNDOFFS = 16      # f32 roundoffs of sum |a||b| allowed between orders


def _bf16_quantum(t):
    """The bf16 spacing at each element of ``t`` (0 at 0)."""
    import torch
    q = torch.ldexp(torch.ones_like(t), torch.frexp(t)[1] - 8)
    return torch.where(t == 0, torch.zeros_like(t), q)


def _mm_within(out, ref, depth: int, abs_sum=None):
    """f32: rtol 1e-4 and atol 1e-4 x sqrt(contraction length), the
    reference test's bound (another summation order). bf16: both round an
    f32 sum of the same bf16 products (exact in f32), taken in other
    orders. Two such sums differ by a few f32 roundoffs of ``abs_sum`` =
    sum |a||b| (the products' magnitudes); rounding each to bf16 adds at
    most half a quantum of each. So |out - ref| <= the larger quantum of
    the two + SUM_ROUNDOFFS * 2^-24 * abs_sum."""
    import torch
    if out.dtype == torch.float32:
        return bool(torch.allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * depth ** 0.5))
    return bool(torch.all(_bf16_excess(out, ref, abs_sum) <= SUM_ROUNDOFFS))


def _bf16_excess(out, ref, abs_sum):
    """max(|out - ref| - the larger bf16 quantum, 0) in f32 roundoffs of
    ``abs_sum``, per element: what the bf16 check compares with
    SUM_ROUNDOFFS."""
    import torch
    out, ref = out.float(), ref.float()
    q = torch.maximum(_bf16_quantum(out), _bf16_quantum(ref))
    over = ((out - ref).abs() - q).clamp_min(0)
    return torch.where(over == 0, torch.zeros_like(over),
                       over / (F32_UNIT_ROUNDOFF * abs_sum))


def _masked_abs_sums(x, w, mask, g):
    """sum |a||b| of the products behind y, dx and dw, in f32: |x| @
    |w*mask|, |g| @ |w*mask|^T and (|x|^T @ |g|) * mask."""
    import torch
    ax, ag = x.float().abs(), g.float().abs()
    awm = (w.float() * mask.float()).abs()
    return ax @ awm, ag @ awm.t(), (ax.t() @ ag) * mask.float()


def _mm_work(x, n: int, b_bytes: int):
    """(bytes, flops) of one product x (M, K) @ B (K, N): x, B's inputs
    and the output moved once; 2*M*K*N operations."""
    m, k = x.shape
    return (x.numel() * x.element_size() + b_bytes
            + m * n * x.element_size()), 2.0 * m * k * n


def phase_matmul_kernels(device) -> tuple[dict, dict]:
    """The public kernel API's two matmuls. The main path (counters
    zeroed just before, read just after) runs masked_matmul forward and
    backward through autograd and codebook_matmul forward on every case;
    its results are then held against the plain versions, and each
    forward is timed. Returns (rows, launches)."""
    import torch
    from repro_torch.kernels import codebook_matmul, masked_matmul
    from repro_torch.kernels.codebook_matmul.ref import (codebook_matmul_ref,
                                                         decode)
    from repro_torch.kernels.masked_matmul.ops import masked_product
    from repro_torch.kernels.masked_matmul.ref import masked_matmul_ref
    ws = _mm_weights(device)
    mcases = _masked_cases(ws, device)
    ccases = _codebook_cases(ws, device)
    del ws

    def fwd_bwd(fn, x, w, mask, g):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xl, wl, mask)
        return (y.detach(), *torch.autograd.grad(y, (xl, wl), g))

    torch.cuda.synchronize()
    masked_matmul.launches = 0
    routes = masked_matmul.route_launches
    for r in routes:
        routes[r] = 0
    codebook_matmul.launches = 0
    croutes = codebook_matmul.route_launches
    for r in croutes:
        croutes[r] = 0
    m_out, m_routes, c_out, c_routes = {}, {}, {}, {}
    for lbl, x, w, m, g in mcases:
        before = dict(routes)
        m_out[lbl] = fwd_bwd(masked_matmul, x, w, m, g)
        m_routes[lbl] = {r: routes[r] - before[r] for r in routes}
    for lbl, x, idx, cb in ccases:
        before = dict(croutes)
        c_out[lbl] = codebook_matmul(x, idx, cb)
        c_routes[lbl] = {r: croutes[r] - before[r] for r in croutes}
    torch.cuda.synchronize()
    launches = {"masked_matmul": masked_matmul.launches,
                "masked_matmul_wgmma": routes["wgmma"],
                "masked_matmul_simt": routes["simt"],
                "codebook_matmul_calls": codebook_matmul.launches,
                "codebook_matmul_wgmma": croutes["wgmma"],
                "codebook_matmul_simt": croutes["simt"]}
    print(f"matmul main path: launches={json.dumps(launches)} over "
          f"{len(mcases)} masked (forward + dx + dw) and {len(ccases)} "
          f"codebook calls")
    for lbl, _, _, _, _ in mcases:
        print(f"masked_matmul {lbl}: launches per route "
              f"{json.dumps(m_routes[lbl])}")
    check(launches["masked_matmul"] == 3 * len(mcases),
          "masked_matmul launched 3 times per forward + backward")
    check(all(m_routes[lbl][_expected_route(lbl)] == 3
              for lbl, _, _, _, _ in mcases),
          "masked_matmul: every bf16 case at llama3.2-3b's shapes, the "
          "non-binary and the TMA ragged case on the wgmma kernel, f32 and "
          "the (130, 257, 129) bf16 case on the CUDA-core kernel")
    check(launches["codebook_matmul_calls"] == len(ccases),
          "codebook_matmul launched once per call")
    for lbl, _, _, _ in ccases:
        print(f"codebook_matmul {lbl}: launches per route "
              f"{json.dumps(c_routes[lbl])}")
    check(all(c_routes[lbl] == {r: int(r == _codebook_route(lbl))
                                for r in croutes} for lbl, _, _, _ in ccases),
          "codebook_matmul: every case at llama3.2-3b's widths (f32 and bf16 "
          "x, int8, int32, int64 idx) on the wgmma kernel; the padded idx "
          "rows, the ragged and the paper-MLP shapes on the CUDA-core kernel")

    rows, m_err, c_err = {}, {}, {}     # (route, dtype) -> max_abs_err
    for lbl, x, w, mask, g in mcases:
        got = m_out.pop(lbl)
        want = fwd_bwd(masked_matmul_ref, x, w, mask, g)
        m_, k_ = x.shape
        n_ = w.shape[1]
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        key = (_expected_route(lbl), _dtype_name(x.dtype))
        m_err[key] = max(m_err.get(key, 0.0), *errs)
        sums = _masked_abs_sums(x, w, mask, g)
        # the gap in f32 roundoffs of sum |a||b|: the f32 sums' own (for
        # f32), what a bf16 result has beyond one quantum (for bf16)
        gaps = [(_bf16_excess(a, b, s) if a.dtype == torch.bfloat16 else
                 (a - b).abs() / (F32_UNIT_ROUNDOFF * s)).nan_to_num().max()
                .item() for a, b, s in zip(got, want, sums)]
        print(f"masked_matmul {lbl} {x.dtype}: y, dx, dw max_abs_err {errs}; "
              f"gap in f32 roundoffs of sum|a||b| {gaps} (bf16: beyond one "
              f"quantum, limit {SUM_ROUNDOFFS})")
        if lbl.startswith("nonbinary"):
            # dw = round(round(x^T @ g) * mask): rounding x^T @ g twice
            # lets two summation orders differ by more than one final
            # quantum, so dw is held bitwise to the kernel's own x^T @ g
            # masked in bf16, and that product to the plain one
            xtg = masked_product(x.t(), g)
            plain_xtg = (x.float().t() @ g.float()).to(x.dtype)
            xtg_sum = x.float().abs().t() @ g.float().abs()
            over = int((_bf16_excess(got[2], want[2], sums[2])
                        > SUM_ROUNDOFFS).sum())
            print(f"masked_matmul {lbl}: dw elements beyond one quantum + "
                  f"{SUM_ROUNDOFFS} roundoffs of the plain dw: {over} of "
                  f"{got[2].numel()}; x^T@g gap "
                  f"{_bf16_excess(xtg, plain_xtg, xtg_sum).max().item()}")
            check(all(_mm_within(a, b, d, s) for a, b, d, s in
                      zip(got[:2], want[:2], (k_, n_), sums[:2]))
                  and torch.equal(got[2], xtg * mask)
                  and _mm_within(xtg, plain_xtg, m_, xtg_sum),
                  f"masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype}, mask "
                  f"0 or uniform in [0, 1): y, dx within tolerance of the "
                  f"plain version's autograd; dw bitwise round(x^T@g) * "
                  f"mask in bf16, x^T@g within tolerance of the plain one")
            del xtg, plain_xtg, xtg_sum
        else:
            check(all(_mm_within(a, b, d, s)
                      for a, b, d, s in zip(got, want, (k_, n_, m_), sums)),
                  f"masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype}: y, dx, "
                  f"dw vs the plain version's autograd within tolerance, "
                  f"max_abs_err {errs}, roundoffs of sum|a||b| {gaps}")
        del sums
        check(bool(torch.all(got[2][mask == 0] == 0)),
              f"masked_matmul {lbl}: dw exactly 0 wherever the mask is 0")
        del got, want
        big = m_ >= 4096
        reps, inner = (5, 2) if big else (15, 10)
        wm = w * mask
        n_bytes, flops = _mm_work(x, n_, 2 * w.numel() * w.element_size())
        rate = (BF16_FLOP_PER_S if x.dtype == torch.bfloat16
                else F32_FLOP_PER_S)
        bms = bound_ms(n_bytes, flops, rate)
        by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= flops / rate
              else "operations")
        with torch.no_grad():
            ms = time_ms(lambda: masked_matmul(x, w, mask), reps, inner)
            pms = time_ms(lambda: masked_matmul_ref(x, w, mask), reps, inner)
            lms = time_ms(lambda: torch.matmul(x, wm), reps, inner)
            dms = kernel_device_ms(lambda: masked_matmul(x, w, mask),
                                   "masked_matmul_kernel",
                                   calls=5 if big else 100)
        print(f"kernel masked_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} "
              f"route {_expected_route(lbl)}: "
              f"ms={ms:.6f} plain_ms={pms:.6f} matmul_ms={lms:.6f} "
              f"bound_ms={bms:.6f} ({by}) device_ms={dms} bytes={n_bytes} "
              f"flops={flops:.0f} tflops={flops / ms / 1e9:.2f}")
        if lbl in ("train_wi_f32", "train_wi_bf16"):
            rows["masked_matmul" if lbl.endswith("f32")
                 else "masked_matmul_wgmma"] = dict(
                ms=ms, plain_ms=pms, device_ms=dms, bound_ms=bms,
                bound_by=by, library_ms=lms, dtype=_dtype_name(x.dtype))
    _route_errors("masked_matmul", m_err, rows, {
        "wgmma": "masked_matmul_wgmma", "simt": "masked_matmul"})

    for lbl, x, idx, cb in ccases:
        out = c_out.pop(lbl)
        ref = codebook_matmul_ref(x, idx, cb)
        route = _codebook_route(lbl)
        m_, k_ = x.shape
        n_ = idx.shape[1]
        e = (out.float() - ref.float()).abs().max().item()
        key = (route, _dtype_name(x.dtype))
        c_err[key] = max(c_err.get(key, 0.0), e)
        abs_sum = x.float().abs() @ decode(idx, cb).abs()
        gap = (_bf16_excess(out, ref, abs_sum) if x.dtype == torch.bfloat16
               else (out - ref).abs() / (F32_UNIT_ROUNDOFF * abs_sum)
               ).nan_to_num().max().item()
        check(_mm_within(out, ref, k_, abs_sum),
              f"codebook_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} x, "
              f"{idx.dtype} idx, k={cb.numel()}, route {route}: vs the plain "
              f"version within tolerance, max_abs_err {e}, gap in f32 "
              f"roundoffs of sum|x||c| {gap} (bf16: beyond one quantum)")
        del abs_sum
        big = m_ >= 4096
        reps, inner = (5, 2) if big else (15, 10)
        wd, xf = cb[idx.long()], x.float()
        n_bytes, flops = _mm_work(x, n_, idx.numel() * idx.element_size()
                                  + cb.numel() * 4)
        # wgmma: three bf16 products for bf16 x, six for f32 x, at the
        # bf16 peak; simt: one f32 product at the f32 CUDA-core peak
        products = (1 if route == "simt" else
                    3 if x.dtype == torch.bfloat16 else 6)
        rate = F32_FLOP_PER_S if route == "simt" else BF16_FLOP_PER_S
        bms = bound_ms(n_bytes, products * flops, rate)
        by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= products * flops / rate
              else "operations")
        ms = time_ms(lambda: codebook_matmul(x, idx, cb), reps, inner)
        pms = time_ms(lambda: codebook_matmul_ref(x, idx, cb), reps, inner)
        lms = time_ms(lambda: torch.matmul(xf, wd), reps, inner)
        dms = kernel_device_ms(lambda: codebook_matmul(x, idx, cb),
                               "codebook_matmul_kernel",
                               calls=5 if big else 100)
        print(f"kernel codebook_matmul {lbl} ({m_}, {k_}, {n_}) {x.dtype} x "
              f"{idx.dtype} idx k={cb.numel()} route {route}: ms={ms:.6f} "
              f"plain_ms={pms:.6f} matmul_f32_ms={lms:.6f} "
              f"bound_ms={bms:.6f} ({by}; {products} products) "
              f"one_product_bound_ms={bound_ms(n_bytes, flops, rate):.6f} "
              f"device_ms={dms} bytes={n_bytes} flops={flops:.0f} "
              f"tflops={flops / ms / 1e9:.2f}")
        name = {"train_wi_k16_int8_padded": "codebook_matmul",
                "train_wi_k16_int8_bf16": "codebook_matmul_wgmma"}.get(lbl)
        if name:
            rows[name] = dict(ms=ms, plain_ms=pms, device_ms=dms,
                              bound_ms=bms, bound_by=by, library_ms=lms,
                              dtype=_dtype_name(x.dtype))
        del wd, xf
    _route_errors("codebook_matmul", c_err, rows, {
        "wgmma": "codebook_matmul_wgmma", "simt": "codebook_matmul"})
    del mcases, ccases, m_out, c_out
    torch.cuda.empty_cache()
    return rows, launches


# --------------------------------------------------------------- slice

def _run(scenario, engine, device, label, ms_log=None, rounds=ROUNDS):
    """``simulate`` for ``rounds`` rounds, timed; the ms per round also go
    into ``ms_log[(label, engine)]`` when given."""
    import torch
    from repro_torch.fl import simulate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(scenario, rounds, engine=engine, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / rounds * 1e3
    if ms_log is not None:
        ms_log[(label, engine)] = ms
    losses = res.losses
    print(f"slice {label} engine={engine}: ms_per_round={ms:.3f} "
          f"agg_backend={res.agg_backend} loss[1]={losses[0]:.6f} "
          f"loss[{rounds}]={losses[-1]:.6f}")
    check(all(l is not None and l == l and abs(l) != float("inf")
              for l in losses), f"{label}/{engine}: losses finite")
    check(losses[-1] < losses[0], f"{label}/{engine}: loss falls over "
                                  f"{rounds} rounds")
    return res


def _fused_run(scenario, device, label, expect_backend, ms_log=None,
               rounds=ROUNDS):
    """The main path: scan_pallas with every launch counter zeroed just
    before and read just after; one fleet_aggregate launch a round, and
    none through the one-leaf wrappers."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import structured_scatter
    counters = {"fleet_aggregate": fleet_aggregate,
                "grad_aggregate": grad_aggregate,
                "structured_scatter": structured_scatter,
                "fake_quant": fake_quant}
    for fn in counters.values():
        fn.launches = 0
    res = _run(scenario, "scan_pallas", device, label, ms_log, rounds)
    got = {k: fn.launches for k, fn in counters.items()}
    print(f"slice {label}: launches={json.dumps(got)} per_round="
          f"{json.dumps({k: v / rounds for k, v in got.items()})}")
    check(res.agg_backend == expect_backend,
          f"{label}: agg_backend == {expect_backend!r}")
    for k, n in (("fleet_aggregate", 1), ("grad_aggregate", 0),
                 ("structured_scatter", 0)):
        check(got[k] == n * rounds, f"{label}: {k} launched {n} per round")
    return res, got


def _per_leaf_route(params, per_cohort, sliced: bool):
    """The round's aggregation one launch per leaf, as the engine ran it
    before the grouped kernel: masked fleets ``grad_aggregate`` on each
    >=2-D leaf over the cohorts stacked on a tier axis and the chain on
    1-D leaves; width fleets ``structured_scatter_batched`` per group of
    same-signature leaves, stacked."""
    import torch
    from repro_torch.core.aggregation import accumulate_cohort, f32, finalize
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import (
        structured_scatter_batched)
    wn = [f32(w) for (_, _, w, _) in per_cohort]
    wd = [f32(f32(w) * f32(c)) for (_, _, w, c) in per_cohort]
    out = {}
    if sliced:
        groups: dict = {}
        for k, p in params.items():
            sig = (tuple(p.shape),
                   tuple(tuple(g[k].shape) for (g, _, _, _) in per_cohort),
                   tuple(m[k].dim() == 0 for (_, m, _, _) in per_cohort))
            groups.setdefault(sig, []).append(k)
        for (shape, _, _), ks in groups.items():
            res = structured_scatter_batched(
                [torch.stack([g[k] for k in ks]) for (g, _, _, _) in per_cohort],
                [torch.stack([m[k] for k in ks]) for (_, m, _, _) in per_cohort],
                wn, wd, out_shape=shape)
            for j, k in enumerate(ks):
                out[k] = res[j]
        return out
    for k, p in params.items():
        g_t = [g[k] for (g, _, _, _) in per_cohort]
        m_t = [m[k] for (_, m, _, _) in per_cohort]
        if p.dim() >= 2:
            ms = (torch.stack(m_t) if all(m.dim() == 0 for m in m_t) else
                  torch.stack([m.expand(p.shape) for m in m_t]))
            out[k] = grad_aggregate(torch.stack(g_t), ms, wn, w_den=wd)
            continue
        acc = ({"x": torch.zeros_like(p)},
               {"x": torch.zeros((), dtype=torch.float32, device=p.device)})
        for t, (_, _, w, count) in enumerate(per_cohort):
            acc = accumulate_cohort(acc, {"x": g_t[t]}, {"x": m_t[t]},
                                    w, count)
        out[k] = finalize(acc)["x"]
    return out


def aggregation_step(scenario, device, label: str) -> None:
    """One real round's aggregation (the cohorts' updates and masks of the
    round as ``ScanEngine`` hands them over): the grouped call bitwise the
    sequential chain and the per-leaf route, each timed with CUDA events,
    the grouped call's device time, launches and bytes bound."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import ScanEngine, build_server
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.models import mlp
    srv = build_server(scenario, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = ScanEngine(srv, agg="pallas")
    seen = []
    fused = eng._aggregate_fused
    eng._aggregate_fused = lambda p, pc: seen.append((p, pc)) or fused(p, pc)
    eng.run(1)
    params, per_cohort = seen[0]
    before = fleet_aggregate.launches
    got = fused(params, per_cohort)
    n_launch = fleet_aggregate.launches - before
    chain = eng._aggregate_sequential(params, per_cohort)
    leaf = _per_leaf_route(params, per_cohort, eng._any_sliced)
    torch.cuda.synchronize()
    check(all(torch.equal(got[k], chain[k]) and torch.equal(leaf[k], chain[k])
              for k in params),
          f"{label}: the round's grouped aggregation == the sequential chain "
          f"== the per-leaf route (bitwise)")
    leaves = {k: (p.shape, [(g[k], m[k]) for (g, m, _, _) in per_cohort])
              for k, p in params.items()}
    n_bytes = _leaves_bytes(leaves)
    ms = time_ms(lambda: fused(params, per_cohort))
    chain_ms = time_ms(lambda: eng._aggregate_sequential(params, per_cohort))
    leaf_ms = time_ms(lambda: _per_leaf_route(params, per_cohort,
                                              eng._any_sliced))
    dms = kernel_device_ms(lambda: fused(params, per_cohort),
                           "fleet_aggregate_kernel")
    print(f"slice {label} aggregation step: leaves={len(params)} "
          f"tiers={len(per_cohort)} grouped_ms={ms:.6f} "
          f"device_ms={dms:.6f} launches={n_launch} "
          f"bound_ms={bound_ms(n_bytes):.7f} bytes={n_bytes} "
          f"chain_ms={chain_ms:.6f} per_leaf_route_ms={leaf_ms:.6f}")


def _same_params(a, b) -> float:
    import torch
    if all(torch.equal(a[k], b[k]) for k in a):
        return 0.0
    return max((a[k] - b[k]).abs().max().item() for k in a)


def profile_window(label: str, fn, n: int, per: str) -> None:
    """Where a window's time goes: host wall time of ``fn()`` (``n``
    rounds, steps or calls) against the device time of every kernel and
    copy it ran. The trace is the device's alone (nothing here reads the
    host's operators, and tracing them slows the host); the tracing still
    slows the host a little, so the wall time reads above the unprofiled
    one."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = device_events(prof)
    busy_ms = sum(us for _, us in ev) / 1e3
    by_name = collections.Counter()
    for name, us in ev:
        by_name[name[:60]] += us / 1e3
    print(f"profile {label}: wall_ms_per_{per}={wall_ms / n:.3f} "
          f"device_busy_ms_per_{per}={busy_ms / n:.3f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} "
          f"device_ops_per_{per}={len(ev) / n:.1f} (profiled)")
    for name, t in by_name.most_common(6):
        print(f"profile {label}: top device time {t / n:.4f} ms/{per} "
              f"{name}")


def profile_rounds(scenario, device, label: str, rounds: int = 2) -> None:
    """A profiled scan_pallas window of ``rounds`` rounds."""
    import torch

    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import ScanEngine, build_server
    from repro_torch.models import mlp
    srv = build_server(scenario, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = ScanEngine(srv, agg="pallas")
    eng.run(2)
    profile_window(label, lambda: eng.run(rounds), rounds, "round")


def _shared_bisection_check(device) -> None:
    """``magnitude_masks`` (small CUDA leaves share one bisection) bitwise
    ``magnitude_mask`` leaf by leaf: the paper MLP's compressible leaves
    alone and as cohorts of 8, 64 and 256 clients (each client its own
    scaling), and LM-sized small leaves (whisper-tiny's stacked norms and
    MLP biases, an (8, 8192) block), at the tiers' densities and 0.1;
    then the host time of the MLP's masks both ways."""
    import torch
    from repro_torch.configs.paper_mlp import config
    from repro_torch.core.compression import magnitude_mask, magnitude_masks
    from repro_torch.models import mlp
    gen = torch.Generator(device=device).manual_seed(3)
    leaves = {k: v for k, v in mlp.init(torch.Generator().manual_seed(0),
                                        config(), device).items()
              if v.dim() == 2}
    cases = [(leaves, 0)]
    for c in (8, 64, 256):
        scale = torch.rand((c, 1, 1), generator=gen, device=device) + 0.5
        cases.append(({k: v * scale for k, v in leaves.items()}, 1))
    cases.append(({s: torch.randn(s, generator=gen, device=device)
                   for s in ((4, 384), (4, 1536), (8, 8192), (12, 512))}, 0))
    n, differ = 0, []
    for ws, batch in cases:
        for density in (0.5, 0.25, 0.1):
            got = magnitude_masks(ws, density, batch)
            for k, w in ws.items():
                n += 1
                if not torch.equal(got[k], magnitude_mask(w, density, batch)):
                    differ.append((k, tuple(w.shape), density))
    check(not differ, f"shared bisection: {n - len(differ)} of {n} leaf "
                      f"masks == their own bisection's (bitwise); differ: "
                      f"{differ}")
    per_leaf = time_ms(lambda: [magnitude_mask(w, 0.25) for w in
                                leaves.values()], reps=5, inner=10)
    shared = time_ms(lambda: magnitude_masks(leaves, 0.25), reps=5, inner=10)
    print(f"shared bisection: the MLP's "
          f"{len(leaves)} leaves per_leaf_ms={per_leaf:.3f} "
          f"shared_ms={shared:.3f}")


def phase_slice(device, ms_log: dict) -> dict:
    """The 256-client FL slice; fills ``ms_log`` with each clean run's
    ms per round, keyed ``(label, engine)``. Returns launches."""
    import torch
    from repro_torch.fl import (FleetSpec, FLScenario, LocalTraining,
                                ParticipationPolicy, UploadPolicy, simulate)
    _shared_bisection_check(device)
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    masked = FLScenario(fleet=fleet)
    width = FLScenario(fleet=fleet, local=LocalTraining(submodel="width"))
    fedavg = FLScenario(
        fleet=FleetSpec.cycling(QUICKSTART_TIERS, 256, samples_per_client=16),
        local=LocalTraining(mode="fedavg"),
        upload=UploadPolicy(quant="fp8_e4m3", error_feedback=True))

    # agreement with the port's CPU path on a small input
    small = FLScenario(fleet=FleetSpec.cycling(BENCH_TIERS, 16),
                       participation=ParticipationPolicy(0.5, seed=11))
    cpu = simulate(small, 3, device="cpu")
    gpu = simulate(small, 3, engine="scan_pallas", device=device)
    diff = max((cpu.params[k] - gpu.params[k].cpu()).abs().max().item()
               for k in cpu.params)
    check(diff <= 1e-5, f"small fleet: CUDA scan_pallas params vs CPU eager, "
                        f"max_abs_err {diff} <= 1e-5")

    # warm-up: first CUDA use of each path (library handles, kernel loads)
    for sc in (masked, width):
        simulate(sc, 2, engine="scan_pallas", device=device)
    # the kernels line's rows: the grouped kernel stands for grad_aggregate
    # on masked and fedavg fleets, for structured_scatter on width fleets
    launches = {"grad_aggregate": 0, "structured_scatter": 0, "fake_quant": 0}

    _run(masked, "eager", device, "masked", ms_log)
    ref = _run(masked, "scan", device, "masked", ms_log)
    res, got = _fused_run(masked, device, "masked", "pallas", ms_log)
    launches["grad_aggregate"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    check(_same_params(ref.params, res.params) == 0.0,
          "masked: scan_pallas params == scan params (bitwise)")

    _run(width, "eager", device, "width", ms_log)
    ref = _run(width, "scan", device, "width", ms_log)
    res, got = _fused_run(width, device, "width", "pallas_structured",
                          ms_log)
    launches["structured_scatter"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    check(_same_params(ref.params, res.params) == 0.0,
          "width: scan_pallas params == scan params (bitwise)")

    ref = _run(fedavg, "scan", device, "fedavg_fp8_ef", rounds=FEDAVG_ROUNDS)
    res, got = _fused_run(fedavg, device, "fedavg_fp8_ef", "pallas",
                          rounds=FEDAVG_ROUNDS)
    launches["grad_aggregate"] += got["fleet_aggregate"]
    launches["fake_quant"] += got["fake_quant"]
    d = _same_params(ref.params, res.params)
    print(f"slice fedavg_fp8_ef: scan_pallas vs scan max_abs_err={d}")
    check(d <= 1e-5, "fedavg_fp8_ef: scan_pallas params == scan to 1e-5")
    fleets = (("masked", masked), ("width", width), ("fedavg_fp8_ef", fedavg))
    for label, sc in fleets:
        aggregation_step(sc, device, label)
    for label, sc in fleets:
        profile_rounds(sc, device, label)
    return launches


# ------------------------------------------------------------ examples

# each line of the hetero_fl_sim example is held to the reference's
# healthy run, val_acc >= 0.97, but one: on the port's own draw (data,
# init and validation set from its generators) the reference's run of
# ``async buffer=2 + jitter`` also ends at 0.965, so its bar is that
# value less 0.01 (tests/test_torch_examples.py::
# test_async_jitter_line_on_the_ports_draw_is_the_references)
EXAMPLE_VAL_ACC = 0.97
EXAMPLE_VAL_ACC_OF = {"async buffer=2 + jitter": 0.965 - 0.01}
# the reference's default is 300: at 300 one host took 1134 s of command,
# 1086 s of phases (PERF.md §7). 100 since phase mesh's ranks (d) came
# (150 took 820 s of phases on an H100 80GB HBM3 host), 50 since its MoE
# part (d3) came, 20 since its part (d4), 10 since its part (d5); a
# checkpoint every TRAIN_100M_CKPT_EVERY in place of the script's 100, so
# that two are written and the last is the final step's
TRAIN_100M_STEPS = 10
TRAIN_100M_CKPT_EVERY = 5
# hetero_fl_sim's scan block (eager against the scan engine, bitwise, and
# their steady-state rounds/s) at this many rounds of its lines' 60
HETERO_SCAN_ROUNDS = 5
SERVE_TIE = 1e-4                    # top-2 logit gap where decodes may part


def _counters() -> dict:
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import structured_scatter
    return {"fake_quant": fake_quant, "fleet_aggregate": fleet_aggregate,
            "grad_aggregate": grad_aggregate,
            "structured_scatter": structured_scatter,
            "flash_attention": flash_attention}


def _example(name: str, fn, launches: dict):
    """``fn()`` with every launch counter zeroed just before and read
    just after (added into ``launches``), timed between device syncs."""
    import torch
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    print(f"examples {name}: wall_s={s:.3f} launches={json.dumps(got)}")
    return out


def _finite_falling(label: str, losses) -> None:
    check(all(l == l and abs(l) != float("inf") for l in losses),
          f"{label}: losses finite")
    check(losses[-1] < losses[0], f"{label}: loss falls over "
                                  f"{len(losses)} rounds")


def _hetero_fl_sim(device, launches: dict) -> None:
    """hetero_fl_sim's ``main`` at its 60 rounds (timed and counted
    alone; its scan block at HETERO_SCAN_ROUNDS): every line's losses
    finite and falling, val_acc at its bar; the census lines as the CPU
    computes them; the scan block's eager == scan to 1e-5 (bitwise
    printed only when it holds). Then, apart: the 256-client bench fleet
    per client against the cohort runtime (counted as ``bench256``)."""
    import torch
    from repro_torch.examples import hetero_fl_sim as H
    from repro_torch.fl import FleetSpec, FLScenario, scenario_census, simulate
    block = H.scan_block
    H.scan_block = lambda rounds, device: block(HETERO_SCAN_ROUNDS, device)
    try:
        out = _example("hetero_fl_sim",
                       lambda: H.main(["--device", str(device)]), launches)
    finally:
        H.scan_block = block
    for label, v in out.items():
        if label in ("census", "scan"):
            continue
        res = v["result"]
        bar = EXAMPLE_VAL_ACC_OF.get(label, EXAMPLE_VAL_ACC)
        print(f"examples hetero_fl_sim {label!r}: ms_per_round="
              f"{v['seconds'] / H.ROUNDS * 1e3:.3f} loss[1]="
              f"{res.losses[0]:.6f} loss[{H.ROUNDS}]={res.losses[-1]:.6f} "
              f"val_acc={v['val_acc']:.4f} (bar {bar:.3f})"
              + (f" shards={[len(c.data['y']) for c in res.server.clients]}"
                 if res.scenario.runtime == "client" else ""))
        _finite_falling(f"hetero_fl_sim {label!r}", res.losses)
        check(v["val_acc"] >= bar, f"hetero_fl_sim {label!r}: val_acc "
                                   f"{v['val_acc']:.4f} >= {bar:.3f} on 1000 "
                                   f"held-out samples")
    card = {k: v.to(device) for k, v in out[H.CLIENT[0][0]]["result"]
            .params.items()}
    for (name, sc), line in zip((("masked", H.MASKED),
                                 ("width-sliced", H.WIDTH)), out["census"]):
        cpu = H.census_line(name, scenario_census(sc))
        check(line == cpu == H.census_line(name, scenario_census(sc, card)),
              f"hetero_fl_sim census {name}: the printed line == the CPU's "
              f"== over the card's params")
    s = out["scan"]
    check(s["max_abs_diff"] <= 1e-5,
          f"hetero_fl_sim: scan params == eager to 1e-5 after "
          f"{HETERO_SCAN_ROUNDS} rounds, max_abs_err {s['max_abs_diff']}")

    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    runs = {}

    def bench256():
        for runtime in ("client", "cohort"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[runtime] = simulate(FLScenario(fleet=fleet, runtime=runtime),
                                     2, device=device)
            torch.cuda.synchronize()
            print(f"client bench256 runtime={runtime}: ms_per_round="
                  f"{(time.perf_counter() - t0) / 2 * 1e3:.3f} "
                  f"losses={runs[runtime].losses}")
    _example("bench256", bench256, launches)
    a, b = runs["client"].params, runs["cohort"].params
    d = max((a[k] - b[k]).abs().max().item() for k in a)
    check(d <= 1e-5, f"bench256: per-client params == cohort params to 1e-5 "
                     f"after 2 rounds, max_abs_err {d}")


def _serve_quantized(device, launches: dict) -> None:
    """serve_quantized's ``main`` on the card (counted); then the same
    run from the CPU's params and prompt on the card and on the CPU:
    the compressed params bitwise, payload bits exactly, tokens equal up
    to the first step where the CPU's top-2 logit gap is below
    SERVE_TIE."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.examples import serve_quantized as S
    from repro_torch.models import get_model
    _example("serve_quantized", lambda: S.main(["--device", str(device)]),
             launches)
    model = get_model(get_smoke_config(S.ARCH))
    params = model.init(0, device="cpu")
    prompt = S.make_prompt(model.cfg.vocab_size, "cpu")
    cpu = S.serve_tiers(model, params, prompt, "cpu")
    card = S.serve_tiers(model, {k: v.to(device) for k, v in params.items()},
                         prompt.to(device), device)
    rows = []
    for tier in ("hub", *S.TIERS):
        a, b = cpu[tier], card[tier]
        diff = _same_params(a["params"], {k: v.cpu() for k, v in
                                          b["params"].items()})
        gaps = a["gaps"].numpy()
        close = [i for i, g in enumerate(gaps) if g < SERVE_TIE]
        n = close[0] + 1 if close else len(gaps)
        got, want = b["tokens"].cpu().tolist(), a["tokens"].tolist()
        print(f"examples serve_quantized {tier}: bits={b['bits']} "
              f"params max_abs_err={diff} tokens_equal_first={n} "
              f"(min top-2 gap {gaps.min():.3g}) card={got[:12]} "
              f"cpu={want[:12]}")
        rows.append((tier, diff, a["bits"] == b["bits"], got[:n] == want[:n],
                     n, len(want)))
    for tier, diff, bits, toks, n, gen in rows:
        check(diff == 0.0, f"serve_quantized {tier}: compressed params on "
                           f"the card == the CPU's (bitwise)")
        check(bits, f"serve_quantized {tier}: payload bits == the CPU's")
        check(toks, f"serve_quantized {tier}: tokens == the CPU's up to its "
                    f"first top-2 gap below {SERVE_TIE} ({n} of {gen})")


def _train_100m(device, launches: dict) -> None:
    """train_100m at full width, TRAIN_100M_STEPS steps of 8 x 512 over 4
    tiers, a checkpoint every TRAIN_100M_CKPT_EVERY (its module's
    CKPT_EVERY, set for the run) into a scratch directory: losses finite,
    the last below the first; s/step, tokens/s and peak memory; a
    checkpoint at every CKPT_EVERY steps, and the last one restores
    bitwise to the live state at that step (the final one)."""
    import os
    import shutil

    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.examples import train_100m as T
    d = _ckpt_dir()
    every_before, T.CKPT_EVERY = T.CKPT_EVERY, TRAIN_100M_CKPT_EVERY
    try:
        torch.cuda.reset_peak_memory_stats()
        res = _example("train_100m", lambda: T.train(
            T.config_100m(), steps=TRAIN_100M_STEPS, batch=8, seq=512,
            n_tiers=4, ckpt_dir=d, device=device), launches)
        peak = torch.cuda.max_memory_allocated() / 1e9
        written = sorted(os.listdir(d))
        back, step = Checkpointer(d).restore(res["state"])
        same = all(torch.equal(a, b) for a, b in zip(
            _tensors(back), _tensors(res["state"])))
        del back
    finally:
        shutil.rmtree(d, ignore_errors=True)
        T.CKPT_EVERY = every_before
    every = range(TRAIN_100M_CKPT_EVERY, TRAIN_100M_STEPS + 1,
                  TRAIN_100M_CKPT_EVERY)
    secs = res["sec_per_step"][1:]
    s = statistics.median(secs)
    losses = res["losses"]
    print(f"examples train_100m: params={res['params']:,} "
          f"steps={TRAIN_100M_STEPS} sec_per_step(median of 2..)={s:.6f} "
          f"mean={statistics.mean(secs):.6f} first={res['sec_per_step'][0]:.3f} "
          f"tokens_per_s={8 * 512 / s:.1f} peak_GB={peak:.3f} "
          f"loss[1]={losses[0]:.6f} loss[{len(losses)}]={losses[-1]:.6f} "
          f"checkpoints={written}")
    check(all(l == l and abs(l) != float("inf") for l in losses),
          "train_100m: losses finite")
    check(losses[-1] < losses[0], "train_100m: the last step's loss < the "
                                  "first's")
    check(written == [f"ckpt_{i:08d}.npz" for i in every],
          f"train_100m: a checkpoint every {TRAIN_100M_CKPT_EVERY} steps")
    check(step == TRAIN_100M_STEPS and same,
          f"train_100m: the step-{step} checkpoint restores bitwise to the "
          f"live state at that step")
    # one more step, profiled: where a step's time goes
    from repro_torch import optim
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import get_model
    cfg = T.config_100m()
    step = make_hetero_train_step(
        get_model(cfg), optim.adamw(optim.warmup_cosine(3e-4, 30,
                                                        TRAIN_100M_STEPS)),
        default_tier_plans(4))
    b = {"tokens": TokenStream(cfg.vocab_size, 8, 512).batch_at(
        TRAIN_100M_STEPS)["tokens"].reshape(4, 2, -1).to(device)}
    profile_window("train_100m step", lambda: step(res["state"], b), 1,
                   "step")


def phase_examples(device) -> dict:
    """The five example scripts of ``repro_torch.examples`` on the card
    through their ``main`` or the functions behind it, at the reference's
    settings (train_100m at its full width). Each one's launches are
    counted (counters zeroed just before it); returns their sums."""
    from repro_torch.examples import paper_mlp_repro, quickstart
    launches: dict = {}
    rounds_before, quickstart.ROUNDS = quickstart.ROUNDS, QUICKSTART_ROUNDS
    try:
        res = _example("quickstart",
                       lambda: quickstart.main(["--device", str(device)]),
                       launches)
    finally:
        quickstart.ROUNDS = rounds_before
    _finite_falling("quickstart", res.losses)

    _hetero_fl_sim(device, launches)

    out = _example("paper_mlp_repro",
                   lambda: paper_mlp_repro.main(["--device", str(device)]),
                   launches)
    for n, (accs, _, _) in out["sizes"].items():
        if n >= 1000:
            check(max(accs) >= 0.95, f"paper_mlp_repro n={n}: max_val_acc "
                                     f"{max(accs):.4f} >= 0.95")
    m64, m32 = (max(out["dtypes"][k][0]) for k in ("float64", "float32"))
    check(abs(m64 - m32) <= 0.01, f"paper_mlp_repro: float64 and float32 "
                                  f"max_val_acc within 0.01 ({m64:.4f}, "
                                  f"{m32:.4f})")

    _serve_quantized(device, launches)
    _train_100m(device, launches)
    print(f"examples: launches={json.dumps(launches)}")
    check(launches["fake_quant"] > 0, "examples: fake_quant launched")
    return launches


# --------------------------------------------------------------- async

ASYNC_WINDOWS = 20


def _async_run(sc, engine: str, device, label: str, ms_log=None):
    import torch
    from repro_torch.fl import simulate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(sc, ASYNC_WINDOWS, engine=engine, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ASYNC_WINDOWS * 1e3
    if ms_log is not None:
        ms_log[(f"async {label}", engine)] = ms
    recs = res.records
    print(f"async {label} engine={engine}: ms_per_window={ms:.3f} "
          f"loss[1]={recs[0].loss:.6f} loss[{ASYNC_WINDOWS}]="
          f"{recs[-1].loss:.6f} staleness_mean="
          f"{statistics.mean(r.staleness_mean for r in recs):.4f} "
          f"staleness_max={max(r.staleness_max for r in recs)} "
          f"n_versions_live(last, max)=({recs[-1].n_versions_live}, "
          f"{max(r.n_versions_live for r in recs)}) "
          f"virtual_t={res.sim_time:.6f} agg_backend={res.agg_backend}")
    check(all(r.loss == r.loss and abs(r.loss) != float("inf") for r in recs),
          f"async {label}/{engine}: losses finite")
    check(recs[-1].loss < recs[0].loss,
          f"async {label}/{engine}: loss falls over {ASYNC_WINDOWS} windows")
    return res


def phase_async(device, ms_log: dict) -> int:
    """The async runtime on the 256-client bench fleet and its width
    twin, eager and ``scan`` (bitwise equal), then the full-buffer,
    no-discount limit against the sync-wait cohort run; each run's ms per
    window into ``ms_log``. Returns fake_quant launches (counter zeroed
    at the start)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import (AsyncBuffered, FleetSpec, FLScenario,
                                LocalTraining, WindowScanEngine,
                                build_server, simulate)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import mlp
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    timing = AsyncBuffered(buffer_size=64, staleness_exp=0.5, time_jitter=0.2)
    fake_quant.launches = 0
    for label, local in (("masked", LocalTraining()),
                         ("width", LocalTraining(submodel="width"))):
        sc = FLScenario(fleet=fleet, local=local, timing=timing)
        eager = _async_run(sc, "eager", device, label, ms_log)
        scan = _async_run(sc, "scan", device, label, ms_log)
        check(scan.records == eager.records
              and _same_params(eager.params, scan.params) == 0.0,
              f"async {label}: scan params and records == eager (bitwise)")
        check(max(r.staleness_max for r in eager.records) > 0,
              f"async {label}: the staleness discount fires")
    n = fake_quant.launches
    srv = build_server(FLScenario(fleet=fleet, timing=timing),
                       types.SimpleNamespace(loss_fn=mlp.loss_fn), optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       device=device)
    eng = WindowScanEngine(srv)
    eng.run(2)
    profile_window("async masked scan", lambda: eng.run(5), 5, "window")

    sync = simulate(FLScenario(fleet=fleet), 3, device=device)
    full = simulate(FLScenario(fleet=fleet, timing=AsyncBuffered(
        buffer_size=256, staleness_exp=0.0)), 3, engine="scan",
        device=device)
    d = max((sync.params[k] - full.params[k]).abs().max().item()
            for k in sync.params)
    print(f"async full buffer, no discount vs sync-wait: losses "
          f"{full.losses} vs {sync.losses}, params max_abs_err={d}")
    check(d <= 1e-6, f"async full buffer, no discount == sync-wait cohort "
                     f"run to 1e-6 in params, max_abs_err {d}")
    check(n > 0, f"async: fake_quant launched {n} times on the main path")
    return n


# -------------------------------------------------------------- faults

# (a) availability, churn and dropouts: every engine, scan_pallas too
AVAIL_FAULTS = dict(seed=5, period=24, duty_cycle=0.7, churn_rate=0.05,
                    dropout_rate=0.1)
# (b) repro.fl's headline policy, and a heavy upload attack
FL_FAULTS = dict(period=24, duty_cycle=0.7, churn_rate=0.05,
                 dropout_rate=0.1, corrupt_rate=0.01)
HEAVY_FAULTS = dict(corrupt_rate=0.25, corrupt_kind="bitflip",
                    corrupt_frac=0.5, clip_norm=1.0)
UPLOAD_ROUNDS = 10
# (c) the async runtime's: lost uploads retried, corrupted uploads
ASYNC_FAULTS = dict(dropout_rate=0.1, retry_backoff=0.5, corrupt_rate=0.05)


def _fault_counts(res) -> list:
    return [(r.n_participants, r.n_dropouts, r.n_dropped, r.n_corrupt)
            for r in res.records]


def _finite(params) -> bool:
    import torch
    return all(bool(torch.isfinite(p).all()) for p in params.values())


def _fault_run(sc, n: int, engine: str, device, label: str, clean_ms,
               per: str = "round"):
    """``simulate`` under faults for ``n`` rounds (windows), timed and
    printed beside the clean fleet's ms (``None``: not run clean)."""
    import torch
    from repro_torch.fl import simulate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(sc, n, engine=engine, device=device)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    recs = res.records
    losses = [r.loss for r in recs if r.loss is not None]
    clean = "not run" if clean_ms is None else f"{clean_ms:.3f}"
    joined = [r.n_updates if r.n_participants is None else r.n_participants
              for r in recs]
    print(f"faults {label} engine={engine}: ms_per_{per}={ms:.3f} "
          f"(clean {clean}) agg_backend={res.agg_backend} "
          f"loss[1]={losses[0]:.6f} loss[{n}]={losses[-1]:.6f} "
          f"uploads per {per} (min, mean)=({min(joined)}, "
          f"{statistics.mean(joined):.2f}) "
          f"dropouts={sum(r.n_dropouts or 0 for r in recs)} "
          f"corrupt={sum(r.n_corrupt for r in recs)}")
    return res


def phase_faults(device, ms_log: dict) -> dict:
    """The fault layer on the 256-client bench fleet: (a) availability,
    churn and dropout faults on the masked and width fleets through
    eager, scan and scan_pallas (the grouped aggregation launch under
    rounds with empty tiers); (b) upload faults with fp8 uploads and EF,
    eager and scan (fake_quant before the injection); (c) the async
    runtime with retried and corrupted uploads, eager and scan. Returns
    the launches (fleet_aggregate counted per scan_pallas run, zeroed
    just before it; fake_quant over the phase) and (c)'s runs."""
    from repro_torch.fl import (AsyncBuffered, FaultPolicy, FleetSpec,
                                FLScenario, LocalTraining, UploadPolicy,
                                simulate)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    ef = UploadPolicy(quant="fp8_e4m3", error_feedback=True)
    launches = {"grad_aggregate": 0, "structured_scatter": 0}
    fake_quant.launches = 0

    for label, local, backend, row in (
            ("masked", LocalTraining(), "pallas", "grad_aggregate"),
            ("width", LocalTraining(submodel="width"), "pallas_structured",
             "structured_scatter")):
        sc = FLScenario(fleet=fleet, local=local,
                        faults=FaultPolicy(**AVAIL_FAULTS))
        runs = {}
        for engine in ("eager", "scan", "scan_pallas"):
            fleet_aggregate.launches = 0
            runs[engine] = _fault_run(sc, ROUNDS, engine, device,
                                      f"{label} availability", ms_log.get(
                                          (label, engine)))
        n_launch = fleet_aggregate.launches     # the scan_pallas run's
        e, s, f = runs["eager"], runs["scan"], runs["scan_pallas"]
        n_with = sum(1 for r in f.records if r.n_participants)
        print(f"faults {label} availability: fleet_aggregate launches="
              f"{n_launch} over {n_with} rounds with participants; "
              f"participants per round={[r.n_participants for r in f.records]}")
        check(f.agg_backend == backend,
              f"faults {label}: agg_backend == {backend!r}")
        check(_same_params(s.params, f.params) == 0.0
              and s.records == f.records,
              f"faults {label}: scan_pallas params and records == scan "
              f"(bitwise)")
        d = _same_params(e.params, s.params)
        print(f"faults {label}: scan vs eager params max_abs_err={d}")
        check(d <= 1e-5, f"faults {label}: scan params == eager to 1e-5")
        check(_fault_counts(e) == _fault_counts(s) == _fault_counts(f),
              f"faults {label}: n_participants, n_dropouts, n_dropped equal "
              f"across eager, scan and scan_pallas")
        check(min(r.n_participants for r in f.records) < fleet.n_clients,
              f"faults {label}: rounds with fewer participants than the "
              f"clean fleet's {fleet.n_clients}")
        check(n_launch == n_with, f"faults {label}: one fleet_aggregate "
                                  f"launch per round with participants")
        check(all(r.loss == r.loss for r in f.records if r.loss is not None)
              and f.records[-1].loss < f.records[0].loss,
              f"faults {label}: losses finite and falling")
        launches[row] += n_launch

    fq0 = fake_quant.launches
    for label, pol in (("fl_policy", FL_FAULTS), ("heavy", HEAVY_FAULTS)):
        sc = FLScenario(fleet=fleet, upload=ef, faults=FaultPolicy(**pol))
        e = _fault_run(sc, UPLOAD_ROUNDS, "eager", device,
                       f"{label} fp8_ef", None)
        s = _fault_run(sc, UPLOAD_ROUNDS, "scan", device, f"{label} fp8_ef",
                       None)
        d = _same_params(e.params, s.params)
        print(f"faults {label}: scan vs eager params max_abs_err={d}")
        check(d <= 1e-5, f"faults {label}: scan params == eager to 1e-5")
        check(_fault_counts(e) == _fault_counts(s),
              f"faults {label}: fault counts equal in eager and scan")
        check(sum(r.n_corrupt for r in s.records) > 0 and _finite(s.params)
              and _finite(e.params),
              f"faults {label}: uploads corrupted, params finite")
    fq_upload = fake_quant.launches - fq0
    check(fq_upload > 0, f"faults: fake_quant launched {fq_upload} times "
                         f"on the upload-fault runs")
    # the injection is real: without its defences the heavy attack's
    # bit-flips reach the params. (With the clip alone nothing non-finite
    # is left for the guard: each poisoned row's squared norm overflows
    # and the clip zeroes the row.)
    bare = FaultPolicy(**{**HEAVY_FAULTS, "clip_norm": None},
                       finite_guard=False)
    res = simulate(FLScenario(fleet=fleet, upload=ef, faults=bare),
                   UPLOAD_ROUNDS, device=device)
    bad = sum(int((~p.isfinite()).sum()) for p in res.params.values())
    print(f"faults heavy without guard and clip: non-finite params={bad}")
    check(bad > 0, "faults heavy: without finite guard and clip the "
                   "injected values reach the params")

    timing = AsyncBuffered(buffer_size=64, staleness_exp=0.5, time_jitter=0.2)
    sc = FLScenario(fleet=fleet, timing=timing,
                    faults=FaultPolicy(**ASYNC_FAULTS))
    runs = {engine: _fault_run(sc, ASYNC_WINDOWS, engine, device,
                               "async masked", ms_log.get(
                                   ("async masked", engine)), "window")
            for engine in ("eager", "scan")}
    e, s = runs["eager"], runs["scan"]
    print(f"faults async: virtual_t={s.sim_time:.6f}")
    check(e.records == s.records and _same_params(e.params, s.params) == 0.0,
          "faults async: scan params and records == eager (bitwise)")
    check(sum(r.n_corrupt for r in s.records) > 0 and _finite(s.params),
          "faults async: uploads corrupted, params finite")
    launches["fake_quant"] = fake_quant.launches
    return {"launches": launches, "async": (sc, runs)}


# ---------------------------------------------------------- checkpoint

CKPT_EVERY = 5
CKPT_ARCH = "granite-3-2b"          # the port's smallest dense config
CKPT_TRAIN_STEPS = 4


def _ckpt_dir() -> str:
    """A scratch directory inside the checkout (git-ignored)."""
    import tempfile
    return tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=ROOT)


def _kill_and_resume(sc, engine: str, device, label: str, n: int,
                     full=None):
    """The run cut at ``n // 2`` (checkpoints every CKPT_EVERY) and
    resumed to ``n``, against the uninterrupted run (``full``, or run
    here): params bitwise, every record equal. Returns the resumed
    run."""
    import shutil

    import torch
    from repro_torch.fl import simulate
    if full is None:
        full = simulate(sc, n, engine=engine, device=device)
    d = _ckpt_dir()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        simulate(sc, n // 2, engine=engine, device=device,
                 checkpoint_every=CKPT_EVERY, checkpoint_dir=d)
        res = simulate(sc, n, engine=engine, device=device,
                       checkpoint_every=CKPT_EVERY, resume_from=d)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"checkpoint {label} engine={engine}: cut at {n // 2}, resumed "
          f"to {n}, {s:.3f} s for both legs")
    check(_same_params(full.params, res.params) == 0.0
          and full.records == res.records,
          f"checkpoint {label}/{engine}: the resumed run's params (bitwise) "
          f"and records == the uninterrupted run's")
    return res


def _save_restore(sc, res, device, label: str) -> None:
    """Save and restore of a run's whole server state, timed."""
    import shutil

    import torch
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import build_server, restore_run_state, save_run_state
    from repro_torch.models import mlp
    d = _ckpt_dir()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        npz = save_run_state(res.server, d, scenario=sc)
        save_ms = (time.perf_counter() - t0) * 1e3
        fresh = build_server(sc, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                             optim.sgd(1.0),
                             mlp.init(torch.Generator().manual_seed(0),
                                      config()), device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_run_state(fresh, d, scenario=sc)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        n_bytes = os.path.getsize(npz)
        json_bytes = os.path.getsize(npz[:-3] + "json")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"checkpoint {label}: save_ms={save_ms:.3f} "
          f"restore_ms={restore_ms:.3f} npz_bytes={n_bytes} "
          f"json_bytes={json_bytes}")
    check(_same_params(fresh.params, res.server.params) == 0.0,
          f"checkpoint {label}: restored params == saved (bitwise)")


def phase_checkpoint(device, faults: dict) -> dict:
    """Durable runs: the masked bench fleet with fp8 uploads and EF, 20
    rounds, checkpoints every 5, cut at 10 and resumed, bitwise the
    uninterrupted run: under repro.fl's policy (upload faults) eager and
    scan, under the availability policy scan_pallas; the async fault run
    of phase faults likewise, eager and scan. Save / restore timed. Then
    the LM train launcher with a checkpoint every 2 steps, its last
    checkpoint removed after step 2 and resumed there: steps 3-4 bitwise.
    Returns the launches (counters zeroed at the start)."""
    import shutil

    import torch
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.fl import (FaultPolicy, FleetSpec, FLScenario,
                                UploadPolicy)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.launch.train import train
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16)
    ef = UploadPolicy(quant="fp8_e4m3", error_feedback=True)
    routes = flash_attention.route_launches
    for fn in (fake_quant, flash_attention, fleet_aggregate):
        fn.launches = 0
    for r in routes:
        routes[r] = 0

    sc = FLScenario(fleet=fleet, upload=ef, faults=FaultPolicy(**FL_FAULTS))
    for engine in ("eager", "scan"):
        res = _kill_and_resume(sc, engine, device, "fl_policy fp8_ef",
                               CKPT_ROUNDS)
    _save_restore(sc, res, device, "fl_policy fp8_ef (cohort)")
    _kill_and_resume(FLScenario(fleet=fleet, upload=ef,
                                faults=FaultPolicy(**AVAIL_FAULTS)),
                     "scan_pallas", device, "availability fp8_ef",
                     CKPT_ROUNDS)
    a_sc, a_runs = faults["async"]
    for engine in ("eager", "scan"):
        res = _kill_and_resume(a_sc, engine, device, "async masked",
                               ASYNC_WINDOWS, full=a_runs[engine])
    _save_restore(a_sc, res, device, "async masked (version store, heap)")
    n_agg = fleet_aggregate.launches

    # the LM train launcher: full width, one layer, bf16, flash
    cfg = get_config(CKPT_ARCH).replace(num_layers=1, use_flash=True)
    d = _ckpt_dir()
    kw = dict(steps=CKPT_TRAIN_STEPS, batch=8, seq=1024, n_tiers=4, lr=3e-4,
              warmup=2, seed=0, device=device, log_every=1, ckpt_dir=d,
              ckpt_every=2)
    try:
        full = train(cfg, **kw)
        files = sorted(os.listdir(d))
        ck2 = os.path.join(d, "ckpt_00000002.npz")
        print(f"checkpoint train {CKPT_ARCH}: layers=1 d_model={cfg.d_model} "
              f"files={files} npz_bytes={os.path.getsize(ck2)}")
        check(files == ["ckpt_00000002.npz", "ckpt_00000004.npz"],
              "checkpoint train: --ckpt-every 2 saved steps 2 and 4")
        # what a run killed after step 2 leaves behind
        os.remove(os.path.join(d, "ckpt_00000004.npz"))
        res = train(cfg, **kw)
        print(f"checkpoint train: losses={full['losses']} resumed at step "
              f"{res['start']}: {res['losses']}")
        state = res["state"]
        check(res["start"] == 2 and res["losses"] == full["losses"][2:]
              and res["tier_losses"] == full["tier_losses"][2:]
              and _same_params(full["state"]["params"], state["params"]) == 0.0,
              "checkpoint train: steps 3-4 after the resume == the "
              "uninterrupted run's (losses, tier losses, params bitwise)")
        p = os.path.join(d, "timed.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(state, p)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = load_pytree(state, p)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        print(f"checkpoint train state: save_ms={save_ms:.3f} "
              f"restore_ms={restore_ms:.3f} npz_bytes={os.path.getsize(p)}")
        check(_same_params(back["params"], state["params"]) == 0.0
              and _same_params(back["opt"]["v"], state["opt"]["v"]) == 0.0,
              "checkpoint train: the restored state == the saved (bitwise)")
        del full, res, state, back
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    n_steps = CKPT_TRAIN_STEPS + CKPT_TRAIN_STEPS // 2
    got = {"grad_aggregate": n_agg, "fake_quant": fake_quant.launches,
           "flash_attention_wgmma": routes["wgmma"]}
    print(f"checkpoint: launches={json.dumps(got)}")
    check(routes == {"wgmma": 4 * n_steps, "simt": 0},
          f"checkpoint train: flash_attention launched 4 per step on the "
          f"wgmma kernel (1 layer x 4 tiers x {n_steps} steps): {routes}")
    check(got["fake_quant"] > 0 and n_agg > 0,
          "checkpoint: fake_quant and fleet_aggregate launched")
    return got


# ------------------------------------------------------------ topology

TOPO_EDGES = 8
TOPO_ROUNDS = 3                     # (a) and (b); (c) runs CKPT_ROUNDS
TOPO_CHUNK = 2                      # a chunk of 2, then one resumed from it
ACCEPT_CLIENTS = 100_000            # benchmarks/fl_bench.py:354-396
ACCEPT_CHUNK = 10
# the 4-block runs: one per edge-step branch (fedsgd weighted sum, fp8
# uploads with EF, width slices); sync_drop and fedavg take the first two
FOUR_BLOCKS = ("sync_wait", "quant_ef", "width")


def _topo_scenarios(fleet) -> dict:
    """The reference's five topology scenarios (tests/test_topology.py)
    on ``fleet``."""
    from repro_torch.fl import (FLScenario, LocalTraining,
                                ParticipationPolicy, SyncDrop, UploadPolicy)
    return {
        "sync_wait": FLScenario(
            fleet=fleet, participation=ParticipationPolicy(0.5, seed=11)),
        "sync_drop": FLScenario(fleet=fleet, timing=SyncDrop(0.004)),
        "fedavg": FLScenario(fleet=fleet, local=LocalTraining(
            mode="fedavg", local_steps=3, local_lr=0.5)),
        "quant_ef": FLScenario(
            fleet=fleet, upload=UploadPolicy("fp8_e4m3", error_feedback=True),
            participation=ParticipationPolicy(0.6, seed=5)),
        "width": FLScenario(fleet=fleet,
                            local=LocalTraining(submodel="width")),
    }


def _topo_run(sc, engine: str, device, label: str, n: int = TOPO_ROUNDS,
              mesh=None, flat_ms=None):
    """``simulate`` on a topology fleet for ``n`` rounds, timed, with the
    launch counters zeroed just before and read just after: fake_quant
    launches (every quantized plan's edge copies and fp8 uploads), the
    aggregation kernel none (refused on topology fleets)."""
    import torch
    from repro_torch.fl import simulate
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.fleet_aggregate import fleet_aggregate
    from repro_torch.kernels.grad_aggregate import grad_aggregate
    from repro_torch.kernels.structured_scatter import structured_scatter
    aggs = (fleet_aggregate, grad_aggregate, structured_scatter)
    for fn in (fake_quant,) + aggs:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = simulate(sc, n, engine=engine, device=device, mesh=mesh,
                   chunk_rounds=TOPO_CHUNK if engine == "scan" else None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    fq, agg = fake_quant.launches, sum(fn.launches for fn in aggs)
    losses = [r.loss for r in res.records if r.loss is not None]
    on = "none" if mesh is None else (
        f"{res.server.mesh.size} block(s) on "
        f"{sorted({str(d) for d in res.server.mesh.devices})}")
    flat = "" if flat_ms is None else f" (flat fleet {flat_ms:.3f})"
    print(f"topology {label} engine={engine} mesh={on}: ms_per_round="
          f"{ms:.3f}{flat} loss[1]={losses[0]:.6f} loss[{n}]="
          f"{losses[-1]:.6f} fake_quant={fq} aggregation_launches={agg}")
    check(len(losses) == n and all(math.isfinite(l) for l in losses),
          f"topology {label}/{engine}: losses finite")
    check(fq > 0, f"topology {label}/{engine}: fake_quant launched ({fq})")
    check(agg == 0, f"topology {label}/{engine}: the aggregation kernel "
                    f"never launched")
    return res, fq


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


def _same_state(a, b) -> bool:
    """Two runs' params and optimizer state bitwise, every record equal."""
    import torch
    la, lb = _tensors(a.opt_state), _tensors(b.opt_state)
    return (_same_params(a.params, b.params) == 0.0 and len(la) == len(lb)
            and all(torch.equal(x, y) for x, y in zip(la, lb))
            and a.records == b.records)


def _npz_ef_shapes(npz: str) -> dict:
    """The EF leaves' shapes in a run checkpoint."""
    import numpy as np
    with np.load(npz) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        return {m["name"]: tuple(z[k].shape) for k, m in meta.items()
                if m["name"].startswith("ef/")}


def phase_topology(device, ms_log: dict) -> dict:
    """Hierarchical fleets on the card: (a) the reference's five topology
    scenarios on the 256-client bench fleet over 8 edges, eager, scan,
    scan on the default (one-device) mesh and on a 4-block mesh of the
    one card; (b) the availability fault policy; (c) a kill and resume
    with fp8 EF rows; (d) the reference's 100,000-client, 8-edge
    acceptance fleet. Returns the fake_quant launches (each run's
    counters zeroed just before it)."""
    import shutil

    import torch
    from repro_torch import optim
    from repro_torch.configs.paper_mlp import config
    from repro_torch.fl import (FaultPolicy, FleetSpec, FLScenario,
                                ParticipationPolicy, ScanEngine,
                                build_server, make_edge_mesh, save_run_state,
                                scenario_census, simulate)
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import mlp
    fleet = FleetSpec.cycling(BENCH_TIERS, 256, samples_per_client=16,
                              edges=TOPO_EDGES)
    scenarios = _topo_scenarios(fleet)
    n_fq = 0

    # agreement with the port's CPU path on a small input
    small = FLScenario(fleet=FleetSpec.cycling(BENCH_TIERS, 16, edges=4),
                       participation=ParticipationPolicy(0.5, seed=11))
    cpu = simulate(small, 3, device="cpu")
    gpu = simulate(small, 3, engine="scan", device=device)
    diff = max((cpu.params[k] - gpu.params[k].cpu()).abs().max().item()
               for k in cpu.params)
    check(diff <= 1e-5, f"topology small fleet: CUDA scan params vs CPU "
                        f"eager, max_abs_err {diff} <= 1e-5")
    try:
        simulate(scenarios["sync_wait"], 1, engine="scan_pallas",
                 device=device)
        refused = False
    except ValueError as e:
        refused = "pallas" in str(e)
    check(refused, "topology: engine='scan_pallas' refused (ValueError)")

    # (a) five scenarios, eager / scan / default mesh / 4 blocks
    simulate(scenarios["sync_wait"], 2, engine="scan", device=device)
    four = make_edge_mesh(TOPO_EDGES, devices=[device] * 4)
    # the flat fleets doing the same work (full participation)
    flat_of = {"sync_drop": "masked", "width": "width"}
    for name, sc in scenarios.items():
        flat = flat_of.get(name)
        e, k1 = _topo_run(sc, "eager", device, name,
                          flat_ms=ms_log.get((flat, "eager")))
        s, k2 = _topo_run(sc, "scan", device, name,
                          flat_ms=ms_log.get((flat, "scan")))
        m, k3 = _topo_run(sc, "scan", device, name, mesh=True)
        n_fq += k1 + k2 + k3
        d = _same_params(e.params, s.params)
        print(f"topology {name}: scan vs eager max_abs_err={d}; "
              f"participants per round="
              f"{sorted({r.n_participants for r in s.records})}")
        check(_same_state(e, s), f"topology {name}: scan params, opt_state "
                                 f"and every record == eager (bitwise)")
        check(m.server.mesh.size == 1 and _same_state(s, m),
              f"topology {name}: scan on mesh=True (1 device) == unsharded "
              f"(bitwise)")
        if name in FOUR_BLOCKS:
            f, k4 = _topo_run(sc, "scan", device, name, mesh=four)
            n_fq += k4
            check(f.server.mesh.size == 4 and _same_state(s, f),
                  f"topology {name}: scan on 4 blocks of the card == "
                  f"unsharded (bitwise)")

    # (b) availability, churn and dropouts on sync_wait
    sc = FLScenario(fleet=fleet, participation=ParticipationPolicy(0.5,
                                                                   seed=11),
                    faults=FaultPolicy(**AVAIL_FAULTS))
    e, k1 = _topo_run(sc, "eager", device, "sync_wait availability")
    s, k2 = _topo_run(sc, "scan", device, "sync_wait availability")
    n_fq += k1 + k2
    print(f"topology availability: participants per round="
          f"{[r.n_participants for r in s.records]} dropouts="
          f"{sum(r.n_dropouts for r in s.records)}")
    check(_same_state(e, s) and _fault_counts(e) == _fault_counts(s),
          "topology availability: scan == eager (bitwise), participant, "
          "dropout and drop counts equal")
    check(min(r.n_participants for r in s.records) < fleet.n_clients,
          f"topology availability: rounds with fewer participants than "
          f"{fleet.n_clients}")

    # (c) kill and resume with fp8 EF rows
    sc = scenarios["quant_ef"]
    fake_quant.launches = 0
    for engine in ("eager", "scan"):
        res = _kill_and_resume(sc, engine, device, "topology quant_ef",
                               CKPT_ROUNDS)
    cap = [c.cap for c in res.server.cohorts]
    d = _ckpt_dir()
    try:
        shapes = _npz_ef_shapes(save_run_state(res.server, d, scenario=sc))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"topology checkpoint: {len(shapes)} EF leaves, e.g. "
          f"{ {k: v for k, v in shapes.items() if k.endswith('0/w')} }")
    check(all(shapes[f"ef/{ci}/layers/0/w"] == (TOPO_EDGES, c, 5, 10)
              for ci, c in enumerate(cap)),
          "topology checkpoint: the npz holds the (E, cap, ...) EF rows")
    _save_restore(sc, res, device, "topology quant_ef (edge EF grids)")
    n_fq += fake_quant.launches

    # (d) the reference's acceptance fleet
    spec = FleetSpec.cycling(BENCH_TIERS, ACCEPT_CLIENTS,
                             samples_per_client=16, edges=TOPO_EDGES)
    sc = FLScenario(fleet=spec)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    clients = spec.build_clients()
    t_clients = time.perf_counter() - t0
    srv = build_server(sc, types.SimpleNamespace(loss_fn=mlp.loss_fn),
                       optim.sgd(1.0),
                       mlp.init(torch.Generator().manual_seed(0), config()),
                       clients=clients, device=device)
    torch.cuda.synchronize()
    t_grids = time.perf_counter() - t0 - t_clients
    del clients
    eng = ScanEngine(srv, chunk_rounds=ACCEPT_CHUNK)
    fake_quant.launches = 0
    warm = eng.run(ACCEPT_CHUNK + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = eng.run(ACCEPT_CHUNK)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ACCEPT_CHUNK * 1e3
    n_fq += fake_quant.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile_window(f"topology {ACCEPT_CLIENTS}", lambda: eng.run(1), 1,
                   "round")
    eager = srv.round()
    last = timed[-1]
    t0 = time.perf_counter()
    big = scenario_census(sc)
    t_census = time.perf_counter() - t0
    small_bytes = scenario_census(scenarios["sync_drop"])[
        "cross_shard_bytes_per_round"]
    losses = [r["loss"] for r in warm + timed] + [eager["loss"]]
    print(f"topology {ACCEPT_CLIENTS} clients x {TOPO_EDGES} edges: "
          f"ms_per_round={ms:.3f} (scan, chunk {ACCEPT_CHUNK}) "
          f"build_clients_s={t_clients:.3f} build_grids_s={t_grids:.3f} "
          f"peak_mem_gib={peak:.3f} cap={[c.cap for c in srv.cohorts]} "
          f"cross_shard_bytes_per_round="
          f"{big['cross_shard_bytes_per_round']:.0f} census_s="
          f"{t_census:.3f} loss[1]={losses[0]:.6f} "
          f"loss[{len(losses)}]={losses[-1]:.6f}")
    check(all(math.isfinite(l) for l in losses),
          f"topology {ACCEPT_CLIENTS}: losses finite")
    check(big["cross_shard_bytes_per_round"] == small_bytes,
          f"topology {ACCEPT_CLIENTS}: cross_shard_bytes_per_round equals "
          f"the 256-client fleet's ({small_bytes:.0f})")
    check(all(eager[k] == last[k] for k in
              ("n_participants", "n_dropped", "round_wall_time",
               "total_upload_bytes"))
          and last["n_participants"] == ACCEPT_CLIENTS,
          f"topology {ACCEPT_CLIENTS}: the engine's record counts, wall and "
          f"bytes == an eager round's of the same server")
    del srv, eng
    torch.cuda.empty_cache()
    print(f"topology: fake_quant launches={n_fq}")
    return {"fake_quant": n_fq}


# --------------------------------------------------------------- serve

# one tier with no compression, one pruned + fp8, one k-means + fp4
SERVE_TIERS = ("hub", "low", "embedded")
SERVE_GEN = 8               # tokens a served tier decodes (phase budget)


def phase_serve(device) -> int:
    """The LM serve path on the full config; returns fake_quant launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    batch, prompt, gen = 4, 64, SERVE_GEN
    cfg = get_config(LM_ARCH)
    params = get_model(cfg).init(0, device=device)
    check({k: tuple(v.shape) for k, v in params.items()}
          == _lm_leaf_shapes(cfg),
          f"{LM_ARCH} full config: the params' leaves are the table the "
          f"fake_quant checks ran on")
    n_params = sum(p.numel() for p in params.values())
    print(f"serve {LM_ARCH}: layers={cfg.num_layers} params={n_params} "
          f"dtype={cfg.dtype} batch={batch} prompt={prompt} gen={gen}")
    serve(cfg, "mid", batch=batch, prompt_len=8, gen=2, params=params,
          device=device)                      # warm-up
    total = 0
    for tier in SERVE_TIERS:
        quantized = DEVICE_TIERS[tier].quant_em()[0] > 0
        torch.cuda.reset_peak_memory_stats()
        fake_quant.launches = 0
        res = serve(cfg, tier, batch=batch, prompt_len=prompt, gen=gen,
                    params=params, device=device)
        n = fake_quant.launches
        total += n
        tok_s = gen * batch / res["decode_s"]
        print(f"serve {tier}: compress_s={res['compress_s']:.6f} "
              f"prefill_s={res['prefill_s']:.6f} "
              f"decode_s={res['decode_s']:.6f} decode_tokens_per_s="
              f"{tok_s:.3f} fake_quant_launches={n} peak_mem_gb="
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"sample={res['tokens'][0, :8].tolist()}")
        check(bool(torch.isfinite(res["prefill_logits"]).all()
                   and torch.isfinite(res["replay_logits"]).all()),
              f"serve {tier}: logits finite")
        check(n == (10 if quantized else 0),
              f"serve {tier}: fake_quant launched {n} times "
              f"(10 quantized leaves, 0 for the hub)")
        del res
    _profile_decode(cfg, params, "low", device)
    del params
    torch.cuda.empty_cache()

    # prefill vs the decode replay of the same prompt, in f32 at 2 layers
    # of full width: both are the same f32 math (TF32 off) summed in other
    # orders — batched GEMMs and chunked attention against per-token
    # GEMVs and the ring cache — which moves logits of O(1) by ~1e-6; a
    # wrong position, mask or cache slot moves them by O(1)
    cfg2 = cfg.replace(num_layers=2, dtype="float32")
    res = serve(cfg2, "mid", batch=batch, prompt_len=prompt, gen=1,
                device=device)
    a, b = res["replay_logits"], res["prefill_logits"]
    e = (a - b).abs().max().item()
    check(torch.allclose(a, b, rtol=1e-3, atol=1e-4),
          f"serve f32 2-layer: decode replay == prefill last-token logits "
          f"(rtol 1e-3, atol 1e-4), max_abs_err {e}, "
          f"max|logit| {b.abs().max().item():.3f}")
    return total


# --------------------------------------------------------------- train

def _attn_calls(cfg) -> int:
    """Attention calls in one forward: every decoder layer, each
    application of Zamba's shared block, none in xLSTM; Whisper's encoder
    layers and its decoder layers twice (self and cross)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers
    return cfg.num_layers


def _train_smoke_vs_cpu(arch: str, device, held: int = 2) -> dict:
    """Two f32 SGD tier-loop steps of ``arch``'s smoke config with flash,
    on the CPU and on the card from one init: losses to rtol 1e-4, params
    after ``held`` steps to atol 1e-5, every flash_attention launch on the
    simt kernel (hd 32). whisper-tiny holds its params after the first
    step: its low tier prunes the stacked LayerNorm scales, which one step
    leaves clustered just below 1.0, and the card's and the CPU's
    bisection thresholds (their f32 ``exp`` and ``log`` an ulp apart) then
    fall on either side of one of them, which moves the second step's
    params by ~1e-3, as one ulp of difference in the state does on the
    CPU alone (tests/test_torch_whisper.py::
    test_second_sgd_step_flips_a_pruned_norm_scale_under_an_ulp). Returns
    the launches per route (counters zeroed just before)."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import get_model
    cfg = get_smoke_config(arch).replace(use_flash=True)
    model = get_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    runs = {}
    routes = flash_attention.route_launches
    for r in routes:
        routes[r] = 0
    for dev in ("cpu", device):
        opt = optim.sgd(0.5)
        step = make_hetero_train_step(model, opt, default_tier_plans(4))
        params = {k: v.to(dev) for k, v in init.items()}
        st = dict(params=params, opt=opt.init(params),
                  step=torch.zeros((), dtype=torch.int32, device=dev))
        losses, states = [], []
        for i in range(2):
            b = make_train_batch(cfg, ShapeConfig("t", 64, 8, "train"),
                                 n_tiers=4, seed=1, index=i)
            st, m = step(st, {k: v.to(dev) for k, v in b.items()})
            losses.append(m["loss"].item())
            states.append(st["params"])
        runs[str(dev)] = (losses, states)
    smoke_routes = dict(routes)
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(device)]
    errs = [max((g[k].cpu() - c[k]).abs().max().item() for k in c)
            for c, g in zip(pc, pg)]
    e = errs[held - 1]
    tag = "" if arch == LM_ARCH else f" {arch}"
    print(f"train smoke f32{tag}: cpu losses={lc} cuda losses={lg} "
          f"params max_abs_err after each step={errs} flash launches per "
          f"route={json.dumps(smoke_routes)}")
    smoke_n = _attn_calls(cfg) * 4 * 2
    check(smoke_routes == {"wgmma": 0, "simt": smoke_n},
          f"train smoke f32{tag}: flash_attention launched {smoke_n} times, "
          f"all on the simt kernel ({_attn_calls(cfg)} attention calls x 4 "
          f"tiers x 2 steps on the card)")
    check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(lg, lc)),
          f"train smoke f32{tag}: card losses == CPU losses to rtol 1e-4")
    check(e <= 1e-5, f"train smoke f32{tag}: card params == CPU params to "
                     f"atol 1e-5 after {held} SGD step{'s' * (held > 1)}, "
                     f"max_abs_err {e}")
    return smoke_routes


def phase_train(device) -> dict:
    """The tier-loop LM train step; returns launches of the main run."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.compression import (DEVICE_TIERS,
                                              default_tier_plans,
                                              magnitude_mask)
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train
    from repro_torch.models import get_model

    # the card's f32 step against the port's CPU path, smoke config
    smoke_routes = _train_smoke_vs_cpu(LM_ARCH, device)
    routes = flash_attention.route_launches

    # the main path: full width, cut to TRAIN_LAYERS layers, bf16, flash
    cfg = get_config(LM_ARCH).replace(num_layers=TRAIN_LAYERS, use_flash=True)
    batch, seq, n_tiers = 8, 1024, 4
    print(f"train {LM_ARCH}: layers={cfg.num_layers} (cut from 28) "
          f"d_model={cfg.d_model} dtype={cfg.dtype} use_flash=True "
          f"tiers={n_tiers} batch={batch} seq={seq} steps={TRAIN_STEPS}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    for r in routes:
        routes[r] = 0
    fake_quant.launches = 0
    res = train(cfg, steps=TRAIN_STEPS, batch=batch, seq=seq,
                n_tiers=n_tiers, lr=3e-4, warmup=2, seed=0, device=device,
                log_every=1)
    main_routes = dict(routes)
    # flash_attention_simt: the smoke f32 step's launches (the main run
    # must have none)
    got = {"flash_attention": flash_attention.launches,
           "flash_attention_wgmma": main_routes["wgmma"],
           "flash_attention_simt": smoke_routes["simt"],
           "fake_quant": fake_quant.launches}
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses, secs = res["losses"], res["sec_per_step"]
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    print(f"train: losses={losses} tier_losses (hub, high, mid, low)="
          f"{res['tier_losses']}")
    print(f"train: sec_per_step={secs} "
          f"mean_sec_per_step(steps 2..{TRAIN_STEPS})={sps:.6f} "
          f"tokens_per_s={batch * seq / sps:.3f} peak_mem_gb={peak:.3f} "
          f"launches={json.dumps(got)}")
    check(all(l == l and abs(l) != float("inf") for l in losses),
          "train: losses finite")
    low = DEVICE_TIERS["low"]
    keep = {k: magnitude_mask(res["state"]["params"][k], low.density)
            .mean().item() for k in ("layers.ln1", "layers.ln2")}
    print(f"train: fraction of the stacked norm scales (all 1.0 at init, "
          f"so all kept) that the low tier keeps after step "
          f"{TRAIN_STEPS}: {keep}")
    # warmup_cosine gives lr 0 at step 0, so step 2's loss is step 1's
    # model. AdamW's first nonzero updates then make every tier's loss
    # jump at step 3, the uncompressed hub's too: at this width the
    # reference does the same (tests/test_torch_lm_steps.py::
    # test_adamw_loss_jump_at_full_width_matches_reference), and so does
    # the run without flash below. Training must then lower the mean
    # loss and each tier's at every later step.
    curves = {"mean": losses, **dict(zip(("hub", "high", "mid", "low"),
                                         zip(*res["tier_losses"])))}
    check(all(c[4] < c[3] < c[2] for c in curves.values()),
          f"train: the mean loss and each tier's fall at each of steps 4 "
          f"and 5: " + ", ".join(f"{k} {c[2]:.4f} -> {c[3]:.4f} -> "
                                 f"{c[4]:.4f}" for k, c in curves.items()))
    layers_tiers = cfg.num_layers * n_tiers
    check(got["flash_attention"] == layers_tiers * TRAIN_STEPS,
          f"train: flash_attention launched {layers_tiers} per step "
          f"({cfg.num_layers} layers x {n_tiers} tiers, forward only)")
    check(main_routes == {"wgmma": layers_tiers * TRAIN_STEPS, "simt": 0},
          f"train: every flash_attention launch on the wgmma kernel "
          f"({layers_tiers} per step), none on simt: {main_routes}")
    check(got["fake_quant"] == 30 * TRAIN_STEPS,
          "train: fake_quant launched 30 per step (3 quantized tiers x 10 "
          "leaves)")
    # one more step of the same run, profiled
    opt = optim.adamw(optim.warmup_cosine(3e-4, 2, TRAIN_STEPS))
    step = make_hetero_train_step(get_model(cfg), opt,
                                  default_tier_plans(n_tiers))
    b = make_train_batch(cfg, ShapeConfig("t", seq, batch, "train"),
                         n_tiers=n_tiers, seed=0, index=TRAIN_STEPS)
    b = {k: v.to(device) for k, v in b.items()}
    profile_window("train step", lambda: step(res["state"], b), 1, "step")
    del res, step, b
    # the same run with the plain attention in place of the kernel
    plain = train(cfg.replace(use_flash=False), steps=TRAIN_STEPS,
                  batch=batch, seq=seq, n_tiers=n_tiers, lr=3e-4, warmup=2,
                  seed=0, device=device, log_every=TRAIN_STEPS)
    e = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    print(f"train without flash: losses={plain['losses']} tier_losses="
          f"{plain['tier_losses']}")
    check(e <= 1e-3, f"train: the flash run's losses == the run without "
                     f"flash to rtol 1e-3 (bf16 attention rounding), max "
                     f"rel err {e}")
    return got


# ------------------------------------------------------- MoE and VLM

QWEN_MOE = "qwen3-moe-30b-a3b"
LLAVA = "llava-next-34b"
WIDE_LAYERS = 1     # qwen3-moe (of 48) and llava (of 60) at full width (4
                    # until phase mesh (d6) came, 2 until (d7): phase budget)
DECODE_STEPS = 8    # the profiled MoE decode window
HUB_GEN = 2         # tokens of the MoE, VLM and Zamba hubs' checked serve


def _serve_tiers(cfg, params, tiers, label: str, device, flash: int = 0,
                 gen: int = None) -> tuple[int, int]:
    """``launch.serve`` of ``params`` for each tier at batch 4, prompt 64,
    ``gen`` tokens, counters zeroed before each call: fake_quant once per
    compressible leaf for a quantized tier, 0 for the hub; flash_attention
    ``flash`` times a call (prefill's, Whisper's), all on the wgmma
    kernel. Returns the launches of fake_quant and of flash."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve
    batch, prompt = 4, 64
    gen = SERVE_GEN if gen is None else gen
    n_leaves = _n_compressible(cfg)
    routes = flash_attention.route_launches
    total = total_flash = 0
    for tier in tiers:
        quantized = DEVICE_TIERS[tier].quant_em()[0] > 0
        torch.cuda.reset_peak_memory_stats()
        fake_quant.launches = 0
        for r in routes:
            routes[r] = 0
        res = serve(cfg, tier, batch=batch, prompt_len=prompt, gen=gen,
                    params=params, device=device)
        n, took = fake_quant.launches, dict(routes)
        total += n
        total_flash += took["wgmma"]
        print(f"serve {label} {tier}: compress_s={res['compress_s']:.6f} "
              f"prefill_s={res['prefill_s']:.6f} "
              f"decode_s={res['decode_s']:.6f} decode_tokens_per_s="
              f"{gen * batch / res['decode_s']:.3f} fake_quant_launches={n} "
              f"flash_launches={json.dumps(took)} "
              f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
              f"sample={res['tokens'][0, :8].tolist()}")
        check(bool(torch.isfinite(res["prefill_logits"]).all()
                   and torch.isfinite(res["replay_logits"]).all()),
              f"serve {label} {tier}: logits finite")
        check(n == (n_leaves if quantized else 0),
              f"serve {label} {tier}: fake_quant launched {n} times "
              f"({n_leaves} compressible leaves if quantized, 0 for the hub)")
        check(took == {"wgmma": flash, "simt": 0},
              f"serve {label} {tier}: flash_attention launched {flash} times, "
              f"all on the wgmma kernel: {took}")
    return total, total_flash


def _full_params(cfg, label: str, device) -> dict:
    """Seeded params of ``cfg`` on the card, checked against the leaf table
    the fake_quant checks ran on."""
    from repro_torch.models import get_model
    params = get_model(cfg).init(0, device=device)
    check({k: tuple(v.shape) for k, v in params.items()}
          == _lm_leaf_shapes(cfg),
          f"{label}: the params' leaves are the decoder's leaf table")
    print(f"serve {label}: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"params={sum(p.numel() for p in params.values())} "
          f"dtype={cfg.dtype} experts={cfg.num_experts} "
          f"top_k={cfg.experts_per_token} patches={cfg.num_patches}")
    return params


def _profile_decode(cfg, params, tier: str, device) -> None:
    """A profiled window of DECODE_STEPS decode steps at batch 4 on the
    tier's compressed params: the device busy share of a decode step."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.core.steps import compress_for_serving, make_serve_step
    from repro_torch.models import get_model
    model = get_model(cfg)
    cparams = compress_for_serving(params, DEVICE_TIERS[tier])
    step = make_serve_step(model)
    cache = model.init_cache(4, 2 * DECODE_STEPS, device=device)
    tok = torch.ones((4, 1), dtype=torch.int32, device=device)
    step(cparams, cache, tok, 0)

    def window():
        for pos in range(1, DECODE_STEPS + 1):
            step(cparams, cache, tok, pos)
    profile_window(f"decode {cfg.name} {tier}", window, DECODE_STEPS, "step")


def _replay_check(label: str, replay, prefill, layers=2) -> None:
    """Decode's replay of the prompt against prefill's last-token logits,
    in f32 at a few layers: the same math summed in other orders moves
    logits of O(1) by ~1e-6; a wrong position, mask, slot, route or
    carried state moves them by O(1)."""
    import torch
    e = (replay - prefill).abs().max().item()
    check(torch.allclose(replay, prefill, rtol=1e-3, atol=1e-4),
          f"serve {label} f32 {layers}-layer: decode replay == prefill "
          f"last-token logits (rtol 1e-3, atol 1e-4), max_abs_err {e}, "
          f"max|logit| {prefill.abs().max().item():.3f}")


def phase_moe_serve(device) -> int:
    """The MoE and VLM serve paths at full width; returns fake_quant
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.core.steps import compress_for_serving, make_prefill_step
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    from repro_torch.models.moe import _num_groups, capacity

    # granite-moe-1b-a400m whole, every tier (the hub, which the dense
    # serve phase times, checked over HUB_GEN tokens; it warms up too)
    cfg = get_config(MOE_ARCH)
    params = _full_params(cfg, MOE_ARCH, device)
    _serve_tiers(cfg, params, ("hub",), MOE_ARCH, device, gen=HUB_GEN)
    total = _serve_tiers(cfg, params, ("low", "embedded"), MOE_ARCH,
                         device)[0]
    _profile_decode(cfg, params, "low", device)
    del params
    torch.cuda.empty_cache()

    # qwen3-moe-30b-a3b and llava-next-34b at full width, cut in depth
    for arch in (QWEN_MOE, LLAVA):
        full = get_config(arch)
        cfg = full.replace(num_layers=WIDE_LAYERS)
        params = _full_params(cfg, f"{arch} ({WIDE_LAYERS} of "
                                   f"{full.num_layers} layers)", device)
        n = 4 * (64 + cfg.num_patches)
        if cfg.is_moe:
            print(f"serve {arch}: prefill groups {_num_groups(n, 1)} of "
                  f"{n // _num_groups(n, 1)} tokens, capacity "
                  f"{capacity(n // _num_groups(n, 1), cfg)} per expert; "
                  f"decode capacity {capacity(4, cfg)}")
        _serve_tiers(cfg, params, ("hub",), arch, device, gen=HUB_GEN)
        total += _serve_tiers(cfg, params, ("low",), arch, device)[0]
        del params
        torch.cuda.empty_cache()

    # decode replay against prefill, f32 at 2 layers of full width; MoE
    # at a capacity factor that drops nothing (E / k), as the reference's
    # smoke config does: at 1.25, decode at batch 4 has capacity 1 and
    # drops choices that prefill keeps
    cfg = get_config(MOE_ARCH)
    cfg = cfg.replace(num_layers=2, dtype="float32",
                      capacity_factor=cfg.num_experts / cfg.experts_per_token)
    res = serve(cfg, "mid", batch=4, prompt_len=64, gen=1, device=device)
    _replay_check(MOE_ARCH, res["replay_logits"], res["prefill_logits"])
    # VLM: the replay sees the text alone, so it is held against a prefill
    # of the same prompt without patches; the patches must move prefill
    cfg = get_config(LLAVA).replace(num_layers=2, dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=device)
    res = serve(cfg, "mid", batch=4, prompt_len=64, gen=1, params=params,
                device=device)
    prompt = TokenStream(cfg.vocab_size, 4, 64, seed=0).batch_at(0)[
        "tokens"][:, :64].to(device)
    text, _ = make_prefill_step(model)(
        compress_for_serving(params, DEVICE_TIERS["mid"]), {"tokens": prompt})
    _replay_check(LLAVA, res["replay_logits"], text)
    moved = (res["prefill_logits"] - text).abs().max().item()
    check(moved > 1e-2, f"serve {LLAVA} f32 2-layer: the patches move "
                        f"prefill's last-token logits (max {moved})")
    return total


def _train_run(cfg, label: str, steps: int, batch: int, seq: int,
               route: str, device, n_tiers: int = 4, lr: float = 3e-4,
               model_parallel: int = 1):
    """``launch.train`` of ``cfg`` (AdamW(warmup_cosine(lr, 2, steps)),
    ``n_tiers`` tiers, ``--model-parallel``), its counters zeroed just
    before: losses finite, flash_attention once per attention call per
    tier and step, all on ``route``, fake_quant once per compressible
    leaf per quantized tier and step. Returns (the run, its launches)."""
    import torch
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train
    routes = flash_attention.route_launches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for r in routes:
        routes[r] = 0
    fake_quant.launches = 0
    res = train(cfg, steps=steps, batch=batch, seq=seq, n_tiers=n_tiers,
                lr=lr, warmup=2, seed=0, device=device, log_every=1,
                model_parallel=model_parallel)
    launches = {"fake_quant": fake_quant.launches, **routes}
    losses, secs = res["losses"], res["sec_per_step"]
    steady = secs[1:] if len(secs) > 1 else secs
    sps = sum(steady) / len(steady)
    print(f"train {label}: losses={losses} tier_losses (hub, high, mid, "
          f"low)={res['tier_losses']}")
    print(f"train {label}: sec_per_step={secs} mean_sec_per_step(steps "
          f"2..{steps})={sps:.6f} tokens_per_s={batch * seq / sps:.3f} "
          f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.3f} "
          f"launches={json.dumps(launches)}")
    check(all(math.isfinite(x) for x in losses)
          and all(math.isfinite(x) for t in res["tier_losses"] for x in t),
          f"train {label}: losses finite")
    per_step = _attn_calls(cfg) * n_tiers
    check(launches[route] == per_step * steps
          and sum(launches[r] for r in routes) == per_step * steps,
          f"train {label}: flash_attention launched {per_step} per step "
          f"({_attn_calls(cfg)} attention calls x {n_tiers} tiers), all on "
          f"the {route} kernel at hd {cfg.head_dim}")
    n_fq = 3 * _n_compressible(cfg)
    check(launches["fake_quant"] == n_fq * steps,
          f"train {label}: fake_quant launched {n_fq} per step (3 "
          f"quantized tiers x {n_fq // 3} leaves)")
    return res, launches


def _profile_train_step(cfg, state, steps: int, label: str, device,
                        lr: float = 3e-4) -> None:
    """One more step of a ``_train_run`` (batch index ``steps``, 8 x 1024
    over 4 tiers), profiled."""
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models import get_model
    opt = optim.adamw(optim.warmup_cosine(lr, 2, steps))
    step = make_hetero_train_step(get_model(cfg), opt, default_tier_plans(4))
    b = make_train_batch(cfg, ShapeConfig("t", 1024, 8, "train"), n_tiers=4,
                         seed=0, index=steps)
    b = {k: v.to(device) for k, v in b.items()}
    profile_window(f"train step {label}", lambda: step(state, b), 1, "step")


def phase_moe_train(device) -> dict:
    """The tier-loop train step on the MoE and VLM families; returns the
    launches of its runs."""
    from repro_torch.configs import get_config

    smoke_routes = _train_smoke_vs_cpu(MOE_ARCH, device)
    got = {"flash_attention_simt": smoke_routes["simt"]}

    def run(cfg, label, steps, batch, seq):
        res, launches = _train_run(cfg, label, steps, batch, seq, "wgmma",
                                   device)
        for k in ("fake_quant", "wgmma"):
            got[k] = got.get(k, 0) + launches[k]
        return res

    # granite-moe-1b-a400m whole: every layer, full width
    cfg = get_config(MOE_ARCH).replace(use_flash=True)
    print(f"train {MOE_ARCH}: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"experts={cfg.num_experts} top_k={cfg.experts_per_token} "
          f"dtype={cfg.dtype} use_flash=True tiers=4 batch=8 seq=1024 "
          f"steps={TRAIN_STEPS}")
    res = run(cfg, MOE_ARCH, TRAIN_STEPS, 8, 1024)
    del res

    # llava-next-34b at full width, one layer: 896 text + 1152 patch
    # positions, flash at hd 128
    cfg = get_config(LLAVA).replace(num_layers=1, use_flash=True)
    print(f"train {LLAVA}: layers=1 (of 60) d_model={cfg.d_model} "
          f"head_dim={cfg.head_dim} patches={cfg.num_patches} dtype="
          f"{cfg.dtype} use_flash=True tiers=4 batch=4 seq=2048 steps=2")
    run(cfg, LLAVA, 2, 4, 2048)
    return {"fake_quant": got["fake_quant"],
            "flash_attention_wgmma": got["wgmma"],
            "flash_attention_simt": got["flash_attention_simt"]}


# ------------------------------------------------ recurrent families

# xLSTM and Zamba at the low tier (the warm-up call serves the hub); the
# embedded tier's k-means runs in phase serve, and Zamba's hub left since
# phase mesh (d6) came (phase budget)
RECURRENT_SERVE = {XLSTM: ("low",), ZAMBA: ("low",)}
RECURRENT_REPLAY = {XLSTM: 8, ZAMBA: 6}     # one superblock; one application
RECURRENT_TRAIN = {XLSTM: 8, ZAMBA: 12}     # one superblock; two applications
RECURRENT_STEPS = 3
# AdamW's peak lr: at 3e-4, the other train phases' lr, Zamba's mean loss
# on an H100 jumps at step 3 under AdamW's first updates and then swings
# (15.05, 11.47, 12.16 at steps 3-5), the uncompressed tiers the most; at
# 3e-5 it falls from step 3 on
RECURRENT_LR = {XLSTM: 3e-4, ZAMBA: 3e-5}


def phase_recurrent_serve(device) -> int:
    """xlstm-1.3b and zamba2-2.7b served whole; returns fake_quant
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    total = 0
    for arch, tiers in RECURRENT_SERVE.items():
        cfg = get_config(arch)
        params = _full_params(cfg, arch, device)
        serve(cfg, "hub", batch=4, prompt_len=8, gen=2, params=params,
              device=device)                      # warm-up
        for tier in tiers:
            kw = {"gen": HUB_GEN} if tier == "hub" else {}
            total += _serve_tiers(cfg, params, (tier,), arch, device,
                                  **kw)[0]
        _profile_decode(cfg, params, "low", device)
        del params
        torch.cuda.empty_cache()
    # the f32 replay at full width: a prompt of 512 makes prefill run two
    # 256-chunks and carry the state across. Zamba's decode attends to the
    # slots not written yet (slot_pos 0, as the reference's init_cache), so
    # its replay fills a cache exactly as long as the prompt (gen 0)
    for arch, layers in RECURRENT_REPLAY.items():
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        res = serve(cfg, "mid", batch=4, prompt_len=512,
                    gen=0 if cfg.family == "hybrid" else 1, device=device)
        _replay_check(f"{arch} prompt 512", res["replay_logits"],
                      res["prefill_logits"], layers)
        del res
        torch.cuda.empty_cache()
    return total


def phase_recurrent_train(device) -> dict:
    """The tier-loop train step on the recurrent families; returns the
    launches of its runs."""
    from repro_torch.configs import get_config
    got = {"fake_quant": 0, "flash_attention_simt": 0}
    for arch in RECURRENT_TRAIN:
        got["flash_attention_simt"] += _train_smoke_vs_cpu(arch, device)["simt"]
    for arch, layers in RECURRENT_TRAIN.items():
        full = get_config(arch)
        cfg = full.replace(num_layers=layers, use_flash=True)
        steps, lr = RECURRENT_STEPS, RECURRENT_LR[arch]
        print(f"train {arch}: layers={layers} (of {full.num_layers}) "
              f"d_model={cfg.d_model} dtype={cfg.dtype} use_flash=True "
              f"tiers=4 batch=8 seq=1024 steps={steps} lr={lr}")
        res, launches = _train_run(cfg, arch, steps, 8, 1024, "simt", device,
                                   lr=lr)
        c = res["losses"]
        check(c[-1] < c[-2], f"train {arch}: the mean loss falls over the "
                             f"last two steps: {c[-2]:.4f} -> {c[-1]:.4f}")
        got["fake_quant"] += launches["fake_quant"]
        got["flash_attention_simt"] += launches["simt"]
        del res
    return got


# ------------------------------------------------------------- audio

# AdamW's peak lr for whisper-tiny's train run
AUDIO_LR = 3e-4


def phase_audio_serve(device) -> dict:
    """whisper-tiny served whole with flash, and its f32 decode replay;
    returns the launches of fake_quant and flash."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.compression import DEVICE_TIERS
    from repro_torch.core.steps import (compress_for_serving,
                                        make_prefill_step, make_serve_step)
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.launch.serve import serve
    from repro_torch.models import get_model
    cfg = get_config(WHISPER).replace(use_flash=True)
    params = _full_params(cfg, WHISPER, device)
    print(f"serve {WHISPER}: encoder_layers={cfg.encoder_layers} "
          f"frames={cfg.encoder_seq} use_flash=True")
    serve(cfg, "hub", batch=4, prompt_len=8, gen=2, params=params,
          device=device)                      # warm-up
    # prefill's flash calls: each encoder layer's self-attention and each
    # decoder layer's cross-attention (its self-attention is chunked)
    fq, flash = _serve_tiers(cfg, params, SERVE_TIERS, WHISPER, device,
                             flash=cfg.encoder_layers + cfg.num_layers)
    _profile_decode(cfg, params, "low", device)
    del params
    torch.cuda.empty_cache()

    # f32 at the full config: a fresh cache holding prefill's cross-KV
    # (as the reference's tests/test_decode_consistency.py seeds it),
    # replayed token by token, gives prefill's last-token logits
    cfg = get_config(WHISPER).replace(dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=device)
    cparams = compress_for_serving(params, DEVICE_TIERS["mid"])
    batch, prompt_len = 4, 64
    prompt = TokenStream(cfg.vocab_size, batch, prompt_len, seed=0).batch_at(
        0)["tokens"][:, :prompt_len].to(device)
    frames = torch.randn(
        (batch, cfg.encoder_seq, cfg.d_model), dtype=torch.float32,
        device=device, generator=torch.Generator(device=device).manual_seed(0))
    logits, pcache = make_prefill_step(model)(
        cparams, {"tokens": prompt, "frames": frames})
    cache = model.init_cache(batch, prompt_len, device=device)
    for k in ("enc_k", "enc_v"):
        cache["layers"][k].copy_(pcache["layers"][k])
    step = make_serve_step(model)
    for i in range(prompt_len):
        replay, cache = step(cparams, cache, prompt[:, i:i + 1], i)
    _replay_check(f"{WHISPER} (prefill's cross-KV)", replay, logits,
                  f"{cfg.encoder_layers}+{cfg.num_layers}")
    # the launcher's own replay starts from init_cache's zero cross-KV, as
    # the reference's does, so its decode does not see the audio
    res = serve(cfg, "mid", batch=batch, prompt_len=prompt_len, gen=1,
                params=params, device=device)
    same = (res["prefill_logits"] - logits).abs().max().item()
    check(same <= 1e-5, f"serve {WHISPER} f32: the launcher's prefill (its "
                        f"frames drawn from the seed) == the prefill above, "
                        f"max_abs_err {same}")
    moved = (res["replay_logits"] - res["prefill_logits"]).abs().max().item()
    check(moved > 1e-2, f"serve {WHISPER} f32: the launcher's replay with zero "
                        f"cross-KV differs from prefill (max {moved}), as the "
                        f"reference's launcher's does")
    return {"fake_quant": fq, "flash_attention_wgmma": flash}


def phase_audio_train(device) -> dict:
    """The tier-loop train step on whisper-tiny; returns the launches of
    its runs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    smoke = _train_smoke_vs_cpu(WHISPER, device, held=1)
    cfg = get_config(WHISPER).replace(use_flash=True)
    print(f"train {WHISPER}: encoder_layers={cfg.encoder_layers} "
          f"layers={cfg.num_layers} d_model={cfg.d_model} frames="
          f"{cfg.encoder_seq} dtype={cfg.dtype} use_flash=True tiers=4 "
          f"batch=8 seq=1024 steps={TRAIN_STEPS} lr={AUDIO_LR}")
    res, launches = _train_run(cfg, WHISPER, TRAIN_STEPS, 8, 1024, "wgmma",
                               device, lr=AUDIO_LR)
    c = res["losses"]
    check(c[-1] < c[-2], f"train {WHISPER}: the mean loss falls over the "
                         f"last two steps: {c[-2]:.4f} -> {c[-1]:.4f}")
    _profile_train_step(cfg, res["state"], TRAIN_STEPS, WHISPER, device,
                        AUDIO_LR)
    del res
    # the same run with the plain attention in place of the kernel
    plain = train(cfg.replace(use_flash=False), steps=TRAIN_STEPS, batch=8,
                  seq=1024, n_tiers=4, lr=AUDIO_LR, warmup=2, seed=0,
                  device=device, log_every=TRAIN_STEPS)
    e = max(abs(a - b) / abs(b) for a, b in zip(c, plain["losses"]))
    print(f"train {WHISPER} without flash: losses={plain['losses']}")
    check(e <= 1e-3, f"train {WHISPER}: the flash run's losses == the run "
                     f"without flash to rtol 1e-3, max rel err {e}")
    return {"fake_quant": launches["fake_quant"],
            "flash_attention_wgmma": launches["wgmma"],
            "flash_attention_simt": smoke["simt"]}


# ------------------------------------------------------ meshes, dry run

MESH_STEPS = 2                      # (a)'s steps (phase budget)
# (a)'s and (b)'s depth, 2 of whisper-tiny's 4 decoder and 4 encoder
# layers (whole until phase mesh (d7) came: phase budget)
MESH_WHISPER_DEPTH = dict(num_layers=2, encoder_layers=2)
MESH_MEMORY_RTOL = 0.25             # dry-run bytes vs the card's peak
MESH_RANKS = 2                      # (d): two ranks share the card over gloo
# (d1), warmup 20; 2 layers and 8 x 256 until (d7) came (phase budget)
MESH_F32 = dict(layers=1, batch=8, seq=128, steps=2)
MESH_BF16 = dict(layers=4, batch=8, seq=1024, steps=2)  # (d2), warmup 2
# (d2): its losses within this x the one rank's bf16-vs-f32 distance D: 2 D
# by the triangle inequality through the f32 losses, and one D more for the
# bf16 rounding of each rank's partial sum of a row-split projection
MESH_BF16_SLACK = 3.0
MESH_RANK_TIMEOUT = 600             # seconds the ranks of (d) may take
# (d3) runs the MoE decoder over the same two ranks at (d1)'s and (d2)'s
# shapes and bars: granite-moe at full width (E 32 top-8, H 16 / 8, vocab
# 49155, which splits the embedding on d_model). (d4) runs xLSTM, Zamba2
# and Whisper at full width at (d1)'s shape and bars on (1, 2), and times
# Zamba's bf16 part at (d2)'s shape (the device-bound family, flash on its
# 16 local heads of 80).
# The parts of (d): (f32 tag, bf16 tag or None, arch, layers, the
# model-parallel widths of the f32 part's meshes)
MESH_PARTS = (("d1", "d2", LM_ARCH, None, (MESH_RANKS, 1)),
              ("d3 f32", "d3 bf16", MOE_ARCH, None, (MESH_RANKS, 1)),
              ("d4 zamba", "d4 bf16", ZAMBA, 6, (MESH_RANKS,)),  # one app.
              ("d4 whisper", None, WHISPER, 4, (MESH_RANKS,)),   # whole
              ("d4 xlstm", None, XLSTM, 8, (MESH_RANKS,)))   # one superblock


def phase_mesh(device) -> dict:
    """(a) whisper-tiny (2 + 2 layers) trained through ``launch.train`` at
    --model-parallel 2 (the host mesh over every CUDA device: (1, 1) on a
    one-card host) and at 1: losses and final params bitwise; (b) the LM
    dry run of the same config and shape on that host mesh against the
    real state, batch and step on the card; (c) one production record,
    its collectives and temp per device; (d) the dense and MoE decoders,
    xLSTM, Zamba2 and Whisper trained over two ranks, and prefill and
    decode served over them (:func:`_mesh_ranks`). Returns the launches
    of (a) and (d)."""
    import shutil

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import TrainState, make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.launch.analysis import nbytes
    from repro_torch.launch.dryrun import dry_run_step, run_one
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model

    # (a) the launcher at --model-parallel 2 and 1
    cfg = get_config(WHISPER).replace(use_flash=True, **MESH_WHISPER_DEPTH)
    runs, got = {}, {"fake_quant": 0, "flash_attention_wgmma": 0}
    for mp in (2, 1):
        print(f"mesh: train {WHISPER} {MESH_WHISPER_DEPTH} --model-parallel "
              f"{mp}: bf16 "
              f"use_flash=True tiers=4 batch=8 seq=1024 steps={MESH_STEPS}")
        runs[mp], launches = _train_run(cfg, f"{WHISPER} mp{mp}", MESH_STEPS,
                                        8, 1024, "wgmma", device, lr=AUDIO_LR,
                                        model_parallel=mp)
        got["fake_quant"] += launches["fake_quant"]
        got["flash_attention_wgmma"] += launches["wgmma"]
    a, b = runs[2], runs[1]
    same = a["losses"] == b["losses"] and a["tier_losses"] == b[
        "tier_losses"] and all(torch.equal(v, b["state"]["params"][k])
                               for k, v in a["state"]["params"].items())
    check(same, f"mesh: --model-parallel 2 (a (1, 1) host mesh on one card) "
                f"== --model-parallel 1: losses, tier losses and final "
                f"params bitwise")
    del runs, a, b
    torch.cuda.empty_cache()

    # (b) the dry run on the host mesh against the card, flash off in both
    plain = cfg.replace(use_flash=False)
    shape = ShapeConfig("cli", 1024, 8, "train")
    mesh = make_host_mesh(2)
    t0 = time.perf_counter()
    rec = dry_run_step(plain, shape, mesh)
    print(f"mesh: dry run {WHISPER} cli 8 x 1024 on host mesh "
          f"{dict(mesh.shape)}: {time.perf_counter() - t0:.1f} s "
          f"trace_s={rec['trace_s']} flops={rec['flops']} traffic_bytes="
          f"{rec['traffic_bytes']} memory={json.dumps(rec['memory'])}")
    model = get_model(plain)
    opt = optim.adamw(optim.warmup_cosine(3e-4, 100, 10_000))
    state = TrainState.create(model, opt, 0, device=device)
    batch = {k: v.to(device) for k, v in make_train_batch(
        plain, shape, n_tiers=4, seed=0, index=0).items()}
    step = make_hetero_train_step(model, opt, default_tier_plans(4))
    step(state, batch)                          # warm-up
    torch.cuda.synchronize()
    arg_bytes = nbytes((state, batch))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        out = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    mem = rec["memory"]
    dry = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"mesh: real step on the card: argument bytes {arg_bytes} "
          f"(allocated before the step {before}), output bytes "
          f"{nbytes(out)}, FlopCounterMode flops {fc.get_total_flops()}, "
          f"max_memory_allocated {peak}; dry run argument + temp {dry} "
          f"({dry / peak:.4f} of the peak)")
    check(mem["argument_size_in_bytes"] == arg_bytes,
          f"mesh: dry-run argument bytes {mem['argument_size_in_bytes']} == "
          f"the real train state and batch on the card {arg_bytes}")
    check(rec["flops"] == fc.get_total_flops(),
          f"mesh: dry-run flops {rec['flops']} == FlopCounterMode over one "
          f"real step on the card {fc.get_total_flops()} (flash off)")
    check(abs(dry - peak) <= MESH_MEMORY_RTOL * peak,
          f"mesh: dry-run argument + temp bytes {dry} within "
          f"{MESH_MEMORY_RTOL:.0%} of the step's max_memory_allocated {peak}")
    del state, batch, out
    torch.cuda.empty_cache()

    # (c) one production record
    d = _ckpt_dir()
    try:
        r = run_one(LM_ARCH, "decode_32k", False, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mem = r.get("memory", {})
    print(f"mesh: dry run {LM_ARCH} decode_32k 16x16: status={r['status']} "
          f"wall_s={r['wall_s']} trace_s={r.get('trace_s')} rank_trace_s="
          f"{r.get('rank_trace_s')} flops={r.get('flops')} traffic_bytes="
          f"{r.get('traffic_bytes')} per device: argument_bytes="
          f"{mem.get('argument_size_in_bytes')} temp_bytes="
          f"{mem.get('temp_size_in_bytes')} ({mem.get('temp_scope')}) "
          f"collectives={json.dumps(r.get('collectives'))} "
          f"{r.get('error', '')}")
    check(r["status"] == "ok", f"mesh: the {LM_ARCH} decode_32k record on "
                               f"16x16 is ok")

    # (d) every family trained over two ranks sharing the card
    for k, v in _mesh_ranks(device).items():
        got[k] = got.get(k, 0) + v
    return got


def _mesh_cfg(layers: int | None, dtype: str, arch: str = LM_ARCH):
    """``arch`` at full width, ``layers`` deep (None: the (d1) / (d2)
    depth of the run of ``dtype``), flash on."""
    from repro_torch.configs import get_config
    if layers is None:
        layers = (MESH_F32 if dtype == "float32" else MESH_BF16)["layers"]
    return get_config(arch).replace(num_layers=layers, dtype=dtype,
                                    use_flash=True)


def _mesh_train(cfg, run: dict, warmup: int, device, model_parallel=1,
                fsdp: bool = False):
    """``launch.train`` of a (d) run, its counters zeroed just before;
    (the run, with ``census``: each step's collectives, its launches)."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import train
    routes = flash_attention.route_launches
    for r in routes:
        routes[r] = 0
    fake_quant.launches = 0
    with _StepCensus() as census:
        res = train(cfg, steps=run["steps"], batch=run["batch"],
                    seq=run["seq"], n_tiers=4, lr=3e-4, warmup=warmup,
                    seed=0, device=device, log_every=1,
                    model_parallel=model_parallel, fsdp=fsdp)
    res["census"] = census.records
    return res, {"fake_quant": fake_quant.launches, **routes}


class _StepCensus:
    """The collectives of each train step that ``launch.train`` takes
    within the window (``parallel.counting`` around each call of the
    step it builds): ``records``, one census record a step."""

    def __enter__(self):
        from repro_torch.launch import train as train_mod
        from repro_torch.models import parallel
        inner, records = train_mod.make_hetero_train_step, []
        self.records = records

        def make(*a, **k):
            step = inner(*a, **k)

            def counted(*args):
                with parallel.counting() as c:
                    out = step(*args)
                records.append(c.record())
                return out
            return counted

        self._restore = (train_mod, inner)
        train_mod.make_hetero_train_step = make
        return self

    def __exit__(self, *exc):
        train_mod, inner = self._restore
        train_mod.make_hetero_train_step = inner


def _count_exactness(params: dict, densities) -> dict:
    """Whether the one-rank pruning's f32 counts are exact: for each leaf
    past 2^24 elements and each density, the halvings of its bisection
    (``pruning._threshold``'s arithmetic) whose f32 count differs from
    the int64 count of the same compare."""
    import torch
    from repro_torch.core.compression import pruning as pr
    out = {}
    for name, w in params.items():
        if w.dim() < 2 or w.numel() <= 1 << 24:
            continue
        aw = w.abs()
        for density in densities:
            amax = torch.amax(aw) + 1e-30
            lo, hi = torch.log(pr._flush(amax * pr.EPS)), torch.log(amax)
            off = []
            for i in range(pr.ITERS):
                mid = 0.5 * (lo + hi)
                keep = aw >= pr._flush(torch.exp(mid))
                count = torch.sum(keep.to(torch.float32))
                exact = int(torch.sum(keep, dtype=torch.int64).item())
                if count.item() != exact:
                    off.append((i, count.item(), exact))
                up = count / float(aw.numel()) > density
                lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
            out[f"{name}@{density}"] = off
    return out


def _one_rank_runs(part: tuple, device, d: Path) -> dict:
    """The one-rank runs of a (d) part (:data:`MESH_PARTS`), here:
    ``MESH_F32`` in f32 under the launcher's warmup (its final params
    saved to ``d`` for the ranks), and where the part has a bf16 part
    ``MESH_BF16`` in bf16 and in f32 (warmup 2) for the bf16 bar."""
    import torch
    t0 = time.perf_counter()
    tag1, tag2, arch, layers, _ = part
    cfg1 = _mesh_cfg(layers, "float32", arch)
    print(f"mesh ({tag1}): one rank: {arch} {MESH_F32} layers "
          f"{cfg1.num_layers} f32 use_flash=True tiers=4 (launcher warmup "
          f"20)")
    one, l1 = _mesh_train(cfg1, MESH_F32, 20, device)
    torch.save({g: {k: v.cpu() for k, v in tree.items()} for g, tree in (
        ("params", one["state"]["params"]), ("m", one["state"]["opt"]["m"]))},
        d / f"one_rank_f32_{cfg1.name}.pt")
    del one["state"]
    torch.cuda.empty_cache()
    out = {"cfg1": cfg1, "one": one, "l1": l1}
    if layers is None:              # the decoders' pruning counts
        from repro_torch.models import get_model
        whole = get_model(cfg1).init(0, device=device)
        exact = _count_exactness(whole, (0.5, 0.25))
        del whole
        print(f"mesh ({tag1}): one-rank f32 counts that differ from the "
              f"exact count, (halving, f32, exact), per leaf past 2^24 "
              f"elements: {json.dumps(exact)}")
    if tag2 is None:
        print(f"mesh ({tag1}): one-rank runs {time.perf_counter() - t0:.1f} s")
        return out
    cfg2 = _mesh_cfg(layers, "bfloat16", arch)
    bf, l2 = _mesh_train(cfg2, MESH_BF16, 2, device)
    f32, _ = _mesh_train(cfg2.replace(dtype="float32"), MESH_BF16, 2, device)
    dist_bf = max(abs(a - b) for a, b in zip(bf["losses"], f32["losses"]))
    print(f"mesh ({tag2}): one rank {MESH_BF16} layers {cfg2.num_layers}: "
          f"bf16 losses {bf['losses']} f32 losses {f32['losses']} (max "
          f"distance {dist_bf:.6g}); bf16 sec_per_step {bf['sec_per_step']}"
          f" launches {json.dumps(l2)}")
    del bf["state"], f32["state"]
    torch.cuda.empty_cache()
    print(f"mesh ({tag1}, {tag2}): one-rank runs "
          f"{time.perf_counter() - t0:.1f} s")
    return {**out, "cfg2": cfg2, "bf": bf, "l2": l2, "dist_bf": dist_bf}


def _mesh_ranks(device) -> dict:
    """(d) the decoder over ``MESH_RANKS`` ranks on the one card (gloo:
    NCCL refuses two ranks on one device), each rank a process of its
    own (``--mesh-rank``). (d1) llama3.2-3b at full width, 1 layer, f32,
    flash (simt), 4 tiers, 8 x 128, 2 steps under the launcher's warmup:
    meshes (1, 2) and (2, 1) against the one-rank launcher from the same
    seed (losses rtol 1e-4, gathered params atol 1e-5), each rank's masks
    bitwise the one-rank masks' blocks, its fake_quant launches the
    one-rank count, its flash launches its attention calls, its placed
    state exactly ``shard_bytes``. (d2) 4 layers, bf16, flash (wgmma),
    8 x 1024, 3 steps on (1, 2): s/step, tokens/s, peak memory and busy
    share per rank; losses within ``MESH_BF16_SLACK`` x the one-rank
    run's own bf16-vs-f32 distance. (d3) the same two parts on
    granite-moe-1b-a400m (experts split over "model", 16 a rank; on
    (2, 1) each tier's one 512-token group straddles the data ranks),
    with the MoE layer's share of (d3)'s profiled step. (d4) (d1)'s part
    on (1, 2) for xlstm-1.3b (8 layers), zamba2-2.7b (6) and whisper-tiny
    (whole), and (d2)'s for zamba2-2.7b (flash on the simt route, hd 80).
    (d5) (d1)'s run on (2, 1) with the FSDP layout, held to (d1)'s
    one-rank run and bars and to its dry-run record (:func:`_check_fsdp`).
    (d2)'s and (d5)'s counted collectives and step peaks against the dry
    run's per-device census and bytes (:func:`_check_census`). (d6)
    prefill and decode on (1, 2) of ``MESH_SERVE``'s runs, each rank its
    blocks of the deployed params and of the cache, against one rank and
    the dry run (:func:`_check_serve`). (d7) the same on (1, 8) for
    :data:`MESH_ROWS`, in ``MESH_ROWS_RANKS`` rank processes of their
    own. Returns the ranks' launches."""
    import shutil

    d = Path(_ckpt_dir())
    try:
        # the one-rank runs, here, and (d2)'s and (d5)'s dry-run records
        parts = [_one_rank_runs(part, device, d) for part in MESH_PARTS]
        serve_one = {p: _serve_one_rank(device, d, p) for p in SERVE_PARTS}
        dry = _rank_dry_runs()
        serve_dry = {p: _serve_dry_runs(p) for p in SERVE_PARTS}
        # (d7)'s ranks start beside (d)'s, so that their start-up overlaps
        # (d)'s run, and wait for its end (the go file) before they work
        rows = _start_ranks(d, MESH_ROWS_RANKS)
        try:
            ranks = _join_ranks(d, "d", _start_ranks(d, MESH_RANKS))
            (d / "d7.go").touch()
            rows = _join_ranks(d, "d7", rows)
        finally:
            _stop(rows)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    launches = {"fake_quant": 0, "flash_attention_simt": 0,
                "flash_attention_wgmma": 0}
    for part, one_rank in zip(MESH_PARTS, parts):
        f32s = [rk[part[0]] for rk in ranks]
        if part[0] == "d1":     # (d5) is held to (d1)'s one-rank run
            f32s = [{**runs, "(2, 1) fsdp": rk["d5"]}
                    for runs, rk in zip(f32s, ranks)]
        got = _check_ranks(one_rank, f32s, [rk.get(part[1]) for rk in ranks],
                           part[:2])
        for k in launches:
            launches[k] += got[k]
    _check_fsdp(ranks, dry["d5"]["argument_size_in_bytes"])
    _check_census(ranks, dry)
    _check_serve(ranks, serve_one["d6"], serve_dry["d6"], "d6")
    _check_serve(rows, serve_one["d7"], serve_dry["d7"], "d7")
    launches["fake_quant"] += sum(
        rk[p][tag]["launches"] for p, rks in (("d6", ranks), ("d7", rows))
        for rk in rks for tag, *_ in SERVE_PARTS[p][0])
    return launches


def _start_ranks(d: Path, world: int) -> tuple:
    """Starts ``world`` rank processes on the card (``chip_smoke.py
    --mesh-rank R``, gloo over a free port), each writing its log to
    ``d/w{world}_rank{R}.log``; returns (the processes, their start
    time)."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in range(world):
        with open(d / f"w{world}_rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 str(r), "--mesh-world", str(world), "--mesh-dir", str(d),
                 "--mesh-port", str(port)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, text=True))
    return procs, time.perf_counter()


def _stop(started) -> None:
    """Kills the processes of :func:`_start_ranks` still running."""
    if isinstance(started, tuple):
        for p in started[0]:
            if p.poll() is None:
                p.kill()
                p.wait()


def _join_ranks(d: Path, what: str, started: tuple) -> list:
    """Waits for the rank processes of :func:`_start_ranks` with a time
    limit from their start; prints their logs, and returns each rank's
    results (``d/w{world}_rank{R}.json``). A rank's nonzero exit fails
    the phase."""
    procs, t0 = started
    world = len(procs)
    try:
        for p in procs:
            left = MESH_RANK_TIMEOUT - (time.perf_counter() - t0)
            p.wait(timeout=max(left, 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        _stop(started)
    for r in range(world):
        for line in (d / f"w{world}_rank{r}.log").read_text().splitlines():
            print(f"mesh ({what}) rank {r}: {line}")
    check(all(p.returncode == 0 for p in procs),
          f"mesh ({what}): every rank of {world} exits 0 within "
          f"{MESH_RANK_TIMEOUT} s (exit codes "
          f"{[p.returncode for p in procs]}, "
          f"{time.perf_counter() - t0:.1f} s)")
    return [json.loads((d / f"w{world}_rank{r}.json").read_text())
            for r in range(world)]


def _rank_dry_runs() -> dict:
    """The dry run's per-device figures (``launch.specs``: fake tensors,
    flash off, which moves no argument byte and no collective) of (d2)'s
    config and shape on an abstract (1, MESH_RANKS) mesh and of (d5)'s,
    the reference's FSDP layout, on (MESH_RANKS, 1): a train record's
    argument bytes (``train_setup``'s shardings) and rank 0's trace of
    the sharded step (``rank_traced``: its temp bytes and collectives).
    The global trace, which neither check reads, is not run."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import rank_traced, setup_for
    from repro_torch.models.sharding import shard_bytes
    out = {}
    for tag, dtype, run, mesh_shape in (
            ("d2", "bfloat16", MESH_BF16, (1, MESH_RANKS)),
            ("d5", "float32", MESH_F32, (MESH_RANKS, 1))):
        cfg = _mesh_cfg(None, dtype).replace(use_flash=False)
        slots = np.empty(mesh_shape, dtype=object)
        slots.fill(torch.device("meta"))
        mesh = Mesh(slots, ("data", "model"))
        shape = ShapeConfig("cli", run["seq"], run["batch"], "train")
        t0 = time.perf_counter()
        _, args, in_sh, _ = setup_for(cfg, shape, mesh)
        counts, _, rank_s = rank_traced(cfg, shape, mesh)
        rec = out[tag] = {"argument_size_in_bytes": shard_bytes(args, in_sh),
                          "temp_size_in_bytes": counts["temp_bytes"],
                          "collectives": counts["collectives"]}
        print(f"mesh ({tag}): dry run {cfg.name} {cfg.num_layers} layers "
              f"{cfg.dtype} cli {run['batch']} x {run['seq']} on an "
              f"abstract {dict(mesh.shape)} mesh"
              f"{', FSDP' if tag == 'd5' else ''}: "
              f"{time.perf_counter() - t0:.1f} s (rank_trace_s {rank_s}), "
              f"per device: {json.dumps(rec)}")
    return out


def _check_fsdp(ranks: list, dry: int) -> None:
    """(d5)'s bars past (d1)'s: each rank's placed state is the dry run's
    per-device argument bytes less its batch rows, exactly, and its step's
    peak is below (d1)'s (2, 1) peak on the same rank."""
    for r, rk in enumerate(ranks):
        d5, d1 = rk["d5"], rk["d1"][f"({MESH_RANKS}, 1)"]
        tag = f"mesh (d5) rank {r} mesh ({MESH_RANKS}, 1) fsdp"
        steps = len(d5["sec_per_step"])
        coll = (d5["gather_s"] + d5["scatter_s"]) / steps
        p5, p1 = max(d5["peak_bytes"]), max(d1["peak_bytes"])
        print(f"{tag}: placed state {d5['bytes'][0]} bytes (FSDP "
              f"shard_bytes {d5['bytes'][1]}; (d1) (2, 1): "
              f"{d1['bytes'][0]}), + batch rows {d5['batch_bytes']} = "
              f"{d5['bytes'][0] + d5['batch_bytes']} (dry run {dry}); step "
              f"peak max_memory_allocated {d5['peak_bytes']} ((d1) (2, 1): "
              f"{d1['peak_bytes']}); sec_per_step {d5['sec_per_step']} "
              f"((d1) (2, 1): {d1['sec_per_step']}); collectives over "
              f"\"data\" {coll:.3f} s a step ({d5['gathers']} all_gathers "
              f"{d5['gather_s']:.3f} s, {d5['scatters']} reduce_scatters "
              f"{d5['scatter_s']:.3f} s in {steps} steps; host clock, a "
              f"device sync before and after each call); launches a rank "
              f"fake_quant {d5['launches']['fake_quant']} flash simt "
              f"{d5['launches']['simt']}")
        check(d5["bytes"][0] + d5["batch_bytes"] == dry,
              f"{tag}: the placed state + batch rows "
              f"{d5['bytes'][0] + d5['batch_bytes']} bytes == the dry run's "
              f"argument bytes per device {dry}")
        check(p5 < p1, f"{tag}: the step's peak {p5} < (d1) (2, 1)'s {p1}")


def _scores_bytes(cfg, run: dict, mesh_shape: tuple) -> int:
    """The bytes that the plain attention (the dry run's, flash off) keeps
    for the backward of one tier's step on a rank of ``mesh_shape``: per
    layer the softmax's f32 output and the probabilities in the compute
    dtype, (rows a rank, local heads, T, T) each; the flash kernel keeps
    neither."""
    import torch
    dp, mp = mesh_shape
    rows = run["batch"] // 4 // dp
    item = 4 + getattr(torch, cfg.dtype).itemsize
    return (cfg.num_layers * rows * (cfg.num_heads // mp) * run["seq"] ** 2
            * item)


def _check_census(ranks: list, dry: dict) -> None:
    """(d2)'s and (d5)'s ranks against the dry run's per-device records of
    the same config and mesh: every step's counted collectives exactly
    the census (op by op, count and bytes), and argument + temp bytes
    within ``MESH_MEMORY_RTOL`` of the step's peak, the plain attention's
    saved scores beside the gap."""
    for tag, run, mesh_shape in (("d2", MESH_BF16, (1, MESH_RANKS)),
                                 ("d5", MESH_F32, (MESH_RANKS, 1))):
        rec = dry[tag]
        want = rec["collectives"]
        est = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
        scores = _scores_bytes(_mesh_cfg(None, "bfloat16" if tag == "d2"
                                         else "float32"), run, mesh_shape)
        for r, rk in enumerate(ranks):
            got = rk[tag]
            peaks = got["step_peaks"] if tag == "d2" else got["peak_bytes"]
            peak = max(peaks, default=0)
            name = f"mesh ({tag}) rank {r} mesh {mesh_shape}"
            print(f"{name}: collectives counted a step "
                  f"{json.dumps(got['census'])}; the dry run's census "
                  f"{json.dumps(want)}")
            check(len(got["census"]) == run["steps"]
                  and all(c == want for c in got["census"]),
                  f"{name}: each of the {run['steps']} steps' collectives "
                  f"== the dry run's per-device census, op by op in count "
                  f"and bytes")
            gap = est - peak
            print(f"{name}: dry-run argument + temp bytes per device {est} "
                  f"against the step peaks {peaks} "
                  f"({est / max(peak, 1):.4f} of the largest); the plain "
                  f"attention's saved scores, which the flash run keeps "
                  f"none of, {scores} bytes, {scores / (gap or 1):.4f} of "
                  f"the gap {gap}")
            check(abs(est - peak) <= MESH_MEMORY_RTOL * peak,
                  f"{name}: dry-run argument + per-device temp bytes {est} "
                  f"within {MESH_MEMORY_RTOL:.0%} of the rank's step peak "
                  f"max_memory_allocated {peak}")


def _flash_route(cfg) -> str:
    """The flash_attention route of ``cfg``'s attention: bf16 at hd 64 or
    128 on the tensor cores, else the CUDA cores."""
    return ("wgmma" if cfg.dtype == "bfloat16" and cfg.head_dim in (64, 128)
            else "simt")


def _check_ranks(one_rank: dict, f32s: list, bf16s: list,
                 tags: tuple) -> dict:
    """The checks of a (d) part against its one-rank runs (``tags``: its
    f32 and bf16 parts' names; bf16 None: no bf16 part); the ranks'
    launches."""
    from repro_torch.models.moe import _num_groups
    one, l1, cfg1 = one_rank["one"], one_rank["l1"], one_rank["cfg1"]
    launches = {"fake_quant": 0, "flash_attention_simt": 0,
                "flash_attention_wgmma": 0}
    calls1 = _attn_calls(cfg1) * 4 * MESH_F32["steps"]
    for r, (runs, run2) in enumerate(zip(f32s, bf16s)):
        for mesh, run in runs.items():
            tag_ = (f"mesh ({'d5' if run['fsdp'] else tags[0]}) rank {r} "
                    f"mesh {mesh}")
            a = run["losses"] + [x for t in run["tier_losses"] for x in t]
            b = one["losses"] + [x for t in one["tier_losses"] for x in t]
            check(all(math.isclose(x, y, rel_tol=1e-4) for x, y in zip(a, b)),
                  f"{tag_}: losses and tier losses {run['losses']} within "
                  f"rtol 1e-4 of one rank's {one['losses']}")
            check(run["m_share"] <= MESH_M_SHARE,
                  f"{tag_}: AdamW's first moment within {MESH_M_SHARE:g} of "
                  f"its leaf's largest of one rank's (max "
                  f"{run['m_share']:.3g})")
            flips = tags[0] in MESH_FLIP_PARTS
            check(run["max_param_diff"] <= 1e-5 and (
                run["flip_max_diff"] <= run["flip_bound"] if flips
                else run["flips"] == 0),
                  f"{tag_}: its params within atol 1e-5 of one rank's (max "
                  f"{run['max_param_diff']:.3g})"
                  + (f" but where AdamW's first moment flips sign below "
                     f"{MESH_M_SHARE:g} of its leaf's largest: "
                     f"{run['flips']} such params past 1e-5, max "
                     f"{run['flip_max_diff']:.3g} <= 2 lr "
                     f"{run['flip_bound']:.3g}; the largest (leaf, one-rank "
                     f"m / leaf max, ranks' m / leaf max, diff) "
                     f"{run['flip_worst']}" if flips
                     else f", every one ({run['flips']} sign flips past it)"))
            check(run["masks_bitwise"],
                  f"{tag_}: its {run['masks']} masks (2 densities x "
                  f"{run['masks'] // 2} leaves) bitwise the one-rank masks' "
                  f"blocks")
            check(run["launches"]["fake_quant"] == l1["fake_quant"],
                  f"{tag_}: fake_quant launched {run['launches']['fake_quant']}"
                  f" times, the one-rank count {l1['fake_quant']}")
            check(run["launches"]["simt"] == calls1
                  and l1["simt"] == calls1,
                  f"{tag_}: flash_attention launched {calls1} times on the "
                  f"simt kernel (its attention calls), as one rank")
            check(run["bytes"][0] == run["bytes"][1],
                  f"{tag_}: the placed state's bytes {run['bytes'][0]} == "
                  f"shard_bytes {run['bytes'][1]}")
            if run["fsdp"]:
                check(run["gathers"] > 0 and run["scatters"] > 0,
                      f"{tag_}: the FSDP leaves gathered over \"data\" "
                      f"({run['gathers']} all_gathers) and their gradients "
                      f"reduce-scattered ({run['scatters']})")
                launches["fake_quant"] += run["launches"]["fake_quant"]
                launches["flash_attention_simt"] += run["launches"]["simt"]
                continue
            want = (cfg1.num_layers * 4 * MESH_F32["steps"]
                    if cfg1.is_moe and run["data_ranks"] > 1 else 0)
            check(run["gathers"] == want,
                  f"{tag_}: {run['gathers']} all_gathers over \"data\" (one "
                  f"a MoE layer and tier over several data ranks: {want})")
            if want:
                tier = MESH_F32["batch"] // 4 * MESH_F32["seq"]
                ng = _num_groups(tier, 1)
                secs = sum(run["sec_per_step"])
                print(f"{tag_}: each tier's {tier} tokens in {ng} MoE "
                      f"group(s) of {tier // ng}, {tier // run['data_ranks']}"
                      f" tokens a data rank; the groups' choices all-gathered"
                      f" {run['gathers']} times, {run['gather_s'] * 1e3:.3f} "
                      f"ms of {secs * 1e3:.3f} ms of steps, share "
                      f"{run['gather_s'] / secs:.4f} (host clock, a device "
                      f"sync before and after each call)")
            launches["fake_quant"] += run["launches"]["fake_quant"]
            launches["flash_attention_simt"] += run["launches"]["simt"]
        if tags[1] is None:
            continue
        bf, cfg2, dist_bf = one_rank["bf"], one_rank["cfg2"], \
            one_rank["dist_bf"]
        tag_ = f"mesh ({tags[1]}) rank {r} mesh (1, {MESH_RANKS})"
        sps = statistics.mean(run2["sec_per_step"][1:])
        prof = ""
        if "wall_ms" in run2:
            prof = (f" profiled step: wall_ms {run2['wall_ms']:.3f} "
                    f"device_busy_ms {run2['busy_ms']:.3f} device_busy_share "
                    f"{run2['busy_ms'] / run2['wall_ms']:.4f} device_ops "
                    f"{run2['ops']}")
        if "moe_ms" in run2:
            prof += (f" moe_layer_ms {run2['moe_ms']:.3f} "
                     f"moe_layer_share_of_wall "
                     f"{run2['moe_ms'] / run2['wall_ms']:.4f}")
        print(f"{tag_}: bf16 losses {run2['losses']} sec_per_step "
              f"{run2['sec_per_step']} mean_sec_per_step(steps 2..) {sps:.6f} "
              f"tokens_per_s {MESH_BF16['batch'] * MESH_BF16['seq'] / sps:.3f}"
              f" peak_mem_gb {run2['peak_bytes'] / 1e9:.3f} launches "
              f"{json.dumps(run2['launches'])}{prof}")
        gap = max(abs(x - y) for x, y in zip(run2["losses"], bf["losses"]))
        check(gap <= MESH_BF16_SLACK * dist_bf,
              f"{tag_}: losses within {MESH_BF16_SLACK} x the one-rank bf16-f32"
              f" distance {dist_bf:.6g} of one rank's bf16 (max {gap:.6g}; "
              f"the two ranks' bf16 sums round once, as the reference's "
              f"sharded bf16 step's f32 sums do, "
              f"tests/test_torch_parallel_bf16.py)")
        calls2 = _attn_calls(cfg2) * 4 * MESH_BF16["steps"]
        route = _flash_route(cfg2)
        l2 = one_rank["l2"]
        check(run2["launches"][route] == calls2 == l2[route]
              and run2["launches"]["fake_quant"] == l2["fake_quant"]
              == 3 * _n_compressible(cfg2) * MESH_BF16["steps"],
              f"{tag_}: flash_attention {calls2} launches on the {route} "
              f"kernel at the local heads (hd {cfg2.head_dim}), fake_quant "
              f"{3 * _n_compressible(cfg2)} a step: the one-rank counts")
        launches["fake_quant"] += run2["launches"]["fake_quant"]
        launches[f"flash_attention_{route}"] += run2["launches"][route]
    return launches


def mesh_rank(rank: int, directory: str, port: int, world: int) -> int:
    """One rank of phase mesh's (d), in a process of its own: joins the
    gloo group of ``world`` ranks on ``port``; of ``MESH_RANKS``, runs
    each part of :data:`MESH_PARTS` through ``launch.train`` (its f32
    part on its meshes, its bf16 part on (1, 2)), then (d6), of
    ``MESH_ROWS_RANKS`` (d7) alone (:func:`_mesh_serve_rank`); and writes
    its results to ``directory/w{world}_rank{rank}.json``. Of
    ``MESH_ROWS_RANKS``, it starts beside (d)'s ranks and waits for
    ``directory/d7.go`` before it works."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    device = init_distributed("cuda")           # one card for all: gloo
    print(f"rank {rank}: backend {dist.get_backend()} device {device}")
    out = {}
    result = Path(directory) / f"w{world}_rank{rank}.json"
    if world == MESH_ROWS_RANKS:
        go = Path(directory) / "d7.go"
        while not go.exists():      # (d)'s ranks run until it is written
            time.sleep(0.2)
        out["d7"] = _mesh_serve_rank(device, Path(directory), "d7")
        result.write_text(json.dumps(out))
        dist.destroy_process_group()
        return 0
    for f32_key, bf16_key, arch, layers, mps in MESH_PARTS:
        t0 = time.perf_counter()
        out[f32_key] = {}
        cfg = _mesh_cfg(layers, "float32", arch)
        for mp in mps:
            run = _mesh_f32_rank(mp, device, Path(directory), cfg)
            out[f32_key][f"({MESH_RANKS // mp}, {mp})"] = run
            torch.cuda.empty_cache()
        if f32_key == "d1":         # (d5): (d1)'s run, FSDP-placed
            t5 = time.perf_counter()
            out["d5"] = _mesh_f32_rank(1, device, Path(directory), cfg,
                                       fsdp=True)
            torch.cuda.empty_cache()
            print(f"rank {rank}: part d5: {time.perf_counter() - t5:.1f} s",
                  flush=True)
        if bf16_key is not None:
            out[bf16_key] = _mesh_bf16_rank(
                device, _mesh_cfg(layers, "bfloat16", arch),
                profiled=arch == MOE_ARCH)
            torch.cuda.empty_cache()
        print(f"rank {rank}: part {f32_key}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    out["d6"] = _mesh_serve_rank(device, Path(directory), "d6")
    result.write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def _mesh_f32_rank(mp: int, device, directory: Path, cfg,
                   fsdp: bool = False) -> dict:
    """A (d) f32 run on the (MESH_RANKS / mp, mp) mesh (``fsdp``: the
    train state split over "data" too, part (d5)): its losses, s/step,
    each step's peak, launches, the data axis's collectives, its params
    and first moment against one rank's; at init the masks of the two
    pruned tiers against the one-rank masks' blocks, the placed state's
    bytes beside ``shard_bytes``, and the batch rows this rank takes."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.compression import compressible, magnitude_masks
    from repro_torch.core.steps import TrainState, _data_rows
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.models import get_model, parallel
    from repro_torch.models.sharding import place, shard_bytes
    with _DataGathers() as gathers:
        res, launches = _mesh_train(cfg, MESH_F32, 20, device,
                                    model_parallel=mp, fsdp=fsdp)
    sh = res["shardings"]
    diffs = _against_one_rank(res["state"], sh["params"],
                              directory / f"one_rank_f32_{cfg.name}.pt",
                              device)
    del res["state"]
    # at init: the masks of the two pruned tiers' densities, and the bytes
    model = get_model(cfg)
    state = TrainState.create(model, optim.adamw(3e-4), 0, device=device)
    placed = place(state, sh)
    local = sum(t.numel() * t.element_size() for t in _tensors(placed))
    ok, n = True, 0
    names = [k for k, w in state["params"].items() if compressible(k, w)]
    for density in (0.5, 0.25):
        whole = magnitude_masks({k: state["params"][k] for k in names},
                                density)
        split = magnitude_masks({k: placed["params"][k] for k in names},
                                density, shardings=sh["params"])
        for k in names:
            ok &= torch.equal(split[k], sh["params"][k].block(whole[k]))
            n += 1
        del whole, split
    batch = make_train_batch(cfg, ShapeConfig("cli", MESH_F32["seq"],
                                              MESH_F32["batch"], "train"),
                             n_tiers=4, seed=0, index=0)
    with parallel.using(next(iter(sh["params"].values())).mesh):
        rows = _data_rows(batch)
    return {"losses": res["losses"], "tier_losses": res["tier_losses"],
            "sec_per_step": res["sec_per_step"],
            "peak_bytes": res["peak_bytes"], "launches": launches,
            "census": res["census"],
            "fsdp": fsdp, "data_ranks": MESH_RANKS // mp,
            "gathers": gathers.calls, "gather_s": gathers.seconds,
            "scatters": gathers.scatters, "scatter_s": gathers.scatter_s,
            **diffs, "masks_bitwise": bool(ok), "masks": n,
            "bytes": [local, shard_bytes(state, sh)],
            "batch_bytes": sum(t.numel() * t.element_size()
                               for t in rows.values())}


# (d)'s f32 bars past the losses. AdamW's first moment m is linear in the
# summed gradients (its update is not: a gradient off by a factor moves no
# param), so m is held within this share of its leaf's largest one-rank
# |m|: sound runs read at most 8.94e-05 (xLSTM), a gradient summed once
# too few or too many times reads a share of order 1. The params are held
# within atol 1e-5 of one rank's. In (d4) alone an element may pass 1e-5
# where the ranks' m and the one-rank m differ in sign and the one-rank
# |m| is at most this share of its leaf's largest: there the gradient is
# at the f32 noise of the ranks' other summation order, and AdamW's step
# (lr 0 at step 0, so only step 1's, each of size up to lr) moves the two
# runs apart by up to 2 lr. Such elements are counted and printed.
MESH_M_SHARE = 1e-3
MESH_FLIP_PARTS = ("d4 zamba", "d4 whisper", "d4 xlstm")


def _against_one_rank(state: dict, sh: dict, path: Path, device) -> dict:
    """This rank's blocks of the params and of AdamW's first moment after a
    (d) f32 run against the same blocks of the one-rank run's (saved at
    ``path``): the largest first-moment difference as a share of its
    leaf's largest one-rank |m|; the largest param difference outside
    the sign flips below :data:`MESH_M_SHARE`, and of those flips the
    count past 1e-5, their largest difference with its bound 2 lr, and
    the largest few as (leaf, one-rank m / its leaf's largest, this
    run's m / the same, param difference)."""
    import torch
    from repro_torch import optim
    one = torch.load(path, map_location="cpu", mmap=True)
    lr = float(optim.warmup_cosine(3e-4, 20, MESH_F32["steps"])(
        MESH_F32["steps"] - 1))
    out = {"max_param_diff": 0.0, "flips": 0, "flip_max_diff": 0.0,
           "flip_bound": 2 * lr, "m_share": 0.0, "flip_worst": []}
    for k, p in state["params"].items():
        p1 = sh[k].block(one["params"][k]).to(device)
        m1 = sh[k].block(one["m"][k]).to(device)
        m = state["opt"]["m"][k]
        scale = one["m"][k].abs().max().item()
        dp = (p - p1).abs()
        flip = (m1.abs() <= MESH_M_SHARE * scale) \
            & (torch.sign(m) != torch.sign(m1)) & (dp > 1e-5)
        out["max_param_diff"] = max(out["max_param_diff"], dp.masked_fill(
            flip, 0).max().item())
        if flip.any():
            out["flips"] += int(flip.sum())
            d = dp.masked_fill(~flip, 0).flatten()
            out["flip_max_diff"] = max(out["flip_max_diff"], d.max().item())
            for i in d.topk(min(3, int(flip.sum()))).indices.tolist():
                out["flip_worst"].append(
                    (k, m1.flatten()[i].item() / scale,
                     m.flatten()[i].item() / scale, d[i].item()))
        dm = (m - m1).abs().max().item()
        out["m_share"] = max(out["m_share"], dm / scale if scale else dm)
    out["flip_worst"] = sorted(out["flip_worst"], key=lambda w: -w[3])[:5]
    return out


class _DataGathers:
    """The calls of ``parallel.all_gather`` (``calls``, ``seconds``) and
    of ``parallel.reduce_scatter`` (``scatters``, ``scatter_s``) over
    "data" (alone or among the data axes) within a window and their seconds on the host clock, each call
    between two device syncs (the syncs' own cost falls outside): on a
    data-parallel mesh the MoE layer's gather of its groups' expert
    choices, the one such gather of a train step; with the FSDP layout
    (d5) every leaf's gathers, forward and backward, and its gradient's
    reduce-scatter."""

    def __enter__(self):
        import torch
        from repro_torch.models import parallel
        self.calls, self.seconds = 0, 0.0
        self.scatters, self.scatter_s = 0, 0.0
        inner = (parallel.all_gather, parallel.reduce_scatter)

        def timed(fn, counts):
            def call(x, axis, dim, mesh=None):
                if "data" not in ((axis,) if isinstance(axis, str)
                                  else axis):
                    return fn(x, axis, dim, mesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(x, axis, dim, mesh)
                torch.cuda.synchronize()
                counts(time.perf_counter() - t0)
                return out
            return call

        def gathered(s):
            self.calls += 1
            self.seconds += s

        def scattered(s):
            self.scatters += 1
            self.scatter_s += s

        self._restore = (parallel, inner)
        parallel.all_gather = timed(inner[0], gathered)
        parallel.reduce_scatter = timed(inner[1], scattered)
        return self

    def __exit__(self, *exc):
        parallel, inner = self._restore
        parallel.all_gather, parallel.reduce_scatter = inner


class _MoeSpans:
    """The stream time of each MoE layer's forward and backward within a
    window (CUDA events: the layer's first op to its last, the model
    ranks' collectives inside it included), by wrapping
    ``decoder.moe_apply``; ``ms()`` their sum."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        import torch
        from repro_torch.models import decoder
        spans, inner = self.spans, decoder.moe_apply

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        class Mark(torch.autograd.Function):
            """Identity; its backward records an event (``begin``: the
            output's gradient arrives, else the input's leaves)."""
            @staticmethod
            def forward(ctx, x, span, begin):
                ctx.span, ctx.begin = span, begin
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                ctx.span[0 if ctx.begin else 1] = event()
                return g, None, None

        def timed(p, x, *a, **k):
            fwd, bwd = [event(), None], [None, None]
            y, aux = inner(p, Mark.apply(x, bwd, False), *a, **k)
            fwd[1] = event()
            spans.extend([fwd, bwd])
            return Mark.apply(y, bwd, True), aux

        self._restore = (decoder, inner)
        decoder.moe_apply = timed
        return self

    def __exit__(self, *exc):
        decoder, inner = self._restore
        decoder.moe_apply = inner

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans
                   if a is not None and b is not None)


def _mesh_bf16_rank(device, cfg, profiled: bool) -> dict:
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.configs import ShapeConfig
    from repro_torch.core.compression import default_tier_plans
    from repro_torch.core.steps import make_hetero_train_step
    from repro_torch.data.synthetic import make_train_batch
    from repro_torch.launch.mesh import num_batch_shards
    from repro_torch.models import get_model, parallel
    run = MESH_BF16
    torch.cuda.reset_peak_memory_stats()
    res, launches = _mesh_train(cfg, run, 2, device,
                                model_parallel=MESH_RANKS)
    peak = torch.cuda.max_memory_allocated()
    out = {"losses": res["losses"], "sec_per_step": res["sec_per_step"],
           "launches": launches, "peak_bytes": peak,
           "step_peaks": res["peak_bytes"], "census": res["census"]}
    if not profiled:
        return out
    # one more step, profiled (not counted on the main path)
    sh = res["shardings"]["params"]
    mesh = next(iter(sh.values())).mesh
    steps = run["steps"]
    step = make_hetero_train_step(
        get_model(cfg), optim.adamw(optim.warmup_cosine(3e-4, 2, steps)),
        default_tier_plans(4), num_groups=num_batch_shards(mesh),
        shardings=sh)
    b = make_train_batch(cfg, ShapeConfig("t", run["seq"], run["batch"],
                                          "train"),
                         n_tiers=4, seed=0, index=steps)
    b = {k: v.to(device) for k, v in b.items()}
    spans = _MoeSpans() if cfg.is_moe else contextlib.nullcontext()
    torch.cuda.synchronize()
    with parallel.using(mesh), spans:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(res["state"], b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    ev = device_events(prof)
    out.update(wall_ms=wall, busy_ms=sum(us for _, us in ev) / 1e3,
               ops=len(ev))
    if cfg.is_moe:
        out["moe_ms"] = spans.ms()
    return out


# (d6): prefill and decode over the same two ranks on (1, 2), each rank
# its blocks of the deployed params (the tier's compression of the whole
# params, then placed) and of the cache as cache_spec_tree places it:
# (tag, arch, layers (None: whole), dtype, the f32 runs' bar against one
# rank). A number is an atol beside rtol MESH_SERVE_RTOL; "f64" holds the
# ranks' logits and each cache leaf within MESH_F64_SLACK x the one-rank
# f32 run's own distance from its f64 twin on the same deployed params
# (Zamba: six Mamba2 layers' f32 rounding exceeds a fixed 1e-5 at full
# width; (d2)'s argument with f64 for f32 and f32 for bf16).
MESH_SERVE = (("d6 llama", LM_ARCH, 2, "float32", 1e-5),
              ("d6 zamba", ZAMBA, 6, "float32", "f64"),  # one application
              ("d6 llama whole", LM_ARCH, None, "bfloat16", None))
MESH_F64_SLACK = 3.0
MESH_SERVE_TIER = "mid"
MESH_SERVE_BATCH, MESH_SERVE_PROMPT = 4, 64
MESH_SERVE_GEN = 8                  # decode steps after the prefill
MESH_SERVE_RTOL = 1e-4
# (d7): where the heads do not split over the ranks, the prefill's
# attention on each rank's query rows (whisper-tiny's 6 heads; its q, k
# and v on head_dim) and xLSTM's mLSTM on each rank's block of dk (its 4
# heads; mC and mn on dk) over MESH_ROWS_RANKS gloo ranks on the card,
# (1, 8): no model takes either path at 2 ranks. Each run as (d6) runs
# it, at (d6)'s bars; xLSTM's prompt is three mLSTM chunks.
MESH_ROWS_RANKS = 8
MESH_ROWS = (("d7 whisper", WHISPER, None, "float32", 1e-5),
             ("d7 xlstm", XLSTM, 8, "float32", "f64"))   # one superblock
MESH_SERVE_PROMPTS = {"d7 xlstm": 3 * 256}
# the serve parts of phase mesh: part -> (its runs, its model ranks)
SERVE_PARTS = {"d6": (MESH_SERVE, MESH_RANKS),
               "d7": (MESH_ROWS, MESH_ROWS_RANKS)}


def _serve_cfg(arch: str, layers, dtype: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(dtype=dtype)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def _prompt(tag: str) -> int:
    return MESH_SERVE_PROMPTS.get(tag, MESH_SERVE_PROMPT)


def _serve_shapes(prompt: int):
    from repro_torch.configs import ShapeConfig
    return (ShapeConfig("p", prompt, MESH_SERVE_BATCH, "prefill"),
            ShapeConfig("d", prompt, MESH_SERVE_BATCH, "decode"))


def _deploy(cfg, device) -> tuple[dict, int]:
    """``cfg``'s params from seed 0 on ``device``, compressed for
    ``MESH_SERVE_TIER`` on the whole leaves (``compress_for_serving``),
    the compressible leaves then held in the compute dtype, as the dry
    run's ``_deployed_params`` holds them; and the fake_quant launches
    the compression made."""
    import torch
    from repro_torch.core.compression import DEVICE_TIERS, compressible
    from repro_torch.core.steps import compress_for_serving
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import get_model
    params = get_model(cfg).init(0, device=device)
    fake_quant.launches = 0
    cp = compress_for_serving(params, DEVICE_TIERS[MESH_SERVE_TIER])
    launches = fake_quant.launches
    del params
    dt = getattr(torch, cfg.dtype)
    return {k: v.to(dt) if compressible(k, v) else v
            for k, v in cp.items()}, launches


def _serve_run(cfg, params, device, mesh=None,
               t: int = MESH_SERVE_PROMPT) -> dict:
    """``launch.specs``' prefill step on a seeded 4 x ``t`` prompt (with
    seeded frames for audio), then ``MESH_SERVE_GEN`` decode steps on
    seeded tokens (positions t...: the ring of t slots wraps), on one
    device, or with ``mesh`` on this rank's blocks (``params`` placed
    already), each call's collectives counted: the logits, the cache
    after the last step (on the host), the censuses, the prefill's
    seconds and peak, the decode's tokens/s and the run's peak."""
    import torch
    from repro_torch.core.steps import make_prefill_step, make_serve_step
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import get_model, parallel
    b = MESH_SERVE_BATCH
    model = get_model(cfg)
    batch = {"tokens": TokenStream(cfg.vocab_size, b, t, seed=0).batch_at(
        0)["tokens"][:, :t].to(device)}
    gen = torch.Generator(device=device).manual_seed(1)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=gen, device=device,
            dtype=torch.float32).to(getattr(torch, cfg.dtype))
    toks = [torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                          device=device, dtype=torch.int32)
            for _ in range(MESH_SERVE_GEN)]
    prefill, decode = make_prefill_step(model), make_serve_step(model)
    out = {"logits": [], "census": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["allocated_bytes"] = torch.cuda.memory_allocated()
    with parallel.using(mesh):
        t0 = time.perf_counter()
        with parallel.counting() as c:
            logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["logits"].append(_wide(logits).cpu())
        out["census"].append(c.record())
        t0 = time.perf_counter()
        for i, tok in enumerate(toks):
            with parallel.counting() as c:
                logits, cache = decode(params, cache, tok, t + i)
            out["logits"].append(_wide(logits).cpu())
            out["census"].append(c.record())
        torch.cuda.synchronize()
    out["decode_tokens_per_s"] = MESH_SERVE_GEN * b / (time.perf_counter()
                                                       - t0)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["cache"] = _to_host(cache)
    return out


def _wide(x):
    """``x`` in f32, or in its own dtype where that is wider (f64)."""
    import torch
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _to_host(tree):
    return ({k: _to_host(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.cpu())


DIGEST_CHUNK = 1 << 24


def _digests(tree: dict) -> dict:
    """name -> a position-weighted digest of each leaf's bit patterns:
    sum_i bits[i] * (2 i + 1) modulo 2**64 (int64 sums wrap, exactly, in
    any order), so that a permutation or offsetting changes of elements
    show, unlike a plain sum. Chunked, to bound the index's memory."""
    import torch
    out = {}
    for k, v in tree.items():
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[v.element_size()]
        flat = v.contiguous().view(ints).reshape(-1)
        h = 0
        for lo in range(0, flat.numel(), DIGEST_CHUNK):
            x = flat[lo:lo + DIGEST_CHUNK].to(torch.int64)
            i = torch.arange(lo, lo + x.numel(), device=x.device,
                             dtype=torch.int64)
            h += int((x * (2 * i + 1)).sum())
        out[k] = h % (1 << 64)
    return out


def _serve_one_rank(device, d: Path, part: str) -> dict:
    """A serve part's ((d6), (d7): :data:`SERVE_PARTS`) one-rank runs,
    here, before the ranks start: each of its runs deployed and served on
    the card (its logits and cache saved to ``d`` for the ranks), the
    deployed leaves' blocks' digests for each rank of (1, M), its
    fake_quant launches; for the bf16 run also its f32 twin, whose logits
    give the bar, and for a run of bar "f64" its f64 twin on the same
    deployed params, whose distances (logits, each cache leaf) give the
    bars."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh, census_mesh
    from repro_torch.models.sharding import named, param_spec_tree
    runs, m = SERVE_PARTS[part]
    slots = np.empty((1, m), dtype=object)
    slots.fill(torch.device("meta"))
    out = {}
    for tag, arch, layers, dtype, atol in runs:
        t0 = time.perf_counter()
        cfg = _serve_cfg(arch, layers, dtype)
        t = _prompt(tag)
        params, launches = _deploy(cfg, device)
        specs = param_spec_tree(params, m)
        digests = []
        for r in range(m):
            sh = named(census_mesh(Mesh(slots, ("data", "model")), r), specs)
            digests.append(_digests({k: sh[k].block(v)
                                     for k, v in params.items()}))
        run = _serve_run(cfg, params, device, t=t)
        rec = {"launches": launches, "digests": digests,
               "prefill_s": run["prefill_s"],
               "decode_tokens_per_s": run["decode_tokens_per_s"],
               "peak_bytes": run["peak_bytes"]}
        if atol == "f64":           # the same deployed params, in f64
            f64 = _serve_run(cfg.replace(dtype="float64"), params, device,
                             t=t)
            rec["f32_f64"] = _distances(run, f64)
        del params
        torch.cuda.empty_cache()
        if dtype == "bfloat16":
            twin, _ = _deploy(cfg.replace(dtype="float32"), device)
            f32 = _serve_run(cfg.replace(dtype="float32"), twin, device,
                             t=t)
            del twin
            torch.cuda.empty_cache()
            rec["bf16_f32"] = max((a - b).abs().max().item() for a, b in
                                  zip(run["logits"], f32["logits"]))
        torch.save({"logits": run["logits"], "cache": run["cache"]},
                   d / f"serve_{tag.replace(' ', '_')}.pt")
        out[tag] = rec
        print(f"mesh ({tag}): one rank: {cfg.name} {cfg.num_layers} layers "
              f"{dtype} tier {MESH_SERVE_TIER} prefill {MESH_SERVE_BATCH} x "
              f"{t} + {MESH_SERVE_GEN} decode steps: "
              f"prefill_s {run['prefill_s']:.6f} decode_tokens_per_s "
              f"{run['decode_tokens_per_s']:.3f} peak_bytes "
              f"{run['peak_bytes']} fake_quant {launches}"
              + (f" bf16-vs-f32 logits {rec['bf16_f32']:.6g}"
                 if "bf16_f32" in rec else "")
              + (f" f32-vs-f64 (logits, cache leaves) "
                 f"{json.dumps(rec['f32_f64'])}" if "f32_f64" in rec else "")
              + f" ({time.perf_counter() - t0:.1f} s)")
    return out


def _distances(run: dict, ref: dict) -> dict:
    """The max abs distance of ``run``'s logits (over the prefill and
    every decode step) and of each leaf of its final cache from
    ``ref``'s, both on the host."""
    from repro_torch.checkpoint.checkpointer import named_leaves
    return {"logits": max((a - b).abs().max().item()
                          for a, b in zip(run["logits"], ref["logits"])),
            "cache": {n: (_wide(x) - _wide(w)).abs().max().item()
                      for (n, x), (_, w) in zip(
                          named_leaves(run["cache"]),
                          named_leaves(ref["cache"]))
                      if not n.endswith("slot_pos")}}


def _serve_dry_runs(part: str) -> dict:
    """The dry run's per-device figures of each run of a serve part's
    prefill and decode step on an abstract (1, M) mesh: argument bytes
    (the setups' shardings) and rank 0's trace (its temp bytes and
    collectives)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.specs import rank_traced, setup_for
    from repro_torch.models.sharding import shard_bytes
    runs, m = SERVE_PARTS[part]
    slots = np.empty((1, m), dtype=object)
    slots.fill(torch.device("meta"))
    mesh = Mesh(slots, ("data", "model"))
    out = {}
    for tag, arch, layers, dtype, atol in runs:
        cfg = _serve_cfg(arch, layers, dtype)
        t0 = time.perf_counter()
        for shape in _serve_shapes(_prompt(tag)):
            _, args, in_sh, _ = setup_for(cfg, shape, mesh)
            counts, _, rank_s = rank_traced(cfg, shape, mesh)
            rec = out[f"{tag} {shape.mode}"] = {
                "argument_size_in_bytes": shard_bytes(args, in_sh),
                "temp_size_in_bytes": counts["temp_bytes"],
                "collectives": counts["collectives"]}
            print(f"mesh ({tag}): dry run {cfg.name} {cfg.num_layers} "
                  f"layers {dtype} {shape.mode} {shape.global_batch} x "
                  f"{shape.seq_len} on an abstract {dict(mesh.shape)} "
                  f"mesh (rank_trace_s {rank_s}), per device: "
                  f"{json.dumps(rec)}")
        print(f"mesh ({tag}): dry runs {time.perf_counter() - t0:.1f} s")
    return out


def _mesh_serve_rank(device, directory: Path, part: str) -> dict:
    """A serve part ((d6), (d7)) on this rank, (1, M): each of its runs
    deployed (the whole params compressed, then placed; the ranks in
    turns, so that one rank's whole params are on the card at a time),
    served on the
    rank's blocks, and held against the one-rank run's logits and its
    cache's blocks (``cache_spec_tree``) saved in ``directory``."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint.checkpointer import named_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import _batch_spec
    from repro_torch.models.sharding import (cache_spec_tree, named,
                                             param_spec_tree, place)
    runs, m = SERVE_PARTS[part]
    mesh = make_host_mesh(m, devices=[device])
    out = {}
    for tag, arch, layers, dtype, atol in runs:
        t0 = time.perf_counter()
        cfg = _serve_cfg(arch, layers, dtype)
        for r in range(m):              # in turns: the whole params of
            if dist.get_rank() == r:    # two ranks do not fit one card
                whole, launches = _deploy(cfg, device)
                params = place(whole, named(mesh, param_spec_tree(
                    whole, m)))
                del whole
                torch.cuda.empty_cache()
            dist.barrier()
        digests = _digests(params)
        run = _serve_run(cfg, params, device, mesh, _prompt(tag))
        del params
        torch.cuda.empty_cache()
        one = torch.load(directory / f"serve_{tag.replace(' ', '_')}.pt")
        csh = named(mesh, cache_spec_tree(
            one["cache"], _batch_spec(mesh, MESH_SERVE_BATCH), m))
        logit_err = [(a - b).abs().max().item()
                     for a, b in zip(run["logits"], one["logits"])]
        atol = atol if isinstance(atol, float) else 0.0
        logits_close = all(torch.allclose(a, b, rtol=MESH_SERVE_RTOL,
                                          atol=atol)
                           for a, b in zip(run["logits"], one["logits"]))
        cache_err, cache_close, slots_exact = {}, True, True
        for (name, x), (_, sh), (_, w) in zip(
                named_leaves(run["cache"]), named_leaves(csh),
                named_leaves(one["cache"])):
            w = sh.block(w)
            if name.endswith("slot_pos"):
                slots_exact &= torch.equal(x, w)
                continue
            x, w = x.float(), w.float()
            cache_err[name] = [(x - w).abs().max().item(),
                               w.abs().max().item()]
            cache_close &= torch.allclose(x, w, rtol=MESH_SERVE_RTOL,
                                          atol=atol)
        out[tag] = {"launches": launches, "digests": digests,
                    "census": run["census"], "logit_err": logit_err,
                    "logits_close": logits_close, "cache_err": cache_err,
                    "cache_close": bool(cache_close),
                    "slots_exact": bool(slots_exact),
                    "cache_shapes": [list(x.shape) for _, x in
                                     named_leaves(run["cache"])],
                    **{k: run[k] for k in (
                        "prefill_s", "decode_tokens_per_s", "peak_bytes",
                        "prefill_peak_bytes", "allocated_bytes")}}
        print(f"part {tag}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _check_serve(ranks: list, one_rank: dict, dry: dict, part: str) -> None:
    """A serve part's bars ((d6), (d7)): each rank's deployed blocks
    bitwise the one-rank
    deployed leaves' blocks (position-weighted digests), its fake_quant
    launches the one-rank count; the f32 runs' logits within
    ``MESH_SERVE_RTOL`` and the run's atol of one rank's and its cache of
    the one-rank cache's block, or (bar "f64") within ``MESH_F64_SLACK``
    x the one-rank run's distance from its f64 twin, logits and each
    cache leaf; ``slot_pos`` exact; the bf16 run's logits within ``MESH_BF16_SLACK`` x the
    one-rank bf16-vs-f32 distance; every call's collectives the dry
    run's census exactly; argument + temp bytes of the prefill within
    ``MESH_MEMORY_RTOL`` of the rank's peak over it. Each rank's
    figures are printed beside the card's name and power limit."""
    runs, m = SERVE_PARTS[part]
    for tag, arch, layers, dtype, atol in runs:
        one = one_rank[tag]
        for r, rk in enumerate(ranks):
            got = rk[part][tag]
            name = f"mesh ({tag}) rank {r} mesh (1, {m})"
            print(f"{name} on {CARD}: prefill_s {got['prefill_s']:.6f} "
                  f"decode_tokens_"
                  f"per_s {got['decode_tokens_per_s']:.3f} peak_bytes "
                  f"{got['peak_bytes']} (one rank: prefill_s "
                  f"{one['prefill_s']:.6f} decode_tokens_per_s "
                  f"{one['decode_tokens_per_s']:.3f} peak_bytes "
                  f"{one['peak_bytes']}); logits max_abs_err "
                  f"{max(got['logit_err']):.6g}; the cache's blocks "
                  f"{got['cache_shapes']}, (max_abs_err, max|one rank|) "
                  f"per leaf {json.dumps(got['cache_err'])}")
            check(got["digests"] == one["digests"][r],
                  f"{name}: the placed params' position-weighted digests "
                  f"equal the one-rank deployed leaves' blocks' "
                  f"({len(got['digests'])} leaves)")
            check(got["launches"] == one["launches"],
                  f"{name}: fake_quant launched {got['launches']} times "
                  f"deploying the tier, the one-rank count "
                  f"{one['launches']}")
            if atol == "f64":
                ref = one["f32_f64"]
                bar = MESH_F64_SLACK * ref["logits"]
                check(max(got["logit_err"]) <= bar,
                      f"{name}: the prefill's and {MESH_SERVE_GEN} decode "
                      f"steps' logits within {MESH_F64_SLACK} x the one-rank "
                      f"f32-vs-f64 distance {ref['logits']:.6g} (max "
                      f"{max(got['logit_err']):.6g})")
                far = {n: (e, ref["cache"][n]) for n, (e, _) in
                       got["cache_err"].items()
                       if e > MESH_F64_SLACK * ref["cache"][n]}
                check(not far and got["slots_exact"],
                      f"{name}: each cache leaf after the last step within "
                      f"{MESH_F64_SLACK} x its one-rank f32-vs-f64 distance "
                      f"of the one-rank cache's block (beyond: "
                      f"{json.dumps(far)}), slot_pos exact")
            elif dtype == "float32":
                check(got["logits_close"],
                      f"{name}: the prefill's and {MESH_SERVE_GEN} decode "
                      f"steps' logits within rtol {MESH_SERVE_RTOL} / atol "
                      f"{atol} of one rank's (max "
                      f"{max(got['logit_err']):.3g})")
                check(got["cache_close"] and got["slots_exact"],
                      f"{name}: the cache after the last step within the "
                      f"same bar of the one-rank cache's block (max "
                      f"{max(e for e, _ in got['cache_err'].values()):.3g})"
                      f", slot_pos exact")
            else:
                bar = MESH_BF16_SLACK * one["bf16_f32"]
                check(max(got["logit_err"]) <= bar and got["slots_exact"],
                      f"{name}: logits within {MESH_BF16_SLACK} x the "
                      f"one-rank bf16-vs-f32 distance {one['bf16_f32']:.6g} "
                      f"(max {max(got['logit_err']):.6g}), slot_pos exact")
            want = [dry[f"{tag} prefill"]["collectives"]] + [
                dry[f"{tag} decode"]["collectives"]] * MESH_SERVE_GEN
            print(f"{name}: collectives counted, prefill "
                  f"{json.dumps(got['census'][0])}, a decode step "
                  f"{json.dumps(got['census'][1])}")
            check(got["census"] == want,
                  f"{name}: the prefill's and each decode step's collectives "
                  f"== the dry run's per-device census, op by op in count "
                  f"and bytes")
            rec = dry[f"{tag} prefill"]
            est = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
            peak = got["prefill_peak_bytes"]
            print(f"{name}: dry-run argument + temp bytes per device {est} "
                  f"against the prefill's peak {peak} ({est / peak:.4f}; "
                  f"allocated before it {got['allocated_bytes']})")
            check(abs(est - peak) <= MESH_MEMORY_RTOL * peak,
                  f"{name}: dry-run argument + per-device temp bytes {est} "
                  f"within {MESH_MEMORY_RTOL:.0%} of the rank's "
                  f"max_memory_allocated over the prefill {peak}")


# ---------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", action="append", default=[],
                    help="run only this phase (repeatable)")
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)   # phase mesh (d) starts these
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=MESH_RANKS,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = args.phase
    # before CUDA starts: deterministic cuBLAS, so the bitwise checks test
    # the aggregation and not GEMM reduction order
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.mesh_rank is not None:
        return mesh_rank(args.mesh_rank, args.mesh_dir, args.mesh_port,
                         args.mesh_world)
    global CARD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    CARD = (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi: {smi.stderr.strip()}")
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name in build.SOURCES:
        entry = ""
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                # the kernel's (mangled) name and template arguments:
                # Lb1E true, Lb0E false, Li128E 128, 13__nv_bfloat16 bf16
                mangled = line.split("'")[1]
                at = mangled.find(f"{name}_kernel")
                entry = mangled[at:at + 56] if at >= 0 else mangled[-56:]
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {entry}: {line.strip()}")

    device = torch.device("cuda")
    clean_ms: dict = {}                 # the clean FL runs' ms per round
    out = {}
    phases = [("kernels", lambda: phase_kernels(device)),
              ("lm kernels", lambda: phase_lm_kernels(device)),
              ("matmul kernels", lambda: phase_matmul_kernels(device)),
              ("slice", lambda: phase_slice(device, clean_ms)),
              ("examples", lambda: phase_examples(device)),
              ("async", lambda: phase_async(device, clean_ms)),
              ("faults", lambda: phase_faults(device, clean_ms)),
              ("checkpoint", lambda: phase_checkpoint(device, out["faults"])),
              ("topology", lambda: phase_topology(device, clean_ms)),
              ("serve", lambda: phase_serve(device)),
              ("train", lambda: phase_train(device)),
              ("moe serve", lambda: phase_moe_serve(device)),
              ("moe train", lambda: phase_moe_train(device)),
              ("recurrent serve", lambda: phase_recurrent_serve(device)),
              ("recurrent train", lambda: phase_recurrent_train(device)),
              ("audio serve", lambda: phase_audio_serve(device)),
              ("audio train", lambda: phase_audio_train(device)),
              ("mesh", lambda: phase_mesh(device))]
    if only:
        unknown = sorted(set(only) - {name for name, _ in phases})
        if unknown:
            print(f"chip_smoke.py: no phase {unknown}", file=sys.stderr)
            return 2
        phases = [(name, run) for name, run in phases if name in only]
    try:
        for name, run in phases:
            t_phase = time.perf_counter()
            out[name] = run()
            print(f"phase {name}: {time.perf_counter() - t_phase:.1f} s")
    except CheckFailed as e:
        print(f"CHECK FAILED: {e}", file=sys.stderr)
        return 1
    if only:
        return 0
    rows = {**out["kernels"], **out["lm kernels"], **out["matmul kernels"][0]}
    # each main path's launches, its counters zeroed just before it
    launches = dict(out["slice"])
    flt, ckpt = out["faults"]["launches"], out["checkpoint"]
    # the examples aggregate sequentially (engines eager and scan), so
    # their fleet_aggregate count is whatever launched, 0 as they stand
    launches["grad_aggregate"] += (flt["grad_aggregate"]
                                   + ckpt["grad_aggregate"]
                                   + out["examples"]["fleet_aggregate"])
    launches["structured_scatter"] += flt["structured_scatter"]
    launches["fake_quant"] += (out["examples"]["fake_quant"] + out["async"]
                               + out["serve"]
                               + out["train"]["fake_quant"]
                               + flt["fake_quant"] + ckpt["fake_quant"]
                               + out["topology"]["fake_quant"]
                               + out["moe serve"]
                               + out["moe train"]["fake_quant"]
                               + out["recurrent serve"]
                               + out["recurrent train"]["fake_quant"]
                               + out["audio serve"]["fake_quant"]
                               + out["audio train"]["fake_quant"]
                               + out["mesh"]["fake_quant"])
    launches.update(out["matmul kernels"][1])
    # the kernels line has one entry per route of flash_attention,
    # masked_matmul and codebook_matmul: the f32 train row on the CUDA
    # cores (flash: the smoke f32 train step's launches; codebook: idx rows
    # TMA refuses), the bf16 train row on the tensor cores
    launches["flash_attention"] = (
        out["train"]["flash_attention_simt"]
        + out["moe train"]["flash_attention_simt"]
        + out["recurrent train"]["flash_attention_simt"]
        + out["audio train"]["flash_attention_simt"]
        + out["mesh"]["flash_attention_simt"])
    launches["flash_attention_wgmma"] = (
        out["train"]["flash_attention_wgmma"] + ckpt["flash_attention_wgmma"]
        + out["moe train"]["flash_attention_wgmma"]
        + out["audio serve"]["flash_attention_wgmma"]
        + out["audio train"]["flash_attention_wgmma"]
        + out["mesh"]["flash_attention_wgmma"])
    launches["masked_matmul"] = launches.pop("masked_matmul_simt")
    launches["codebook_matmul"] = launches.pop("codebook_matmul_simt")
    del launches["codebook_matmul_calls"]
    print(f"main-path launches (FL slice + examples + async + faults + "
          f"checkpoint + topology + serve + train + moe serve + moe train + "
          f"recurrent serve + recurrent train + audio serve + audio train + "
          f"mesh, "
          f"matmul entry points): "
          f"{json.dumps(launches)}")
    kernels = []
    for name, replaces in (
            ("grad_aggregate",
             "src/repro/kernels/grad_aggregate/kernel.py:51"),
            ("structured_scatter",
             "src/repro/kernels/structured_scatter/kernel.py:142"),
            ("fake_quant", "src/repro/kernels/fake_quant/kernel.py:54"),
            ("flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:72"),
            ("flash_attention_wgmma",
             "src/repro/kernels/flash_attention/kernel.py:72"),
            ("masked_matmul",
             "src/repro/kernels/masked_matmul/kernel.py:36"),
            ("masked_matmul_wgmma",
             "src/repro/kernels/masked_matmul/kernel.py:36"),
            ("codebook_matmul",
             "src/repro/kernels/codebook_matmul/kernel.py:40"),
            ("codebook_matmul_wgmma",
             "src/repro/kernels/codebook_matmul/kernel.py:40")):
        r = rows[name]
        # one grouped kernel stands for both aggregation kernels
        source = ("fleet_aggregate" if name in ("grad_aggregate",
                                                "structured_scatter")
                  else name.removesuffix("_wgmma"))
        if launches[name] <= 0:
            print(f"CHECK FAILED: {name} never launched on its main path",
                  file=sys.stderr)
            return 1
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}.cu",
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "device_ms": r["device_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r.get("bound_by", "bytes"),
                        "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    # the number of devices this script drives, whatever the host has
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
