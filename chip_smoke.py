#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-scan

Run from the root of a checkout on a machine with an NVIDIA H100 (any
card with ``nvcc`` for ``sm_90a``).  It builds the seven kernel
libraries from the checkout (``src/repro_torch/kernels/flowhash/csrc/flowhash.cu``,
``src/repro_torch/kernels/placement/csrc/placement.cu``,
``src/repro_torch/kernels/loads/csrc/loads.cu``,
``src/repro_torch/kernels/drain/csrc/drain.cu``,
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu``,
``src/repro_torch/kernels/ssd/csrc/ssd.cu`` and
``src/repro_torch/kernels/selective_scan/csrc/selective_scan.cu``, seven
``nvcc`` processes at once) and then:

1. prints the card's name and power limit (``nvidia-smi``);
2. holds every kernel wrapper against its plain PyTorch version on the
   card at the main paths' shapes — the flow hash bit for bit at 5 and
   at 7 fields (and the JAX package's pinned values), flash attention
   in bf16 and f32 to the JAX package's Pallas tolerances (2e-2, 2e-6)
   and to a per-row relative limit (2e-2, 1e-4) at 32 query heads over
   8 kv heads, hd 64, S 4,096 causal and not, a ragged S 1,000, and S
   32,768 (every row, and the last 256 rows against a plain computation
   of those rows alone; a planted skipped key tile of the bf16 kernel's
   width must fail the row limit; the same at the hd-128 serving shape,
   32 query heads over 2, with its own row on the ``kernels`` line, and
   at qwen2-vl-72b's 64 query heads over 8, timed on the phase's line; the
   ``-Xptxas -v`` report must show one bf16 instance a head dim, with the tiles ``ops.BF16_TILES`` names, no
   spills and no serialised ``wgmma``), the SSD
   intra-chunk kernel (the ``-Xptxas -v`` report must show the bf16
   bodies ``ops.BF16_BODIES`` names, no spills and no serialised
   ``wgmma``) in bf16 and f32 to the JAX package's tolerances
   (5e-2, 1e-5) and a per-row limit (y 2e-2, 1e-5; states 1e-4, 1e-5)
   at mamba2-1.3b's shape (B 2, S 32,768, 64 heads, N 128, hd 64, Q 256)
   and through the whole scan at S 32,768 and a ragged S 1,000, with dt
   from Mamba-2's init so the chunk decays carry signal (two planted
   faults must fail the limits), and Mamba-1's selective scan (the
   ``-Xptxas -v`` report shows the aligned and unaligned instances of
   each input type, free of spills and warnings) in bf16 and f32 at
   jamba's width (B 2, d_inner 16,384, N 16) over S 2,048 and a ragged
   S 1,000 against the plain step loop, y and the final state row by
   row within ``ref.ROW_RTOL`` (1e-5) and the final state equal to the
   loop's bit for bit (the count of unequal elements printed), with dt
   from Mamba's init so that the largest step decay exceeds 0.5 (three
   planted faults, the state reset at each staged time tile, C read a
   step late and a tile scanned with the x and dt of the tile before,
   must fail the limit), timed at the serving shape (S 32,768), with
   its warps an SM — and times kernel,
   plain version and
   (for attention, in alternating rounds with the kernel) SDPA with CUDA
   events (``bulk_hash``, a launch of a few microseconds, as a CUDA
   graph of back-to-back launches, beside the time of one wrapper
   call);
3. anchors the simulator on the paper testbed (256 flows x 1,024
   seeds): aggregate FIM mean and mean max-min rate under both hash
   backends must match the JAX package's numpy-engine values to 1e-9;
4. drives the simulator's path at full scale — the default multipod
   fabric (144 devices, 1,024 links) with 102,400 bipartite pod-to-pod
   flows: ``monte_carlo_fim`` over 10,240 seeds,
   ``monte_carlo_throughput`` over 1,024 seeds and the paper's
   four-stage ``simulate_paper_paths`` — and checks its first two seeds
   against the CPU path;
5. drives the paper's Algorithm 1 and Fig. 3 comparison ("fig3"): the
   port's hop-by-hop ``FlowTracer`` with ECMP at seed 7 on the paper
   testbed must give the JAX package's FIM (29.1015625 and its four
   layers); the card's ``exact`` walks of four seeds under each field
   mode must give the tracer's paths (``paths_for_seed``) and the
   card's max-min fill its per-pair rates by the scalar model
   (``pair_throughput_for_seed``, 1e-9); ``static_route_assignment``
   must give FIM 0.0 with 1,024 table entries and every pair at 400
   Gb/s, replayed by ``StaticRouting`` through the tracer, and
   ``hop_greedy`` 25.0; the ECMP arm, ``monte_carlo_fim`` over seeds
   0..1023 on the card (``murmur``, the murmur-grid kernel), must give
   the anchor's FIM mean and a reduction of at least 15 points; the
   reduced multipod fabric of ``benchmarks/monte_carlo_fim.py`` gives
   static FIM 0.0 and tracer FIM 61.40625 at seed 7; and at full scale
   the card's walk of seed 7 must equal traces of 8 host pairs (6,400
   flows) by 4 worker processes started after the card's work, and by
   one;
6. drives the routing strategies: the sequential placement kernel
   (a warp per seed, load rows and compact tables in shared memory)
   must equal its plain version bit for bit (link ids and float64
   loads) on 102,400 flows x 64 seeds with a residue mask, and is timed
   against a latency bound (its longest seed's hops x two dependent
   shared-memory loads, at the latency a pointer-chase probe measures);
   the ordered load sum must equal ``torch.bincount`` on the CPU bit for
   bit at the sprayed walk's shape with byte and with log-normal weights,
   where the card's atomic ``torch.bincount`` must not; on the paper testbed (256 flows x 1,024 seeds, ``murmur``,
   ``roce-nack``) the FIM mean, goodput mean and exposure p95 of every
   family (and of the two elephant variants under byte demand) must
   match the JAX package's numpy-engine values to 1e-9; at full scale
   ``prime-spray`` (819,200 flowlet columns, the hash at 7 fields),
   ``adaptive-spray`` (on a 3:1 skewed pair mix, where its re-spray
   rounds run, its load sums in the ordered-sum kernel; again under byte
   demand), ``congestion-aware`` and ``wave-congestion-aware`` (its load
   sums in the ordered-sum kernel too)
   route 64 seeds, each with FIM and throughput (the chain's own time
   taken apart from the route's), and each but the congestion-aware
   chain then routes seeds 0 and 1 on the card and on the CPU: the same
   link ids and rounds, FIM to 1e-12, rates and goodput to 1e-9; and
   byte-demand ``adaptive-spray`` and ``adaptive-spray-elephant`` route
   the paper testbed's 1,024 seeds with the same link ids on both;
7. drives the phased LLM training step ("timeline"): the departure
   drain's two-flow case (0.16 / 0.32 s) on the card (the drain is the
   kernel ``kernels/drain/csrc/drain.cu``, every seed's whole drain one
   cluster of CTAs of one launch); at the bench
   shapes (seeds 0..7) under ``exact`` and ``murmur``, the paper-testbed
   LLM schedule's static FIM and goodput and event JCT and FIM, the
   multipod disjoint-elephant schedule's event JCT under ECMP,
   ``prime-spray`` and the wave, and its merged and phased FIM, each
   within 1e-9 of the JAX package's numpy-engine value; at full width
   (the multipod job on all 128 hosts of the default fabric: 4,304
   flows, 5 steps; byte demand, ``roce-nack``, event timing, 64 seeds)
   ECMP, the wave, ``prime-spray`` and ``adaptive-spray``, and
   ``adaptive-spray`` over the DP-overlap schedule (where its load sums
   take the ordered-sum kernel), each with its route, fill and drain
   times, drain and fill rounds, JCT mean and p99 and step durations
   (the adaptive drives' seeds are cut, and the cut printed, if the
   phase would pass 90 s), each uncut drive's JCT mean and p99 within
   1e-9 of the first drain design's (``TL_JCT_FIRST_DESIGN``); ECMP and the wave
   at full width on seeds 0 and 1 on the card and on the CPU: every
   step's link ids identical, completion times, step durations and JCT
   within 1e-9; and the drain kernel against its plain version on the
   card, on the inputs ECMP's widest step gave it (4,096 columns x 64
   seeds) and on prime-spray's (32,768 columns x 64 seeds) cut to its
   first 8 seeds x 8,192 cells under the uncut step's cluster,
   completion times within 1e-9 relative (drain rounds reported, not
   compared), timed uncut at both with its operations bound and its
   latency bound (the longest seed's rounds at the cost of one
   cluster-wide reduction, ``drain_sync_probe``), and its ``-Xptxas -v``
   report (registers, spills, the plan's shared memory) free of
   spills;
8. drives granite-3-2b serving at full width (bf16, weights from a
   seeded generator on the card) and ``GRANITE_LAYERS`` (4) of its 40
   layers, printed with ``reduced``: ``prefill_logits`` on 2 x 32,768
   tokens (a flash-attention launch at hd 64 a layer), ``generate`` for
   4 x 2,304-token prompts and 16 greedy tokens with the decode logits
   checked against the prefill's, and a 2-layer f32 model on the card:
   its prefill against the CPU's, and its cached decode of a prompt's
   last token against its prefill;
9. drives glm4-9b serving the same way at full width and depth (40
   layers, q/k/v biases, 32 query heads over 2 kv heads: 40 flash
   launches at hd 128), its ``generate`` and decode checks at
   ``GEN_LAYERS_CUT`` (4) of the 40 layers (printed with ``reduced``),
   the 2-layer f32 checks with nonzero biases drawn from the seed;
10. drives qwen2-moe-a2.7b the same way at full width and depth (24
   layers, 60 experts, top 4, a shared expert, 16 heads over 16 at hd
   128): the prefill at the config's capacity factor, which drops
   tokens (the drops of each layer printed); ``generate`` and the
   decode checks drop-free (capacity factor 60) at ``GEN_LAYERS_CUT``
   (4) layers, each prompt position of the generate routed, layer by
   layer, to the experts the prompts' prefill chose for it (decode's
   own choice would differ where two experts' router logits tie within
   the bf16 rounding: the differing positions of each layer and
   decode's gap between its k-th and (k+1)-th logits there are
   printed), so that its bf16 decode is held against the prefill as
   granite's is; one layer's MoE on the prefill's shape run twice with
   identical bits;
11. drives qwen2-72b at full width and the most layers that fit beside
   a 2 x 32,768-token prefill (printed, with ``reduced``):
   ``Model.prefill`` with ``last_only`` (a flash launch at hd 128 a
   layer, 64 query heads over 8);
12. drives deepseek-v2-lite-16b (MLA) the same way at full width and
   depth (27 layers: a dense first layer, then 26 MoE layers of 64
   experts, top 6, two shared): the 2 x 32,768-token prefill at the
   capacity factor, its MLA attention (q/k of 192, v of 128) in
   ``chunked_attention`` with no flash launch, and that function's
   time in the profiled prefill; ``generate`` for 4 x 520-token prompts
   through the absorbed decode over the latent cache at
   ``GEN_LAYERS_CUT`` (4) of the 27 layers (printed with ``reduced``),
   forced to the prefill's experts (3 routings a step); and the 2-layer
   f32 model
   (the dense layer and one MoE layer) at 2,304 tokens, card against
   CPU, then its absorbed decode of the last token against its
   decompressed prefill;
13. drives qwen2-vl-72b (M-RoPE) at full width and the most layers that
   fit beside a 2 x 32,768-position prefill (printed, with
   ``reduced``): ``Model.prefill`` with ``last_only`` on patch and
   token embeddings drawn from the seed and three M-RoPE position
   streams of one 64 x 64 image between two runs of text (a flash
   launch at hd 128 a layer, 64 query heads over 8); one full-width
   layer in f32 on the card against the CPU at 512 positions, with the
   CPU's seconds;
14. drives whisper-large-v3 (the encoder-decoder) at full width and
   depth (32 encoder and 32 decoder layers, 20 heads at hd 64):
   ``Model.encode`` over 32 clips of 1,500 seeded frame embeddings
   (frames/s), ``generate`` for 4 requests of 64-token decoder prompts
   and 16 greedy tokens with ``extra_batch={"enc_memory": ...}``, the
   decode logits held against the decoder prefill's, and 2 + 2 layers
   in f32 on the card against the CPU with every layer-norm and MLP
   bias drawn nonzero; no flash launch (both attentions stay under
   2,048);
15. drives jamba-1.5-large-398b (the hybrid) at full width over one
   period, 8 of its 72 sublayers (Mamba-1 at 0-6, GQA at 7 with 64 heads
   over 8 at hd 128, a SwiGLU after even and a MoE of 16 experts, top 2,
   after odd sublayers), its four MoE sublayers sharing one 16-expert
   stack (both cuts printed), bf16 on seeded weights with Mamba's dt
   init: ``Model.prefill`` with ``last_only`` on 2 x 32,768 tokens (7
   selective-scan launches and one flash launch at hd 128, G 8; profiled
   by kernel group, with the MoE's host seconds); ``generate`` for 4 x
   256-token prompts and 16 greedy tokens, drop-free and forced to the
   prefill's experts, the decode logits (the one-step recurrence, the
   4,096-token window) held against the prefill's (the kernel) under
   0.2, and that gap split: the prompts' prefill again with its scan in
   the one-step recurrence, and their decode again with the prefill's
   conv rounding, each block's difference at the last prompt position
   printed; and the period in f32 at 256 positions, like sublayers
   sharing weights, on the card against the CPU: each block (a
   sublayer's mixer or FFN) fed the CPU's input within 1e-5 of its
   largest output, the logits within 3e-5 of the largest logit;
16. drives mamba2-1.3b serving at full width and ``MAMBA2_LAYERS``
   (12) of its 48 layers, printed with ``reduced`` (bf16, Mamba-2's
   dt_bias init): ``prefill_logits`` on 2 x 32,768 tokens (an SSD
   launch a layer), ``generate`` for 4 x 520-token prompts and
   16 greedy tokens with the decode logits checked against the
   prefill's, and a 2-layer f32 prefill on the card against the CPU;
17. trains granite-3-2b ("train"): (a) the flash op's autograd Function
   (``models/attention.py::FlashAttention``: the kernel forward, the
   recomputed ``chunked_attention`` backward) against autograd through
   ``plain_attention`` at B 1, S 4,096, 32 heads over 8, hd 64, causal:
   dq, dk, dv in f32 within 1e-5 of each one's largest |value|, in bf16
   against the f32 plain gradients within 5e-2; (b) the reduced config
   in f32 at 2,176 tokens (the Function and the kernel run), one
   ``train_step`` on the card against the CPU: the loss within 1e-5
   relative, each gradient leaf within 1e-4 and each weight after the
   update within 1e-5 of its largest |value|; (c) the reduced config in
   bf16, 2 steps, a checkpoint, 2 more, against a restore and the same
   2 steps: every weight and optimizer state bit for bit; (d) the full
   config, all 40 layers, on ``train_4k``'s 4,096 tokens with the global
   batch of 256 cut to 4 (2 microbatches of 2), bf16 weights, f32 AdamW
   state, the default sqrt remat (groups of 5): a warm-up step, then
   ``TRAIN_TIMED_STEPS`` timed ones (seconds, tokens/s, peak memory,
   loss and grad norm, all finite) and one profiled step split into the
   flash forward, the chunked backward, GEMMs, the optimizer and the
   rest; then the Function's backward alone at that shape against SDPA's
   (a sub-row of the flash row on the ``kernels`` line, whose launches
   count the train steps' too);
18. prints the ``kernels`` record, each phase's seconds and, last, the
   one-line result.

Each serving phase prints its seconds by step, and its decode rate
from ``DECODE_TIMED_STEPS`` decode steps run alone (no routing patch,
no profiler).

Each path runs with every kernel's launch count set to 0 just before it
and read just after; a kernel that its path never launched fails the
run, and so does a strategy whose walk made fewer murmur launches than
its paths have hops, a chain that did not launch the placement
kernel, an adaptive or wave route that did not launch the ordered sum, or a
timeline phase that did not launch the flow hash at 5 and at 7 fields,
the placement kernel, the ordered sum and the drain (its launches join
the ``kernels`` line's counts).  The flow hash's launches are counted
by the width they hashed: the ``kernels`` line gives the 5-field
launches on the murmur row and the 7-field ones under its ``f7``.  The
flash kernel's are counted by the head dim of the config that launched
them: the hd-64 row counts granite's prefills (whisper-large-v3, at hd
64, launches none), the hd-128 row those of glm4-9b, qwen2-moe-a2.7b,
qwen2-72b, qwen2-vl-72b and jamba-1.5-large-398b (deepseek-v2-lite-16b,
at hd 128, launches none: its prefill takes ``chunked_attention``).  The
selective scan's launches are jamba's prefill's.

Every check raises, so any failure exits non-zero before the result
line.  Without a CUDA card, or without the repository around it, the
script exits non-zero and prints no result.

``--profile-scan`` runs none of the above but the builds and one
full-width Mamba-1 sublayer's prefill on 2 x 32,768 tokens, its scan
once in the plain loop and once in the kernel, each under the profiler
(``profile_scan``): the evidence that the scan's time loop wants a
kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT32_OPS_PER_S = 67e12        # 32-bit ALU peak outside the tensor cores
F64_FLOPS_PER_S = 34e12        # float64 peak outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12        # f32 FMA peak outside the tensor cores
# exponentials of the special-function units: 16 per SM per clock, 132
# SMs at the 1.98 GHz boost clock of the other peaks
EXP_PER_S = 16 * 132 * 1.98e9
#: integer operations of the murmur chain: per field fold, and fmix
FOLD_OPS, FMIX_OPS = 9, 8

# The JAX package's numpy-engine values on the paper testbed (256
# bipartite flows, seeds 0..1023): aggregate FIM mean, mean flow rate.
ANCHORS = {
    "exact": (32.53364562988281, 18.45605006788607),
    "murmur": (32.590484619140625, 18.449603870457246),
}
ANCHOR_RTOL = 1e-9
# The JAX package's numpy-engine values on the paper testbed, for
# (strategy, demand_mode): aggregate FIM mean, goodput mean and exposure
# p95 under roce-nack, 256 bipartite flows (16 a host pair) of
# alternating 2**20 and 2**30 bytes (``anchor_flows``), seeds 0..1023,
# murmur.  Made with
#   PYTHONPATH=src python -c 'import dataclasses as d, numpy as np, repro.core as R
#   c = R.compile_fabric(R.build_paper_testbed()); s = np.arange(1024)
#   w = R.bipartite_pairs([R.server_name(i) for i in range(8)],
#       [R.server_name(8 + i) for i in range(8)], flows_per_pair=16)
#   f = [d.replace(x, bytes=2**20 if j % 2 == 0 else 2**30) for j, x in
#        enumerate(R.synthesize_flows(w, nic_ip=R.nic_ip, nics_per_server=2))]
#   for n, m in [("prime-spray", "uniform"), ("adaptive-spray", "uniform"),
#       ("congestion-aware", "uniform"), ("wave-congestion-aware", "uniform"),
#       ("prime-spray-elephant", "bytes"), ("adaptive-spray-elephant", "bytes")]:
#     k = dict(strategy=n, demand_mode=m, hash_backend="murmur")
#     t = R.monte_carlo_throughput(c, f, s, transport="roce-nack", **k)
#     print(n, m, R.monte_carlo_fim(c, f, s, **k).aggregate.mean(),
#           t.goodput.mean(), np.percentile(t.exposure, 95))'
STRATEGY_ANCHORS = {
    ("prime-spray", "uniform"):
        (11.779379844665527, 15.837154231893102, 0.7070889522395549),
    ("adaptive-spray", "uniform"):
        (10.354781150817871, 16.95561558939206, 0.665906102593618),
    ("congestion-aware", "uniform"):
        (3.1169891357421875, 23.772078998505123, 0.0),
    ("wave-congestion-aware", "uniform"):
        (3.1169891357421875, 23.772078998505123, 0.0),
    ("prime-spray-elephant", "bytes"):
        (58.23903600181028, 16.424418813608987, 0.5834432982546484),
    ("adaptive-spray-elephant", "bytes"):
        (58.06043931914546, 17.932433883364403, 0.36057408148643516),
}
# The JAX package's hop-by-hop tracer (Algorithm 1) with ECMP at seed 7 on
# the paper testbed (256 bipartite flows): aggregate and per-layer FIM,
# and static placement's hop_greedy FIM.  Made with
#   PYTHONPATH=src python -c 'import repro.core as R; f = R.build_paper_testbed(); w = R.bipartite_pairs([R.server_name(i) for i in range(8)], [R.server_name(8 + i) for i in range(8)], flows_per_pair=16); x = R.synthesize_flows(w, nic_ip=R.nic_ip, nics_per_server=2); p = R.FlowTracer(f, R.EcmpRouting(f, seed=7), w, x).trace().paths; print(R.fim(p, f), R.per_layer_fim(p, f), R.fim(R.static_route_assignment(f, x, mode="hop_greedy")[1], f))'
FIG3_FIM = 29.1015625
FIG3_LAYERS = {"host-to-leaf": 30.46875, "leaf-to-host": 19.53125,
               "leaf-to-spine": 33.59375, "spine-to-leaf": 32.8125}
FIG3_HOP_GREEDY = 25.0
# The same on the reduced multipod fabric of benchmarks/monte_carlo_fim.py
# (2 pods x 16 hosts, 4 leaves a pod, 8 spines, 256 flows): the tracer's
# FIM at seed 7 and static placement's.  Made with
#   PYTHONPATH=src python -c 'import repro.core as R; f = R.build_multipod_fabric(num_pods=2, hosts_per_pod=16, leaves_per_pod=4, num_spines=8); w = R.bipartite_pairs([f"host-{i}" for i in range(16)], [f"host-{16 + i}" for i in range(16)], flows_per_pair=8); x = R.synthesize_flows(w, nic_ip=R.nic_ip, nics_per_server=1); print(len(x), R.fim(R.FlowTracer(f, R.EcmpRouting(f, seed=7), w, x).trace().paths, f), R.fim(R.static_route_assignment(f, x)[1], f))'
FIG3_MULTIPOD_FIM = 61.40625
# the least ECMP-minus-static FIM, in points (tests/test_system.py; the
# paper's 36.5 - 6.2 = 30.3)
FIG3_REDUCTION_MIN = 15.0
FIG3_SEEDS = [0, 7, 1234567, 2**40 + 17]   # walks held against the tracer
FIG3_PAIRS = 8                 # full-scale host pairs traced by processes
# The JAX package's numpy-engine values for the phased LLM step at the
# bench shapes, seeds 0..7.  The paper-testbed LLM schedule (336 flows,
# 5 sequential steps, byte demand, roce-nack, prime-spray-elephant):
# static FIM mean, static goodput mean, event JCT mean, event FIM mean,
# per hash backend.  Made with
#   PYTHONPATH=src python -c 'import numpy as np, repro.core as R
#   c = R.compile_fabric(R.build_paper_testbed()); _, f, _, s = R.paper_testbed_llm_schedule()
#   for b in ("exact", "murmur"):
#     k = dict(demand_mode="bytes", transport="roce-nack", strategy="prime-spray-elephant", hash_backend=b)
#     a = R.simulate_timeline(c, f, s, np.arange(8), **k); e = R.simulate_timeline(c, f, s, np.arange(8), timing="event", **k)
#     print(b, a.fim.mean(), a.goodput.mean(), e.job_completion.mean(), e.fim.mean())'
TIMELINE_PAPER = {
    "exact": (133.71512276785714, 56.92891008831366, 1.0773051353950285,
              130.64726421033623),
    "murmur": (133.58677455357144, 56.74866925820838, 1.1004450181254815,
               130.34317352396147),
}
# The multipod disjoint-elephant schedule of benchmarks/timeline.py (the
# default multipod fabric; 520 flows: gradient all-reduce, then MoE
# all-to-all; byte demand, event timing): mean JCT per (backend,
# strategy), and the merged and phased static FIM (exact).  Made with
#   PYTHONPATH=src python -c 'import numpy as np, repro.core as R
#   c = R.compile_fabric(R.build_multipod_fabric()); _, f, _, _ = R.multipod_llm_schedule(param_bytes=20_000_000_000)
#   f = [x for x in f if R.flow_channel(x) in (1, 4)]; s = [R.TimelineStep("ar", (1,)), R.TimelineStep("a2a", (4,))]
#   for b in ("exact", "murmur"):
#     for n in ("ecmp", "prime-spray", "wave-congestion-aware"):
#       print(b, n, R.simulate_timeline(c, f, s, np.arange(8), demand_mode="bytes", strategy=n, timing="event", hash_backend=b).job_completion.mean())
#   k = dict(demand_mode="bytes", hash_backend="exact")
#   print(R.simulate_timeline(c, f, [R.merged_step(s)], np.arange(8), **k).fim.mean(), R.simulate_timeline(c, f, s, np.arange(8), **k).fim.mean())'
TIMELINE_MULTIPOD_JCT = {
    ("exact", "ecmp"): 3.01979711488,
    ("exact", "prime-spray"): 2.40459203232,
    ("exact", "wave-congestion-aware"): 1.51073741824,
    ("murmur", "ecmp"): 3.01912602624,
    ("murmur", "prime-spray"): 2.17017508928,
    ("murmur", "wave-congestion-aware"): 1.51073741824,
}
TIMELINE_MERGED_FIM, TIMELINE_PHASED_FIM = 189.34082589747524, 179.6630859375
TIMELINE_ANCHOR_SEEDS = 8
# full width: the repo's multipod LLM job grown to all 128 hosts of the
# default multipod fabric (4 chips a host, 8 hosts a pod, EP groups of
# 16 hosts): 4,304 DCN flows over 5 sequential steps, event timing, byte
# demand, roce-nack, 64 seeds; the DP-overlap schedule (2 fat steps and
# the barrier, mixed volumes a step) under adaptive-spray, whose
# byte-weighted load sums are then not exact in any order
TL_HOSTS, TL_PARAM_BYTES, TL_FLOWS, TL_STEPS = 128, 20_000_000_000, 4_304, 5
TL_SEEDS = 64
TL_SWEEPS = (("ecmp", "sequential"), ("wave-congestion-aware", "sequential"),
             ("prime-spray", "sequential"), ("adaptive-spray", "sequential"),
             ("adaptive-spray", "dp-overlap"))
TL_CHECK = ("ecmp", "wave-congestion-aware")   # card against CPU, seeds 0, 1
TL_BUDGET_S = 90.0
# what the budget keeps for the card-against-CPU check, and an adaptive
# drive's time over prime-spray's, with a margin (its second drain
# departs over about twice the epochs: 3.08 s against 0.956 s at full
# width on an H100 with the cluster drain kernel, as 13.2 s against
# 4.15 s with the first design)
TL_CHECK_RESERVE_S = 10.0
TL_ADAPTIVE_OVER_SPRAY = 4.5
# the drives whose widest step's drain inputs the kernel is held and
# timed on: ECMP's (the MoE all-to-all, 4,096 columns x 64 seeds) and
# prime-spray's (the same step sprayed, 32,768 columns x 64 seeds)
DRAIN_SHAPES = ("ecmp", "prime-spray")
# the plain version takes about 30 s at prime-spray's widest step, so its
# check there cuts the inputs to the first seeds and the first cells of
# each (8 x 8,192: about 5 s plain on an H100's host, 16 CTAs' lists of
# 4,096 cells under the uncut step's cluster of 2)
DRAIN_CUT_SEEDS, DRAIN_CUT_CELLS = 8, 8_192
# cluster-wide reductions a probe launch times
DRAIN_PROBE_ITERS = 20_000
# each full-width drive's JCT mean and p99 (s) under the first drain
# design (one block a seed; this script on an H100, PERF.md section 5),
# held to JCT_RTOL when the drive runs its 64 seeds uncut
TL_JCT_FIRST_DESIGN = {
    ("ecmp", "sequential"): (6.37118106424, 6.37147466552),
    ("wave-congestion-aware", "sequential"): (3.18573733304, 3.18573733304),
    ("prime-spray", "sequential"): (11.4353486673, 12.1686265795),
    ("adaptive-spray", "sequential"): (8.4762512484, 9.6900484151),
    ("adaptive-spray", "dp-overlap"): (6.9312492560, 8.3140198167),
}
JCT_RTOL = 1e-9
# tests/test_kernels.py pins these for the Pallas bulk_hash kernel:
# rng(42) fields (4096, 5) below 2**31, seed 12345
PINNED_HEAD = [1282828036, 453300701, 462728589, 1920719609]
PINNED_SUM = 8712584361707

GRID_FLOWS, GRID_SEEDS, N_FIELDS = 102_400, 2_560, 5
# the sprayed walk's grid: 8 flowlets a flow, the 5-tuple and two
# entropy digits (parts (2, 4)), over the full-scale strategy sweeps' seeds
SPRAY_COLUMNS, SPRAY_FIELDS, SPRAY_SEEDS = 8 * GRID_FLOWS, 7, 64
CHECK_SEEDS = [0, 1]           # strategies on the card against the CPU
# adaptive re-spray's full-scale traffic: the same 102,400 unit-demand
# flows from pod 0 to pod 1, 1,200 a pair on even host pairs and 400 on
# odd ones.  Under the even mix (800 a pair) 819,200 flowlets leave no
# link 1.25 x above the mean and no round runs; the 3:1 skew marks cells
# in every round
SKEW_FLOWS_PER_PAIR = (1_200, 400)
# the placement chain's check against its plain version: flows whose
# every seed is placed, and flows with a share of their seeds placed
CHAIN_WHOLE_FLOWS, CHAIN_PART_FLOWS, CHAIN_PART_SHARE = 2_048, 2_048, 0.3
# the chain's latency bound: the shared-memory loads a hop cannot avoid,
# each waiting on the one before (placement.cu's source note), and the
# dependent loads the pointer-chase probe times
CHAIN_DEPENDENT_LOADS = 2
PROBE_STEPS = 1 << 16
FIM_SEEDS, TP_SEEDS = 10_240, 1_024
GRAPH_LAUNCHES = 200           # bulk_hash launches a timed CUDA graph holds
FLOWS_PER_PAIR = 800           # 128 directed host pairs -> 102,400 flows

# flash attention: the JAX package's tolerances for its Pallas kernel
# (tests/test_kernels.py), as |got - want| <= tol + tol * |want|, and the
# tolerance that scales with the output: each query row's error relative
# to that row's size (ref.row_errors, ref.ROW_RTOL: bf16 2e-2, f32 1e-4)
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-6}
FLASH_HEADS, FLASH_KV_HEADS, FLASH_HD = 32, 8, 64
# the hd-128 serving shape: glm4-9b's 32 query heads over 2 kv heads;
# qwen2-vl-72b's 64 over 8
FLASH_HD128 = (32, 2, 128)
FLASH_HD128_G8 = (64, 8, 128)
BAND = 256                     # query rows held at S = 32,768
# serving: granite-3-2b; the repo's prefill_32k length with the global
# batch of 32 cut to 2 for one card
PREFILL_BATCH, PREFILL_LEN = 2, 32_768
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 2_304, 16
SERVE_SEED = 0
PROFILE_STEPS = 5              # decode steps traced for the device's busy share
DECODE_TIMED_STEPS = 32        # decode steps timed alone for the decode rate
# decode (plain attention, bf16 scores) against prefill (the flash
# kernel, f32 scores) at the last prompt position, 40 layers in bf16:
# max |logit difference| (0.09 measured on an H100 with these seeds;
# glm4-9b's 0.109; the logits have std ~1); also the top-2 gap above
# which the first generated token must be the prefill's argmax.  A MoE's
# decode takes the prefill's experts at each prompt position
# (phase_serve)
DECODE_TOL = 0.2
# the card against the CPU, 2 layers in f32 with TF32 off: max |logit
# difference| relative to the largest |logit|
F32_RTOL = 1e-4

# SSD: the JAX package's tolerances for its Pallas kernel
# (tests/test_kernels.py), as |got - want| <= tol + tol * |want|, and the
# per-row relative limits (ssd ref.row_errors; ref.ROW_RTOL for y: bf16
# 2e-2, f32 1e-5; ref.STATE_ROW_RTOL for S_loc and states: 1e-4, 1e-5);
# dt from Mamba-2's init (arXiv:2405.21060), where the largest chunk
# decay must exceed DECAY_MIN
SSD_TOL = {"bfloat16": 5e-2, "float32": 1e-5}
SSD_HEADS, SSD_HD, SSD_STATE, SSD_CHUNK = 64, 64, 128, 256
DT_RANGE = (1e-3, 1e-1)
DECAY_MIN = 1e-2
RAGGED_S = 1_000
# serving: mamba2-1.3b; prompts of two whole chunks and a ragged third
M2_GEN_PROMPT = 520
# decode (conv einsum, f32 state) against prefill (the kernel, bf16 w) at
# the last prompt position in bf16 (set at all 48 layers, 0.31 measured
# there): max |logit difference|, and
# the top-2 gap above which the first generated token must be the
# prefill's argmax
M2_DECODE_TOL = 0.5
# the biases of the f32 card-against-CPU checks, N(0, std), where the
# reference's init makes them zero: q/k/v, the GELU MLP's and the layer
# norms'
BIAS_STD = 0.5
BIASES = ("bq", "bk", "bv", "b_in", "b_out", "ln1b", "ln2b", "lnxb",
          "final_norm_b", "enc_final_norm_b")
# granite-3-2b's and mamba2-1.3b's serving depths, cut from 40 and 48
# so that the script keeps inside 600 s beside the hd-128 paths and the
# train phase (granite trains at all 40 layers there): their generates
# are host-bound, about 1.1 to 1.5 ms a layer a decode step on an H100's
# host, whose speed moves by half from one machine to the next (8 and
# 24 layers until the train phase came: 562 s on one host, 644 s on
# another)
GRANITE_LAYERS = 4
MAMBA2_LAYERS = 12
# glm4-9b's, qwen2-moe-a2.7b's and deepseek-v2-lite-16b's generate and
# decode checks, cut from 40, 24 and 27 layers (their 2 x 32,768-token
# prefills stay at full depth) so that the script keeps inside 600 s
# beside qwen2-vl-72b, whisper-large-v3, jamba-1.5-large-398b and the
# train phase (8 layers until the train phase came)
GEN_LAYERS_CUT = 4
# qwen2-vl-72b: one 64 x 64 block of merged patches after 1,024 text
# positions of the 32,768 (text positions before, side); its f32
# card-against-CPU check at 512 positions (a 16 x 16 block after 64),
# where one full-width layer's CPU prefill takes seconds
VLM_IMAGE = (1_024, 64)
VLM_F32_LEN, VLM_F32_IMAGE = 512, (64, 16)
VLM_FRAGMENTATION_BYTES = 8 << 30
# whisper-large-v3: the encoder over a global batch of 32 clips of 1,500
# frames; generate's decoder prompts
ENC_BATCH = 32
WHISPER_PROMPT = 64
# phase_serve's depth for a config whose full depth exceeds the card's
# memory: the most layers that fit
FIT = "fit"
# jamba-1.5-large-398b: one period (8 of its 72 sublayers) at full width,
# its four MoE sublayers sharing one stack of 16 experts (19.3 GB in
# bf16), so that the period's 32.5 GB of weights fit beside the prefill;
# generate's prompts; the f32 card-against-CPU check's positions, with
# like sublayers sharing weights: each block (a sublayer's mixer or FFN)
# on the same input held to tests/_torch_lm.py's f32 limit, and the
# logits, after 16 blocks of sums at widths of 8,192 to 24,576 taken in
# other orders by the two BLAS libraries, to JAMBA_LOGIT_RTOL: 2.3 times
# the 1.28e-5 an H100 gave with these seeds
JAMBA = "jamba-1.5-large-398b"
JAMBA_PERIODS = 1
JAMBA_PROMPT = 256
JAMBA_F32_LEN = 256
JAMBA_F32_RTOL = 1e-5
JAMBA_LOGIT_RTOL = 3e-5
# the selective scan's checks against its plain version (about 12
# launches a step) at jamba's width, a whole and a ragged number of time
# tiles, with dt from Mamba's init (DT_RANGE): the largest per-step decay
# exp(dt A) must exceed SCAN_DECAY_MIN, so that a wrong carry shows
SCAN_CHECK_S = (2_048, RAGGED_S)
SCAN_DECAY_MIN = 0.5
# training: granite-3-2b at full width and depth on train_4k's 4,096
# tokens, its global batch of 256 cut to 4 for one card (2 microbatches
# of 2 sequences), bf16 weights, f32 AdamW state, the default remat;
# one warm-up step, then TRAIN_TIMED_STEPS timed ones and one profiled
TRAIN_ARCH = "granite-3-2b"
TRAIN_MICRO, TRAIN_ACCUM = 2, 2
TRAIN_TIMED_STEPS = 2
# the gates: the flash Function's gradients against autograd through
# plain_attention at B 1, S 4,096 (f32 within 1e-5 of each gradient's
# largest |value|; bf16 against the f32 plain gradients within
# tests/_torch_lm.py's bf16 5e-2); reduced granite on the card against
# the CPU in f32 at a length past LONG_SEQ (loss 1e-5 relative, each
# gradient leaf 1e-4 and each weight after a step 1e-5 of its largest
# |value|); and 2 + 2 steps against a restore after 2, bit for bit
TRAIN_GRAD_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TRAIN_CHECK_S = 2_176
TRAIN_LOSS_RTOL, TRAIN_LEAF_RTOL, TRAIN_PARAM_RTOL = 1e-5, 1e-4, 1e-5
TRAIN_RESUME_STEPS = 2


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms over ``reps`` event-timed
    runs, after one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn, launches: int, reps: int = 10) -> float:
    """Device ms per call of ``fn``, from the median over ``reps`` of a
    CUDA graph of ``launches`` back-to-back calls, event-timed: the
    kernel's own time, without the host's cost of each call."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def paired_ms(fn_a, fn_b, rounds: int = 4, reps: int = 3) -> tuple:
    """Medians in ms of ``fn_a`` and ``fn_b`` timed in alternating
    rounds (a b, b a, ...) of ``reps`` runs each, so that a drift of the
    card's clock reaches both alike."""
    a, b = [], []
    for r in range(rounds):
        for fn, out in ((fn_a, a), (fn_b, b))[::1 if r % 2 == 0 else -1]:
            out.append(cuda_ms(fn, reps))
    return sorted(a)[rounds // 2], sorted(b)[rounds // 2]


def bound(bytes_moved: int, ops: int,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn):
    """(result, host seconds, peak device bytes) of ``fn`` run alone."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def phase_build():
    """Build the kernel libraries with one ``nvcc`` process each, all at
    once."""
    from repro_torch.kernels.drain import build as drain_build
    from repro_torch.kernels.flash_attention import build as fa_build
    from repro_torch.kernels.flowhash import build as fh_build
    from repro_torch.kernels.loads import build as loads_build
    from repro_torch.kernels.placement import build as pl_build
    from repro_torch.kernels.selective_scan import build as ss_build
    from repro_torch.kernels.ssd import build as ssd_build
    builds = (fh_build, pl_build, loads_build, drain_build, fa_build,
              ssd_build, ss_build)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda b: b.build(), builds))
    for b in builds:
        b.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {lib.name: [
              ln.strip() for ln in lib.with_suffix(".log").read_text()
              .splitlines() if any(w in ln for w in (
                  "entry function", "registers", "spill"))]
              for lib in libs}})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def phase_kernels(np, torch):
    """Each wrapper against its plain version at the main path's shape;
    returns the kernel records (launch counts filled in later)."""
    from repro_torch.kernels.flowhash import ops, ref
    rng = np.random.default_rng(2024)
    fields = torch.from_numpy(rng.integers(
        0, 2**32, (GRID_FLOWS, N_FIELDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    dev_seed = torch.from_numpy(rng.integers(
        0, 2**64, (GRID_FLOWS, GRID_SEEDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    records = []

    # the walk's per-(flow, seed) grid (bulk_hash_seeded_kernel's chain)
    got = ops.murmur_hash_grid(fields, dev_seed)
    want = ref.murmur_hash_grid_ref(fields, dev_seed)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want), "murmur_hash_grid != plain version")
    del got, want
    seeded = torch.from_numpy(rng.integers(
        0, 2**32, GRID_FLOWS, dtype=np.uint64).view(np.int64)).cuda()
    check(torch.equal(ops.bulk_hash_seeded(fields, seeded),
                      ref.murmur_hash_grid_ref(fields, seeded[:, None])[:, 0]),
          "bulk_hash_seeded != plain version")
    cells = GRID_FLOWS * GRID_SEEDS
    b_ms, b_by = bound(fields.numel() * 8 + 2 * cells * 8,
                       cells * (N_FIELDS * FOLD_OPS + FMIX_OPS))
    records.append({
        "name": "murmur_hash_grid", "route": "cuda",
        "source": "src/repro_torch/kernels/flowhash/csrc/flowhash.cu",
        "replaces": "src/repro/kernels/flowhash/kernel.py:90",
        "shape": [GRID_FLOWS, N_FIELDS, GRID_SEEDS],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.murmur_hash_grid(fields, dev_seed), 20),
        "plain_ms": cuda_ms(
            lambda: ref.murmur_hash_grid_ref(fields, dev_seed), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del dev_seed

    # the same kernel at the sprayed walk's width: 7 fields over 819,200
    # flowlet columns
    fields7 = torch.from_numpy(rng.integers(
        0, 2**32, (SPRAY_COLUMNS, SPRAY_FIELDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    seed7 = torch.from_numpy(rng.integers(
        0, 2**64, (SPRAY_COLUMNS, SPRAY_SEEDS), dtype=np.uint64
    ).view(np.int64)).cuda()
    got = ops.murmur_hash_grid(fields7, seed7)
    want = ref.murmur_hash_grid_ref(fields7, seed7)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "murmur_hash_grid != plain version at F 7")
    cells7 = SPRAY_COLUMNS * SPRAY_SEEDS
    b_ms, b_by = bound(fields7.numel() * 8 + 2 * cells7 * 8,
                       cells7 * (SPRAY_FIELDS * FOLD_OPS + FMIX_OPS))
    records[0]["f7"] = {
        "shape": [SPRAY_COLUMNS, SPRAY_FIELDS, SPRAY_SEEDS],
        "max_abs_err": int((got - want).abs().max()),
        "ms": cuda_ms(lambda: ops.murmur_hash_grid(fields7, seed7), 20),
        "plain_ms": cuda_ms(
            lambda: ref.murmur_hash_grid_ref(fields7, seed7), 5),
        "bound_ms": b_ms, "bound_by": b_by}
    del fields7, seed7, got, want

    # one scalar seed broadcast over the rows (bulk_hash_kernel)
    got = ops.bulk_hash(fields, 12345)
    init = torch.full((GRID_FLOWS, 1), 12345, dtype=torch.int64,
                      device="cuda")
    want = ref.murmur_hash_grid_ref(fields, init)[:, 0]
    check(torch.equal(got, want), "bulk_hash != plain version")
    b_ms, b_by = bound(fields.numel() * 8 + 8 + GRID_FLOWS * 8,
                       GRID_FLOWS * (N_FIELDS * FOLD_OPS + FMIX_OPS))
    records.append({
        "name": "bulk_hash", "route": "cuda",
        "source": "src/repro_torch/kernels/flowhash/csrc/flowhash.cu",
        "replaces": "src/repro/kernels/flowhash/kernel.py:70",
        "shape": [GRID_FLOWS, N_FIELDS],
        "max_abs_err": int((got - want).abs().max()),
        "ms": graph_ms(lambda: ops.bulk_hash(fields, 12345), GRAPH_LAUNCHES),
        "wrapper_ms": cuda_ms(lambda: ops.bulk_hash(fields, 12345), 50),
        "plain_ms": cuda_ms(
            lambda: ref.murmur_hash_grid_ref(fields, init), 20),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    # the values the JAX package pins for its Pallas kernel
    rng42 = np.random.default_rng(42)
    pinned = torch.from_numpy(
        rng42.integers(0, 2**31, (4096, 5)).astype(np.int64)).cuda()
    h = ops.bulk_hash(pinned, 12345).cpu().numpy()
    check(h[:4].tolist() == PINNED_HEAD and int(h.sum()) == PINNED_SUM,
          f"pinned flow-hash values drifted: {h[:4].tolist()} {h.sum()}")
    emit({"phase": "kernels", "pinned_values": "ok",
          "checked": [r["name"] for r in records] + ["bulk_hash_seeded"]})
    return records


def phase_anchor(np):
    """Paper testbed, 256 flows x 1,024 seeds, against the JAX
    package's numpy-engine values."""
    from repro_torch.core import (
        bipartite_pairs, build_paper_testbed, compile_fabric,
        monte_carlo_fim, monte_carlo_throughput, server_name,
    )
    comp = compile_fabric(build_paper_testbed())
    wl = bipartite_pairs([server_name(i) for i in range(8)],
                         [server_name(8 + i) for i in range(8)],
                         flows_per_pair=16)
    seeds = np.arange(1024)
    out = {}
    for backend, (fim_want, rate_want) in ANCHORS.items():
        fim = float(monte_carlo_fim(comp, wl, seeds, hash_backend=backend)
                    .aggregate.mean())
        rate = float(monte_carlo_throughput(comp, wl, seeds,
                                            hash_backend=backend)
                     .rates.mean())
        for name, got, want in (("fim", fim, fim_want),
                                ("rate", rate, rate_want)):
            rel = abs(got - want) / abs(want)
            check(rel <= ANCHOR_RTOL,
                  f"{backend} {name} {got!r} != {want!r} (rel {rel:.3g})")
        out[backend] = {"fim_mean": fim, "rate_mean": rate}
    emit({"phase": "anchor", "fabric": "paper-testbed", "flows": 256,
          "seeds": 1024, "rtol": ANCHOR_RTOL, **out})


def phase_full_scale(np, torch):
    """The main path at full scale; returns the launch counts of the run."""
    from repro_torch.core import (
        bipartite_pairs, build_multipod_fabric, compile_fabric,
        flow_fields_matrix, max_min_rates, monte_carlo_fim,
        monte_carlo_throughput, nic_ip, simulate_paths, synthesize_flows,
    )
    from repro_torch.kernels.flowhash import ops

    t0 = time.perf_counter()
    fab = build_multipod_fabric()
    comp = compile_fabric(fab)
    pod0 = [f"host-{i}" for i in range(64)]
    pod1 = [f"host-{64 + i}" for i in range(64)]
    flows = synthesize_flows(bipartite_pairs(pod0, pod1, FLOWS_PER_PAIR),
                             nic_ip=nic_ip, nics_per_server=1)
    fm = flow_fields_matrix(flows, "5tuple")
    setup_s = time.perf_counter() - t0
    check(len(flows) == GRID_FLOWS, f"{len(flows)} flows")
    hops = simulate_paths(comp, flows, np.arange(4),
                          field_matrix=fm).link_ids.shape[0]

    ops.reset_launches()
    fim, fim_s, fim_peak = timed(lambda: monte_carlo_fim(
        comp, flows, np.arange(FIM_SEEDS), field_matrix=fm))
    grid_after_fim = ops.LAUNCHES["murmur_hash_grid"]
    tp, tp_s, tp_peak = timed(lambda: monte_carlo_throughput(
        comp, flows, np.arange(TP_SEEDS), field_matrix=fm))
    fields = torch.from_numpy(fm.view(np.int64)).cuda()
    stages, pp_s, _ = timed(lambda: ops.simulate_paper_paths(fields))
    launches = dict(ops.LAUNCHES)
    check(set(ops.GRID_LAUNCHES_BY_FIELDS) == {5},
          f"grid widths {sorted(ops.GRID_LAUNCHES_BY_FIELDS)}")

    fim_chunks = -(-FIM_SEEDS // fim.seed_chunk)
    tp_chunks = -(-TP_SEEDS // tp.seed_chunk)
    check(tuple(fim.aggregate.shape) == (FIM_SEEDS,), "FIM shape")
    check(bool(torch.isfinite(fim.aggregate).all())
          and bool((fim.aggregate >= 0).all()), "FIM not finite")
    check(grid_after_fim >= hops * fim_chunks,
          f"{grid_after_fim} grid launches < {hops} hops x {fim_chunks}")
    check(launches["murmur_hash_grid"] - grid_after_fim >= hops * tp_chunks,
          "throughput sweep skipped the hash kernel")
    check(tuple(tp.rates.shape) == (GRID_FLOWS, TP_SEEDS), "rates shape")
    check(bool(torch.isfinite(tp.rates).all())
          and bool((tp.rates > 0).all()), "rates not finite and positive")
    pair_sum = tp.per_pair.sum(0)
    check(bool(torch.allclose(pair_sum, tp.rates.sum(0), rtol=1e-9, atol=0)),
          "per-pair totals do not add up to the flow rates")
    check(launches["bulk_hash"] == 4, "simulate_paper_paths is 4 launches")
    uplinks = torch.bincount(stages["uplink"].long(), minlength=16)
    check(int(uplinks.sum()) == GRID_FLOWS, "stage choices lost flows")
    # the card's sweeps agree with the CPU path (plain versions) on their
    # first two seeds, at full width
    cpu = dict(field_matrix=fm, hash_backend="murmur", device="cpu")
    cpu_fim = monte_carlo_fim(comp, flows, np.arange(2), **cpu)
    check(np.allclose(fim.aggregate[:2].cpu().numpy(),
                      cpu_fim.aggregate.numpy(), rtol=1e-12, atol=0),
          "FIM on the card != FIM on the CPU")
    cpu_tp = monte_carlo_throughput(comp, flows, np.arange(2), **cpu)
    check(np.allclose(tp.rates[:, :2].cpu().numpy(), cpu_tp.rates.numpy(),
                      rtol=1e-9, atol=0), "rates on the card != on the CPU")

    # where the time goes, outside the counted run: one throughput
    # chunk's walk, its link counts and its fill, each timed alone
    res, walk_s, walk_peak = timed(lambda: simulate_paths(
        comp, flows, np.arange(tp.seed_chunk), field_matrix=fm))
    _, counts_s, _ = timed(res.link_flow_counts)
    _, fill_s, fill_peak = timed(lambda: max_min_rates(res))
    del res

    fsum = fim.summary()["aggregate"]
    tsum = tp.summary()
    emit({"phase": "full_scale", "fabric": "multipod default",
          "devices": comp.num_devices, "links": comp.num_links,
          "flows": len(flows), "hops": int(hops), "setup_s": setup_s,
          "seed_cut": None,
          "monte_carlo_fim": {
              "seeds": FIM_SEEDS, "hash_backend": "murmur",
              "seed_chunk": fim.seed_chunk, "chunks": fim_chunks,
              "wall_s": fim_s, "peak_bytes": fim_peak,
              "launches": grid_after_fim, "aggregate": fsum},
          "monte_carlo_throughput": {
              "seeds": TP_SEEDS, "hash_backend": "murmur",
              "seed_chunk": tp.seed_chunk, "chunks": tp_chunks,
              "wall_s": tp_s, "peak_bytes": tp_peak,
              "launches": launches["murmur_hash_grid"] - grid_after_fim,
              "flow_rate": tsum["flow_rate"],
              "pair_total": tsum["pair_total"]},
          "simulate_paper_paths": {"wall_s": pp_s,
                                   "launches": launches["bulk_hash"]},
          "throughput_chunk_stages": {
              "seeds": tp.seed_chunk, "walk_s": walk_s,
              "link_counts_s": counts_s, "fill_s": fill_s,
              "fill_rounds": tp.fill_rounds, "walk_peak_bytes": walk_peak,
              "fill_peak_bytes": fill_peak},
          })
    return launches


def link_names(paths) -> dict:
    return {k: [ln.name for ln in v] for k, v in paths.items()}


def phase_fig3(np, torch):
    """The paper's Algorithm 1 and Fig. 3 comparison on the port: the
    hop-by-hop tracer against the vector engine's walks on the card
    (``exact``, the tracer's hash), static routing against an ECMP arm
    on the card (``murmur``, the murmur-grid kernel); returns the launch
    counts of the phase."""
    import repro_torch.core as T
    from repro_torch.kernels.flowhash import ops

    t_phase = time.perf_counter()
    ops.reset_launches()
    # 1. paper testbed: Algorithm 1 against the vector engine on the card
    fab = T.build_paper_testbed()
    comp = T.compile_fabric(fab)
    wl = T.bipartite_pairs([T.server_name(i) for i in range(8)],
                           [T.server_name(8 + i) for i in range(8)],
                           flows_per_pair=16)
    flows = T.synthesize_flows(wl, nic_ip=T.nic_ip, nics_per_server=2)
    t = time.perf_counter()
    traced = T.FlowTracer(fab, T.EcmpRouting(fab, seed=7), wl, flows,
                          num_threads=8).trace()
    trace_s = time.perf_counter() - t
    ecmp_fim = T.fim(traced.paths, fab)
    check(ecmp_fim == FIG3_FIM, f"tracer FIM {ecmp_fim!r} != {FIG3_FIM!r}")
    layers = {k: v for k, (v, _) in T.per_layer_fim(traced.paths,
                                                     fab).items()}
    check(layers == FIG3_LAYERS, f"tracer per-layer FIM {layers}")
    walks = {}
    for mode in (T.FIELDS_5TUPLE, T.FIELDS_VXLAN, T.FIELDS_IP_PAIR):
        res = T.simulate_paths(comp, flows, FIG3_SEEDS, fields=mode,
                               hash_backend="exact")
        check(res.link_ids.is_cuda, "the walk did not run on the card")
        for i, seed in enumerate(FIG3_SEEDS):
            want = T.FlowTracer(fab, T.EcmpRouting(fab, seed=seed,
                                                   fields=mode),
                                wl, flows).trace()
            check(link_names(res.paths_for_seed(i)) ==
                  link_names(want.paths),
                  f"{mode} seed {seed}: paths_for_seed != the tracer")
        walks[mode] = "identical"
    mc = T.monte_carlo_throughput(comp, flows, [7, 11, 42],
                                  hash_backend="exact")
    check(mc.per_pair.is_cuda and mc.num_seeds == 3, "throughput sweep")
    scalar = T.per_pair_throughput(flows, traced.paths)
    vec = mc.pair_throughput_for_seed(0)
    check(set(vec) == set(scalar), "pair sets differ")
    pair_err = max(abs(vec[p] - r) / r for p, r in scalar.items())
    check(pair_err <= 1e-9,
          f"pair_throughput_for_seed vs the scalar model: rel {pair_err:.3g}")

    # 2. static routing against the ECMP arm on the card
    t = time.perf_counter()
    table, static_paths = T.static_route_assignment(fab, flows)
    static_s = time.perf_counter() - t
    static_fim = T.fim(static_paths, fab)
    check(abs(static_fim) <= 1e-9, f"static FIM {static_fim!r}")
    check(len(table) == 1024, f"{len(table)} static table entries")
    static_pairs = T.per_pair_throughput(flows, static_paths)
    check(all(abs(r - 400.0) < 1e-6 for r in static_pairs.values()),
          "a static pair below 400 Gb/s")
    replay = T.FlowTracer(fab, T.StaticRouting(fab, table), wl, flows,
                          num_threads=8).trace()
    check(link_names(replay.paths) == link_names(static_paths),
          "StaticRouting through the tracer != the planned paths")
    _, greedy = T.static_route_assignment(fab, flows, mode="hop_greedy")
    greedy_fim = T.fim(greedy, fab)
    check(greedy_fim == FIG3_HOP_GREEDY, f"hop_greedy FIM {greedy_fim!r}")
    grid_before = ops.LAUNCHES["murmur_hash_grid"]
    t = time.perf_counter()
    arm = T.monte_carlo_fim(comp, flows, np.arange(1024))
    arm_mean = float(arm.aggregate.mean())
    arm_s = time.perf_counter() - t
    arm_launches = ops.LAUNCHES["murmur_hash_grid"] - grid_before
    check(arm_launches > 0, "the ECMP arm never launched the murmur kernel")
    rel = abs(arm_mean - ANCHORS["murmur"][0]) / ANCHORS["murmur"][0]
    check(rel <= ANCHOR_RTOL,
          f"ECMP arm FIM mean {arm_mean!r} != {ANCHORS['murmur'][0]!r}")
    reduction = arm_mean - static_fim
    check(reduction >= FIG3_REDUCTION_MIN, f"reduction {reduction!r}")

    # 3. the reduced multipod fabric of benchmarks/monte_carlo_fim.py
    mfab = T.build_multipod_fabric(num_pods=2, hosts_per_pod=16,
                                   leaves_per_pod=4, num_spines=8)
    mwl = T.bipartite_pairs([f"host-{i}" for i in range(16)],
                            [f"host-{16 + i}" for i in range(16)],
                            flows_per_pair=8)
    mflows = T.synthesize_flows(mwl, nic_ip=T.nic_ip, nics_per_server=1)
    check(len(mflows) == 256, f"{len(mflows)} reduced multipod flows")
    t = time.perf_counter()
    _, mstatic = T.static_route_assignment(mfab, mflows)
    mstatic_s = time.perf_counter() - t
    check(abs(T.fim(mstatic, mfab)) <= 1e-9, "multipod static FIM")
    mtraced = T.FlowTracer(mfab, T.EcmpRouting(mfab, seed=7), mwl, mflows,
                           num_threads=8).trace()
    mfim = T.fim(mtraced.paths, mfab)
    check(mfim == FIG3_MULTIPOD_FIM, f"multipod tracer FIM {mfim!r}")
    mres = T.simulate_paths(T.compile_fabric(mfab), mflows, [7],
                            hash_backend="exact")
    check(link_names(mres.paths_for_seed(0)) == link_names(mtraced.paths),
          "multipod: paths_for_seed != the tracer")

    # 4. full scale: the card's walk of seed 7 against traces of 8 host
    # pairs, one spread over processes started after the card's work
    big = T.build_multipod_fabric()
    bcomp = T.compile_fabric(big)
    bwl = T.bipartite_pairs([f"host-{i}" for i in range(64)],
                            [f"host-{64 + i}" for i in range(64)],
                            FLOWS_PER_PAIR)
    bflows = T.synthesize_flows(bwl, nic_ip=T.nic_ip, nics_per_server=1)
    check(len(bflows) == GRID_FLOWS, f"{len(bflows)} full-scale flows")
    bres, walk_s, _ = timed(lambda: T.simulate_paths(
        bcomp, bflows, [7], hash_backend="exact"))
    t = time.perf_counter()
    bpaths = bres.paths_for_seed(0)
    pfs_s = time.perf_counter() - t
    check(len(bpaths) == GRID_FLOWS, "paths_for_seed lost flows")
    sub = T.WorkloadDescription(pairs=bwl.pairs[:FIG3_PAIRS])
    keys = {(p.src, p.dst) for p in sub.pairs}
    sflows = [f for f in bflows if (f.src, f.dst) in keys]
    check(len(sflows) == FIG3_PAIRS * FLOWS_PER_PAIR, "traced flow count")
    routing = T.EcmpRouting(big, seed=7)
    t = time.perf_counter()
    par = T.FlowTracer(big, routing, sub, sflows, num_processes=4,
                       num_threads=4).trace()
    par_s = time.perf_counter() - t
    t = time.perf_counter()
    serial = T.FlowTracer(big, routing, sub, sflows).trace()
    serial_s = time.perf_counter() - t
    got = link_names(par.paths)
    check(got == link_names(serial.paths),
          "the process-parallel trace != the serial one")
    check(got == {k: [ln.name for ln in bpaths[k]] for k in got},
          "full scale: paths_for_seed != the tracer")
    launches = dict(ops.LAUNCHES)
    check(launches["murmur_hash_grid"] == arm_launches,
          "a murmur launch outside the ECMP arm")

    emit({"phase": "fig3", "fabric": "paper-testbed", "flows": len(flows),
          "tracer_fim_seed7": ecmp_fim, "tracer_per_layer_fim": layers,
          "trace_s": trace_s, "walks_vs_tracer": walks,
          "walk_seeds": [str(x) for x in FIG3_SEEDS],
          "pair_throughput_rel_err": pair_err,
          "static_fim": static_fim, "static_entries": len(table),
          "static_s": static_s, "hop_greedy_fim": greedy_fim,
          "ecmp_arm": {"seeds": 1024, "hash_backend": "murmur",
                       "fim_mean": arm_mean, "wall_s": arm_s,
                       "murmur_launches": arm_launches},
          "reduction_pct": reduction,
          "multipod_reduced": {"flows": len(mflows), "tracer_fim_seed7": mfim,
                               "static_fim": T.fim(mstatic, mfab),
                               "static_s": mstatic_s},
          "full_scale": {"flows": len(bflows), "walk_s": walk_s,
                         "traced_flows": len(sflows),
                         "trace_processes_s": par_s,
                         "trace_serial_s": serial_s},
          "paths_for_seed_s": pfs_s,
          "seconds": time.perf_counter() - t_phase})
    return launches


def anchor_flows(T):
    """The paper testbed's 256 bipartite flows (16 a host pair) with
    alternating 2**20 and 2**30 bytes: mice and elephants."""
    wl = T.bipartite_pairs([T.server_name(i) for i in range(8)],
                           [T.server_name(8 + i) for i in range(8)],
                           flows_per_pair=16)
    return [dataclasses.replace(f, bytes=2**20 if j % 2 == 0 else 2**30)
            for j, f in enumerate(T.synthesize_flows(
                wl, nic_ip=T.nic_ip, nics_per_server=2))]


def skewed_flows(T):
    """The full-scale flows with a 3:1 skew between alternate host pairs
    (``SKEW_FLOWS_PER_PAIR``), 102,400 in all."""
    pod0 = [f"host-{i}" for i in range(64)]
    pod1 = [f"host-{64 + i}" for i in range(64)]
    out = []
    for k, per_pair in enumerate(SKEW_FLOWS_PER_PAIR):
        part = T.synthesize_flows(
            T.bipartite_pairs(pod0[k::2], pod1[k::2], per_pair),
            nic_ip=T.nic_ip, nics_per_server=1)
        out += [dataclasses.replace(f, flow_id=len(out) + i)
                for i, f in enumerate(part)]
    return out


def smem_latency(torch) -> tuple[float, float]:
    """(cycles of one dependent shared-memory load, the SM clock in MHz
    by the probe's own timer): the placement library's pointer-chase
    probe, one warp, ``clock64`` over ``PROBE_STEPS`` loads, run twice."""
    from repro_torch.kernels.placement import build
    out = torch.zeros(34, dtype=torch.int64, device="cuda")
    for _ in range(2):
        rc = build.load().smem_latency_probe(
            out.data_ptr(), PROBE_STEPS,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"smem_latency_probe launch failed with {rc}")
        cycles, ns = out[:2].tolist()
    check(cycles > 0 and ns > 0, "the latency probe read no clock")
    return cycles / PROBE_STEPS, cycles / ns * 1e3


def sm_clock_during(torch, fn) -> float:
    """``nvidia-smi``'s ``clocks.sm`` in MHz, read while the card runs
    ``fn`` back to back (an idle card reads its idle clock)."""
    box = {}

    def query():
        box["mhz"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout

    fn()
    thread = threading.Thread(target=query)
    thread.start()
    while thread.is_alive():
        fn()
    thread.join()
    torch.cuda.synchronize()
    return float(box["mhz"].split()[0])


def check_ordered_sum(np, torch, T, comp, flows, fm):
    """The ordered load sum against its plain version (``torch.bincount``
    on the CPU) at the sprayed walk's shape: the (H, 819,200, 64) link ids
    of a ``prime-spray`` route of the full-scale flows over 64 seeds, with
    byte weights (alternating 2**20- and 2**30-byte flows, over K 8) and
    with log-normal weights (``exp(normal(0, 12))``), bit for bit and the
    same on a second run.  The card's atomic ``torch.bincount`` (the
    library call) must miss those bits under the log-normal weights, so
    the check can see a wrong order.  Returns the kernel's record (launch
    count filled in later), timed under the byte weights."""
    from repro_torch.kernels.loads import build, ops
    res = T.simulate_paths(comp, flows, np.arange(SPRAY_SEEDS),
                           strategy="prime-spray", field_matrix=fm,
                           hash_backend="murmur")
    ids = res.link_ids.contiguous()
    H, C, S = ids.shape
    L = comp.num_links
    b = np.where(np.arange(len(flows)) % 2 == 0, 2.0**20, 2.0**30)
    weights = {
        "bytes": (torch.from_numpy(b / b.mean()).cuda()[res.flow_index]
                  / 8).contiguous(),
        "lognormal": torch.from_numpy(np.exp(np.random.default_rng(26).normal(
            0, 12, C))).cuda()}
    del res
    ids_cpu = ids.cpu()
    # the library call's inputs: (seed, link) keys, a weight a cell
    off = torch.arange(S, device="cuda", dtype=torch.int32) * L
    keys = torch.where(ids >= 0, ids + off, S * L).reshape(-1)
    held, plain_s = {}, None
    for name, w in weights.items():
        got = ops.ordered_cell_sum(ids, w, L)
        t = time.perf_counter()
        want = ops.ordered_cell_sum(ids_cpu, w.cpu(), L)
        plain_s = plain_s or time.perf_counter() - t
        err = float((got.cpu() - want).abs().max())
        check(torch.equal(got.cpu(), want), f"ordered_cell_sum != plain "
              f"version under {name} weights (max error {err})")
        check(torch.equal(ops.ordered_cell_sum(ids, w, L), got),
              f"ordered_cell_sum differs between runs ({name})")
        cells = w[None, :, None].expand(H, C, S).reshape(-1)
        library = torch.bincount(keys, weights=cells,
                                 minlength=S * L + 1)[:S * L].cpu()
        held[name] = {"max_abs_err": err,
                      "library_bit_identical": bool(torch.equal(
                          library, want.reshape(-1))),
                      "library_max_abs_err": float(
                          (library - want.reshape(-1)).abs().max())}
        del got, want, cells, library
    check(not held["lognormal"]["library_bit_identical"],
          "torch.bincount on the card gave the ordered sums under "
          "log-normal weights: the check cannot see a wrong order")
    w = weights["bytes"]
    cells = w[None, :, None].expand(H, C, S).reshape(-1).contiguous()
    ms, library_ms = paired_ms(
        lambda: ops.ordered_cell_sum(ids, w, L),
        lambda: torch.bincount(keys, weights=cells, minlength=S * L + 1))
    m = ids.numel()
    longest = int(torch.bincount(keys, minlength=S * L + 1)[:S * L].max())
    probe = torch.zeros(3, dtype=torch.int64, device="cuda")
    for _ in range(2):                 # the first run warms the clock
        rc = build.load().dadd_latency_probe(
            probe.data_ptr(), PROBE_STEPS,
            torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"dadd_latency_probe launch failed with {rc}")
        torch.cuda.synchronize()
    add_ns = probe[1].item() / PROBE_STEPS
    fn_bytes = m * 4 + C * 8 + S * L * 8      # link ids, weights, sums
    b_ms, b_by = bound(fn_bytes, m, F64_FLOPS_PER_S)
    rec = {
        "name": "ordered_cell_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/loads/csrc/loads.cu",
        "replaces": "src/repro/core/strategies.py:261",
        "shape": [H, C, S], "cells": m, "bins": S * L,
        "max_abs_err": max(h["max_abs_err"] for h in held.values()),
        "ms": ms, "plain_ms": plain_s * 1e3,
        "bound_ms": b_ms, "bound_by": b_by, "bytes": fn_bytes,
        "library_ms": library_ms, "held": held,
        "library_bit_identical": held["bytes"]["library_bit_identical"],
        "longest_run": longest, "add_latency_ns": add_ns,
        "chain_floor_ms": longest * add_ns / 1e6}
    del keys, cells, ids, ids_cpu, weights
    return rec


def check_placement(np, torch, T, comp, flows, fm):
    """The sequential placement kernel against its plain version at the
    full-scale shape: 102,400 flows x 64 seeds on the ECMP loads of the
    same seeds, placing a residue mask as the wave's round cap does.
    Returns the kernel's record (launch count filled in later)."""
    from repro_torch.kernels.placement import ops, ref
    n, s, L = len(flows), SPRAY_SEEDS, comp.num_links
    seeds = np.arange(s)
    ecmp = T.simulate_paths(comp, flows, seeds, field_matrix=fm,
                            hash_backend="murmur")
    load = ecmp.link_flow_counts().to(torch.float64).contiguous()
    rng = np.random.default_rng(16)
    pick = rng.permutation(n)[:CHAIN_WHOLE_FLOWS + CHAIN_PART_FLOWS]
    mask = np.zeros((n, s), bool)
    mask[pick[:CHAIN_WHOLE_FLOWS]] = True
    part = pick[CHAIN_WHOLE_FLOWS:]
    mask[part] = rng.random((len(part), s)) < CHAIN_PART_SHARE
    tabs = comp.to("cuda")
    ends = [torch.from_numpy(np.asarray(e, np.int64)).cuda()
            for e in comp.flow_endpoint_ids(flows)]
    order = torch.arange(n, device="cuda")
    weight = torch.ones(n, dtype=torch.float64, device="cuda")
    fields = torch.from_numpy(fm.view(np.int64).copy()).cuda()
    seeds_t = torch.from_numpy(seeds.astype(np.int64)).cuda()
    mask_t = torch.from_numpy(mask).cuda()
    ids0 = torch.full((16, n, s), -1, dtype=torch.int32, device="cuda")

    def run(dev, load_in, ids_in):
        def on(t):
            return t if t is None else t.to(dev)
        return ops.congestion_place(
            *(on(t) for t in (tabs.cand, tabs.cand_n, tabs.dev_crc,
                              tabs.is_server, tabs.link_dst, fields,
                              seeds_t, *ends, weight, order)),
            load_in, ids_in, on(mask_t), num_keys=tabs.num_keys,
            c_max=tabs.c_max, max_hops=16, murmur=True)

    got_load, got_ids = load.clone(), ids0.clone()
    got = run("cuda", got_load, got_ids)
    want_load, want_ids = load.cpu(), ids0.cpu()
    t = time.perf_counter()
    want = run("cpu", want_load, want_ids)
    plain_s = time.perf_counter() - t
    check(got[1] is None and want[1] is None, f"placement faults {got[1]}")
    check(got[0] == want[0], f"placement hops {got[0]} != {want[0]}")
    check(torch.equal(got_ids.cpu(), want_ids),
          "congestion_place link ids != plain version")
    err = float((got_load.cpu() - want_load).abs().max())
    check(err == 0.0, f"congestion_place loads differ by {err}")

    # the wrapper (the tables packed, the inputs gathered, the launch and
    # the fault report), its inputs restored outside the timed span; and
    # the kernel's own device time, from the profiler
    times = []
    for _ in range(3):
        l_in, i_in = load.clone(), ids0.clone()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run("cuda", l_in, i_in)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    wrapper_ms = sorted(times)[1]
    prof = device_profile(
        lambda: [run("cuda", load.clone(), ids0.clone()) for _ in range(3)],
        groups={"kernel": ("congestion_place_kernel",)})
    k_s, k_n = prof["groups"]["kernel"]
    check(k_n == 3, f"profiled {k_n} placement kernels of 3")
    ms = k_s / k_n * 1e3
    # work of these inputs: per placed cell, each hop reads its
    # candidates' loads and compares them twice (the min and the ties)
    placed = int(mask.sum())
    hop_cells = int((want_ids >= 0).sum())
    placed_flows = int(mask.any(1).sum())
    F = fm.shape[1]
    bytes_moved = (placed_flows * (F + 6) * 8 + n * s   # fields, ends,
                   # weight, order of the placed flows; the mask
                   + 2 * s * L * 8                      # loads in and out
                   + hop_cells * 4                      # the paths written
                   + sum(t.numel() * t.element_size() for t in (
                       tabs.cand, tabs.cand_n, tabs.dev_crc, tabs.is_server,
                       tabs.link_dst)))
    b_ms, b_by = bound(bytes_moved, 2 * hop_cells * tabs.c_max,
                       F64_FLOPS_PER_S)
    # the latency bound: the longest seed's placed hops, each a chain of
    # CHAIN_DEPENDENT_LOADS shared-memory loads at the probe's latency,
    # at the SM clock nvidia-smi reads while the kernel runs
    seed_hops = int((want_ids >= 0).sum((0, 1)).max())
    mhz = sm_clock_during(torch, lambda: run("cuda", load.clone(),
                                             ids0.clone()))
    lat, probe_mhz = smem_latency(torch)
    chain_ms = seed_hops * CHAIN_DEPENDENT_LOADS * lat / (mhz * 1e3)
    _, offs = ops.pack_tables(tabs.cand, tabs.cand_n, tabs.dev_crc,
                              tabs.is_server, tabs.link_dst, tabs.c_max)
    pl = ops.plan(L, comp.num_devices, tabs.cand_n.numel(), offs["n_cands"])
    check(pl.shared_tables, "the multipod fabric's tables left shared memory")
    del got_ids, want_ids, ecmp
    return {
        "name": "congestion_place", "route": "cuda",
        "source": "src/repro_torch/kernels/placement/csrc/placement.cu",
        "replaces": "src/repro/core/strategies.py:467",
        "shape": [n, s, 16], "placed_cells": placed,
        "max_abs_err": err, "ms": ms, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "instance": "shared tables" if pl.shared_tables else "global tables",
        "warps": pl.warps, "smem_bytes": pl.smem_bytes,
        "max_seed_hops": seed_hops,
        "dependent_loads_per_hop": CHAIN_DEPENDENT_LOADS,
        "smem_latency_cycles": lat, "sm_clock_mhz": mhz,
        "probe_clock_mhz": probe_mhz, "chain_bound_ms": chain_ms,
        "chain_share": chain_ms / ms}


def phase_strategies(np, torch):
    """The routing strategies: the placement kernel and the ordered load
    sum against their plain versions, paper-testbed anchors, full-scale
    sweeps and the card against the CPU; returns the two kernels'
    records and the launch counts of the counted run (the full-scale
    sweeps)."""
    import repro_torch.core as T
    from repro_torch.kernels.flowhash import ops
    from repro_torch.kernels.loads import ops as loads_ops
    from repro_torch.kernels.placement import ops as pl_ops

    t_phase = time.perf_counter()
    big = T.compile_fabric(T.build_multipod_fabric())
    even = T.synthesize_flows(
        T.bipartite_pairs([f"host-{i}" for i in range(64)],
                          [f"host-{64 + i}" for i in range(64)],
                          FLOWS_PER_PAIR),
        nic_ip=T.nic_ip, nics_per_server=1)
    skew = skewed_flows(T)
    # the same skewed flows, alternating 2**20 and 2**30 bytes
    skew_bytes = [dataclasses.replace(f, bytes=2**20 if j % 2 == 0 else 2**30)
                  for j, f in enumerate(skew)]
    check(len(even) == len(skew) == GRID_FLOWS, "full-scale flow counts")
    fm_even = T.flow_fields_matrix(even, "5tuple")
    fm_skew = T.flow_fields_matrix(skew, "5tuple")
    record = check_placement(np, torch, T, big, even, fm_even)
    check_s = time.perf_counter() - t_phase
    t_sum = time.perf_counter()
    sum_record = check_ordered_sum(np, torch, T, big, even, fm_even)
    sum_check_s = time.perf_counter() - t_sum

    # 1. anchors against the JAX package's numpy engine (their launches,
    # at the paper testbed's shapes, are reported here and not counted
    # in the kernels line)
    ops.reset_launches()
    pl_ops.reset_launches()
    t_anchor = time.perf_counter()
    comp = T.compile_fabric(T.build_paper_testbed())
    flows = anchor_flows(T)
    seeds = np.arange(1024)
    anchors = {}
    for (name, demand), want in STRATEGY_ANCHORS.items():
        kw = dict(strategy=name, demand_mode=demand, hash_backend="murmur")
        (fim, tp), wall, _ = timed(lambda: (
            T.monte_carlo_fim(comp, flows, seeds, **kw),
            T.monte_carlo_throughput(comp, flows, seeds,
                                     transport="roce-nack", **kw)))
        got = (float(fim.aggregate.mean()), float(tp.goodput.mean()),
               float(np.percentile(tp.exposure.cpu().numpy(), 95)))
        for what, g, w in zip(("fim_mean", "goodput_mean", "exposure_p95"),
                              got, want):
            check(abs(g - w) <= ANCHOR_RTOL * abs(w),
                  f"{name} ({demand}) {what} {g!r} != {w!r}")
        anchors[name] = {"demand": demand, "fim_mean": got[0],
                         "goodput_mean": got[1], "exposure_p95": got[2],
                         "wall_s": wall}
    anchors_s = time.perf_counter() - t_anchor
    anchor_launches = {"grid_by_fields": dict(ops.GRID_LAUNCHES_BY_FIELDS),
                       "chain": pl_ops.LAUNCHES["congestion_place"]}

    # 2. full scale, the counted run: each strategy routes its seeds
    # once; FIM and throughput read the same routed result.  A spy times
    # each launch of the placement chain with CUDA events, so a route's
    # chain is taken apart from the rest of it
    ops.reset_launches()
    pl_ops.reset_launches()
    loads_ops.reset_launches()
    sweeps = (("prime-spray", "uniform", "even", even, fm_even),
              ("adaptive-spray", "uniform", "skewed 3:1", skew, fm_skew),
              ("adaptive-spray", "bytes", "skewed 3:1, 2**20 / 2**30 bytes",
               skew_bytes, fm_skew),
              ("congestion-aware", "uniform", "even", even, fm_even),
              ("wave-congestion-aware", "uniform", "even", even, fm_even))
    full = {}
    chain_ms = []
    place = pl_ops.congestion_place

    def timed_chain(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = place(*args, **kw)
        b.record()
        b.synchronize()
        chain_ms.append(a.elapsed_time(b))
        return out

    for name, demand, traffic, fl, fm in sweeps:
        grid0 = dict(ops.GRID_LAUNCHES_BY_FIELDS)
        chain0 = pl_ops.LAUNCHES["congestion_place"]
        sum0 = loads_ops.LAUNCHES["ordered_cell_sum"]
        chain_ms.clear()
        pl_ops.congestion_place = timed_chain
        try:
            res, route_s, route_peak = timed(lambda: T.simulate_paths(
                big, fl, np.arange(SPRAY_SEEDS), strategy=name,
                field_matrix=fm, hash_backend="murmur", demand_mode=demand))
        finally:
            pl_ops.congestion_place = place
        grid = {f: c - grid0.get(f, 0)
                for f, c in ops.GRID_LAUNCHES_BY_FIELDS.items()
                if c > grid0.get(f, 0)}
        chain = pl_ops.LAUNCHES["congestion_place"] - chain0
        ordered = loads_ops.LAUNCHES["ordered_cell_sum"] - sum0
        fim, fim_s, _ = timed(lambda: T.fim_vector(res))
        tp, tp_s, tp_peak = timed(lambda: T.throughput_from_result(
            res, transport="roce-nack"))
        hops, columns = res.link_ids.shape[0], res.num_flowlets
        walks = sum(grid.values())
        if name == "congestion-aware":
            check(walks == 0 and chain == 1,
                  f"{name}: {walks} grid and {chain} chain launches")
        else:
            check(walks >= hops, f"{name}: {walks} grid launches < {hops} hops")
        check(name != "adaptive-spray" or demand == "bytes"
              or res.rounds > 0, f"{name}: no re-spray round ran")
        check((ordered > 0) == name.startswith(("adaptive", "wave")),
              f"{name} ({demand}): {ordered} ordered load sums")
        check(len(chain_ms) == chain, f"{name}: chain spy saw {chain_ms}")
        check(chain == int(res.residue_placed or name == "congestion-aware"),
              f"{name}: {chain} placement launches")
        check(tuple(fim.shape) == (SPRAY_SEEDS,)
              and bool(torch.isfinite(fim).all()), f"{name} FIM")
        check(tuple(tp.rates.shape) == (GRID_FLOWS, SPRAY_SEEDS)
              and bool(torch.isfinite(tp.rates).all())
              and bool((tp.rates > 0).all()), f"{name} rates")
        check(bool((tp.exposure >= 0).all())
              and bool((tp.goodput <= tp.rates).all()),
              f"{name} exposure or goodput out of range")
        full[name if demand == "uniform" else f"{name} ({demand})"] = {
            "traffic": traffic, "demand": demand, "columns": columns,
            "hops": hops, "seeds": SPRAY_SEEDS, "route_s": route_s,
            "chain_ms": sum(chain_ms), "ordered_sums": ordered,
            "fim_s": fim_s,
            "throughput_s": tp_s, "wall_s": route_s + fim_s + tp_s,
            "peak_bytes": max(route_peak, tp_peak), "rounds": res.rounds,
            "residue_placed": res.residue_placed,
            "grid_launches_by_fields": grid, "chain_launches": chain,
            "fim_mean": float(fim.mean()),
            "goodput_mean": float(tp.goodput.mean()),
            "exposure_p95": float(np.percentile(
                tp.exposure.cpu().numpy(), 95))}
        del res, tp
    launches = {"murmur_hash_grid": ops.GRID_LAUNCHES_BY_FIELDS.get(5, 0),
                "murmur_hash_grid_f7": ops.GRID_LAUNCHES_BY_FIELDS.get(7, 0),
                "congestion_place": pl_ops.LAUNCHES["congestion_place"],
                "ordered_cell_sum": loads_ops.LAUNCHES["ordered_cell_sum"]}
    check(set(ops.GRID_LAUNCHES_BY_FIELDS) <= {5, 7},
          f"grid widths {sorted(ops.GRID_LAUNCHES_BY_FIELDS)}")

    # 3. the card against the CPU on one seed list, at full width (the
    # congestion-aware chain's CPU side takes about a minute at this
    # width; its kernel is held against the plain version above)
    t_check = time.perf_counter()
    vs_cpu = {}
    for name, demand, traffic, fl, fm in sweeps:
        if name == "congestion-aware":
            continue
        kw = dict(strategy=name, field_matrix=fm, hash_backend="murmur",
                  demand_mode=demand)
        card, card_s, _ = timed(lambda: T.simulate_paths(
            big, fl, CHECK_SEEDS, **kw))
        t = time.perf_counter()
        cpu = T.simulate_paths(big, fl, CHECK_SEEDS, device="cpu", **kw)
        cpu_s = time.perf_counter() - t
        check(torch.equal(card.link_ids.cpu(), cpu.link_ids),
              f"{name}: link ids on the card != on the CPU")
        check(card.rounds == cpu.rounds
              and card.residue_placed == cpu.residue_placed,
              f"{name}: rounds on the card != on the CPU")
        check(np.allclose(T.fim_vector(card).cpu().numpy(),
                          T.fim_vector(cpu).numpy(), rtol=1e-12, atol=0),
              f"{name}: FIM on the card != on the CPU")
        tp_card = T.throughput_from_result(card, transport="roce-nack")
        tp_cpu = T.throughput_from_result(cpu, transport="roce-nack")
        for what in ("rates", "goodput"):
            check(np.allclose(getattr(tp_card, what).cpu().numpy(),
                              getattr(tp_cpu, what).numpy(),
                              rtol=1e-9, atol=0),
                  f"{name}: {what} on the card != on the CPU")
        vs_cpu[name if demand == "uniform" else f"{name} ({demand})"] = {
            "traffic": traffic, "seeds": CHECK_SEEDS, "rounds": cpu.rounds,
            "card_route_s": card_s, "cpu_route_s": cpu_s,
            "link_ids": "identical"}
        del card, cpu
    # byte demand on the paper testbed's anchor flows over all 1,024
    # seeds: the re-spray rounds' load sums take the ordered-sum kernel
    # on the card, and its decisions are the CPU's
    bytes_vs_cpu = {}
    for name in ("adaptive-spray", "adaptive-spray-elephant"):
        kw = dict(strategy=name, demand_mode="bytes", hash_backend="murmur")
        loads_ops.reset_launches()
        card = T.simulate_paths(comp, flows, seeds, **kw)
        ordered = loads_ops.LAUNCHES["ordered_cell_sum"]
        cpu = T.simulate_paths(comp, flows, seeds, device="cpu", **kw)
        check(ordered > 0, f"{name} (bytes): no ordered load sum")
        check(card.link_ids.shape == cpu.link_ids.shape
              and torch.equal(card.link_ids.cpu(), cpu.link_ids)
              and card.rounds == cpu.rounds,
              f"{name} (bytes): link ids on the card != on the CPU")
        bytes_vs_cpu[name] = {"seeds": len(seeds), "rounds": cpu.rounds,
                              "ordered_sums": ordered,
                              "link_ids": "identical"}
    emit({"phase": "strategies", "fabric": "multipod default",
          "flows": GRID_FLOWS, "placement_check": {
              k: record[k] for k in ("shape", "placed_cells", "max_abs_err",
                                     "ms", "wrapper_ms", "plain_ms")},
          "placement_check_s": check_s, "ordered_sum_check": {
              k: sum_record[k] for k in ("shape", "max_abs_err", "ms",
                                         "library_ms", "plain_ms")},
          "ordered_sum_check_s": sum_check_s, "anchors": anchors,
          "anchor_rtol": ANCHOR_RTOL, "anchors_s": anchors_s,
          "anchor_launches": anchor_launches, "full_scale": full,
          "card_vs_cpu": vs_cpu, "bytes_card_vs_cpu": bytes_vs_cpu,
          "card_vs_cpu_s": time.perf_counter() - t_check,
          "seconds": time.perf_counter() - t_phase})
    return [record, sum_record], launches


class StageClock:
    """Host seconds a phased simulation spends in each stage: spies on
    ``core.timeline``'s ``simulate_paths`` (route), ``_fill_seeds``
    (the snapshot fill) and ``departure_fill`` (the drain), each ending
    in a synchronise, and the routed link ids of every step."""

    NAMES = {"simulate_paths": "route_s", "_fill_seeds": "fill_s",
             "departure_fill": "drain_s"}

    def __init__(self, torch, TL):
        self.torch, self.TL = torch, TL
        self.real = {n: getattr(TL, n) for n in self.NAMES}
        self.reset()

    def reset(self):
        self.seconds = dict.fromkeys(self.NAMES.values(), 0.0)
        self.link_ids = []

    def __enter__(self):
        for name, key in self.NAMES.items():
            setattr(self.TL, name, self._spy(self.real[name], key))
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.TL, name, fn)

    def _spy(self, fn, key):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.seconds[key] += time.perf_counter() - t
            if key == "route_s":
                self.link_ids.append(out.link_ids)
            return out
        return run


class WidestDrain:
    """Spies on ``kernels/drain/ops.departure_drain`` and keeps, for each
    label it is given (``label``; ``None`` keeps nothing), the arguments
    of the widest call: the drain's inputs at a drive's widest step."""

    def __init__(self, drain_ops):
        self.ops, self.real = drain_ops, drain_ops.departure_drain
        self.label, self.args = None, {}

    def __enter__(self):
        def spy(*args, **kw):
            kept = self.args.get(self.label)
            if self.label is not None and (
                    kept is None or args[0].shape[1] > kept[0].shape[1]):
                self.args[self.label] = args
            return self.real(*args, **kw)
        self.ops.departure_drain = spy
        return self

    def __exit__(self, *exc):
        self.ops.departure_drain = self.real


def full_width_schedules(T) -> dict:
    """The full-width LLM job's flows and steps per schedule mode."""
    out = {}
    for mode in ("sequential", "dp-overlap"):
        _, flows, _, sched = T.multipod_llm_schedule(
            mode, num_hosts=TL_HOSTS, param_bytes=TL_PARAM_BYTES)
        out[mode] = (flows, sched)
    return out


def widest_drains(np, torch, names=DRAIN_SHAPES) -> dict:
    """The drain's inputs at the widest step of each named strategy's
    full-width drive (the sequential schedule, 64 seeds, as the timeline
    phase drives it)."""
    import repro_torch.core as T
    from repro_torch.kernels.drain import ops as drain_ops
    big = T.compile_fabric(T.build_multipod_fabric())
    flows, sched = full_width_schedules(T)["sequential"]
    with WidestDrain(drain_ops) as widest:
        for name in names:
            widest.label = name
            T.simulate_timeline(big, flows, sched, np.arange(TL_SEEDS),
                                strategy=name, demand_mode="bytes",
                                transport="roce-nack", hash_backend="murmur",
                                timing="event")
    torch.cuda.synchronize()
    return widest.args


def cut_drain(torch, args, n_seeds: int, per_seed: int) -> tuple:
    """The drain's inputs cut to their first ``n_seeds`` seeds and the
    first ``per_seed`` cells of each (no-link ids renumbered)."""
    cells, seed, S, cap, gbits, eff, w, init, max_rounds = args
    L = cap.numel()
    start = torch.zeros(S + 1, dtype=torch.int64, device=seed.device)
    torch.cumsum(torch.bincount(seed, minlength=S), 0, out=start[1:])
    pos = torch.arange(seed.numel(), device=seed.device) - start[seed]
    keep = (seed < n_seeds) & (pos < per_seed)
    cut = cells[:, keep]
    return (torch.where(cut >= S * L, n_seeds * L, cut), seed[keep], n_seeds,
            cap, gbits[keep], eff[keep], None if w is None else w[keep],
            None if init is None else init[keep], max_rounds)


def phase_timeline(np, torch):
    """The phased LLM training step: anchors against the JAX package's
    numpy engine under both hash backends and both timings, the
    departure drain's analytic case, the full-width job over 64 seeds
    per strategy, and ECMP and the wave at full width on the card and
    the CPU; returns the launch counts of the phase."""
    import repro_torch.core as T
    import repro_torch.core.timeline as TL
    from repro_torch.kernels.drain import ops as drain_ops
    from repro_torch.kernels.flowhash import ops
    from repro_torch.kernels.loads import ops as loads_ops
    from repro_torch.kernels.placement import ops as pl_ops

    t_phase = time.perf_counter()
    ops.reset_launches()
    pl_ops.reset_launches()
    loads_ops.reset_launches()
    drain_ops.reset_launches()

    def close(got, want, what):
        check(abs(got - want) <= ANCHOR_RTOL * abs(want),
              f"timeline {what}: {got!r} != {want!r}")

    # 1. the departure drain's two-flow analytic case, on the card
    two = T.departure_fill(torch.zeros((1, 2, 3), dtype=torch.int64,
                                       device="cuda"), [100.0], [8.0, 24.0])
    check(two.completion.device.type == "cuda"
          and np.allclose(two.completion.cpu().numpy(),
                          [[0.16] * 3, [0.32] * 3], rtol=0, atol=1e-12)
          and two.rounds == 2, f"two-flow drain {two}")

    # 2. anchors at the bench shapes
    t_anchor = time.perf_counter()
    seeds = np.arange(TIMELINE_ANCHOR_SEEDS)
    paper = T.compile_fabric(T.build_paper_testbed())
    _, pflows, _, psched = T.paper_testbed_llm_schedule()
    check(len(pflows) == 336 and len(psched) == 5, "paper LLM schedule")
    big = T.compile_fabric(T.build_multipod_fabric())
    _, mflows, _, _ = T.multipod_llm_schedule(param_bytes=TL_PARAM_BYTES)
    sub = [f for f in mflows if T.flow_channel(f) in (T.CH_GRAD_AR,
                                                       T.CH_MOE_A2A)]
    two_steps = [T.TimelineStep("grad-all-reduce", (T.CH_GRAD_AR,)),
                 T.TimelineStep("moe-all-to-all", (T.CH_MOE_A2A,))]
    check(len(sub) == 520, f"{len(sub)} disjoint-elephant flows")
    anchors = {}
    for backend in ("exact", "murmur"):
        kw = dict(demand_mode="bytes", transport="roce-nack",
                  strategy="prime-spray-elephant", hash_backend=backend)
        st = T.simulate_timeline(paper, pflows, psched, seeds, **kw)
        ev = T.simulate_timeline(paper, pflows, psched, seeds,
                                 timing="event", **kw)
        got = (float(st.fim.mean()), float(st.goodput.mean()),
               float(ev.job_completion.mean()), float(ev.fim.mean()))
        for what, g, w in zip(("static FIM", "static goodput", "event JCT",
                               "event FIM"), got, TIMELINE_PAPER[backend]):
            close(g, w, f"paper {backend} {what}")
        row = {"paper": dict(zip(("static_fim", "static_goodput",
                                  "event_jct_s", "event_fim"), got))}
        for name in ("ecmp", "prime-spray", "wave-congestion-aware"):
            tl = T.simulate_timeline(big, sub, two_steps, seeds,
                                     demand_mode="bytes", strategy=name,
                                     timing="event", hash_backend=backend)
            jct = float(tl.job_completion.mean())
            close(jct, TIMELINE_MULTIPOD_JCT[backend, name],
                  f"multipod {backend} {name} JCT")
            row[name] = {"jct_s": jct, "drain_rounds": [
                sr.drain_rounds for sr in tl.steps]}
        anchors[backend] = row
    kw = dict(demand_mode="bytes", hash_backend="exact")
    merged = float(T.simulate_timeline(big, sub, [T.merged_step(two_steps)],
                                       seeds, **kw).fim.mean())
    phased = float(T.simulate_timeline(big, sub, two_steps, seeds,
                                       **kw).fim.mean())
    close(merged, TIMELINE_MERGED_FIM, "merged FIM")
    close(phased, TIMELINE_PHASED_FIM, "phased FIM")
    anchors_s = time.perf_counter() - t_anchor

    # 3. full width, 64 seeds per strategy; the adaptive drives' seeds
    # are cut if the phase would pass its budget
    t_full = time.perf_counter()
    schedules = full_width_schedules(T)
    check(len(schedules["sequential"][0]) == TL_FLOWS
          and len(schedules["sequential"][1]) == TL_STEPS,
          "full-width LLM schedule")
    full, cuts = {}, {}
    clock = StageClock(torch, TL)
    spray_s = None
    # the drain's inputs at ECMP's and prime-spray's widest steps, kept
    # for the kernel's checks against its plain version
    with WidestDrain(drain_ops) as widest:
        for name, mode in TL_SWEEPS:
            widest.label = (name if mode == "sequential" and name in DRAIN_SHAPES
                            else None)
            flows, sched = schedules[mode]
            n_seeds = TL_SEEDS
            if name == "adaptive-spray" and spray_s is not None:
                # an adaptive drive drains each step twice (round 1, then
                # its RTT budget), the second time over more departure
                # epochs; the adaptive drives share what is left
                adaptive_left = sum(n == name for n, _ in TL_SWEEPS[
                    TL_SWEEPS.index((name, mode)):])
                left = (TL_BUDGET_S - (time.perf_counter() - t_phase)
                        - TL_CHECK_RESERVE_S) / adaptive_left
                need = TL_ADAPTIVE_OVER_SPRAY * spray_s
                if need > left:
                    n_seeds = min(TL_SEEDS, max(8, int(
                        TL_SEEDS * max(left, 0.0) / need) // 8 * 8))
                    cuts[f"{name} ({mode})"] = {"from": TL_SEEDS, "to": n_seeds,
                                                "predicted_s": need,
                                                "left_s": left}
                    print(f"timeline: {name} ({mode}) cut from {TL_SEEDS} to "
                          f"{n_seeds} seeds (predicted {need:.1f} s, "
                          f"{left:.1f} s left)", flush=True)
            grid0 = dict(ops.GRID_LAUNCHES_BY_FIELDS)
            chain0 = pl_ops.LAUNCHES["congestion_place"]
            sum0 = loads_ops.LAUNCHES["ordered_cell_sum"]
            clock.reset()
            with clock:
                tl, wall, peak = timed(lambda: T.simulate_timeline(
                    big, flows, sched, np.arange(n_seeds), strategy=name,
                    demand_mode="bytes", transport="roce-nack",
                    hash_backend="murmur", timing="event"))
            jct = tl.job_completion.cpu().numpy()
            check(jct.shape == (n_seeds,) and np.isfinite(jct).all()
                  and (jct > 0).all(), f"{name} ({mode}) JCT")
            check(torch.equal(tl.step_ends[-1], tl.job_completion),
                  f"{name} ({mode}) step ends")
            if name == "prime-spray":
                spray_s = wall
            jct_mean, jct_p99 = float(jct.mean()), float(np.percentile(jct, 99))
            if n_seeds == TL_SEEDS:
                # uncut drives give the first design's job completion times
                for what, got, want in zip(("mean", "p99"), (jct_mean, jct_p99),
                                           TL_JCT_FIRST_DESIGN[name, mode]):
                    check(abs(got - want) <= JCT_RTOL * want,
                          f"{name} ({mode}) JCT {what} {got!r} != {want!r}")
            full[f"{name} ({mode})"] = {
                "seeds": n_seeds, "steps": [s.name for s in sched],
                "columns": [int(ids.shape[1]) for ids in clock.link_ids],
                "wall_s": wall, **clock.seconds, "peak_bytes": peak,
                "drain_rounds": [sr.drain_rounds for sr in tl.steps],
                "fill_rounds": [sr.fill_rounds for sr in tl.steps],
                "jct_mean_s": jct_mean, "jct_p99_s": jct_p99,
                "jct_held_to_first_design": n_seeds == TL_SEEDS,
                "step_duration_mean_s": tl.step_durations.mean(1).tolist(),
                "fim_mean": float(tl.fim.mean()),
                "goodput_mean": float(tl.goodput.mean()),
                "grid_launches_by_fields": {
                    f: c - grid0.get(f, 0)
                    for f, c in ops.GRID_LAUNCHES_BY_FIELDS.items()
                    if c > grid0.get(f, 0)},
                "chain_launches": pl_ops.LAUNCHES["congestion_place"] - chain0,
                "ordered_sums": loads_ops.LAUNCHES["ordered_cell_sum"] - sum0}
            del tl
    full_s = time.perf_counter() - t_full

    # 4. ECMP and the wave at full width, seeds 0 and 1, card and CPU
    t_check = time.perf_counter()
    vs_cpu = {}
    flows, sched = schedules["sequential"]
    for name in TL_CHECK:
        kw = dict(strategy=name, demand_mode="bytes", transport="roce-nack",
                  hash_backend="murmur", timing="event")
        clock.reset()
        with clock:
            card = T.simulate_timeline(big, flows, sched, CHECK_SEEDS, **kw)
        card_ids = [ids.cpu() for ids in clock.link_ids]
        clock.reset()
        t = time.perf_counter()
        with clock:
            cpu = T.simulate_timeline(big, flows, sched, CHECK_SEEDS,
                                      device="cpu", **kw)
        cpu_s = time.perf_counter() - t
        check(len(card_ids) == len(clock.link_ids) == TL_STEPS,
              f"{name}: {len(card_ids)} routed steps")
        for k, (a, b) in enumerate(zip(card_ids, clock.link_ids)):
            check(torch.equal(a, b),
                  f"{name} step {k}: link ids on the card != on the CPU")
        for k, (a, b) in enumerate(zip(card.steps, cpu.steps)):
            check(np.allclose(a.completion.cpu().numpy(),
                              b.completion.numpy(), rtol=1e-9, atol=0),
                  f"{name} step {k}: completion on the card != on the CPU")
        for what in ("step_durations", "job_completion"):
            check(np.allclose(getattr(card, what).cpu().numpy(),
                              getattr(cpu, what).numpy(), rtol=1e-9, atol=0),
                  f"{name}: {what} on the card != on the CPU")
        vs_cpu[name] = {"seeds": CHECK_SEEDS, "link_ids": "identical",
                        "cpu_s": cpu_s,
                        "jct_s": card.job_completion.tolist(),
                        "drain_rounds_card": [s.drain_rounds
                                              for s in card.steps],
                        "drain_rounds_cpu": [s.drain_rounds
                                             for s in cpu.steps]}
    check_s = time.perf_counter() - t_check

    launches = {"murmur_hash_grid": ops.GRID_LAUNCHES_BY_FIELDS.get(5, 0),
                "murmur_hash_grid_f7": ops.GRID_LAUNCHES_BY_FIELDS.get(7, 0),
                "congestion_place": pl_ops.LAUNCHES["congestion_place"],
                "ordered_cell_sum": loads_ops.LAUNCHES["ordered_cell_sum"],
                "departure_drain": drain_ops.LAUNCHES["departure_drain"]}
    for k, v in launches.items():
        check(v > 0, f"the timeline phase never launched {k}")
    record = check_drain(np, torch, drain_ops, widest.args["ecmp"],
                         widest.args["prime-spray"])
    del widest
    emit({"phase": "timeline", "fabric": "multipod default",
          "two_flow_drain_s": two.completion[:, 0].tolist(),
          "anchors": anchors, "merged_fim": merged, "phased_fim": phased,
          "anchor_rtol": ANCHOR_RTOL, "anchors_s": anchors_s,
          "full_width": {"hosts": TL_HOSTS, "flows": TL_FLOWS,
                         "steps": TL_STEPS, "sweeps": full,
                         "seed_cut": cuts or None, "seconds": full_s},
          "card_vs_cpu": vs_cpu, "card_vs_cpu_s": check_s,
          "launches": launches, "drain_check": {
              k: record[k] for k in ("shape", "max_abs_err", "max_rel_err",
                                     "rounds", "ms", "plain_ms")},
          "drain_spray_check": {
              k: record["spray"][k] for k in (
                  "shape", "cut", "max_rel_err", "cut_rounds", "ms",
                  "cut_ms", "cut_plain_ms")},
          "seconds": time.perf_counter() - t_phase})
    return record, launches


def drain_bytes(args) -> int:
    """Bytes the drain must move: its inputs read once (int64 cells,
    segment offsets, capacities, gigabits, efficiency and the optional
    weights and round-1 rates) and its completion times written once,
    with the statistics."""
    cells, n_seeds, L = args[0], args[2], args[3].numel()
    H, A = cells.shape
    return (H * A * 4 + (n_seeds + 1) * 8 + L * 8
            + A * 8 * (3 + sum(a is not None for a in args[6:8]))
            + A * 8 + n_seeds * 32)


def check_drain(np, torch, drain_ops, args, spray_args):
    """The drain kernel against its plain version on the card, on the
    inputs the main path gave it at ECMP's widest step (the MoE
    all-to-all: 4,096 columns x 64 seeds) and, cut to its first
    ``DRAIN_CUT_SEEDS`` seeds and ``DRAIN_CUT_CELLS`` cells a seed under
    the uncut step's cluster, at prime-spray's (32,768 columns x 64
    seeds): completion times within 1e-9 relative; timed with CUDA
    events, uncut at both.  Drain rounds are reported, not compared:
    finish times within 1e-12 of a horizon depart together, and both
    sides' float atomics can move a finish across that line.  Beside the
    operations bound (the float64 operations the inputs' cells and links
    need), a latency bound: the longest seed's drain and freeze rounds,
    each at the cost of one cluster-wide reduction that
    ``drain_sync_probe`` measures at the same launch shape."""
    from repro_torch.kernels.drain import build
    from repro_torch.kernels.drain.ref import departure_drain_ref

    report, warnings = ptxas_report(
        build.build().with_suffix(".log").read_text(), "drain_kernel")
    check(sorted(report) == ["1", "2"],
          f"drain_kernel instances {sorted(report)} are not 1 and 2 chunks")
    for inst, r in report.items():
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"drain_kernel<{inst}> spills: {r}")

    def held(args, cluster=None):
        """The kernel against one event-timed run of the plain version."""
        got = drain_ops.departure_drain(*args, cluster=cluster)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        want_done, want_rounds, want_fills = departure_drain_ref(*args)
        b.record()
        b.synchronize()
        err = (got.done - want_done).abs()
        rel = float((err / want_done.abs().clamp(min=1e-300)).max())
        check(rel <= 1e-9, f"departure_drain != plain version: {rel} "
              f"relative ({got.rounds} against {want_rounds} rounds)")
        return got, float(err.max()), rel, want_rounds, want_fills, \
            a.elapsed_time(b)

    def timing(args, reps):
        """The kernel's uncut record at ``args``: ms, bounds, plan."""
        H, A = args[0].shape
        S, L = args[2], args[3].numel()
        per_seed = int(torch.bincount(args[1], minlength=S).max())
        pl = drain_ops.plan(S, per_seed, L, H)
        got = drain_ops.departure_drain(*args)
        ms = cuda_ms(lambda: drain_ops.departure_drain(*args), reps)
        b_ms, b_by = bound(drain_bytes(args), got.flops, F64_FLOPS_PER_S)
        probe = drain_ops.sync_probe_ms(pl, S, L, DRAIN_PROBE_ITERS)
        return pl, {
            "shape": [H, A, S, L], "plan": dataclasses.asdict(pl),
            "rounds": got.rounds, "fill_rounds": got.fill_rounds,
            "chain_rounds": got.chain, "ms": ms,
            "us_per_freeze_round": ms * 1e3 / max(got.fill_rounds, 1),
            "bound_ms": b_ms, "bound_by": b_by, "flops": got.flops,
            "reduction_ms": probe, "chain_bound_ms": got.chain * probe,
            "chain_share": got.chain * probe / ms}

    pl, rec = timing(args, 5)
    got, abs_err, rel, want_rounds, want_fills, plain_ms = held(args)
    rec.update({
        "name": "departure_drain", "route": "cuda",
        "source": "src/repro_torch/kernels/drain/csrc/drain.cu",
        "replaces": "src/repro/core/vector_throughput.py:395",
        "rounds": [got.rounds, want_rounds],
        "fill_rounds": [got.fill_rounds, want_fills],
        "max_abs_err": abs_err, "max_rel_err": rel, "plain_ms": plain_ms,
        "library_ms": None})
    spray_pl, spray = timing(spray_args, 3)
    cut = cut_drain(torch, spray_args, DRAIN_CUT_SEEDS, DRAIN_CUT_CELLS)
    check(int(torch.bincount(cut[1]).min()) // spray_pl.cluster
          > drain_ops.THREADS, "the cut keeps no more cells a CTA than "
          "threads")
    print(f"timeline: the drain's check at prime-spray's widest step cut to "
          f"{DRAIN_CUT_SEEDS} seeds x {DRAIN_CUT_CELLS} cells (cluster "
          f"{spray_pl.cluster})", flush=True)
    got, abs_err, rel, want_rounds, want_fills, plain_ms = held(
        cut, spray_pl.cluster)
    spray.update({
        "cut": [DRAIN_CUT_SEEDS, DRAIN_CUT_CELLS, spray_pl.cluster],
        "cut_rounds": [got.rounds, want_rounds],
        "cut_fill_rounds": [got.fill_rounds, want_fills],
        "max_abs_err": abs_err, "max_rel_err": rel,
        "cut_plain_ms": plain_ms,
        "cut_ms": cuda_ms(lambda: drain_ops.departure_drain(
            *cut, cluster=spray_pl.cluster), 3)})
    rec["spray"] = spray
    emit({"phase": "ptxas", "kernel": "drain_kernel", "instances": report,
          "smem_bytes": {"ecmp": pl.smem_bytes,
                         "prime-spray": spray_pl.smem_bytes},
          "warnings": [w for w in warnings if "drain" in w]})
    return rec


def ptxas_report(log: str, kernel: str) -> tuple[dict, list]:
    """Registers and spill bytes of each instance of ``kernel`` in an
    ``nvcc -Xptxas -v`` log, keyed by its template arguments ("64 128 3
    3": the bf16 kernel's head dim, keys, stages and consumer
    warpgroups), and the log's warnings."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            name = None
            if kernel in m.group(1):
                name = " ".join(re.findall(r"Li(\d+)E", m.group(1)
                                           .split(kernel, 1)[1]))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out, [ln.strip() for ln in log.splitlines()
                 if "arning" in ln or "Performance Loss" in ln]


def phase_flash(np, torch):
    """The flash-attention kernel against its plain version on the card
    in bf16 and f32; returns its records at the two serving shapes, hd
    64 and hd 128 (launch counts filled in later)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import build, ops, ref

    # the bf16 instances as the compiler built them (head dim, keys,
    # stages, consumers): one a head dim, with the tiles the wrapper's
    # constants name, no spills and no serialised wgmma
    report, warnings = ptxas_report(
        build.build().with_suffix(".log").read_text(), "flash_fwd_bf16")
    emit({"phase": "ptxas", "kernel": "flash_fwd_bf16", "instances": report,
          "warnings": warnings})
    check(sorted(report) == sorted(
        f"{hd} {bk} {stages} {bq // 64}"
        for hd, (bq, bk, stages) in ops.BF16_TILES.items()),
          f"bf16 instances {sorted(report)} are not ops.BF16_TILES "
          f"{ops.BF16_TILES}")
    for inst, r in report.items():
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"flash_fwd_bf16<{inst}> spills: {r}")
    check(not [w for w in warnings if "flash_fwd_bf16" in w],
          f"ptxas warns on the bf16 kernel: {warnings}")
    gen = torch.Generator(device="cuda").manual_seed(11)

    def qkv(B, S, dtype, heads=FLASH_HEADS, kv_heads=FLASH_KV_HEADS,
            hd=FLASH_HD):
        return [torch.randn((B, h, S, hd), generator=gen,
                            device="cuda").to(dtype)
                for h in (heads, kv_heads, kv_heads)]

    def cost(q, k, causal):
        """(bytes of q, k, v and o, flops of the unmasked q-k pairs)."""
        B, H, S, hd = q.shape
        pairs = S * (S + 1) // 2 if causal else S * S
        return ((2 * q.numel() + 2 * k.numel()) * q.element_size(),
                4 * hd * pairs * B * H)

    failures = []

    def errs_of(got, want, what):
        """(max |got - want|, max row error); a miss of either tolerance
        is a failure."""
        tol, row_tol = FLASH_TOL[str(got.dtype)[6:]], ref.ROW_RTOL[got.dtype]
        row = float(ref.row_errors(got, want).max())
        got, want = got.float(), want.float()
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            failures.append(f"flash attention ({what}) != plain version "
                            f"beyond {tol} + {tol} |want|")
        if not row <= row_tol:
            failures.append(f"flash attention ({what}): a row differs from "
                            f"the plain version's by {row} > {row_tol}")
        return float((got - want).abs().max()), row

    def check_shape(dtype, S, causal):
        q, k, v = qkv(1, S, getattr(torch, dtype))
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention_ref(q, k, v, causal=causal)
        peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        b_ms, b_by = bound(*cost(q, k, causal), peak)
        err, row = errs_of(got, want, f"{dtype}, S {S}, causal {causal}")
        return {
            "dtype": dtype, "S": S, "causal": causal,
            "max_abs_err": err, "max_row_err": row,
            "ms": cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal),
                          10),
            "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), 3),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), 10),
            "bound_ms": b_ms, "bound_by": b_by}

    checks = [check_shape(dtype, S, causal)
              for dtype in ("bfloat16", "float32")
              for S, causal in ((4096, True), (4096, False), (1000, True))]

    def serving_shape(name, heads, kv_heads, hd):
        """A served prefill's attention: 2 x ``heads`` over ``kv_heads``,
        S 32,768, causal bf16.  Every row is held against the plain
        version (timed in the same run), and the last BAND rows also
        against a plain computation of those rows alone; a planted
        skipped key tile must fail the row check; the kernel is timed
        against SDPA in alternating rounds.  Returns (kernels-line
        record, phase record)."""
        S, off = PREFILL_LEN, PREFILL_LEN - BAND
        q, k, v = qkv(PREFILL_BATCH, S, torch.bfloat16, heads, kv_heads, hd)
        got = ops.flash_attention(q, k, v)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = ref.flash_attention_ref(q, k, v)
        b.record()
        b.synchronize()
        plain_ms = a.elapsed_time(b)
        full = errs_of(got, want, f"hd {hd}, S {S}, causal")
        del want
        got = got[:, :, off:]
        want = ref.flash_attention_ref(q[:, :, off:], k, v, q_offset=off)
        band = errs_of(got, want, f"hd {hd}, S {S}, band")
        # a planted fault: the band's output with the middle key tile (as
        # many keys as the bf16 kernel stages at a time) skipped must fail
        # the row check
        bq, tile, stages = ops.BF16_TILES[hd]
        k0 = S // 2
        kd, vd = (torch.cat([t[:, :, :k0], t[:, :, k0 + tile:]], 2)
                  for t in (k, v))
        bad = ref.flash_attention_ref(q[:, :, off:], kd, vd,
                                      q_offset=off - tile)
        bad_row = float(ref.row_errors(bad, want).max())
        bad_abs = float((bad.float() - want.float()).abs().max())
        if not bad_row > ref.ROW_RTOL[torch.bfloat16]:
            failures.append(f"the row check passes a skipped key tile at hd "
                            f"{hd} ({bad_row})")
        del got, want, kd, vd, bad
        b_ms, b_by = bound(*cost(q, k, True), BF16_FLOPS_PER_S)
        # one exponential a query-key pair the causal mask keeps
        exps = PREFILL_BATCH * heads * S * (S + 1) // 2
        ms, library_ms = paired_ms(
            lambda: ops.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True))
        record = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "shape": [PREFILL_BATCH, heads, kv_heads, PREFILL_LEN, hd],
            "dtype": "bfloat16", "causal": True, "max_abs_err": full[0],
            "max_row_err": full[1], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "ms_over_library": ms / library_ms}
        info = {"heads": [heads, kv_heads], "hd": hd,
                "tiles": {"query_rows": bq, "keys": tile, "stages": stages},
                "exponentials": exps, "exp_bound_ms": exps / EXP_PER_S * 1e3,
                "full": {"S": S, "batch": PREFILL_BATCH,
                         "max_abs_err": full[0], "max_row_err": full[1]},
                "band": {"S": S, "rows": BAND, "max_abs_err": band[0],
                         "max_row_err": band[1]},
                "planted_skipped_tile": {"key_tile": [k0, k0 + tile],
                                         "max_abs_err": bad_abs,
                                         "max_row_err": bad_row}}
        return record, info

    record, info = serving_shape("flash_attention", FLASH_HEADS,
                                 FLASH_KV_HEADS, FLASH_HD)
    record128, info128 = serving_shape("flash_attention_hd128", *FLASH_HD128)
    # qwen2-vl-72b's (and qwen2-72b's) grouping, held and timed the same
    # way; it is the hd-128 instance, so it has no row of its own on the
    # kernels line
    g8, info_g8 = serving_shape("flash_attention_hd128_g8", *FLASH_HD128_G8)
    emit({"phase": "kernels", "kernel": "flash_attention", "tol": FLASH_TOL,
          "row_tol": {str(d)[6:]: t for d, t in ref.ROW_RTOL.items()},
          **info, "checks": checks, "hd128": info128,
          "hd128_g8": {**info_g8, **{k: g8[k] for k in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "ms_over_library")}}})
    check(not failures, "; ".join(failures))
    return [record, record128]


def ssd_inputs(torch, B, S, dtype, seed):
    """x (B, S, H, hd) N(0, 1) * 0.5 and Bm, Cm (B, S, N) N(0, 1) * 0.3 in
    ``dtype``; in f32, dt (B, S, H) as the model makes it with Mamba-2's
    init, softplus(z + dt_bias) with z ~ N(0, 1) and each head's dt_bias
    softplus^-1 of a log-uniform draw in DT_RANGE, and A =
    -exp(log(linspace(1, 16, H))) (mamba2's A_log)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    H, hd, N = SSD_HEADS, SSD_HD, SSD_STATE
    x = (torch.randn((B, S, H, hd), generator=gen, device="cuda") * 0.5
         ).to(dtype)
    lo, hi = (float(v) for v in torch.log(torch.tensor(DT_RANGE)))
    u = torch.exp(torch.empty(H, device="cuda").uniform_(lo, hi, generator=gen))
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device="cuda")
        + torch.log(torch.expm1(u)))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device="cuda")))
    Bm, Cm = ((torch.randn((B, S, N), generator=gen, device="cuda") * 0.3)
              .to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


def ssd_chunks(x, dt, A, Bm, Cm):
    """The intra-chunk contract as views of the sequence-major tensors
    (what ``ops.ssd_scan`` hands the kernel)."""
    B, S, H, hd = x.shape
    Q, N = SSD_CHUNK, Bm.shape[-1]
    nc = S // Q
    a = (dt * A).view(B, nc, Q, H).permute(0, 3, 1, 2)[..., None]
    return (a, dt.view(B, nc, Q, H).permute(0, 3, 1, 2)[..., None],
            Bm.view(B, nc, Q, N), Cm.view(B, nc, Q, N),
            x.view(B, nc, Q, H, hd).permute(0, 3, 1, 2, 4))


def phase_ssd(np, torch):
    """The SSD intra-chunk kernel against its plain version on the card
    in bf16 and f32, alone and inside the whole scan; returns its record
    at the serving path's shape (launch count filled in later)."""
    from repro_torch.kernels.ssd import build, ops, ref

    # the bf16 bodies as the compiler built them, (Q, N, hd, heads a
    # block) on wgmma and (Q, N, hd) on mma.sync: the ones ops.BF16_BODIES
    # names, and no spills or serialised wgmma in any instance
    log = build.build().with_suffix(".log").read_text()
    report = {k: ptxas_report(log, k)[0] for k in (
        "ssd_chunk_wgmma", "ssd_chunk_bf16", "ssd_chunk_f32")}
    warnings = ptxas_report(log, "ssd_chunk")[1]
    emit({"phase": "ptxas", "kernel": "ssd", "instances": report,
          "warnings": warnings})
    want_bodies = {
        "ssd_chunk_wgmma": sorted(f"{q} {n} {hd} {g}" for (q, n, hd), (body, g)
                                  in ops.BF16_BODIES.items() if body == "wgmma"),
        "ssd_chunk_bf16": sorted(" ".join(map(str, k)) for k, (body, _)
                                 in ops.BF16_BODIES.items() if body == "mma.sync")}
    for kernel, want in want_bodies.items():
        check(sorted(report[kernel]) == want,
              f"{kernel} instances {sorted(report[kernel])} are not "
              f"ops.BF16_BODIES {ops.BF16_BODIES}")
    for kernel, insts in report.items():
        for inst, r in insts.items():
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"{kernel}<{inst}> spills: {r}")
    check(not [w for w in warnings if "wgmma" in w or "ssd_chunk" in w],
          f"ptxas warns on the SSD kernel: {warnings}")
    failures = []

    def errs_of(got, want, dtype, row_tol, what):
        """(max |got - want|, max row error or None); a miss of either
        tolerance is a failure."""
        tol = SSD_TOL[dtype]
        row = None if row_tol is None else float(ref.row_errors(got, want).max())
        got, want = got.float(), want.float()
        if not bool(((got - want).abs() <= tol + tol * want.abs()).all()):
            failures.append(f"ssd {what} != plain version beyond {tol} + "
                            f"{tol} |want|")
        if row is not None and not row <= row_tol:
            failures.append(f"ssd {what}: a row differs from the plain "
                            f"version's by {row} > {row_tol}")
        return float((got - want).abs().max()), row

    def cost(B, S, dtype):
        """(bytes of x, y, S_loc, a, dt, Bm, Cm and dec; flops of C B^T
        and w @ x over the causal pairs, and of S_loc)."""
        H, hd, N, Q = SSD_HEADS, SSD_HD, SSD_STATE, SSD_CHUNK
        nc, el = S // Q, torch.tensor([], dtype=dtype).element_size()
        pairs = Q * (Q + 1) // 2
        return (2 * B * S * H * hd * el + B * H * nc * N * hd * 4
                + 2 * B * S * H * 4 + 2 * B * S * N * el + B * H * nc * 4,
                B * H * nc * (2 * pairs * (N + hd) + 2 * Q * N * hd))

    def plain_scan(x, dt, A, Bm, Cm):
        """ops.ssd_scan's glue around the plain intra-chunk version."""
        real = ops.ssd_intra_chunk
        ops.ssd_intra_chunk = ref.ssd_intra_chunk_ref
        try:
            return ops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
        finally:
            ops.ssd_intra_chunk = real

    checks, record = [], None
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        B, S = PREFILL_BATCH, PREFILL_LEN
        x, dt, A, Bm, Cm = ssd_inputs(torch, B, S, tdt, 21)
        args = ssd_chunks(x, dt, A, Bm, Cm)
        got = ops.ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        want = ref.ssd_intra_chunk_ref(*args)
        errs = {name: errs_of(g, w, dtype, rt, f"{name} ({dtype}, S {S})")
                for name, g, w, rt in zip(
                    ("y", "s_loc", "dec"), got, want,
                    (ref.ROW_RTOL[tdt], ref.STATE_ROW_RTOL[tdt], None))}
        max_decay = float(want[2].max())
        if not max_decay > DECAY_MIN:
            failures.append(f"largest chunk decay {max_decay} <= {DECAY_MIN}")
        peak = BF16_FLOPS_PER_S if dtype == "bfloat16" else F32_FLOPS_PER_S
        b_ms, b_by = bound(*cost(B, S, tdt), peak)
        rec = {"dtype": dtype, "B": B, "S": S, "max_chunk_decay": max_decay,
               "max_abs_err": {k: v[0] for k, v in errs.items()},
               "max_row_err": {k: v[1] for k, v in errs.items()},
               "ms": cuda_ms(lambda: ops.ssd_intra_chunk(*args), 10),
               "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(*args), 3),
               "bound_ms": b_ms, "bound_by": b_by}
        if dtype == "bfloat16":
            # planted faults, each must break the row limit: the causal
            # mask moved by one (y without its diagonal term), and chunk
            # 1's S_loc without its decay to the chunk's end
            a, dtk, Bk, Ck, xk = args
            eye = torch.eye(SSD_CHUNK, dtype=tdt, device="cuda")
            w_ii = torch.diagonal(ref.ssd_intra_chunk_ref(
                a[:, :, :2], dtk[:, :, :2], Bk[:, :2], Ck[:, :2],
                eye.expand(*xk.shape[:2], 2, SSD_CHUNK, SSD_CHUNK))[0].float(),
                dim1=-2, dim2=-1)[..., None]
            y_bad = (want[0][:, :, :2].float() - w_ii * xk[:, :, :2].float()
                     ).to(tdt)
            s_bad = torch.einsum("bjn,bhjd->bhnd", Bk[:, 1].float(),
                                 xk[:, :, 1].float() * dtk[:, :, 1].float())
            faults = {
                "mask_moved_by_one": float(ref.row_errors(
                    y_bad, want[0][:, :, :2]).max()),
                "s_loc_without_decay": float(ref.row_errors(
                    s_bad, want[1][:, :, 1]).max())}
            limits = {"mask_moved_by_one": ref.ROW_RTOL[tdt],
                      "s_loc_without_decay": ref.STATE_ROW_RTOL[tdt]}
            for k, v in faults.items():
                if not v > limits[k]:
                    failures.append(f"the row check passes the planted "
                                    f"fault {k} ({v})")
            rec["planted_faults_max_row_err"] = faults
            record = {
                "name": "ssd_intra_chunk", "route": "cuda",
                "source": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
                "replaces": "src/repro/kernels/ssd/kernel.py:61",
                "shape": [B, SSD_HEADS, S // SSD_CHUNK, SSD_CHUNK, SSD_STATE,
                          SSD_HD],
                "dtype": dtype, "max_abs_err": errs["y"][0],
                "max_row_err": errs["y"][1], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}
        del got, want, args
        # the whole scan: y and the final state, at S 32,768 and ragged
        for S_scan in (S, RAGGED_S):
            if S_scan != S:
                x, dt, A, Bm, Cm = ssd_inputs(torch, B, S_scan, tdt, 22)
            y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
            y_p, st_p = plain_scan(x, dt, A, Bm, Cm)
            tag = f"({dtype}, S {S_scan})"
            rec[f"scan_S{S_scan}"] = {
                "y": errs_of(y, y_p, dtype, ref.ROW_RTOL[tdt], f"scan y {tag}"),
                "state": errs_of(st, st_p, dtype, ref.STATE_ROW_RTOL[tdt],
                                 f"scan state {tag}")}
            del y, st, y_p, st_p
        checks.append(rec)
        del x, dt, Bm, Cm

    emit({"phase": "kernels", "kernel": "ssd_intra_chunk", "tol": SSD_TOL,
          "row_tol": {str(d)[6:]: t for d, t in ref.ROW_RTOL.items()},
          "state_row_tol": {str(d)[6:]: t
                            for d, t in ref.STATE_ROW_RTOL.items()},
          "dt_range": DT_RANGE, "heads": SSD_HEADS, "hd": SSD_HD,
          "d_state": SSD_STATE, "chunk": SSD_CHUNK, "checks": checks})
    check(not failures, "; ".join(failures))
    return record


def device_profile(fn, top: int = 6, groups: dict | None = None) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host seconds, summed
    device-kernel seconds, the device's busy share of the host time, the
    ``top`` kernels by device time and, with ``groups`` ({name: words}),
    device seconds and launches summed over the kernels whose name holds
    one of a group's words (the first group that matches; the rest under
    "other").  The profiler adds host time, so the busy share is a lower
    bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # the device's activity alone: tracing every host op as well costs
    # tens of seconds of post-processing at a decode's launch counts
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_s = sum(e.self_device_time_total for e in kernels) / 1e6
    out = {"host_s": wall, "device_s": device_s,
           "busy_share": device_s / wall,
           "top": [[e.key[:60], e.self_device_time_total / 1e6, e.count]
                   for e in kernels[:top]]}
    if groups:
        sums = {g: [0.0, 0] for g in (*groups, "other")}
        for e in kernels:
            key = e.key.lower()
            g = next((g for g, words in groups.items()
                      if any(w in key for w in words)), "other")
            sums[g][0] += e.self_device_time_total / 1e6
            sums[g][1] += e.count
        out["groups"] = sums
    return out


def _to(tree, device, moved=None):
    """A nested dict / list of tensors moved to ``device``; a tensor that
    several leaves share is moved once and stays shared."""
    moved = {} if moved is None else moved
    if isinstance(tree, dict):
        return {k: _to(v, device, moved) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, moved) for v in tree]
    if id(tree) not in moved:
        moved[id(tree)] = tree.to(device)
    return moved[id(tree)]


def all_finite(torch, t) -> bool:
    """``torch.isfinite(t).all()`` 4,096 positions at a time, so that
    the mask of a (B, S, V) logits tensor never exists whole."""
    return all(bool(torch.isfinite(c).all()) for c in t.split(4096, dim=1))


def draw_biases(torch, params, seed):
    """Every bias the reference's init makes zero (``BIASES``: q/k/v, the
    GELU MLP's and the layer norms') drawn N(0, BIAS_STD) from ``seed``,
    walking the tree in its order, so that a check sees them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v)
            elif k in BIASES:
                tree[k] = (torch.randn(v.shape, generator=gen)
                           * BIAS_STD).to(v.device, v.dtype)
    walk(params)


def patched(module, name, make):
    """A context in which ``module.<name>`` is ``make(real)``, ``real``
    being the function it replaces."""

    @contextlib.contextmanager
    def patch():
        real = getattr(module, name)
        setattr(module, name, make(real))
        try:
            yield
        finally:
            setattr(module, name, real)

    return patch()


def layers_that_fit(torch, cfg, extra_bytes: int = 0) -> tuple[int, dict]:
    """The most of ``cfg``'s layers whose bf16 weights fit in the card's
    free memory beside the embedding, the head, a 2 x 32,768-token
    prefill and ``extra_bytes`` of inputs, and the sizes that decided
    it."""
    D, F_, V = cfg.d_model, cfg.d_ff, cfg.vocab
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.hd
    layer_bytes = 2 * (D * qkv + cfg.num_heads * cfg.hd * D + 3 * D * F_
                       + 2 * D + qkv)
    head_bytes = 2 * (2 * V * D + D)
    # the prefill's transient peak: the SwiGLU's four (B·S, F) bf16
    # tensors (gate, up, silu, product), and a margin for the rest
    reserve = 4 * PREFILL_BATCH * PREFILL_LEN * F_ * 2 + (6 << 30)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    layers = min(cfg.num_layers, int((free - head_bytes - reserve
                                      - extra_bytes) // layer_bytes))
    check(layers > 0, f"{cfg.name}: no layer fits in {free} free bytes")
    return layers, {"layer_bytes": layer_bytes, "free_bytes_before": free,
                    "total_bytes": total, "input_bytes": extra_bytes}


def flash_expected(cfg, seq: int, layers: int) -> int:
    """Flash launches of a ``layers``-layer prefill of ``seq`` tokens:
    one a layer past ``LONG_SEQ``, none for MLA (its prefill takes
    ``chunked_attention``)."""
    from repro_torch.models.attention import LONG_SEQ
    return 0 if cfg.mla or seq <= LONG_SEQ else layers


class Laps:
    """Seconds of a phase's steps: ``laps.lap(name)`` closes a step."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now


class ForcedRouting:
    """A MoE's generate held against its prefill.  The prompts' prefill
    records each MoE layer's experts (``recording``); the generate then
    routes each prompt position, MoE layer by MoE layer, to those
    experts with decode's own router weights for them (``forcing``),
    keeping decode's own top k and its k+1 largest router probabilities
    there; generated tokens route freely.  In bf16 decode and prefill
    route a token apart where two experts' router logits lie within the
    rounding, and the flips cascade through the layers."""

    def __init__(self, n_moe: int, prompt_len: int, batch: int, top_k: int):
        import torch
        self.n_moe, self.prompt_len, self.k = n_moe, prompt_len, top_k
        self.prefilled, self.calls = [], 0        # (B, S0, k) ids a layer
        self.own = torch.empty((prompt_len, n_moe, batch, top_k),
                               dtype=torch.int64, device="cuda")
        self.own_top = torch.empty((prompt_len, n_moe, batch, top_k + 1),
                                   device="cuda")

    def recording(self, real):
        def route(probs, top_k):
            w, idx = real(probs, top_k)
            self.prefilled.append(idx)
            return w, idx
        return route

    def forcing(self, real):
        import torch

        def route(probs, top_k):
            step, layer = divmod(self.calls, self.n_moe)
            self.calls += 1
            if step >= self.prompt_len:           # generated tokens
                return real(probs, top_k)
            vals, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
            self.own[step, layer] = order[:, 0, :top_k]
            self.own_top[step, layer] = vals[:, 0, :top_k + 1]
            want = self.prefilled[layer][:, step:step + 1]          # (B, 1, k)
            w = probs.gather(-1, want)
            return w / torch.clamp(w.sum(dim=-1, keepdim=True),
                                   min=1e-9), want
        return route

    def checks(self, steps: int) -> list:
        return [(self.calls == steps * self.n_moe,
                 f"{self.calls} routings in {steps} decode steps of "
                 f"{self.n_moe} MoE layers"),
                (len(self.prefilled) == self.n_moe,
                 f"{len(self.prefilled)} routings in a prefill of "
                 f"{self.n_moe} MoE layers")]

    def stats(self) -> dict:
        """Where decode's own top k differ from the prefill's, and its gap
        between its k-th and (k+1)-th router logits (log-probabilities
        differ as the logits do)."""
        import torch
        k = self.k
        pre = torch.stack(self.prefilled, dim=1).permute(2, 1, 0, 3)  # S0,L,B,k
        flips = (self.own.sort(-1).values != pre.sort(-1).values).any(-1)
        gaps = self.own_top[..., k - 1].log() - self.own_top[..., k].log()
        at = gaps[flips]
        return dict(
            routing="each prompt position's experts taken from the "
                    "prompts' prefill, layer by layer; generated tokens "
                    "route freely",
            routing_flips_by_layer=flips.sum(dim=(0, 2)).tolist(),
            positions=flips.shape[0] * flips.shape[2],
            layer0_flips=int(flips[:, 0].sum()),
            layer0_gap_at_flips_max=float(gaps[:, 0][flips[:, 0]].max())
            if bool(flips[:, 0].any()) else None,
            gap_at_flips_max=float(at.max()) if at.numel() else None,
            gap_at_flips_median=float(at.median()) if at.numel() else None,
            gap_median=float(gaps.median()))


def phase_serve(np, torch, arch, layers=None, prefill_only=False,
                gen_layers=None, prompt_len=GEN_PROMPT):
    """``arch`` serving at full width, and at full depth unless
    ``layers`` cuts it (``FIT``: the most layers that fit on the card);
    returns the flash launches of the 32,768-token prefill by head dim.
    ``prefill_only`` serves that prefill alone, with ``last_only`` (the
    next-token logits a server needs).  ``gen_layers`` cuts the depth of
    the generate and its decode checks alone (printed with ``reduced``),
    and ``prompt_len`` is the generate's prompt length.  The phase's
    record is printed before its checks run, so a failed check still
    shows the numbers.

    A MoE config runs its prefill at its own capacity factor (which
    drops tokens at that length), and ``generate`` and the decode checks
    drop-free (capacity factor E), so that decode, routed a token at a
    time, may be held against prefill.  In bf16 the two route a token
    apart where two experts' router logits lie within the rounding, so
    the generate routes each prompt position to the experts the
    prompt's prefill chose for it, layer by layer (the MoE layers: an
    MLA config's dense first layer routes nothing), with decode's own
    router weights for them, and records where and by how much decode's
    own choice would have differed.  One layer's MoE is run twice on the
    prefill's shape and must repeat bit for bit.  An MLA config's long
    prefill takes ``chunked_attention`` (no flash launch); its time
    there is measured in the profiled prefill."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model, attention, moe
    from repro_torch.serve import ServeEngine

    laps = Laps()
    full_cfg = get_arch(arch)
    record = {"phase": f"serve {arch}", "arch": arch}
    if layers == FIT:
        layers, fit = layers_that_fit(torch, full_cfg)
        record.update(fit, fit_to="the card's memory")
    cfg = dataclasses.replace(full_cfg, num_layers=layers or
                              full_cfg.num_layers)
    model = Model(cfg)
    params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    weights = list(_leaves(params))
    checks = []
    record.update(layers=cfg.num_layers, reduced=cfg != full_cfg,
                  params=sum(t.numel() for t in weights),
                  weight_bytes=sum(t.numel() * t.element_size()
                                   for t in weights),
                  init_s=init_s)
    if cfg != full_cfg:
        record["cut"] = f"{full_cfg.num_layers} layers -> {cfg.num_layers}"

    # 1. the prefill on 2 x 32,768 tokens: the counted run
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                         generator=gen, device="cuda")
    eng = ServeEngine(model, PREFILL_BATCH, PREFILL_LEN)
    if prefill_only:
        run = lambda t: model.prefill(  # noqa: E731
            params, {"tokens": t}, last_only=True)
    else:
        run = lambda t: eng.prefill_logits(params, {"tokens": t})  # noqa: E731
    run(toks[:1, :GEN_PROMPT])                                     # warm-up
    ops.reset_launches()
    logits, prefill_s, prefill_peak = timed(lambda: run(toks))
    launches = {cfg.hd: ops.LAUNCHES["flash_attention"]}
    want_flash = flash_expected(cfg, PREFILL_LEN, cfg.num_layers)
    want_shape = (PREFILL_BATCH, 1 if prefill_only else PREFILL_LEN,
                  cfg.vocab)
    checks += [
        (tuple(logits.shape) == want_shape, f"prefill logits "
                                            f"{tuple(logits.shape)}"),
        (all_finite(torch, logits), "prefill logits not finite"),
        (launches[cfg.hd] == want_flash,
         f"{launches[cfg.hd]} flash launches in a {cfg.num_layers}-layer "
         f"prefill at hd {cfg.hd}, not {want_flash}")]
    del logits
    prefill = {"batch": PREFILL_BATCH, "seq": PREFILL_LEN,
               "cut": "global batch 32 -> 2 (one card)", "wall_s": prefill_s,
               "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
               "peak_bytes": prefill_peak, "flash_launches": launches[cfg.hd]}
    record["prefill"] = prefill
    laps.lap("prefill")
    if prefill_only:
        prefill["last_only"] = True
        del params, toks, model, eng
        return finish_serve(record, laps, checks, launches)

    # where the time goes: one more prefill under the profiler (for a
    # MoE, counting the slots each layer dropped; for MLA, timing
    # chunked_attention's calls between synchronisations)
    groups = {"flash": ("flash",), "bf16_gemm": ("nvjet", "gemm", "cutlass",
                                                 "xmma")}
    chunked = [0.0, 0]

    def timing(real):
        def chunked_attention(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            chunked[0] += time.perf_counter() - t
            chunked[1] += 1
            return out
        return chunked_attention

    def profile():
        with (patched(attention, "chunked_attention", timing) if cfg.mla
              else contextlib.nullcontext()):
            out = device_profile(lambda: run(toks), top=8, groups=groups)
        if cfg.mla:
            out.update(chunked_attention_s=chunked[0],
                       chunked_attention_calls=chunked[1],
                       chunked_attention_share=chunked[0] / out["host_s"])
        return out

    if cfg.moe:
        drops = []

        def counting(real):
            def dispatch(x, idx, C, E):
                buf, rank = real(x, idx, C, E)
                drops.append((rank >= C).sum())
                return buf, rank
            return dispatch

        with patched(moe, "_dispatch", counting):
            prefill["profiled"] = profile()
        drops = [int(d) for d in drops]
        prefill.update(capacity_factor=cfg.moe.capacity_factor,
                       dropped_slots_by_layer=drops)
        checks.append((sum(drops) > 0, "the prefill dropped no token"))
        laps.lap("prefill_profile")
        # the same seeded input routed twice: identical bits
        h = torch.randn((PREFILL_BATCH, PREFILL_LEN, cfg.d_model),
                        generator=gen, device="cuda").to(cfg.param_dtype())
        y1, aux1 = moe.moe_forward(params["layers"][0]["mlp"], cfg, h)
        y2, aux2 = moe.moe_forward(params["layers"][0]["mlp"], cfg, h)
        same = torch.equal(y1, y2) and torch.equal(aux1, aux2)
        record["moe_repeats_bit_for_bit"] = same
        checks.append((same, "one layer's MoE gave other bits the second "
                             "time on the same input"))
        del h, y1, y2
        laps.lap("moe_repeat")
    else:
        prefill["profiled"] = profile()
        laps.lap("prefill_profile")
    if cfg.mla:
        checks.append((chunked[1] == cfg.num_layers,
                       f"{chunked[1]} chunked_attention calls in a "
                       f"{cfg.num_layers}-layer MLA prefill"))
    del toks

    # 2. generate: prompts fed token by token through decode, then 16
    # greedy tokens; the decode logits at the last prompt position
    # (cache path) against the prompts' prefill, which runs first so
    # that a MoE's decode can take its routing.  ``gen_layers`` cuts
    # the depth here.
    L = gen_layers or cfg.num_layers
    cfg_gen = dataclasses.replace(cfg, num_layers=L)
    if cfg.moe:
        cfg_gen = dataclasses.replace(cfg_gen, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    p_gen = params
    if L != cfg.num_layers:
        first = cfg.moe.first_dense_layers if cfg.moe else 0
        p_gen = {**params, "layers": params["layers"][:L - first]}
    model = Model(cfg_gen)
    n_moe = L - (cfg.moe.first_dense_layers if cfg.moe else 0)
    S0 = prompt_len
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, S0), generator=gen,
                            device="cuda")
    eng = ServeEngine(model, GEN_BATCH, S0 + GEN_STEPS)
    routing = (ForcedRouting(n_moe, S0, GEN_BATCH, cfg.moe.top_k)
               if cfg.moe else None)

    ops.reset_launches()
    with (patched(moe, "_route", routing.recording) if cfg.moe
          else contextlib.nullcontext()):
        last, _, last_peak = timed(lambda: eng.prefill_logits(
            p_gen, {"tokens": prompts})[:, -1].float())
    prompt_launches = ops.LAUNCHES["flash_attention"]
    laps.lap("prompt_prefill")

    steps = S0 + GEN_STEPS - 1
    with (patched(moe, "_route", routing.forcing) if cfg.moe
          else contextlib.nullcontext()):
        (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
            p_gen, prompts, GEN_STEPS, return_logits=True))
    laps.lap("generate")
    # the decode rate, from steps run alone (no patch): one traced for
    # where the time goes, then DECODE_TIMED_STEPS timed
    cache = eng.init_cache()

    def decode_steps(first, count):
        for i in range(first, first + count):
            model.decode_step(p_gen, cache, {"tokens": prompts[:, i:i + 1]}, i)

    decode_prof = device_profile(lambda: decode_steps(0, PROFILE_STEPS))
    _, decode_s, _ = timed(lambda: decode_steps(PROFILE_STEPS,
                                                DECODE_TIMED_STEPS))
    del cache
    laps.lap("decode_profile_and_rate")
    dec = chosen_from[:, 0].float()
    row_err = (dec - last).abs().amax(dim=-1)
    dec_err = float(row_err.max())
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > DECODE_TOL
    record["generate"] = {
        "batch": GEN_BATCH, "prompt": S0, "new_tokens": GEN_STEPS,
        "layers": L, "reduced": L != full_cfg.num_layers,
        "decode_steps": steps, "wall_s": gen_s,
        "ms_per_decode_step": decode_s / DECODE_TIMED_STEPS * 1e3,
        "timed_decode_steps": DECODE_TIMED_STEPS,
        "peak_bytes": gen_peak, "prompt_prefill_peak_bytes": last_peak,
        "profiled_steps": PROFILE_STEPS, "profiled": decode_prof,
        "decode_vs_prefill_max_abs": dec_err,
        "decode_vs_prefill_by_row": row_err.tolist(),
        "prefill_logit_std": float(last.std()), "tol": DECODE_TOL,
        "clear_argmax_rows": int(clear.sum())}
    if L != cfg.num_layers:
        record["generate"]["cut"] = (f"{full_cfg.num_layers} layers -> {L} "
                                     f"for the generate and its checks")
    want_prompt_flash = flash_expected(cfg, S0, L)
    checks += [
        (tuple(out.shape) == (GEN_BATCH, S0 + GEN_STEPS),
         f"generated {tuple(out.shape)}"),
        (torch.equal(out[:, :S0], prompts), "prompt not kept"),
        (bool(torch.isfinite(chosen_from).all()), "decode logits not finite"),
        (prompt_launches == want_prompt_flash,
         f"{prompt_launches} flash launches in the {S0}-token prefill, not "
         f"{want_prompt_flash}"),
        (dec_err <= DECODE_TOL,
         f"decode logits differ from prefill's by {dec_err} > {DECODE_TOL}"),
        (bool((out[:, S0] == last.argmax(-1))[clear].all()),
         "first generated token != prefill argmax where the gap is clear")]
    if cfg.moe:
        checks += routing.checks(steps)
        record["generate"].update(capacity_factor=cfg_gen.moe.capacity_factor,
                                  **routing.stats())
    del params, p_gen, chosen_from, last, dec, model, eng, routing
    laps.lap("generate_checks")

    # 3. the card against the CPU: full width, 2 layers (an MLA config's
    # dense first layer and one MoE layer), f32, TF32 off, nonzero q/k/v
    # biases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    draw_biases(torch, p_gpu, SERVE_SEED)
    t32 = torch.randint(0, cfg.vocab, (1, GEN_PROMPT), generator=gen,
                        device="cuda")
    chunked[1] = 0
    ops.reset_launches()
    with patched(attention, "chunked_attention", timing):
        on_card = m_gpu.prefill(p_gpu, {"tokens": t32}).cpu()
    f32_launches, f32_chunked = ops.LAUNCHES["flash_attention"], chunked[1]
    t = time.perf_counter()
    on_cpu = m_cpu.prefill(_to(p_gpu, "cpu"), {"tokens": t32.cpu()})
    cpu_s = time.perf_counter() - t
    f32_err = float((on_card - on_cpu).abs().max())
    f32_scale = float(on_cpu.abs().max())
    want_f32_flash = flash_expected(cfg, GEN_PROMPT, cfg32.num_layers)
    checks += [
        (f32_launches == want_f32_flash,
         f"{f32_launches} flash launches in the f32 prefill, not "
         f"{want_f32_flash}"),
        (f32_chunked == (cfg32.num_layers if cfg.mla else 0),
         f"{f32_chunked} chunked_attention calls in the f32 prefill"),
        (f32_err <= F32_RTOL * f32_scale,
         f"f32 logits: card != CPU by {f32_err} (max |logit| {f32_scale})")]
    # decode against prefill in f32 (a MoE drop-free): the prompt less
    # its last token written to the cache in one call, then the last
    # token alone, against the prefill's last position (the kernel; for
    # MLA the absorbed decode against the decompressed prefill)
    m_dec = Model(dataclasses.replace(cfg32, moe=cfg_gen.moe)
                  if cfg.moe else cfg32)
    cache = m_dec.init_cache(1, GEN_PROMPT)
    m_dec.decode_step(p_gpu, cache, {"tokens": t32[:, :-1]}, 0)
    dec32 = m_dec.decode_step(p_gpu, cache, {"tokens": t32[:, -1:]},
                              GEN_PROMPT - 1)[0][:, -1]
    pre32 = m_dec.prefill(p_gpu, {"tokens": t32}, last_only=True)[:, -1]
    dec32_err = float((dec32 - pre32).abs().max())
    dec32_scale = float(pre32.abs().max())
    checks.append((dec32_err <= F32_RTOL * dec32_scale,
                   f"f32 decode logits != prefill's by {dec32_err} (max "
                   f"|logit| {dec32_scale})"))
    record["card_vs_cpu_f32"] = {
        "layers": 2, "batch": 1, "seq": GEN_PROMPT, "tf32": False,
        "bias_std": BIAS_STD if cfg.qkv_bias else None,
        "max_abs": f32_err, "max_abs_logit": f32_scale, "rtol": F32_RTOL,
        "flash_launches": f32_launches, "chunked_attention_calls": f32_chunked,
        "cpu_s": cpu_s, "decode_vs_prefill_max_abs": dec32_err,
        "decode_vs_prefill_max_abs_logit": dec32_scale}
    del m_gpu, p_gpu, on_card, on_cpu, m_dec, cache
    laps.lap("card_vs_cpu_f32")
    return finish_serve(record, laps, checks, launches)


def finish_serve(record, laps, checks, launches):
    """Print a serving phase's record, then run its checks; returns its
    flash launches by head dim."""
    record["seconds_by_step"] = laps.seconds
    record["seconds"] = time.perf_counter() - laps.start
    emit(record)
    for ok, msg in checks:
        check(ok, msg)
    return launches


def mrope_positions(torch, S, before, side, batch):
    """(3, batch, S) M-RoPE positions as Qwen2-VL lays out one image
    between two runs of text: ``before`` text positions, equal in all
    three streams; a ``side`` x ``side`` block of merged patches at
    temporal index ``before``, with its own height and width indexes
    (``before`` + row, ``before`` + column); then text again from the
    block's largest index + 1."""
    n = side * side
    pos = torch.empty((3, S), dtype=torch.int64)
    pos[:, :before] = torch.arange(before)
    row, col = torch.arange(n) // side, torch.arange(n) % side
    pos[0, before:before + n] = before
    pos[1, before:before + n] = before + row
    pos[2, before:before + n] = before + col
    pos[:, before + n:] = before + side + torch.arange(S - before - n)
    return pos[:, None].expand(3, batch, S).contiguous().to("cuda")


def phase_serve_vlm(np, torch):
    """qwen2-vl-72b's backbone at full width and the most layers that
    fit beside a 2 x 32,768-position prefill (printed, with
    ``reduced``): ``Model.prefill`` with ``last_only`` on patch and
    token embeddings drawn from the seed and M-RoPE positions of one
    64 x 64 image between two runs of text (a flash launch at hd 128 a
    layer, 64 query heads over 8); then 1 layer in f32 on the card
    against the CPU at full width, at ``VLM_F32_LEN`` positions (the
    card takes ``plain_attention`` there; the kernel at G 8 is held in
    the flash phase).  Returns the prefill's flash launches by head
    dim."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model

    laps = Laps()
    full_cfg = get_arch("qwen2-vl-72b")
    record = {"phase": "serve qwen2-vl-72b", "arch": full_cfg.name}
    B, S, D = PREFILL_BATCH, PREFILL_LEN, full_cfg.d_model
    # the bf16 embeddings, and room for the allocator's fragmentation:
    # with layers_that_fit's margin alone the prefill ran out of memory
    # with 6.7 GiB reserved but unallocated
    layers, fit = layers_that_fit(torch, full_cfg,
                                  B * S * D * 2 + VLM_FRAGMENTATION_BYTES)
    record.update(fit, fit_to="the card's memory")
    cfg = dataclasses.replace(full_cfg, num_layers=layers)
    model = Model(cfg)
    params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    weights = list(_leaves(params))
    record.update(layers=cfg.num_layers, reduced=cfg != full_cfg,
                  params=sum(t.numel() for t in weights),
                  weight_bytes=sum(t.numel() * t.element_size()
                                   for t in weights), init_s=init_s)
    if cfg != full_cfg:
        record["cut"] = f"{full_cfg.num_layers} layers -> {cfg.num_layers}"
    del weights
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    batch = {"embeds": torch.randn((B, S, D), generator=gen, device="cuda"
                                   ).to(cfg.param_dtype()),
             "mrope_positions": mrope_positions(torch, S, *VLM_IMAGE, B)}
    pos = batch["mrope_positions"]
    streams_differ = bool((pos[0] != pos[1]).any() and
                          (pos[1] != pos[2]).any())

    def run(b):
        return model.prefill(params, b, last_only=True)

    run({"embeds": batch["embeds"][:1, :GEN_PROMPT],
         "mrope_positions": pos[:, :1, :GEN_PROMPT]})              # warm-up
    ops.reset_launches()
    logits, prefill_s, peak = timed(lambda: run(batch))
    launches = {cfg.hd: ops.LAUNCHES["flash_attention"]}
    checks = [
        (tuple(logits.shape) == (B, 1, cfg.vocab),
         f"prefill logits {tuple(logits.shape)}"),
        (all_finite(torch, logits), "prefill logits not finite"),
        (streams_differ, "the three M-RoPE streams do not differ"),
        (launches[cfg.hd] == cfg.num_layers,
         f"{launches[cfg.hd]} flash launches in a {cfg.num_layers}-layer "
         f"prefill at hd {cfg.hd}")]
    record["prefill"] = {
        "batch": B, "seq": S, "cut": "global batch 32 -> 2 (one card)",
        "inputs": "embeds (B, S, d_model) from the seed, M-RoPE positions "
                  f"of {VLM_IMAGE[1]} x {VLM_IMAGE[1]} patches after "
                  f"{VLM_IMAGE[0]} text positions",
        "last_only": True, "wall_s": prefill_s, "positions_per_s": B * S /
        prefill_s, "peak_bytes": peak, "flash_launches": launches[cfg.hd]}
    del logits, params, model, batch, pos
    laps.lap("prefill")

    # the card against the CPU: full width, 1 layer, f32, TF32 off,
    # nonzero q/k/v biases, M-RoPE positions that differ by stream
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=1, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    draw_biases(torch, p_gpu, SERVE_SEED)
    S32 = VLM_F32_LEN
    b32 = {"embeds": torch.randn((1, S32, D), generator=gen, device="cuda"),
           "mrope_positions": mrope_positions(torch, S32, *VLM_F32_IMAGE, 1)}
    ops.reset_launches()
    on_card = m_gpu.prefill(p_gpu, b32).cpu()
    f32_launches = ops.LAUNCHES["flash_attention"]
    p_cpu = _to(p_gpu, "cpu")
    del p_gpu
    t = time.perf_counter()
    on_cpu = m_cpu.prefill(p_cpu, _to(b32, "cpu"))
    cpu_s = time.perf_counter() - t
    f32_err = float((on_card - on_cpu).abs().max())
    f32_scale = float(on_cpu.abs().max())
    checks += [
        (f32_launches == 0, "the f32 prefill launched the flash kernel"),
        (f32_err <= F32_RTOL * f32_scale,
         f"f32 logits: card != CPU by {f32_err} (max |logit| {f32_scale})")]
    record["card_vs_cpu_f32"] = {
        "layers": 1, "batch": 1, "seq": S32, "image": list(VLM_F32_IMAGE),
        "tf32": False, "bias_std": BIAS_STD, "max_abs": f32_err,
        "max_abs_logit": f32_scale, "rtol": F32_RTOL,
        "flash_launches": f32_launches, "cpu_s": cpu_s}
    del m_gpu, p_cpu, on_card, on_cpu
    laps.lap("card_vs_cpu_f32")
    return finish_serve(record, laps, checks, launches)


def phase_serve_whisper(np, torch):
    """whisper-large-v3 at full width and depth (32 encoder and 32
    decoder layers, 20 heads at hd 64; bf16, weights from a seeded
    generator on the card): ``Model.encode`` over ``ENC_BATCH`` clips of
    1,500 seeded frame embeddings; ``generate`` for 4 requests (their
    encoder memory, ``WHISPER_PROMPT``-token decoder prompts, 16 greedy
    tokens) with ``extra_batch={"enc_memory": ...}``, its decode logits
    held against the decoder prefill's; then 2 + 2 layers in f32 on the
    card against the CPU with nonzero layer-norm and MLP biases, and
    their cached decode against their prefill.  Both the encoder's 1,500
    frames and the decoder's context stay under ``LONG_SEQ``, so no
    flash launch.  Returns the flash launches by head dim."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    laps = Laps()
    cfg = get_arch("whisper-large-v3")
    Se, D = cfg.encdec.encoder_seq, cfg.d_model
    model = Model(cfg)
    params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    weights = list(_leaves(params))
    record = {"phase": "serve whisper-large-v3", "arch": cfg.name,
              "layers": cfg.num_layers,
              "encoder_layers": cfg.encdec.num_encoder_layers,
              "reduced": False, "params": sum(t.numel() for t in weights),
              "weight_bytes": sum(t.numel() * t.element_size()
                                  for t in weights), "init_s": init_s}
    del weights
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    frames = torch.randn((ENC_BATCH, Se, D), generator=gen, device="cuda"
                         ).to(cfg.param_dtype())
    checks = []

    # 1. the encoder over the global batch of clips: the counted run
    model.encode(params, frames[:1])                               # warm-up
    ops.reset_launches()
    memory, enc_s, enc_peak = timed(lambda: model.encode(params, frames))
    launches = {cfg.hd: ops.LAUNCHES["flash_attention"]}
    checks += [(tuple(memory.shape) == (ENC_BATCH, Se, D),
                f"encoder memory {tuple(memory.shape)}"),
               (all_finite(torch, memory), "encoder memory not finite")]
    record["encode"] = {
        "clips": ENC_BATCH, "frames_per_clip": Se, "wall_s": enc_s,
        "frames_per_s": ENC_BATCH * Se / enc_s, "peak_bytes": enc_peak,
        "profiled": device_profile(lambda: model.encode(params, frames),
                                   top=8)}
    memory = memory[:GEN_BATCH].clone()
    del frames
    laps.lap("encode")

    # 2. generate: 4 requests' memory, prompts fed token by token, then
    # 16 greedy tokens; decode at the last prompt position against the
    # decoder's prefill over the same memory
    S0 = WHISPER_PROMPT
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, S0), generator=gen,
                            device="cuda")
    eng = ServeEngine(model, GEN_BATCH, S0 + GEN_STEPS)
    extra = {"enc_memory": memory}
    ops.reset_launches()
    last = eng.prefill_logits(params, {"tokens": prompts, **extra}
                              )[:, -1].float()
    (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
        params, prompts, GEN_STEPS, extra_batch=extra, return_logits=True))
    launches[cfg.hd] += ops.LAUNCHES["flash_attention"]
    laps.lap("generate")
    cache = eng.init_cache()

    def decode_steps(first, count):
        for i in range(first, first + count):
            model.decode_step(params, cache,
                              {"tokens": prompts[:, i:i + 1], **extra}, i)

    decode_prof = device_profile(lambda: decode_steps(0, PROFILE_STEPS))
    _, decode_s, _ = timed(lambda: decode_steps(PROFILE_STEPS,
                                                DECODE_TIMED_STEPS))
    del cache
    laps.lap("decode_profile_and_rate")
    row_err = (chosen_from[:, 0].float() - last).abs().amax(dim=-1)
    dec_err = float(row_err.max())
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > DECODE_TOL
    record["generate"] = {
        "batch": GEN_BATCH, "prompt": S0, "new_tokens": GEN_STEPS,
        "encoder_frames": Se, "decode_steps": S0 + GEN_STEPS - 1,
        "wall_s": gen_s,
        "ms_per_decode_step": decode_s / DECODE_TIMED_STEPS * 1e3,
        "timed_decode_steps": DECODE_TIMED_STEPS, "peak_bytes": gen_peak,
        "profiled_steps": PROFILE_STEPS, "profiled": decode_prof,
        "decode_vs_prefill_max_abs": dec_err,
        "decode_vs_prefill_by_row": row_err.tolist(),
        "prefill_logit_std": float(last.std()), "tol": DECODE_TOL,
        "clear_argmax_rows": int(clear.sum())}
    checks += [
        (tuple(out.shape) == (GEN_BATCH, S0 + GEN_STEPS),
         f"generated {tuple(out.shape)}"),
        (torch.equal(out[:, :S0], prompts), "prompt not kept"),
        (bool(torch.isfinite(chosen_from).all()), "decode logits not finite"),
        (dec_err <= DECODE_TOL,
         f"decode logits differ from prefill's by {dec_err} > {DECODE_TOL}"),
        (bool((out[:, S0] == last.argmax(-1))[clear].all()),
         "first generated token != prefill argmax where the gap is clear")]
    del params, model, eng, memory, extra, chosen_from, last
    laps.lap("generate_checks")

    # 3. the card against the CPU: full width, 2 encoder + 2 decoder
    # layers, f32, TF32 off, every bias drawn nonzero; then the cached
    # decode of the last prompt token against the prefill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                                encdec=dataclasses.replace(
                                    cfg.encdec, num_encoder_layers=2))
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    draw_biases(torch, p_gpu, SERVE_SEED)
    b32 = {"tokens": torch.randint(0, cfg.vocab, (1, S0), generator=gen,
                                   device="cuda"),
           "enc_embeds": torch.randn((1, Se, D), generator=gen,
                                     device="cuda")}
    ops.reset_launches()
    on_card = m_gpu.prefill(p_gpu, b32).cpu()
    t = time.perf_counter()
    on_cpu = m_cpu.prefill(_to(p_gpu, "cpu"), _to(b32, "cpu"))
    cpu_s = time.perf_counter() - t
    f32_err = float((on_card - on_cpu).abs().max())
    f32_scale = float(on_cpu.abs().max())
    mem32 = m_gpu.encode(p_gpu, b32["enc_embeds"])
    cache = m_gpu.init_cache(1, S0)
    t32 = b32["tokens"]
    m_gpu.decode_step(p_gpu, cache, {"tokens": t32[:, :-1],
                                     "enc_memory": mem32}, 0)
    dec32 = m_gpu.decode_step(p_gpu, cache, {"tokens": t32[:, -1:],
                                             "enc_memory": mem32},
                              S0 - 1)[0][:, -1]
    dec32_err = float((dec32.cpu() - on_card[:, -1]).abs().max())
    launches[cfg.hd] += ops.LAUNCHES["flash_attention"]
    checks += [
        (f32_err <= F32_RTOL * f32_scale,
         f"f32 logits: card != CPU by {f32_err} (max |logit| {f32_scale})"),
        (dec32_err <= F32_RTOL * f32_scale,
         f"f32 decode logits != prefill's by {dec32_err} (max |logit| "
         f"{f32_scale})"),
        (launches[cfg.hd] == 0,
         f"{launches[cfg.hd]} flash launches: whisper's attention is short")]
    record["card_vs_cpu_f32"] = {
        "encoder_layers": 2, "layers": 2, "batch": 1, "frames": Se,
        "seq": S0, "tf32": False, "bias_std": BIAS_STD, "max_abs": f32_err,
        "max_abs_logit": f32_scale, "rtol": F32_RTOL, "cpu_s": cpu_s,
        "decode_vs_prefill_max_abs": dec32_err}
    del m_gpu, p_gpu, on_card, on_cpu, mem32, cache
    laps.lap("card_vs_cpu_f32")
    return finish_serve(record, laps, checks, launches)


def mamba_dt_bias(torch, mixers, seed):
    """Mamba's own dt init (state-spaces/mamba's dt_min/dt_max; Mamba-1,
    arXiv:2312.00752, and Mamba-2, arXiv:2405.21060): each mixer's
    dt_bias is softplus^-1 of a log-uniform draw in DT_RANGE, in place of
    the reference init's zeros, under which the decays vanish within a
    few steps (Mamba-1: exp(dt A) at most 0.5, near 1.6e-5 at the 16th
    state) and a wrong carry of the state would not show.  A choice of
    weights, like the seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = (float(v) for v in torch.log(torch.tensor(DT_RANGE)))
    for mixer in mixers:
        bias = mixer["dt_bias"]
        u = torch.exp(torch.empty(bias.shape).uniform_(lo, hi, generator=gen))
        mixer["dt_bias"] = torch.log(torch.expm1(u)).to(bias.device)


def phase_serve_mamba2(np, torch, layers=None):
    """mamba2-1.3b serving at full width, and at full depth unless
    ``layers`` cuts it; returns the SSD launches of the 32,768-token
    prefill.  The phase's record is printed before its checks run, so a
    failed check still shows the numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd import ops
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    laps = Laps()
    full_cfg = get_arch("mamba2-1.3b")
    cfg = dataclasses.replace(full_cfg, num_layers=layers or
                              full_cfg.num_layers)
    model = Model(cfg)
    params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    mamba_dt_bias(torch, [lp["mixer"] for lp in params["layers"]],
                  SERVE_SEED)
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    weights = list(_leaves(params))
    checks = []
    groups = {"ssd_kernel": ("ssd_chunk",),
              "inter_chunk_loop": ("addcmul",),
              "y_inter_f32_gemm": ("gemm_f32f32",),
              "bf16_gemm": ("nvjet", "gemm", "cutlass", "xmma")}

    # 1. prefill_logits on 2 x 32,768 tokens: the counted run
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                         generator=gen, device="cuda")
    eng = ServeEngine(model, PREFILL_BATCH, PREFILL_LEN)
    eng.prefill_logits(params, {"tokens": toks[:1, :M2_GEN_PROMPT]})  # warm-up
    ops.reset_launches()
    logits, prefill_s, prefill_peak = timed(
        lambda: eng.prefill_logits(params, {"tokens": toks}))
    launches = dict(ops.LAUNCHES)
    checks += [
        (tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab),
         f"prefill logits {tuple(logits.shape)}"),
        (bool(torch.isfinite(logits).all()), "prefill logits not finite"),
        (launches["ssd_intra_chunk"] == cfg.num_layers,
         f"{launches['ssd_intra_chunk']} SSD launches in a "
         f"{cfg.num_layers}-layer prefill")]
    del logits
    laps.lap("prefill")
    prefill_prof = device_profile(
        lambda: eng.prefill_logits(params, {"tokens": toks}), top=10,
        groups=groups)
    del toks
    laps.lap("prefill_profile")

    # 2. generate: prompts fed token by token through decode (conv and
    # state caches), then 16 greedy tokens; the decode logits at the last
    # prompt position against prefill_logits (the kernel, a launch a layer)
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, M2_GEN_PROMPT),
                            generator=gen, device="cuda")
    eng = ServeEngine(model, GEN_BATCH, M2_GEN_PROMPT + GEN_STEPS)
    (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
        params, prompts, GEN_STEPS, return_logits=True))
    laps.lap("generate")
    decode_steps = M2_GEN_PROMPT + GEN_STEPS - 1
    cache = eng.init_cache()

    def decode_some():
        for i in range(PROFILE_STEPS):
            model.decode_step(params, cache, {"tokens": prompts[:, i:i + 1]}, i)

    decode_prof = device_profile(decode_some)
    del cache
    ops.reset_launches()
    last = eng.prefill_logits(params, {"tokens": prompts})[:, -1].float()
    gen_launches = ops.LAUNCHES["ssd_intra_chunk"]
    dec = chosen_from[:, 0].float()
    dec_err = float((dec - last).abs().max())
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > M2_DECODE_TOL
    checks += [
        (tuple(out.shape) == (GEN_BATCH, M2_GEN_PROMPT + GEN_STEPS),
         f"generated {tuple(out.shape)}"),
        (torch.equal(out[:, :M2_GEN_PROMPT], prompts), "prompt not kept"),
        (bool(torch.isfinite(chosen_from).all()), "decode logits not finite"),
        (gen_launches == cfg.num_layers,
         "the 520-token prefill did not take the kernel"),
        (dec_err <= M2_DECODE_TOL,
         f"decode logits differ from prefill's by {dec_err} > {M2_DECODE_TOL}"),
        (bool((out[:, M2_GEN_PROMPT] == last.argmax(-1))[clear].all()),
         "first generated token != prefill argmax where the gap is clear")]
    logit_std = float(last.std())
    del params, chosen_from, last, dec
    laps.lap("decode_profile_and_checks")

    # 3. the card against the CPU: full width, 2 layers, f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    mamba_dt_bias(torch, [lp["mixer"] for lp in p_gpu["layers"]], SERVE_SEED)
    t32 = torch.randint(0, cfg.vocab, (1, M2_GEN_PROMPT), generator=gen,
                        device="cuda")
    ops.reset_launches()
    on_card = m_gpu.prefill(p_gpu, {"tokens": t32}).cpu()
    f32_launches = ops.LAUNCHES["ssd_intra_chunk"]
    t = time.perf_counter()
    on_cpu = m_cpu.prefill(_to(p_gpu, "cpu"), {"tokens": t32.cpu()})
    cpu_s = time.perf_counter() - t
    f32_err = float((on_card - on_cpu).abs().max())
    f32_scale = float(on_cpu.abs().max())
    checks += [
        (f32_launches == cfg32.num_layers,
         "the f32 prefill did not take the kernel"),
        (f32_err <= F32_RTOL * f32_scale,
         f"f32 logits: card != CPU by {f32_err} (max |logit| {f32_scale})")]

    emit({"phase": "serve_mamba2", "arch": cfg.name,
          "layers": cfg.num_layers, "reduced": cfg != full_cfg,
          **({"cut": f"{full_cfg.num_layers} layers -> {cfg.num_layers}"}
             if cfg != full_cfg else {}),
          "params": sum(t.numel() for t in weights),
          "weight_bytes": sum(t.numel() * t.element_size() for t in weights),
          "init_s": init_s, "dt_bias": f"softplus^-1(log-uniform {DT_RANGE})",
          "prefill": {"batch": PREFILL_BATCH, "seq": PREFILL_LEN,
                      "cut": "global batch 32 -> 2 (one card)",
                      "wall_s": prefill_s,
                      "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
                      "peak_bytes": prefill_peak,
                      "ssd_launches": launches["ssd_intra_chunk"],
                      "profiled": prefill_prof},
          "generate": {"batch": GEN_BATCH, "prompt": M2_GEN_PROMPT,
                       "new_tokens": GEN_STEPS, "decode_steps": decode_steps,
                       "wall_s": gen_s,
                       "ms_per_decode_step": gen_s / decode_steps * 1e3,
                       "peak_bytes": gen_peak,
                       "profiled_steps": PROFILE_STEPS,
                       "profiled": decode_prof,
                       "decode_vs_prefill_max_abs": dec_err,
                       "prefill_logit_std": logit_std,
                       "tol": M2_DECODE_TOL,
                       "clear_argmax_rows": int(clear.sum())},
          "card_vs_cpu_f32": {"layers": 2, "batch": 1, "seq": M2_GEN_PROMPT,
                              "tf32": False, "max_abs": f32_err,
                              "max_abs_logit": f32_scale, "rtol": F32_RTOL,
                              "ssd_launches": f32_launches,
                              "cpu_s": cpu_s},
          "seconds_by_step": {**laps.seconds, "card_vs_cpu_f32":
                              time.perf_counter() - laps.last},
          "seconds": time.perf_counter() - laps.start})
    for ok, msg in checks:
        check(ok, msg)
    return launches


def phase_selective_scan(np, torch):
    """The selective-scan kernel against its plain version on the card at
    jamba's width, in bf16 and f32; returns its record at the serving
    path's shape (launch count filled in later)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import build, ops, ref
    from repro_torch.models.ssm import mamba1_dims

    cfg = get_arch(JAMBA)
    D, N = mamba1_dims(cfg)[0], cfg.ssm.d_state
    # registers and spills of each instance (bf16 and f32 inputs, N 16,
    # rows aligned to 16 bytes or not: "16 1", "16 0")
    log = build.build().with_suffix(".log").read_text()
    report = {dt: ptxas_report(log, f"selective_scan_kernelI{mangled}")[0]
              for dt, mangled in (("bfloat16", "13__nv_bfloat16"),
                                  ("float32", "f"))}
    warnings = ptxas_report(log, "selective_scan")[1]
    emit({"phase": "ptxas", "kernel": "selective_scan", "instances": report,
          "warnings": warnings})
    check(all(set(r) == {f"{N} 1", f"{N} 0"} for r in report.values()),
          f"selective_scan instances {report} are not N {N}, aligned and "
          f"not")
    for dt, insts in report.items():
        for inst, r in insts.items():
            check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
                  f"selective_scan_kernel<{dt}, {inst}> spills: {r}")
    check(not [w for w in warnings if "selective_scan" in w],
          f"ptxas warns on the selective scan: {warnings}")

    failures, checks = [], []
    B, tile = PREFILL_BATCH, ops.TILE_STEPS
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        for S in SCAN_CHECK_S:
            x, dt, A, Bm, Cm = args = ref.scan_inputs(B, S, D, tdt, S)
            y, h = ops.selective_scan(*args)
            torch.cuda.synchronize()
            y_p, h_p = ref.selective_scan_ref(*args)
            rec = {"dtype": dtype, "B": B, "S": S, "D": D, "N": N,
                   "max_step_decay": float(torch.exp(dt.amin() * A.amax())),
                   "max_abs_err": float((y - y_p).abs().max()),
                   "max_row_err": {"y": float(ref.row_errors(y, y_p).max()),
                                   "state": float(ref.row_errors(h, h_p)
                                                  .max())},
                   "state_unequal": int((h != h_p).sum()),
                   "y_unequal": int((y != y_p).sum())}
            for k, v in rec["max_row_err"].items():
                if not v <= ref.ROW_RTOL:
                    failures.append(f"selective_scan {k} ({dtype}, S {S}): "
                                    f"a row differs by {v} > {ref.ROW_RTOL}")
            if rec["state_unequal"]:
                failures.append(f"selective_scan state ({dtype}, S {S}): "
                                f"{rec['state_unequal']} elements differ "
                                f"from the plain loop's")
            if not rec["max_step_decay"] > SCAN_DECAY_MIN:
                failures.append(f"largest step decay {rec['max_step_decay']}"
                                f" <= {SCAN_DECAY_MIN}")
            if dtype == "bfloat16" and S == SCAN_CHECK_S[0]:
                # planted faults, each must break the row limit: the state
                # set to 0 at each staged time tile, y taken with C of the
                # step before, and each tile scanned with the x and dt of
                # the tile before (a ring stage read before its copy
                # landed: the stage still holds what it held)
                y_reset = torch.cat([ref.selective_scan_ref(
                    x[:, t:t + tile], dt[:, t:t + tile], A,
                    Bm[:, t:t + tile], Cm[:, t:t + tile])[0]
                    for t in range(0, S, tile)], dim=1)
                c_late = torch.cat([Cm[:, :1], Cm[:, :-1]], dim=1)
                y_late = ref.selective_scan_ref(x, dt, A, Bm, c_late)[0]
                y_stale = ref.selective_scan_ref(
                    torch.cat([torch.zeros_like(x[:, :tile]), x[:, :-tile]],
                              dim=1),
                    torch.cat([torch.zeros_like(dt[:, :tile]),
                               dt[:, :-tile]], dim=1), A, Bm, Cm)[0]
                rec["planted_faults_max_row_err"] = faults = {
                    "state_reset_each_tile": float(ref.row_errors(
                        y_reset, y_p).max()),
                    "c_one_step_late": float(ref.row_errors(
                        y_late, y_p).max()),
                    "stage_read_before_landed": float(ref.row_errors(
                        y_stale, y_p).max())}
                for k, v in faults.items():
                    if not v > ref.ROW_RTOL:
                        failures.append(f"the row check passes the planted "
                                        f"fault {k} ({v})")
                rec["plain_ms"] = cuda_ms(
                    lambda a=args: ref.selective_scan_ref(*a), 1)
                checked = rec
                del y_reset, y_late, c_late, y_stale
            checks.append(rec)
            del x, dt, A, Bm, Cm, args, y, h, y_p, h_p

    # the serving shape: one Mamba-1 sublayer's prefill of 2 x 32,768
    S = PREFILL_LEN
    args = ref.scan_inputs(B, S, D, torch.bfloat16, 7)
    ms = cuda_ms(lambda: ops.selective_scan(*args), 5)
    del args
    moved = B * S * D * (2 + 4 + 4) + 2 * B * S * N * 2 + D * N * 4 \
        + B * D * N * 4          # x bf16, dt and y f32, B and C, A, the state
    b_ms, b_by = bound(moved, B * S * D * N, EXP_PER_S)
    # warps an SM at that shape: the grid's blocks spread over the SMs,
    # as many as the occupancy calculator lets one SM hold
    per_sm = build.load().selective_scan_blocks_per_sm(1, 1)
    check(per_sm > 0, f"selective_scan_blocks_per_sm: {per_sm}")
    blocks = -(-D // ops.BLOCK_CHANNELS) * B
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = ops.BLOCK_CHANNELS // 32
    emit({"phase": "kernels", "kernel": "selective_scan",
          "row_tol": ref.ROW_RTOL, "dt_range": ref.DT_RANGE, "tile": tile,
          "block_channels": ops.BLOCK_CHANNELS, "checks": checks})
    check(not failures, "; ".join(failures))
    inst = report["bfloat16"][f"{N} 1"]
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/selective_scan/csrc/"
                      "selective_scan.cu",
            "replaces": "src/repro/models/ssm.py:269",
            "shape": [B, S, D, N], "dtype": "bfloat16",
            "max_abs_err": checked["max_abs_err"],
            "max_row_err": checked["max_row_err"]["y"], "ms": ms,
            "plain_ms": checked["plain_ms"],
            "plain_ms_at": f"S {checked['S']} (the plain loop is host-bound, "
                           f"about 12 launches a step)",
            "bound_ms": b_ms, "bound_by": b_by, "exp_per_s": EXP_PER_S,
            "library_ms": None, "tile": tile,
            "warps_an_sm": {"most": min(per_sm, -(-blocks // sms)) * warps,
                            "mean": min(per_sm * sms, blocks) * warps / sms,
                            "blocks_an_sm_allowed": per_sm},
            "registers": inst["registers"],
            "spill_bytes": inst["spill_stores"] + inst["spill_loads"]}


def drawn_once(keep=()):
    """A ``patched`` maker for an init function (``init_moe``,
    ``init_mamba1``, ``_swiglu_params``): its first call draws the
    parameters and every later call returns the same tensors, but for
    the leaves named in ``keep``, drawn anew at the first call's shapes
    and fan-in."""
    def make(real):
        first = {}

        def init(ctx, cfg):
            if not first:
                first.update(real(ctx, cfg))
                return dict(first)
            return {**first, **{k: ctx.make(tuple(first[k].shape))
                                for k in keep}}
        return init
    return make


#: the functions of ``models/lm.py`` that compute a hybrid sublayer's
#: mixer or FFN from its normalised input
BLOCKS = ("mamba1_forward", "gqa_forward", "moe_forward", "swiglu")


def first_output(out):
    return out[0] if isinstance(out, tuple) else out


def watching_blocks(lm, see):
    """A context in which each call of ``lm``'s ``BLOCKS`` also calls
    ``see(name, the real function, its args, its kwargs, its output
    tensor)``."""
    stack = contextlib.ExitStack()
    for name in BLOCKS:
        def make(real, _name=name):
            def block(*args, **kw):
                out = real(*args, **kw)
                see(_name, real, args, kw, first_output(out))
                return out
            return block
        stack.enter_context(patched(lm, name, make))
    return stack


def recording_blocks(lm, calls):
    """A context in which each of ``lm``'s ``BLOCKS`` appends (name, the
    real function, its args and kwargs, its output tensor) to
    ``calls``."""
    return watching_blocks(lm, lambda *call: calls.append(call))


def last_of_blocks(lm, kept, per_step=0, step=0):
    """A context in which each of ``lm``'s ``BLOCKS`` appends (name, its
    output at the last position in f32) to ``kept``; with ``per_step``
    (the blocks a decode step calls), only the blocks of decode step
    ``step``."""
    calls = [0]

    def see(name, real, args, kw, out):
        if not per_step or calls[0] // per_step == step:
            kept.append((name, out[:, -1].float()))
        calls[0] += 1
    return watching_blocks(lm, see)


def block_gaps(got, want) -> list:
    """Each block's max |difference| relative to its largest |output|."""
    return [(name, float((g - w).abs().max()) / float(w.abs().max()))
            for (name, g), (_, w) in zip(got, want)]


def to_card(obj, card_of):
    """Recorded CPU arguments on the card: a parameter as the card tensor
    it was copied from (``card_of``, by id), any other tensor copied."""
    if isinstance(obj, dict):
        return {k: to_card(v, card_of) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_card(v, card_of) for v in obj)
    if hasattr(obj, "is_cuda"):
        return card_of[id(obj)] if id(obj) in card_of else obj.to("cuda")
    return obj


def unique_sizes(params) -> dict:
    """Parameters and bytes of a tree, each tensor counted once however
    many leaves share it."""
    seen = {t.data_ptr(): t for t in _leaves(params)}
    return {"params": sum(t.numel() for t in seen.values()),
            "weight_bytes": sum(t.numel() * t.element_size()
                                for t in seen.values())}


def profile_scan(torch) -> None:
    """One full-width Mamba-1 sublayer's prefill (jamba-1.5-large-398b's
    mixer: d_model 8,192, d_inner 16,384, d_state 16, dt_rank 512; bf16
    on seeded weights with Mamba's dt init) over 2 x 32,768 seeded
    activations: ``models/ssm.py::mamba1_forward`` once with its scan in
    ``ref.py`` (the reference's step loop in torch ops) and once with
    the kernel, each under ``torch.profiler``
    (device activity only).  Prints one line a run: the sublayer's host
    and device seconds and launches, and the scan's own host seconds
    (between synchronisations) and share of the sublayer."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.selective_scan import ops, ref
    from repro_torch.models import ssm
    from repro_torch.models.common import InitCtx

    cfg = get_arch(JAMBA)
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    p = ssm.init_mamba1(InitCtx(generator=gen, dtype=cfg.param_dtype()), cfg)
    mamba_dt_bias(torch, [p], SERVE_SEED)
    xin = torch.randn((PREFILL_BATCH, PREFILL_LEN, cfg.d_model),
                      generator=gen, device="cuda").to(cfg.param_dtype())
    for name, scan in (("plain", ref.selective_scan_ref),
                       ("kernel", ops.selective_scan)):
        spent = [0.0, 0]

        def timed_scan(real, _scan=scan):
            def run(*args):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _scan(*args)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t
                spent[1] += 1
                return out
            return run

        with patched(ssm, "selective_scan", timed_scan):
            ssm.mamba1_forward(p, cfg, xin[:, :256])               # warm-up
            spent[:] = [0.0, 0]
            ops.reset_launches()
            prof = device_profile(lambda: ssm.mamba1_forward(p, cfg, xin),
                                  top=8, groups={"all": ("",)})
        emit({"phase": "scan_profile", "scan": name,
              "batch": PREFILL_BATCH, "seq": PREFILL_LEN,
              "d_inner": ssm.mamba1_dims(cfg)[0],
              "d_state": cfg.ssm.d_state,
              "sublayer_host_s": prof["host_s"],
              "sublayer_device_s": prof["device_s"],
              "busy_share": prof["busy_share"], "scan_calls": spent[1],
              "scan_host_s": spent[0], "scan_share": spent[0] / prof["host_s"],
              "kernel_launches": ops.LAUNCHES["selective_scan"],
              "device_launches": prof["groups"]["all"][1],
              "top": prof["top"]})


def split_decode_gap(torch, lm, moe, eng, params, prompts, routing, last,
                     decoded, pre_blocks) -> dict:
    """The bf16 decode-vs-prefill gap at the last prompt position, split.
    The prompts' prefill again with its scan in ``ref.py`` (decode's
    one-step update and y), forced to the experts that ``routing``
    recorded for the first prefill (whose logits and blocks are ``last``
    and ``pre_blocks``): against it, the scan's part (``scan_only``).
    The prompts' decode again with the prefill's conv rounding (each
    tap's product and sum rounded in the working type, as
    ``_causal_conv``), forced as ``routing.forcing`` does: against the
    first decode (``decoded``: the conv's part, ``conv_only``), against
    the first prefill (``conv_matched_vs_prefill``) and against the
    prefill with the step scan (``rest``: only the shapes of the GEMMs,
    the attention and the MoE's batches differ there), the last two with
    every block's relative difference."""
    from repro_torch.kernels.selective_scan import ref as ss_ref
    from repro_torch.models import ssm

    recorded, flips = iter(routing.prefilled), [0]

    def forced_prefill(real):
        def route(probs, top_k):
            want = next(recorded)
            own = real(probs, top_k)[1]
            flips[0] += int((own.sort(-1).values != want.sort(-1).values)
                            .any(-1).sum())
            w = probs.gather(-1, want)
            return w / torch.clamp(w.sum(dim=-1, keepdim=True),
                                   min=1e-9), want
        return route

    def conv_as_prefill(real):
        def conv_step(state, x_t, w, b):
            window = torch.cat([state, x_t], dim=1)             # (B, K, C)
            y = sum(window[:, k:k + 1] * w[k] for k in range(w.shape[0]))
            return window[:, 1:], y + b
        return conv_step

    S0 = prompts.shape[1]
    per_step = len(pre_blocks)
    step_blocks, conv_blocks = [], []
    t = time.perf_counter()
    with patched(moe, "_route", forced_prefill), \
            patched(ssm, "selective_scan",
                    lambda real: ss_ref.selective_scan_ref), \
            last_of_blocks(lm, step_blocks):
        step = eng.prefill_logits(params, {"tokens": prompts})[:, -1].float()
    step_s = time.perf_counter() - t
    routing.calls = 0
    cache = eng.init_cache()
    with patched(moe, "_route", routing.forcing), \
            patched(ssm, "_conv_step", conv_as_prefill), \
            last_of_blocks(lm, conv_blocks, per_step, S0 - 1):
        for i in range(S0):
            logits, cache = eng.model.decode_step(
                params, cache, {"tokens": prompts[:, i:i + 1]}, i)
    conv = logits[:, -1].float()
    check(bool(torch.isfinite(step).all() and torch.isfinite(conv).all()),
          "the split's logits are not finite")
    return {"scan_only": float((step - last).abs().max()),
            "conv_only": float((conv - decoded).abs().max()),
            "conv_matched_vs_prefill": float((conv - last).abs().max()),
            "rest": float((conv - step).abs().max()),
            "blocks_scan_only": block_gaps(step_blocks, pre_blocks),
            "blocks_rest": block_gaps(conv_blocks, step_blocks),
            "step_scan_routing_flips": flips[0],
            "step_scan_prefill_s": step_s}


def mamba1_mixers(params):
    return [sub["mixer"] for per in params["periods"] for sub in per["mamba"]]


def phase_serve_jamba(np, torch):
    """jamba-1.5-large-398b at full width over ``JAMBA_PERIODS`` period
    (8 of its 72 sublayers: Mamba-1 at 0-6, GQA at 7, a SwiGLU after even
    and a MoE of 16 experts, top 2, after odd sublayers), bf16 on seeded
    weights with Mamba's dt init, its four MoE sublayers sharing one
    16-expert stack (each its own router); returns the flash launches of
    the 32,768-token prefill by head dim and the scan's launches.  The
    record is printed before its checks run."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.models import Model, lm, moe
    from repro_torch.serve import ServeEngine

    laps = Laps()
    full_cfg = get_arch(JAMBA)
    per = full_cfg.hybrid.period
    cfg = dataclasses.replace(full_cfg, num_layers=per * JAMBA_PERIODS)
    model = Model(cfg)
    with patched(lm, "init_moe", drawn_once(("router",))):
        params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    mamba_dt_bias(torch, mamba1_mixers(params), SERVE_SEED)
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 1)
    checks = []
    record = {"phase": f"serve {JAMBA}", "arch": JAMBA,
              "layers": f"{cfg.num_layers} of {full_cfg.num_layers}",
              "reduced": True,
              "cuts": {"layers": f"{cfg.num_layers} of {full_cfg.num_layers}"
                                 f" ({JAMBA_PERIODS} period)",
                       "moe_weights": "one 16-expert stack shared by the "
                                      "period's 4 MoE sublayers (each its "
                                      "own router)"},
              "dt_bias": f"softplus^-1(log-uniform {DT_RANGE})",
              **unique_sizes(params), "init_s": init_s}

    # 1. the prefill on 2 x 32,768 tokens, last_only: the counted run
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                         generator=gen, device="cuda")

    def run():
        return model.prefill(params, {"tokens": toks}, last_only=True)

    model.prefill(params, {"tokens": toks[:1, :GEN_PROMPT]},
                  last_only=True)                                 # warm-up
    fa_ops.reset_launches()
    ss_ops.reset_launches()
    logits, prefill_s, prefill_peak = timed(run)
    launches = {"flash": fa_ops.LAUNCHES["flash_attention"],
                "scan": ss_ops.LAUNCHES["selective_scan"]}
    checks += [
        (tuple(logits.shape) == (PREFILL_BATCH, 1, cfg.vocab),
         f"prefill logits {tuple(logits.shape)}"),
        (all_finite(torch, logits), "prefill logits not finite"),
        (launches["flash"] == JAMBA_PERIODS,
         f"{launches['flash']} flash launches in {JAMBA_PERIODS} period(s)"),
        (launches["scan"] == (per - 1) * JAMBA_PERIODS,
         f"{launches['scan']} selective-scan launches in {JAMBA_PERIODS} "
         f"period(s)")]
    del logits
    laps.lap("prefill")
    # where the time goes: the prefill again under the profiler, the MoE
    # sublayers' host seconds between synchronisations
    moe_s = [0.0, 0]

    def timing(real):
        def moe_forward(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            moe_s[0] += time.perf_counter() - t
            moe_s[1] += 1
            return out
        return moe_forward

    with patched(lm, "moe_forward", timing):
        prof = device_profile(run, top=8, groups={
            "selective_scan": ("selective_scan",), "flash": ("flash",),
            "bf16_gemm": ("nvjet", "gemm", "cutlass", "xmma")})
    prof.update(moe_host_s=moe_s[0], moe_calls=moe_s[1],
                moe_share=moe_s[0] / prof["host_s"])
    record["prefill"] = {
        "batch": PREFILL_BATCH, "seq": PREFILL_LEN, "last_only": True,
        "cut": "global batch 32 -> 2 (one card)", "wall_s": prefill_s,
        "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
        "peak_bytes": prefill_peak, "flash_launches": launches["flash"],
        "scan_launches": launches["scan"], "profiled": prof}
    del toks
    laps.lap("prefill_profile")

    # 2. generate, drop-free (capacity factor E), each prompt position
    # routed to the experts the prompts' prefill chose; decode's logits at
    # the last prompt position (the one-step recurrence, the windowed
    # cache) against that prefill's (the kernel)
    S0, n_moe = JAMBA_PROMPT, cfg.num_layers // 2
    cfg_gen = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    model = Model(cfg_gen)
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, S0), generator=gen,
                            device="cuda")
    eng = ServeEngine(model, GEN_BATCH, S0 + GEN_STEPS)
    routing = ForcedRouting(n_moe, S0, GEN_BATCH, cfg.moe.top_k)
    per_step = 2 * cfg.num_layers           # blocks a decode step calls
    pre_blocks, dec_blocks = [], []
    ss_ops.reset_launches()
    with patched(moe, "_route", routing.recording), \
            last_of_blocks(lm, pre_blocks):
        last = eng.prefill_logits(params, {"tokens": prompts})[:, -1].float()
    prompt_scans = ss_ops.LAUNCHES["selective_scan"]
    laps.lap("prompt_prefill")
    steps = S0 + GEN_STEPS - 1
    with patched(moe, "_route", routing.forcing), \
            last_of_blocks(lm, dec_blocks, per_step, S0 - 1):
        (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
            params, prompts, GEN_STEPS, return_logits=True))
    laps.lap("generate")
    cache = eng.init_cache()

    def decode_steps(first, count):
        for i in range(first, first + count):
            model.decode_step(params, cache, {"tokens": prompts[:, i:i + 1]}, i)

    decode_prof = device_profile(lambda: decode_steps(0, PROFILE_STEPS))
    _, decode_s, _ = timed(lambda: decode_steps(PROFILE_STEPS,
                                                DECODE_TIMED_STEPS))
    del cache
    laps.lap("decode_profile_and_rate")
    row_err = (chosen_from[:, 0].float() - last).abs().amax(dim=-1)
    dec_err = float(row_err.max())
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > DECODE_TOL
    record["generate"] = {
        "batch": GEN_BATCH, "prompt": S0, "new_tokens": GEN_STEPS,
        "decode_steps": steps, "wall_s": gen_s,
        "ms_per_decode_step": decode_s / DECODE_TIMED_STEPS * 1e3,
        "timed_decode_steps": DECODE_TIMED_STEPS, "peak_bytes": gen_peak,
        "window": cfg.sliding_window, "profiled_steps": PROFILE_STEPS,
        "profiled": decode_prof, "decode_vs_prefill_max_abs": dec_err,
        "decode_vs_prefill_by_row": row_err.tolist(),
        "prefill_logit_std": float(last.std()), "tol": DECODE_TOL,
        "clear_argmax_rows": int(clear.sum()),
        "capacity_factor": cfg_gen.moe.capacity_factor, **routing.stats()}
    checks += [
        (tuple(out.shape) == (GEN_BATCH, S0 + GEN_STEPS),
         f"generated {tuple(out.shape)}"),
        (torch.equal(out[:, :S0], prompts), "prompt not kept"),
        (bool(torch.isfinite(chosen_from).all()), "decode logits not finite"),
        (prompt_scans == (per - 1) * JAMBA_PERIODS,
         f"{prompt_scans} selective-scan launches in the prompts' prefill"),
        (dec_err <= DECODE_TOL,
         f"decode logits differ from prefill's by {dec_err} > {DECODE_TOL}"),
        (bool((out[:, S0] == last.argmax(-1))[clear].all()),
         "first generated token != prefill argmax where the gap is clear"),
        *routing.checks(steps)]
    laps.lap("generate_checks")

    # the decode-vs-prefill gap split, at the last prompt position: the
    # prompts' prefill again with its scan in the one-step recurrence
    # (ref.py: decode's update and y) and forced to the first prefill's
    # experts; the prompts' decode again with the prefill's conv rounding
    # (each tap's product and sum rounded in the working type, as
    # _causal_conv); with both alike only the shapes of the GEMMs, the
    # attention and the MoE's batches differ
    split = split_decode_gap(torch, lm, moe, eng, params, prompts, routing,
                             last, chosen_from[:, 0].float(), pre_blocks)
    record["decode_gap_split"] = {
        "decode_vs_prefill": dec_err, **split,
        "blocks_decode_vs_prefill": block_gaps(dec_blocks, pre_blocks)}
    checks += [
        (len(pre_blocks) == per_step
         and [n for n, _ in dec_blocks] == [n for n, _ in pre_blocks],
         f"blocks recorded: prefill {[n for n, _ in pre_blocks]}, decode "
         f"{[n for n, _ in dec_blocks]}, of {per_step}"),
        (len(split["blocks_scan_only"]) == len(split["blocks_rest"])
         == per_step, "the split's runs recorded "
         f"{len(split['blocks_scan_only'])} and {len(split['blocks_rest'])} "
         f"blocks, of {per_step}")]
    del params, chosen_from, last, out, model, eng, routing
    laps.lap("decode_gap_split")

    # 3. the card against the CPU: the period at full width in f32, TF32
    # off, like sublayers sharing weights (the 7 Mamba-1 mixers, the 4
    # SwiGLUs, the 4 MoEs' experts), so that card and host each hold one
    # of each.  Every block (a sublayer's mixer or FFN) is recorded on
    # both sides, and each card block is run again on the CPU's input:
    # the error a block makes by itself, apart from what reached it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    with patched(lm, "init_moe", drawn_once(("router",))), \
            patched(lm, "init_mamba1", drawn_once()), \
            patched(lm, "_swiglu_params", drawn_once()):
        p_gpu = m_gpu.init(SERVE_SEED)
    mamba_dt_bias(torch, mamba1_mixers(p_gpu), SERVE_SEED)
    t32 = torch.randint(0, cfg.vocab, (1, JAMBA_F32_LEN), generator=gen,
                        device="cuda")
    blocks = {"cuda": [], "cpu": []}
    ss_ops.reset_launches()
    with recording_blocks(lm, blocks["cuda"]):
        on_card = m_gpu.prefill(p_gpu, {"tokens": t32}).cpu()
    f32_scans = ss_ops.LAUNCHES["selective_scan"]
    f32_bytes = unique_sizes(p_gpu)["weight_bytes"]
    t = time.perf_counter()
    moved = {}
    p_cpu = _to(p_gpu, "cpu", moved)
    with recording_blocks(lm, blocks["cpu"]):
        on_cpu = m_cpu.prefill(p_cpu, {"tokens": t32.cpu()})
    cpu_s = time.perf_counter() - t
    card_of = {id(moved[id(w)]): w for w in _leaves(p_gpu)}
    alone, reached = [], []
    for (name, real, args, kw, want), (_, _, _, _, got) in zip(
            blocks["cpu"], blocks["cuda"]):
        scale = float(want.abs().max())
        again = first_output(real(*to_card(args, card_of),
                                  **to_card(kw, card_of))).cpu()
        alone.append((name, float((again - want).abs().max()) / scale))
        reached.append(float((got.cpu() - want).abs().max()) / scale)
    del p_cpu, p_gpu, blocks, moved, card_of
    f32_err = float((on_card - on_cpu).abs().max())
    f32_scale = float(on_cpu.abs().max())
    worst_alone = max(e for _, e in alone)
    record["card_vs_cpu_f32"] = {
        "layers": cfg32.num_layers, "batch": 1, "seq": JAMBA_F32_LEN,
        "tf32": False, "weights": "like sublayers share one set",
        "weight_bytes": f32_bytes, "max_abs": f32_err,
        "max_abs_logit": f32_scale, "rtol": JAMBA_LOGIT_RTOL,
        "block_rtol": JAMBA_F32_RTOL, "blocks_alone_rel": alone,
        "blocks_as_reached_rel": reached, "scan_launches": f32_scans,
        "cpu_s": cpu_s}
    checks += [
        (f32_scans == (per - 1) * JAMBA_PERIODS,
         f"{f32_scans} selective-scan launches in the f32 prefill"),
        (len(alone) == 2 * cfg32.num_layers,
         f"{len(alone)} blocks recorded in {cfg32.num_layers} sublayers"),
        (worst_alone <= JAMBA_F32_RTOL,
         f"f32 blocks on the CPU's inputs: card != CPU by {worst_alone} of "
         f"the block's largest |output|"),
        (f32_err <= JAMBA_LOGIT_RTOL * f32_scale,
         f"f32 logits: card != CPU by {f32_err} (max |logit| {f32_scale})")]
    del m_gpu, m_cpu, on_card, on_cpu
    laps.lap("card_vs_cpu_f32")
    finish_serve(record, laps, checks, None)
    return {cfg.hd: launches["flash"]}, launches["scan"]


def attention_grad_check(torch, dtype: str, S: int, heads, kv_heads, hd):
    """Gate (a): the flash Function's dq, dk, dv (the kernel forward, the
    chunked_attention backward) against autograd through
    ``plain_attention`` in f32 on the same inputs, causal, B 1.  Returns
    each gradient's max |difference| relative to its largest |value|."""
    from repro_torch.models.attention import FlashAttention, plain_attention
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 7)
    q, k, v = (torch.randn((1, S, h, hd), generator=gen, device="cuda")
               .to(getattr(torch, dtype)) for h in (heads, kv_heads,
                                                     kv_heads))
    w = torch.randn((1, S, heads, hd), generator=gen, device="cuda")

    def grads(fn, *xs):
        leaves = [x.detach().clone().requires_grad_(True) for x in xs]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * w).sum(), leaves)

    got = grads(lambda *t: FlashAttention.apply(*t, True), q, k, v)
    want = grads(lambda *t: plain_attention(*t, causal=True, q_offset=0),
                 q.float(), k.float(), v.float())
    rel = [float((a.float() - b).abs().max() / b.abs().max())
           for a, b in zip(got, want)]
    check(all(a.dtype == q.dtype for a in got), "gradient types")
    check(max(rel) <= TRAIN_GRAD_TOL[dtype],
          f"flash Function gradients ({dtype}) against plain_attention's: "
          f"{rel} > {TRAIN_GRAD_TOL[dtype]} of the largest")
    return rel


def flash_backward_record(torch):
    """The flash op's backward at granite's training shape (B 2, S 4,096,
    32 heads over 8, hd 64, bf16, causal): the Function's backward (the
    recompute of ``chunked_attention`` and its gradient) timed with CUDA
    events against autograd through ``plain_attention`` and SDPA's
    backward, with its bound."""
    import torch.nn.functional as F

    from repro_torch.models.attention import FlashAttention, plain_attention
    B, S, H, Hkv, hd = TRAIN_MICRO, 4096, FLASH_HEADS, FLASH_KV_HEADS, \
        FLASH_HD
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED + 8)
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda")
               .to(torch.bfloat16).requires_grad_(True)
               for h in (H, Hkv, Hkv))
    g = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    out = FlashAttention.apply(q, k, v, True)
    ms = cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), g,
                                             retain_graph=True), 3)
    pq, pk, pv = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain = plain_attention(pq, pk, pv, causal=True, q_offset=0)
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        plain, (pq, pk, pv), g, retain_graph=True), 3)
    del plain, pq, pk, pv
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True)
                  for t in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib, (qt, kt, vt), g.transpose(1, 2), retain_graph=True), 3)
    # the least work of a causal attention backward: q, k, v, o and do
    # read once, dq, dk, dv written once; per kept query-key pair the
    # recomputed scores, dv, dp, dq and dk products, 2 hd flops each
    pairs = B * H * S * (S + 1) // 2
    elements = 4 * q.numel() + 4 * k.numel()   # q o do dq; k v dk dv
    b_ms, b_by = bound(2 * elements, 10 * hd * pairs, BF16_FLOPS_PER_S)
    return {"what": "FlashAttention.backward: chunked_attention recomputed "
                    "and differentiated (torch ops, no kernel of its own)",
            "shape": [B, H, Hkv, S, hd], "dtype": "bfloat16",
            "ms": ms, "plain_ms": plain_ms,
            "plain": "autograd through plain_attention (scores in f32)",
            "library_ms": library_ms, "bound_ms": b_ms,
            "bound_by": b_by, "ms_over_library": ms / library_ms}


def step_split(torch, fn, regions: list) -> tuple[dict, float, object]:
    """Run ``fn`` once under ``torch.profiler`` (device activity only)
    and split its device seconds: a kernel between the i-th pair of
    spin kernels goes to ``regions[i]`` (the marked regions, which do not
    nest, enqueue on one stream in the order they were entered); the
    rest to ``flash_forward``, ``gemm`` or ``other`` by name.  Returns
    (split, host seconds, fn's result)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    split = dict.fromkeys(("flash_forward", "chunked_backward", "gemm",
                           "optimizer", "other"), 0.0)
    gemm = ("nvjet", "gemm", "cutlass", "xmma")
    opened, inside = 0, False
    for e in kernels:
        name = e.name.lower()
        if "spin_kernel" in name:
            opened += not inside
            inside = not inside
            continue
        key = (regions[opened - 1] if inside else
               "flash_forward" if "flash_fwd" in name else
               "gemm" if any(w in name for w in gemm) else "other")
        split[key] += e.time_range.elapsed_us() / 1e6
    check(opened == len(regions) and not inside,
          f"{opened} marked regions on the device, {len(regions)} entered")
    return split, wall, out


def flash_per_microbatch(remat, layers: int) -> int:
    """Flash launches of one microbatch's forward and backward under
    ``remat``'s sqrt grouping (G layers a group): the forward's, the
    group recomputes' (non-reentrant checkpointing stops a recompute
    once it has what the backward needs: each group's last layer is
    not rerun there) and each layer's own recompute."""
    G = remat.group_for(layers)
    return 3 * layers - (layers // G if G > 1 else layers)


def phase_train(np, torch):
    """Training: gates (a) to (c) on the Function and a reduced granite,
    then granite-3-2b trained at full width and depth (gate (d)).
    Returns (the flash launches of the full-width steps, the backward's
    record for the kernels line)."""
    import tempfile

    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import TRAIN_4K, get_arch
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model, attention
    from repro_torch.models.attention import LONG_SEQ
    from repro_torch.train import (
        AdamWConfig, TrainConfig, adamw_init, init_train_state,
        make_train_step,
    )
    from repro_torch.train import step as step_mod
    from repro_torch.tree import leaves, rebuild

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    laps = Laps()
    record = {"phase": f"train {TRAIN_ARCH}"}

    # (a) the Function's gradients on the card
    record["grad_check"] = {
        "shape": [1, 4096, FLASH_HEADS, FLASH_KV_HEADS, FLASH_HD],
        "tol": TRAIN_GRAD_TOL,
        **{dtype: attention_grad_check(torch, dtype, 4096, FLASH_HEADS,
                                       FLASH_KV_HEADS, FLASH_HD)
           for dtype in ("float32", "bfloat16")}}
    laps.lap("grad_check")

    # (b) reduced granite in f32 past LONG_SEQ: card against CPU
    check(TRAIN_CHECK_S > LONG_SEQ, "the check must take the flash op")
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH).reduced(), dtype="float32")
    cpu, card = Model(cfg, device="cpu"), Model(cfg)
    params_cpu = cpu.init(SERVE_SEED)
    params = _to(params_cpu, "cuda")
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=TRAIN_CHECK_S,
                             global_batch=2, seed=1).batch(0)
    tc = TrainConfig()
    seen = []

    def recording(real):
        def fn(*args, **kw):
            seen.append(real(*args, **kw))
            return seen[-1]
        return fn

    with patched(step_mod, "loss_and_grads", recording):
        p_cpu, _, _ = make_train_step(cpu, tc)(
            params_cpu, adamw_init(params_cpu, tc.optimizer), batch)
        ops.reset_launches()
        p_card, _, _ = make_train_step(card, tc)(
            params, adamw_init(params, tc.optimizer), batch)
        torch.cuda.synchronize()
    want, got = seen
    want_flash = flash_per_microbatch(card.remat, cfg.num_layers)
    check(ops.LAUNCHES["flash_attention"] == want_flash,
          f"{ops.LAUNCHES} flash launches in a reduced step, not "
          f"{want_flash}")
    loss_rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    grad_rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                   for a, b in zip(leaves(got[2]), leaves(want[2])))
    param_rel = max(float((a.cpu() - b).abs().max() / b.abs().max())
                    for a, b in zip(leaves(p_card), leaves(p_cpu)))
    record["card_vs_cpu"] = {
        "config": f"{TRAIN_ARCH} reduced, f32", "seq": TRAIN_CHECK_S,
        "batch": 2, "loss_rel": loss_rel, "grad_leaf_rel_max": grad_rel,
        "param_rel_max": param_rel}
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train loss card vs CPU {loss_rel}")
    check(grad_rel <= TRAIN_LEAF_RTOL, f"gradients card vs CPU {grad_rel}")
    check(param_rel <= TRAIN_PARAM_RTOL, f"updated weights card vs CPU "
                                         f"{param_rel}")
    del cpu, card, params_cpu, params, want, got, seen, p_cpu, p_card
    laps.lap("card_vs_cpu")

    # (c) resume bit for bit: 2 steps, save, 2 more == restore, 2 steps
    cfg = get_arch(TRAIN_ARCH).reduced()
    model = Model(cfg)
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3))
    step = make_train_step(model, tc)
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=TRAIN_CHECK_S,
                          global_batch=2, seed=2)

    def run(params, opt, start, n):
        for i in range(start, start + n):
            params, opt, _ = step(params, opt, ds.batch(i))
        return params, opt

    n = TRAIN_RESUME_STEPS
    params, opt = run(*init_train_state(model, tc, SERVE_SEED), 0, n)
    with tempfile.TemporaryDirectory() as d:
        state = {"params": params, "opt": opt}
        save(d, n, state)
        # zeros of the live tree's types: what comes back is the disk's
        template = rebuild(state, [torch.zeros_like(t) for t in leaves(state)])
        pa, oa = run(params, opt, n, n)      # updates params in place
        restored, at = restore(d, template)
        live = {t.data_ptr() for t in leaves([pa, oa]) if t.numel()}
        shared = sum(t.data_ptr() in live for t in leaves(restored)
                     if t.numel())
        pb, ob = run(restored["params"], restored["opt"], n, n)
    unequal = sum(int((a != b).sum()) for a, b in
                  zip(leaves([pa, oa]), leaves([pb, ob])))
    record["resume"] = {"config": f"{TRAIN_ARCH} reduced, bf16",
                        "seq": TRAIN_CHECK_S, "steps": [n, n],
                        "unequal_elements": unequal,
                        "leaves_sharing_storage": shared}
    check(at == n and shared == 0 and unequal == 0,
          f"resumed training differs in {unequal} elements "
          f"({shared} restored leaves share the live tree's storage)")
    del model, params, opt, state, pa, oa, pb, ob, restored, template
    laps.lap("resume")

    # (d) full width and depth
    full = get_arch(TRAIN_ARCH)
    model = Model(full)
    tc = TrainConfig(optimizer=AdamWConfig(), grad_accum=TRAIN_ACCUM)
    (params, opt), init_s, _ = timed(
        lambda: init_train_state(model, tc, SERVE_SEED))
    seq, batch_size = TRAIN_4K.seq_len, TRAIN_MICRO * TRAIN_ACCUM
    ds = SyntheticDataset(vocab=full.vocab, seq_len=seq,
                          global_batch=batch_size, seed=0)
    step = make_train_step(model, tc)
    G = model.remat.group_for(full.num_layers)
    n_params = sum(t.numel() for t in leaves(params))
    record.update(
        arch=TRAIN_ARCH, layers=full.num_layers, seq=seq,
        global_batch=batch_size, micro_batch=TRAIN_MICRO,
        grad_accum=TRAIN_ACCUM, cut=f"global batch {TRAIN_4K.global_batch}"
        f" -> {batch_size} (one card)", dtype=full.dtype,
        state_dtype=tc.optimizer.state_dtype,
        remat={"policy": model.remat.policy, "group": G}, params=n_params,
        init_s=init_s)
    _, warm_s, _ = timed(lambda: step(params, opt, ds.batch(0)))
    laps.lap("train_warmup")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(1, TRAIN_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, ds.batch(i))
        torch.cuda.synchronize()
        steps.append({"step": i, "s": time.perf_counter() - t,
                      **{k: float(v) for k, v in m.items()}})
    flash = ops.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    step_s = sorted(s["s"] for s in steps)[len(steps) // 2]
    record.update(
        warmup_s=warm_s, steps=steps, step_s_median=step_s,
        tokens_per_s=batch_size * seq / step_s, peak_bytes=peak,
        peak_gb=peak / 1e9, flash_launches=flash,
        flash_launches_per_step=flash / TRAIN_TIMED_STEPS,
        flash_launches_per_step_expected=TRAIN_ACCUM * flash_per_microbatch(
            model.remat, full.num_layers))
    laps.lap("train_steps")

    # where one step's time goes: the kernels of the chunked backward, of
    # the optimizer, the flash kernel's forward, the GEMMs and the rest
    # (profiled step: device activity only, regions marked on the stream)
    def marked(name):
        def wrap(real):
            def fn(*args, **kw):
                regions.append(name)
                torch.cuda._sleep(1)          # a spin kernel opens the region
                out = real(*args, **kw)
                torch.cuda._sleep(1)          # and one closes it
                return out
            return fn
        return wrap

    regions = []
    with patched(attention.FlashAttention, "backward",
                 marked("chunked_backward")), \
            patched(step_mod, "adamw_update", marked("optimizer")):
        split, wall, m = step_split(
            torch, lambda: step(params, opt, ds.batch(TRAIN_TIMED_STEPS + 1)),
            regions)
    device_s = sum(split.values())
    record["profiled_step"] = {
        "host_s": wall, "device_s": device_s, "busy_share": device_s / wall,
        "regions": len(regions), "split_s": split,
        "split_share": {k: v / device_s for k, v in split.items()}
        if device_s else None,
        "loss": float(m[2]["loss"]), "grad_norm": float(m[2]["grad_norm"])}
    check(regions.count("chunked_backward") == TRAIN_ACCUM * full.num_layers,
          f"{regions.count('chunked_backward')} flash backwards in a step")
    laps.lap("train_profile")
    del params, opt, model, step
    torch.cuda.empty_cache()
    backward = flash_backward_record(torch)
    laps.lap("flash_backward")
    record["flash_backward"] = backward
    record["seconds"] = laps.seconds
    emit(record)
    losses = [s["loss"] for s in steps] + [record["profiled_step"]["loss"]]
    norms = [s["grad_norm"] for s in steps] + [
        record["profiled_step"]["grad_norm"]]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"training losses {losses} or grad norms {norms} not finite")
    check(flash > 0, "the full-width training steps launched no flash "
                     "kernel")
    check(device_s > 0, "the profiled step shows no device time")
    return flash, backward


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np

    if sys.argv[1:] == ["--profile-scan"]:
        phase_build()
        profile_scan(torch)
        return 0

    t0 = time.perf_counter()
    seconds = {}

    def timed_phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        emit({"phase_seconds": name, "seconds": seconds[name]})
        return out

    card = timed_phase("build", phase_build)
    records = (timed_phase("kernels", phase_kernels, np, torch)
               + timed_phase("flash", phase_flash, np, torch)
               + [timed_phase("ssd", phase_ssd, np, torch),
                  timed_phase("selective_scan", phase_selective_scan, np,
                              torch)])
    timed_phase("anchor", phase_anchor, np)
    launches = timed_phase("full_scale", phase_full_scale, np, torch)
    launches["murmur_hash_grid"] += timed_phase(
        "fig3", phase_fig3, np, torch)["murmur_hash_grid"]
    strat_records, strat = timed_phase("strategies", phase_strategies, np,
                                       torch)
    records[2:2] = strat_records
    records[0]["f7"]["launches"] = strat.pop("murmur_hash_grid_f7")
    check(records[0]["f7"]["launches"] > 0, "no sprayed walk at 7 fields")
    launches["murmur_hash_grid"] += strat.pop("murmur_hash_grid")
    launches.update(strat)
    drain_record, timeline = timed_phase("timeline", phase_timeline, np,
                                         torch)
    records[4:4] = [drain_record]
    records[0]["f7"]["launches"] += timeline.pop("murmur_hash_grid_f7")
    launches["departure_drain"] = timeline.pop("departure_drain")
    for name, count in timeline.items():
        launches[name] += count
    # the served paths' flash launches, by head dim
    flash = {}
    cut = dict(gen_layers=GEN_LAYERS_CUT)
    for name, fn, args, kw in (
            ("serve granite-3-2b", phase_serve, ("granite-3-2b",
                                                 GRANITE_LAYERS), {}),
            ("serve glm4-9b", phase_serve, ("glm4-9b",), cut),
            ("serve qwen2-moe-a2.7b", phase_serve, ("qwen2-moe-a2.7b",), cut),
            ("serve qwen2-72b", phase_serve, ("qwen2-72b", FIT, True), {}),
            ("serve deepseek-v2-lite-16b", phase_serve,
             ("deepseek-v2-lite-16b",), dict(cut, prompt_len=M2_GEN_PROMPT)),
            ("serve qwen2-vl-72b", phase_serve_vlm, (), {}),
            ("serve whisper-large-v3", phase_serve_whisper, (), {})):
        for hd, n in timed_phase(name, fn, np, torch, *args, **kw).items():
            flash[hd] = flash.get(hd, 0) + n
    jamba_flash, launches["selective_scan"] = timed_phase(
        f"serve {JAMBA}", phase_serve_jamba, np, torch)
    for hd, n in jamba_flash.items():
        flash[hd] = flash.get(hd, 0) + n
    check(set(flash) == {64, 128}, f"flash launches by head dim {flash}")
    launches["flash_attention"] = flash[64]
    launches["flash_attention_hd128"] = flash[128]
    launches.update(timed_phase("serve mamba2-1.3b", phase_serve_mamba2, np,
                                torch, MAMBA2_LAYERS))
    train_flash, flash_backward = timed_phase(f"train {TRAIN_ARCH}",
                                              phase_train, np, torch)
    launches["flash_attention"] += train_flash
    flash_row = next(r for r in records if r["name"] == "flash_attention")
    flash_row["train_launches"] = train_flash
    flash_row["backward"] = flash_backward
    for r in records:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"its path never launched {r['name']}")
    emit({"kernels": records})
    emit({"phase": "done", "card": card, "phase_seconds": seconds,
          "seconds": time.perf_counter() - t0})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
