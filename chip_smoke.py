#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
card with ``nvcc`` for ``sm_90a``).  It builds the six kernel
libraries from the checkout (``src/repro_torch/kernels/flowhash/csrc/flowhash.cu``,
``src/repro_torch/kernels/placement/csrc/placement.cu``,
``src/repro_torch/kernels/loads/csrc/loads.cu``,
``src/repro_torch/kernels/drain/csrc/drain.cu``,
``src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu`` and
``src/repro_torch/kernels/ssd/csrc/ssd.cu``, six ``nvcc`` processes at
once) and then:

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
   32 query heads over 2, with its own row on the ``kernels`` line; the
   ``-Xptxas -v`` report must show one bf16 instance a head dim, with the tiles ``ops.BF16_TILES`` names, no
   spills and no serialised ``wgmma``), the SSD
   intra-chunk kernel (the ``-Xptxas -v`` report must show the bf16
   bodies ``ops.BF16_BODIES`` names, no spills and no serialised
   ``wgmma``) in bf16 and f32 to the JAX package's tolerances
   (5e-2, 1e-5) and a per-row limit (y 2e-2, 1e-5; states 1e-4, 1e-5)
   at mamba2-1.3b's shape (B 2, S 32,768, 64 heads, N 128, hd 64, Q 256)
   and through the whole scan at S 32,768 and a ragged S 1,000, with dt
   from Mamba-2's init so the chunk decays carry signal (two planted
   faults must fail the limits) — and times kernel, plain version and
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
   bit at the sprayed walk's shape with byte weights; on the paper testbed (256 flows x 1,024 seeds, ``murmur``,
   ``roce-nack``) the FIM mean, goodput mean and exposure p95 of every
   family (and of the two elephant variants under byte demand) must
   match the JAX package's numpy-engine values to 1e-9; at full scale
   ``prime-spray`` (819,200 flowlet columns, the hash at 7 fields),
   ``adaptive-spray`` (on a 3:1 skewed pair mix, where its re-spray
   rounds run; again under byte demand, where its load sums take the
   ordered-sum kernel), ``congestion-aware`` and ``wave-congestion-aware``
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
   seeded generator on the card) and ``GRANITE_LAYERS`` (8) of its 40
   layers, printed with ``reduced``: ``prefill_logits`` on 2 x 32,768
   tokens (a flash-attention launch at hd 64 a layer), ``generate`` for
   4 x 2,304-token prompts and 16 greedy tokens with the decode logits
   checked against the prefill's, and a 2-layer f32 model on the card:
   its prefill against the CPU's, and its cached decode of a prompt's
   last token against its prefill;
9. drives glm4-9b serving the same way at full width and depth (40
   layers, q/k/v biases, 32 query heads over 2 kv heads: 40 flash
   launches at hd 128), the 2-layer f32 checks with nonzero biases
   drawn from the seed;
10. drives qwen2-moe-a2.7b the same way at full width and depth (24
   layers, 60 experts, top 4, a shared expert, 16 heads over 16 at hd
   128): the prefill at the config's capacity factor, which drops
   tokens (the drops of each layer printed); ``generate`` and the
   decode checks drop-free (capacity factor 60), each prompt position
   of the generate routed, layer by layer, to the experts the prompts'
   prefill chose for it (decode's own choice would differ where two
   experts' router logits tie within the bf16 rounding: the differing
   positions of each layer and decode's gap between its k-th and
   (k+1)-th logits there are printed), so that its bf16 decode is held
   against the prefill as granite's is; one layer's MoE on the
   prefill's shape run twice with identical bits;
11. drives qwen2-72b at full width and the most layers that fit beside
   a 2 x 32,768-token prefill (printed, with ``reduced``):
   ``Model.prefill`` with ``last_only`` (a flash launch at hd 128 a
   layer, 64 query heads over 8);
12. drives mamba2-1.3b serving at full width and ``MAMBA2_LAYERS``
   (24) of its 48 layers, printed with ``reduced`` (bf16, Mamba-2's
   dt_bias init): ``prefill_logits`` on 2 x 32,768 tokens (an SSD
   launch a layer), ``generate`` for 4 x 520-token prompts and
   16 greedy tokens with the decode logits checked against the
   prefill's, and a 2-layer f32 prefill on the card against the CPU;
13. prints the ``kernels`` record, each phase's seconds and, last, the
   one-line result.

Each serving phase prints its seconds by step, and its decode rate
from ``DECODE_TIMED_STEPS`` decode steps run alone (no routing patch,
no profiler).

Each path runs with every kernel's launch count set to 0 just before it
and read just after; a kernel that its path never launched fails the
run, and so does a strategy whose walk made fewer murmur launches than
its paths have hops, a chain that did not launch the placement
kernel, a byte-demand re-spray that did not launch the ordered sum, or a
timeline phase that did not launch the flow hash at 5 and at 7 fields,
the placement kernel, the ordered sum and the drain (its launches join
the ``kernels`` line's counts).  The flow hash's launches are counted
by the width they hashed: the ``kernels`` line gives the 5-field
launches on the murmur row and the 7-field ones under its ``f7``.  The
flash kernel's are counted by the head dim of the config that launched
them: the hd-64 row counts granite's prefills, the hd-128 row those of
glm4-9b, qwen2-moe-a2.7b and qwen2-72b.

Every check raises, so any failure exits non-zero before the result
line.  Without a CUDA card, or without the repository around it, the
script exits non-zero and prints no result.
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
# SMs at 1.83 GHz
EXP_PER_S = 3.9e12
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
# the hd-128 serving shape: glm4-9b's 32 query heads over 2 kv heads
FLASH_HD128 = (32, 2, 128)
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
# the q/k/v biases of the f32 card-against-CPU checks, N(0, std), where
# the reference's init makes them zero
QKV_BIAS_STD = 0.5
# granite-3-2b's and mamba2-1.3b's serving depths, cut from 40 and 48
# so that the script keeps inside 600 s beside the hd-128 paths: their
# generates are host-bound, about 1.1 to 1.5 ms a layer a decode step
# on an H100's host, whose speed moves by half from one machine to the
# next
GRANITE_LAYERS = 8
MAMBA2_LAYERS = 24
# phase_serve's depth for a config whose full depth exceeds the card's
# memory: the most layers that fit
FIT = "fit"


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
    from repro_torch.kernels.ssd import build as ssd_build
    builds = (fh_build, pl_build, loads_build, drain_build, fa_build,
              ssd_build)
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
    on the CPU) at the sprayed walk's shape: a ``prime-spray`` route of
    the full-scale flows over 64 seeds, its (H, 819,200, 64) cells keyed
    by (seed, link) as ``_cell_loads`` keys them, with byte weights
    (alternating 2**20- and 2**30-byte flows, over K 8).  Returns the
    kernel's record (launch count filled in later)."""
    from repro_torch.kernels.loads import ops
    res = T.simulate_paths(comp, flows, np.arange(SPRAY_SEEDS),
                           strategy="prime-spray", field_matrix=fm,
                           hash_backend="murmur")
    ids = res.link_ids
    H, C, S = ids.shape
    L = comp.num_links
    b = np.where(np.arange(len(flows)) % 2 == 0, 2.0**20, 2.0**30)
    col_w = torch.from_numpy(b / b.mean()).cuda()[res.flow_index] / 8
    off = torch.arange(S, device="cuda", dtype=torch.int32) * L
    keys = torch.where(ids >= 0, ids + off, S * L).reshape(-1)
    w = col_w[None, :, None].expand(H, C, S).reshape(-1).contiguous()
    del res, ids
    check(not ops.exact_in_any_order(col_w, keys.numel()),
          "the byte weights sum exactly in any order")
    got = ops.ordered_bin_sum(keys, w, S * L)
    keys_cpu, w_cpu = keys.cpu(), w.cpu()
    t = time.perf_counter()
    want = ops.ordered_bin_sum(keys_cpu, w_cpu, S * L)
    plain_s = time.perf_counter() - t
    err = float((got.cpu() - want).abs().max())
    check(torch.equal(got.cpu(), want),
          f"ordered_bin_sum != plain version (max error {err})")
    again = ops.ordered_bin_sum(keys, w, S * L)
    check(torch.equal(again, got), "ordered_bin_sum differs between runs")
    perm, start = ops.sort_runs(keys, S * L)
    library = torch.bincount(keys, weights=w, minlength=S * L + 1)[:S * L]
    m = keys.numel()
    b_ms, b_by = bound(m * 4 + m * 8 + S * L * 8, m, F64_FLOPS_PER_S)
    rec = {
        "name": "ordered_bin_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/loads/csrc/loads.cu",
        "replaces": "src/repro/core/strategies.py:261",
        "shape": [H, C, S], "cells": m, "bins": S * L,
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ops.ordered_bin_sum(keys, w, S * L), 10),
        "sort_ms": cuda_ms(lambda: torch.sort(keys, stable=True), 10),
        "runs_ms": cuda_ms(lambda: ops.sort_runs(keys, S * L), 10),
        "fold_ms": cuda_ms(lambda: ops.fold_runs(perm, start, w), 10),
        "plain_ms": plain_s * 1e3,
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.bincount(
            keys, weights=w, minlength=S * L + 1), 10),
        "library_bit_identical": bool(torch.equal(library.cpu(), want)),
        "library_max_abs_err": float((library.cpu() - want).abs().max())}
    del keys, w, perm, start, library, got, again
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
        sum0 = loads_ops.LAUNCHES["ordered_bin_sum"]
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
        ordered = loads_ops.LAUNCHES["ordered_bin_sum"] - sum0
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
        check((ordered > 0) == (demand == "bytes"),
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
                "ordered_bin_sum": loads_ops.LAUNCHES["ordered_bin_sum"]}
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
        ordered = loads_ops.LAUNCHES["ordered_bin_sum"]
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
                                         "sort_ms", "plain_ms")},
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
            sum0 = loads_ops.LAUNCHES["ordered_bin_sum"]
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
                "ordered_sums": loads_ops.LAUNCHES["ordered_bin_sum"] - sum0}
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
                "ordered_bin_sum": loads_ops.LAUNCHES["ordered_bin_sum"],
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
    emit({"phase": "kernels", "kernel": "flash_attention", "tol": FLASH_TOL,
          "row_tol": {str(d)[6:]: t for d, t in ref.ROW_RTOL.items()},
          **info, "checks": checks, "hd128": info128})
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


def _to(tree, device):
    """A nested dict / list of tensors moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def all_finite(torch, t) -> bool:
    """``torch.isfinite(t).all()`` 4,096 positions at a time, so that
    the mask of a (B, S, V) logits tensor never exists whole."""
    return all(bool(torch.isfinite(c).all()) for c in t.split(4096, dim=1))


def draw_qkv_biases(torch, params, seed):
    """Each layer's q/k/v biases drawn N(0, QKV_BIAS_STD) from ``seed``,
    in place of the reference init's zeros, so that a check sees them."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for lp in params["layers"]:
        for name in ("bq", "bk", "bv"):
            b = lp["attn"][name]
            lp["attn"][name] = (torch.randn(b.shape, generator=gen)
                                * QKV_BIAS_STD).to(b.device, b.dtype)


def moe_patch(name, make):
    """A context in which ``repro_torch.models.moe.<name>`` is
    ``make(real)``, ``real`` being the function it replaces."""
    from repro_torch.models import moe

    @contextlib.contextmanager
    def patch():
        real = getattr(moe, name)
        setattr(moe, name, make(real))
        try:
            yield
        finally:
            setattr(moe, name, real)

    return patch()


def layers_that_fit(torch, cfg) -> tuple[int, dict]:
    """The most of ``cfg``'s layers whose bf16 weights fit in the card's
    free memory beside the embedding, the head and a 2 x 32,768-token
    prefill, and the sizes that decided it."""
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
    layers = min(cfg.num_layers,
                 int((free - head_bytes - reserve) // layer_bytes))
    check(layers > 0, f"{cfg.name}: no layer fits in {free} free bytes")
    return layers, {"layer_bytes": layer_bytes, "free_bytes_before": free,
                    "total_bytes": total}


def phase_serve(np, torch, arch, layers=None, prefill_only=False):
    """``arch`` serving at full width, and at full depth unless
    ``layers`` cuts it (``FIT``: the most layers that fit on the card);
    returns the flash launches of the 32,768-token prefill by head dim.
    ``prefill_only`` serves that prefill alone, with ``last_only`` (the
    next-token logits a server needs).  The phase's record is printed
    before its checks run, so a failed check still shows the numbers.

    A MoE config runs its prefill at its own capacity factor (which
    drops tokens at that length), and ``generate`` and the decode checks
    drop-free (capacity factor E), so that decode, routed a token at a
    time, may be held against prefill.  In bf16 the two route a token
    apart where two experts' router logits lie within the rounding, so
    the generate routes each prompt position to the experts the
    prompt's prefill chose for it, layer by layer, with decode's own
    router weights for them, and records where and by how much decode's
    own choice would have differed.  One layer's MoE is run twice on the
    prefill's shape and must repeat bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import Model
    from repro_torch.models.moe import moe_forward
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    laps, last_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last_lap[0]
        last_lap[0] = now

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
    want_shape = (PREFILL_BATCH, 1 if prefill_only else PREFILL_LEN,
                  cfg.vocab)
    checks += [
        (tuple(logits.shape) == want_shape, f"prefill logits "
                                            f"{tuple(logits.shape)}"),
        (all_finite(torch, logits), "prefill logits not finite"),
        (launches[cfg.hd] == cfg.num_layers,
         f"{launches[cfg.hd]} flash launches in a {cfg.num_layers}-layer "
         f"prefill at hd {cfg.hd}")]
    del logits
    prefill = {"batch": PREFILL_BATCH, "seq": PREFILL_LEN,
               "cut": "global batch 32 -> 2 (one card)", "wall_s": prefill_s,
               "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
               "peak_bytes": prefill_peak, "flash_launches": launches[cfg.hd]}
    record["prefill"] = prefill
    lap("prefill")
    if prefill_only:
        prefill["last_only"] = True
        del params, toks, model, eng
        return finish_serve(record, laps, t_phase, checks, launches)

    # where the time goes: one more prefill under the profiler (for a
    # MoE, counting the slots each layer dropped)
    groups = {"flash": ("flash",), "bf16_gemm": ("nvjet", "gemm", "cutlass",
                                                 "xmma")}
    profile = lambda: device_profile(  # noqa: E731
        lambda: run(toks), top=8, groups=groups)
    if cfg.moe:
        drops = []

        def counting(real):
            def dispatch(x, idx, C, E):
                buf, rank = real(x, idx, C, E)
                drops.append((rank >= C).sum())
                return buf, rank
            return dispatch

        with moe_patch("_dispatch", counting):
            prefill["profiled"] = profile()
        drops = [int(d) for d in drops]
        prefill.update(capacity_factor=cfg.moe.capacity_factor,
                       dropped_slots_by_layer=drops)
        checks.append((sum(drops) > 0, "the prefill dropped no token"))
        lap("prefill_profile")
        # the same seeded input routed twice: identical bits
        h = torch.randn((PREFILL_BATCH, PREFILL_LEN, cfg.d_model),
                        generator=gen, device="cuda").to(cfg.param_dtype())
        y1, aux1 = moe_forward(params["layers"][0]["mlp"], cfg, h)
        y2, aux2 = moe_forward(params["layers"][0]["mlp"], cfg, h)
        same = torch.equal(y1, y2) and torch.equal(aux1, aux2)
        record["moe_repeats_bit_for_bit"] = same
        checks.append((same, "one layer's MoE gave other bits the second "
                             "time on the same input"))
        del h, y1, y2
        lap("moe_repeat")
    else:
        prefill["profiled"] = profile()
        lap("prefill_profile")
    del toks

    # 2. generate: prompts fed token by token through decode, then 16
    # greedy tokens; the decode logits at the last prompt position
    # (cache path) against the prompts' prefill (kernel path), which
    # runs first so that a MoE's decode can take its routing
    cfg_gen = cfg
    if cfg.moe:
        cfg_gen = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        model = Model(cfg_gen)
    L = cfg.num_layers
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, GEN_PROMPT),
                            generator=gen, device="cuda")
    eng = ServeEngine(model, GEN_BATCH, GEN_PROMPT + GEN_STEPS)
    prefilled = []                  # a MoE's (B, S0, k) expert ids a layer

    def recording(real):
        def route(probs, top_k):
            w, idx = real(probs, top_k)
            prefilled.append(idx)
            return w, idx
        return route

    ops.reset_launches()
    with (moe_patch("_route", recording) if cfg.moe
          else contextlib.nullcontext()):
        last, _, last_peak = timed(lambda: eng.prefill_logits(
            params, {"tokens": prompts})[:, -1].float())
    prompt_launches = ops.LAUNCHES["flash_attention"]
    lap("prompt_prefill")

    steps = GEN_PROMPT + GEN_STEPS - 1
    n = [0]                         # _route calls of the generate
    if cfg.moe:
        # per prompt position, layer and row: the experts decode would
        # have chosen (``_route``'s stable descending sort) and its k+1
        # largest router probabilities, kept for after the run
        k = cfg.moe.top_k
        own = torch.empty((GEN_PROMPT, L, GEN_BATCH, k), dtype=torch.int64,
                          device="cuda")
        own_top = torch.empty((GEN_PROMPT, L, GEN_BATCH, k + 1),
                              device="cuda")

    def forcing(real):
        def route(probs, top_k):
            step, layer = divmod(n[0], L)
            n[0] += 1
            if step >= GEN_PROMPT:            # generated tokens route freely
                return real(probs, top_k)
            vals, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
            own[step, layer] = order[:, 0, :top_k]
            own_top[step, layer] = vals[:, 0, :top_k + 1]
            want = prefilled[layer][:, step:step + 1]          # (B, 1, k)
            w = probs.gather(-1, want)
            return w / torch.clamp(w.sum(dim=-1, keepdim=True),
                                   min=1e-9), want
        return route

    with (moe_patch("_route", forcing) if cfg.moe
          else contextlib.nullcontext()):
        (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
            params, prompts, GEN_STEPS, return_logits=True))
    lap("generate")
    # the decode rate, from steps run alone (no patch): one traced for
    # where the time goes, then DECODE_TIMED_STEPS timed
    cache = eng.init_cache()

    def decode_steps(first, count):
        for i in range(first, first + count):
            model.decode_step(params, cache, {"tokens": prompts[:, i:i + 1]}, i)

    decode_prof = device_profile(lambda: decode_steps(0, PROFILE_STEPS))
    _, decode_s, _ = timed(lambda: decode_steps(PROFILE_STEPS,
                                                DECODE_TIMED_STEPS))
    del cache
    lap("decode_profile_and_rate")
    dec = chosen_from[:, 0].float()
    row_err = (dec - last).abs().amax(dim=-1)
    dec_err = float(row_err.max())
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > DECODE_TOL
    record["generate"] = {
        "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new_tokens": GEN_STEPS,
        "decode_steps": steps, "wall_s": gen_s,
        "ms_per_decode_step": decode_s / DECODE_TIMED_STEPS * 1e3,
        "timed_decode_steps": DECODE_TIMED_STEPS,
        "peak_bytes": gen_peak, "prompt_prefill_peak_bytes": last_peak,
        "profiled_steps": PROFILE_STEPS, "profiled": decode_prof,
        "decode_vs_prefill_max_abs": dec_err,
        "decode_vs_prefill_by_row": row_err.tolist(),
        "prefill_logit_std": float(last.std()), "tol": DECODE_TOL,
        "clear_argmax_rows": int(clear.sum())}
    checks += [
        (tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_STEPS),
         f"generated {tuple(out.shape)}"),
        (torch.equal(out[:, :GEN_PROMPT], prompts), "prompt not kept"),
        (bool(torch.isfinite(chosen_from).all()), "decode logits not finite"),
        (prompt_launches == L,
         "the 2,304-token prefill did not take the kernel"),
        (dec_err <= DECODE_TOL,
         f"decode logits differ from prefill's by {dec_err} > {DECODE_TOL}"),
        (bool((out[:, GEN_PROMPT] == last.argmax(-1))[clear].all()),
         "first generated token != prefill argmax where the gap is clear")]
    if cfg.moe:
        checks += [(n[0] == steps * L,
                    f"{n[0]} routings in {steps} decode steps of {L} layers"),
                   (len(prefilled) == L,
                    f"{len(prefilled)} routings in an {L}-layer prefill")]
        # where decode's own top k differ from the prefill's, and its
        # gap between its k-th and (k+1)-th router logits (log-
        # probabilities differ as the logits do)
        pre = torch.stack(prefilled, dim=1).permute(2, 1, 0, 3)  # S0,L,B,k
        flips = (own.sort(-1).values != pre.sort(-1).values).any(-1)
        gaps = own_top[..., k - 1].log() - own_top[..., k].log()
        at = gaps[flips]
        record["generate"].update(
            capacity_factor=cfg_gen.moe.capacity_factor,
            routing="each prompt position's experts taken from the "
                    "prompts' prefill, layer by layer; generated tokens "
                    "route freely",
            routing_flips_by_layer=flips.sum(dim=(0, 2)).tolist(),
            positions=GEN_BATCH * GEN_PROMPT,
            layer0_flips=int(flips[:, 0].sum()),
            layer0_gap_at_flips_max=float(gaps[:, 0][flips[:, 0]].max())
            if bool(flips[:, 0].any()) else None,
            gap_at_flips_max=float(at.max()) if at.numel() else None,
            gap_at_flips_median=float(at.median()) if at.numel() else None,
            gap_median=float(gaps.median()))
        del own, own_top, pre, flips, gaps, at
    del params, chosen_from, last, dec, model, eng, prefilled
    lap("generate_checks")

    # 3. the card against the CPU: full width, 2 layers, f32, TF32 off,
    # nonzero q/k/v biases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    if cfg.qkv_bias:
        draw_qkv_biases(torch, p_gpu, SERVE_SEED)
    t32 = torch.randint(0, cfg.vocab, (1, GEN_PROMPT), generator=gen,
                        device="cuda")
    ops.reset_launches()
    on_card = m_gpu.prefill(p_gpu, {"tokens": t32}).cpu()
    f32_launches = ops.LAUNCHES["flash_attention"]
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
    # decode against prefill in f32 (a MoE drop-free): the prompt less
    # its last token written to the cache in one call, then the last
    # token alone, against the prefill's last position (the kernel)
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
        "qkv_bias_std": QKV_BIAS_STD if cfg.qkv_bias else None,
        "max_abs": f32_err, "max_abs_logit": f32_scale, "rtol": F32_RTOL,
        "flash_launches": f32_launches, "cpu_s": cpu_s,
        "decode_vs_prefill_max_abs": dec32_err,
        "decode_vs_prefill_max_abs_logit": dec32_scale}
    del m_gpu, p_gpu, on_card, on_cpu, m_dec, cache
    lap("card_vs_cpu_f32")
    return finish_serve(record, laps, t_phase, checks, launches)


def finish_serve(record, laps, t_phase, checks, launches):
    """Print a serving phase's record, then run its checks; returns its
    flash launches by head dim."""
    record["seconds_by_step"] = laps
    record["seconds"] = time.perf_counter() - t_phase
    emit(record)
    for ok, msg in checks:
        check(ok, msg)
    return launches


def mamba2_dt_bias(torch, params, seed):
    """Mamba-2's own dt init (arXiv:2405.21060, state-spaces/mamba's
    dt_min/dt_max): each layer's dt_bias is softplus^-1 of a log-uniform
    draw in DT_RANGE, in place of the reference init's zeros.  A choice
    of weights, like the seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = (float(v) for v in torch.log(torch.tensor(DT_RANGE)))
    for lp in params["layers"]:
        bias = lp["mixer"]["dt_bias"]
        u = torch.exp(torch.empty(bias.shape).uniform_(lo, hi, generator=gen))
        lp["mixer"]["dt_bias"] = torch.log(torch.expm1(u)).to(bias.device)


def phase_serve_mamba2(np, torch, layers=None):
    """mamba2-1.3b serving at full width, and at full depth unless
    ``layers`` cuts it; returns the SSD launches of the 32,768-token
    prefill.  The phase's record is printed before its checks run, so a
    failed check still shows the numbers."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd import ops
    from repro_torch.models import Model
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    laps, last_lap = {}, [t_phase]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last_lap[0]
        last_lap[0] = now

    full_cfg = get_arch("mamba2-1.3b")
    cfg = dataclasses.replace(full_cfg, num_layers=layers or
                              full_cfg.num_layers)
    model = Model(cfg)
    params, init_s, _ = timed(lambda: model.init(SERVE_SEED))
    mamba2_dt_bias(torch, params, SERVE_SEED)
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
    lap("prefill")
    prefill_prof = device_profile(
        lambda: eng.prefill_logits(params, {"tokens": toks}), top=10,
        groups=groups)
    del toks
    lap("prefill_profile")

    # 2. generate: prompts fed token by token through decode (conv and
    # state caches), then 16 greedy tokens; the decode logits at the last
    # prompt position against prefill_logits (the kernel, a launch a layer)
    prompts = torch.randint(0, cfg.vocab, (GEN_BATCH, M2_GEN_PROMPT),
                            generator=gen, device="cuda")
    eng = ServeEngine(model, GEN_BATCH, M2_GEN_PROMPT + GEN_STEPS)
    (out, chosen_from), gen_s, gen_peak = timed(lambda: eng.generate(
        params, prompts, GEN_STEPS, return_logits=True))
    lap("generate")
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
    lap("decode_profile_and_checks")

    # 3. the card against the CPU: full width, 2 layers, f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    m_gpu, m_cpu = Model(cfg32), Model(cfg32, device="cpu")
    p_gpu = m_gpu.init(SERVE_SEED)
    mamba2_dt_bias(torch, p_gpu, SERVE_SEED)
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
          "seconds_by_step": {**laps, "card_vs_cpu_f32":
                              time.perf_counter() - last_lap[0]},
          "seconds": time.perf_counter() - t_phase})
    for ok, msg in checks:
        check(ok, msg)
    return launches


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
               + [timed_phase("ssd", phase_ssd, np, torch)])
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
    for name, fn, args in (
            ("serve granite-3-2b", phase_serve, ("granite-3-2b",
                                                 GRANITE_LAYERS)),
            ("serve glm4-9b", phase_serve, ("glm4-9b",)),
            ("serve qwen2-moe-a2.7b", phase_serve, ("qwen2-moe-a2.7b",)),
            ("serve qwen2-72b", phase_serve, ("qwen2-72b", FIT, True))):
        for hd, n in timed_phase(name, fn, np, torch, *args).items():
            flash[hd] = flash.get(hd, 0) + n
    check(set(flash) == {64, 128}, f"flash launches by head dim {flash}")
    launches["flash_attention"] = flash[64]
    launches["flash_attention_hd128"] = flash[128]
    launches.update(timed_phase("serve mamba2-1.3b", phase_serve_mamba2, np,
                                torch, MAMBA2_LAYERS))
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
