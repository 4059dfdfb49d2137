#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of DSCEP on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (each prints its lines; any failure exits non-zero):

1. **Build** every CUDA source under ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (one process per source, all started together), print the
   card's name and power limit, each kernel's registers and spills, and
   the count of ``HGMMA`` (``wgmma``) instructions in the SASS of the bf16
   flash kernel (7 instantiations: (D, Dv) = (16, 16), (32, 32), (64,
   64), (80, 80), (128, 128), (96, 64), (192, 128)) and of
   the bf16 SSD passes that multiply (4 each) (``cuobjdump -sass``; none
   in any instantiation, or another count of them, fails the run).
2. **Kernels against their plain versions, on the card**: the scan join,
   the probe join, the match matrix, the closure squaring step and the
   fused descendants step, each held byte for byte (tolerance 0: the
   outputs are integer ids and 0/1 matrices) against its plain PyTorch
   version on the same inputs, at the main path's shapes plus edge cases
   (the scan join also at its tile and row-group edges: KB sizes 4095,
   4096 and 4097, a row's matches across a tile with out_cap cutting
   inside one, a CONST predicate in no KB row, cross products with no
   BOUND slot past out_cap, scattered validity, W = 1, live rows filling
   no whole row group; its count and scatter launches timed apart; the
   probe join also on the edge worlds of ``tests/probe_edge_worlds.py``:
   duplicate runs over a fence, keys outside the view, views shorter than
   a fence stride, runs of exactly k_max and k_max + 1 for k_max 1, 8, 64,
   out_cap inside a block and a row, live rows in the cluster's last
   block, M off the tiles, several tiles a block, set and dead-row
   overflow, M = 0 and out_cap = 0; one probe call and one descendants
   call must each put exactly one kernel on the profiler, with no fill,
   copy, cast or scan; the closure step also at n = 64, 128, 512, 1024,
   densities 0.01, 0.2 and 1; descendants on a column view, zero and
   all-one root columns, n = 700 and 1100); then flash attention and
   decode attention at phase 7's shapes and edge cases (flash also at the tensor-core kernel's tile edges: Tq
   127/128/129, ragged Tk and ``q_offset``, a window narrower than a KV
   tile, D 16 to 128, groups 1, 3, 6), float32 within 1e-4 and bfloat16
   within 2e-2 + 1e-2 relative; a bf16 call must reach only the ``wgmma``
   kernel and an f32 call only the SIMT kernel, each timed; one decode
   call must put exactly one ``decode_`` kernel on the profiler; head dim
   80 (H2O-Danube's 32/8 heads): flash at the lane prefill of phase 12's
   longest prompt (Tq 4600 over a 4672-row lane, window 4096) and decode
   attention with a window (a tick of 8 ragged lanes, window below and
   above the length, length 0, lengths past S, one-row lanes), both
   dtypes, each bf16 shape timed beside SDPA with the same boolean mask
   (the JSON rows' ``shapes``); head dim 128 at group 6 (Mixtral-8x22B's
   48/8 heads): the same lane prefill and an 8-lane windowed tick plus a
   window-below-length case, held and timed alike; MLA's head dims, q and
   k of D against v of Dv (MiniCPM3-4B: 40/40 heads, D 96, Dv 64;
   DeepSeek-V2: 128/128 heads, D 192, Dv 128): the same lane prefill,
   causal without a window (SDPA ``is_causal``), and an 8-lane tick over
   the same lengths without a window, held and timed alike; head dim 128
   at group 4 (Jamba-v0.1-52B's 32/8 heads), causal without a window:
   the same lane prefill and 8-lane tick, held and timed alike; phase
   13's shapes, causal without a window: head dim 128 at group 7
   (Qwen2-VL-7B's 28/4 heads) at its vision forward (B 2, Tq = Tk 2048)
   and an 8-lane tick, head dim 64 at group 1 (MusicGen-large's 32/32
   heads) at its prefill (B 4, Tq = Tk 500) and a tick of its 4
   sequences at 563 rows, held and timed alike;
   then the SSD chunked scan against its plain chunked version at phase
   8's shape and edge cases (ragged T, T below the chunk, G = 2, a nonzero
   initial state), float32 within 2e-4 + 2e-4 relative, bfloat16 as the
   attention kernels, the final state within 2e-4 + 2e-4 relative, and
   one small shape against the sequential oracle; the path case's time is
   also given by kernel (the three passes).
   Each kernel is timed with CUDA events beside its plain version, its
   bound and, where one exists, one PyTorch library call computing the
   same function.
3. **The main path at full scale**: the paper's queries (Q15, Q16, CQuery1,
   artist_classes) registered through ``Session`` in ``monolithic``,
   ``single_program`` and ``pipelined`` mode under ``kb_method`` scan,
   probe and auto, over a ~0.86 M-triple KB and ``CHUNKS`` stream chunks
   of 1000-triple tumbling windows.  The three modes must give the same
   bytes with zero overflow; each line names the sink the DAG modes run
   (``split``, ``split-delta`` or ``augmented``); every pipelined edge must
   have held two chunks or more at once (``depth_hw``) and popped every
   push; the four DSCEP kernels must launch in each mode's runs.  The GPU
   run of ``monolithic`` and ``single_program`` must equal a CPU run of the
   port (plain versions) on all its chunks; ``pipelined`` is held to
   ``single_program`` on the card, so it gets no CPU run of its own.  Each
   configuration runs one warm-up chunk, then the chunks ``REPEATS`` times
   (each pass must give the same bytes); chunks/s is the median pass, with
   the spread, beside the configuration's peak device memory.
4. **Where the time goes**: a ``torch.profiler`` window over two chunks of
   CQuery1 (monolithic scan, monolithic auto, single_program auto,
   pipelined auto): device time by kernel and by PyTorch operator, and the
   device's idle share.
5. **Sliding windows and incremental evaluation**, on the same world: Q15,
   Q16 and CQuery1 at ``RANGE 1000 STEP 250``, artist_classes at its own
   ``RANGE 256 STEP 64`` (``window_from_query``), both modes, ``auto``
   with and without incremental evaluation and ``scan`` with it, and
   ``pipelined`` under ``auto`` incremental (the delta split sink; CQuery1
   keeps the augmented window).  Incremental must equal recompute,
   monolithic single_program and pipelined, and GPU the CPU (one chunk per
   query) byte for byte, with zero overflow, no triple dropped by the
   slide packing, and the pipelined channel gates of phase 3.
6. **The unfused scan join**: the four queries in both modes under
   ``kb_method="scan", fuse_compaction=False`` (the match-matrix kernel),
   tumbling, full KB; byte for byte the fused run of phase 3.
7. **LM generation**: Qwen2-1.5B at full width (28 layers, bf16, random
   weights from a seeded generator on the card), ``generate`` of
   ``LM_NEW`` greedy tokens after ``LM_BATCH`` prompts of ``LM_PROMPT``
   token ids: the cached prefill through the flash-attention kernel, each
   step through the decode-attention kernel (28 and 28 x 63 launches).
   Prefill and decode throughput (median of 3 passes after the counted
   run),
   peak memory and the device's idle share over decode steps.  Gates:
   teacher-forced logits of the kernel path within the plain attention
   path by at most twice what bf16 itself moves them (plain bf16 against
   an f32 copy of the weights, largest and mean difference), and the card
   equal to the CPU on an f32 copy (1
   prompt of 128 ids, 4 new tokens, logits within 2e-3; TF32 off).
8. **Mamba-2 generation**: mamba2-130m at full width (24 layers, bf16,
   random weights from a seeded generator on the card), ``generate`` of
   ``MAMBA_NEW`` greedy tokens after ``MAMBA_BATCH`` prompts of
   ``MAMBA_PROMPT`` token ids (the cached prefill through the SSD kernel,
   24 launches; the steps run the plain one-token recurrence), then
   ``lm.forward`` on one prompt (24 more).  Throughput, peak memory and
   idle share as phase 7; the same two gates, with the SSD kernel's plain
   version as the plain path, and equal ids on the card and the CPU.
9. **Observability and recovery**, on phase 3's world and caps: Q15 and
   CQuery1 under ``auto`` with ``trace=True`` in the three modes must give
   phase 3's bytes with the same DSCEP kernel launches (registration and
   pass), zero overflow, every saturation at most 1, equal per-operator
   counters in ``single_program`` and ``pipelined``, a monolithic
   ``hw_out`` equal to the rows its fullest window published, and
   pipelined spans for ``stage:source`` and every operator; it prints the
   stage and metrics tables, the bottleneck stage, CQuery1 pipelined
   chunks/s untraced and traced with and without fences, and CQuery1's
   EXPLAIN.  CQuery1 at phase 5's ``RANGE 1000 STEP 250``, incremental and
   traced, must count the same in both DAG modes.  Pipelined ``auto``
   under a seeded schedule of the five fault kinds
   (``RecoveryConfig(checkpoint_every=2)``) must give the fault-free bytes
   with every event fired and the channels drained, printing the
   recovery table with the checkpoint bytes and the ms per checkpoint and
   per restore; a stall under ``stage_timeout_s`` (every stage waits by
   polling CUDA events) and a crash past ``max_restarts=0`` (the chunk
   takes the channel-free fallback) must give the fault-free bytes too.

10. **Multi-query serving**, on phase 3's world and caps:
   ``serve_population(64)`` registered into one ``ServeEngine``
   (``Session.serve``) and run over the stream, (a) under ``auto`` at the
   default config with dedup, (b) the same without dedup, (c) under
   ``scan`` with ``fuse_compaction=False``, where the prefix group and the
   constant cohort run their batched programs (the match-matrix kernel).
   Every query must publish the bytes of its own port ``Session`` on the
   card (one session a distinct query body) with zero overflow; (a), (b)
   and (c) must agree byte for byte, and (a)'s first chunk with the port's
   engine on the CPU.  ``last_stats`` must report 23 distinct plans: all
   singletons in (a), one prefix group of the two class plans and one
   cohort of the 21 thresholds in (c).  (a) must launch ``descendants``
   and the KB-join kernels its plans' EXPLAIN names; (c) ``match_matrix``.
   It prints query-evaluations/s (queries x chunks over a pass, median of
   ``REPEATS`` passes after a warm-up chunk) for each arm and for the
   independent sessions, peak memory, and (a)'s device idle share over
   two chunks.
11. **Sharded paths and the launcher**, on phase 3's world and caps:
   (a) ``kb_join_sharded`` at phase 2's join shapes (the full KB's rows
   in ``SHARDS`` blocks on cuda:0, and in one block a visible card),
   ``scan`` and ``probe``: byte for byte the per-block oracle
   (``kb_join_blocks_reference``) on the card and on the CPU, the row
   sets and overflow of the unsharded join, each timed beside it; (b) Q15
   and CQuery1 ``single_program`` ``auto`` with their windows sharded over
   a data axis of ``SHARDS`` x cuda:0 and over ``make_host_mesh()``, and
   ``scan`` over the first: phase 3's bytes with zero overflow, the
   kernels of the method launched, chunks/s beside the unsharded
   configuration run in the same phase; (c) the launcher's ``main``
   (``LAUNCHER_WORLD``: CQuery1 under ``scan``, ``--fuse`` off, so the
   match matrix) in the three modes and ``--serve 8`` with and without
   dedup: equal ``done:`` counts, zero overflow.
12. **The continuous batcher** (``serve.lm.ContinuousBatcher`` over
   ``launch.serve.make_slot_fns``: queued requests prefilled into free
   lanes of a per-sequence cache, every tick decoding all lanes in one
   fixed-shape step, finished lanes reused) at full width with random
   bf16 weights: (a) H2O-Danube-1.8B (8 of its 24 layers, 32/8 heads of
   80, window 4096), 8 slots of 4672 rows, 9 requests of 256-4600 ids (4
   past the window), 8-48 new tokens; (b) OLMo-1B (8 of 16 layers), 8
   slots, 9 requests of 256-2048 ids; (c) Mamba2-130M (8 of 24 layers),
   4 slots, 9 requests; (d)
   Mixtral-8x22B (MoE, 8 experts top-2 of 16384, 48/8 heads of 128,
   window 4096) at 1 of its 56 layers (``BATCH_DEPTH``: 2.9 B of its 141 B
   parameters), danube's traffic; (e) MiniCPM3-4B (MLA: a latent cache of
   256 + 32 columns a row, 40 heads expanded to D 96, Dv 64), 4 of its
   62 layers; (f) DeepSeek-V2 (MLA at D 192, Dv 128, 128
   heads; MoE of 160 experts top-6 with 2 shared) at 1 of its 60 layers
   (5.0 B of its 239 B parameters); (g) Jamba-v0.1-52B (a period of 8
   layers: Mamba-1, d_inner 8192, d_state 16, but for one attention
   layer of 32/8 heads of 128; dense and 16-expert MoE FFNs in turn) at
   one period, 8 of its 32 layers (13.3 B of its 51.5 B parameters); (h)
   Qwen2-VL-7B (M-RoPE: each lane's three position streams from its
   cache length; 28/4 heads of 128), all 28 layers; danube's
   distributions (e, f and g: 8 slots, 9 requests, 4 of them past
   4096 ids; h: 12 requests).  Gates: every
   request drains; flash launches = attention layers x requests, decode
   launches = attention layers x ticks (every tick decodes), SSD
   launches = layers x requests in (c), nothing else; the lane logits of
   6 requests of (a), (d), (e), (f), (g) and (h) (2 past 4096 ids) and 4 of
   (b), recorded by wrapping the two
   callables, within LM_BF16_FACTOR times the bf16-vs-f32 difference of
   the single-sequence path (a batch-1 cache with a shared length fed the
   same ids; max and mean), and the ids equal to its argmax wherever its
   top-2 gap exceeds that bound; for the MoE models (d), (f) and (g),
   whose bf16 routing flips near-tied experts, also the same comparison
   on their f32 copies (all requests drained on it; both sides dropless:
   logits within 2e-3 and the ids equal at every position); (g)'s
   comparisons run on a two-layer copy at full width, layers 4 and 5 of
   its period (attention with a dense FFN, Mamba-1 with an MoE;
   ``BATCH_GATE_PATTERN``), as a float32 copy of 8 layers does not fit
   beside them; the card equal to the CPU on f32 copies at 2 layers of
   (a), (b), (e), (h) and (g)'s pattern and 1 of (d) and (f) (3 slots, 4
   requests of 32-96 ids, equal ids, logits within 2e-3); for (e), (f), (g) and (h) a
   whole decode step of 8 lanes reads nothing back to the host
   (``set_sync_debug_mode("error")``).  It prints generated tokens/s,
   ticks, peak memory and the idle share over 8 ticks of busy lanes; for
   (g) the device time of a lane prefill of 4600 ids and of a tick split
   by the Mamba-1 mixers and their scan, the MoE and the attention
   kernel; for (d) and (f) also the
   MoE's
   share of a tick's device busy time (expert products against dispatch
   and combine) and one lane prefill's MoE with its products over the
   filled slots against the reference's ``cap = n``; the tick's MoE keeps
   all its slots and it, and a whole decode step, read nothing back to
   the host (``set_sync_debug_mode("error")``), the prefill's trims.

13. **Other LM architectures** at full width and depth, random bf16
   weights, through ``lm.forward`` and ``serve.lm.generate``: (a)
   Qwen2-VL-7B (28 layers, M-RoPE sections (16, 24, 24)): ``lm.forward``
   on the vision stub, patch embeddings from a seeded generator for 2
   sequences of 2048 positions whose ``[3, B, T]`` ids are laid out as
   Qwen2-VL's ``get_rope_index`` lays them out (``rope_index``: 64 text
   ids, a 32 x 32 image of merged patches, 64 text, a 24 x 32 image, 128
   text), then ``generate`` of 32 greedy tokens after 4 text prompts of
   1024 ids; (b) MusicGen-large (48 layers, 4 codebooks of 2048):
   ``lm.forward`` on the audio stub's frame embeddings ``[4, 500,
   2048]``, then ``generate`` of 64 frames after 4 prompts of 500 frames
   x 4 codebooks (logits ``[B, T, 4, 2048]``).  Launches: flash once a
   layer in the forward and in the prefill, decode once a layer a step.
   Phase 7's throughput, peak memory, profile and gates: gate 1 on the
   generation (teacher-forced) and on the stub's forward, gate 2 on f32
   copies of 2 layers (phase 7's prompt and a stub of 256 positions, for
   Qwen2-VL with an 8 x 8 image: equal ids, logits within 2e-3).

Phases 3, 5, 6, 7, 8, 9, 10, 11, 12 and 13 each drive their path with
the launch counters zeroed just before and read just after (phases 11
and 12: before and after each of their runs); each kernel of the path
must have launched, and the JSON line's ``launches`` sums the ten
phases' path runs.

The last two lines are a JSON object with one entry per kernel and
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_CORE_OPS_PER_S = 67e12       # float32 outside the tensor cores
INT32_CORE_OPS_PER_S = 16.7e12    # 132 SMs x 64 INT32 lanes x 1.98 GHz
INT8_PEAK_OPS_PER_S = 1979e12     # dense int8 on the tensor cores

# the world (the paper's KB and stream at deployment size): ~0.86 M KB
# triples, close to the most distinct terms the 20-bit term band admits,
# and the first ~sixth of the paper's 60 k-tweet stream
ARTISTS = 100_000
FILLER = 600_000
TWEETS = 11_000
CHUNK = 7936           # 8 windows of 1000 always hold it: a graph has <= 7 triples
CHUNKS = 8
MAX_WINDOWS = 8
CAPS = dict(bind_cap=4096, scan_cap=1024, out_cap=4096,
            intermediate_cap=2048, out_stream_cap=32768)
LIVE_ROWS = 425        # valid binding rows per window in phase 2's joins
REPEATS = 3            # timed passes over the stream per configuration

# phase 5: sliding windows.  A chunk of SLIDE_CHUNK triples; each query's
# (RANGE, STEP, max_windows) gives max_windows + R - 1 slides, which hold
# the whole chunk whatever the packing (every slide but the last is filled
# to at least STEP - 6).  Incremental evaluation runs the chunk as one
# table, so scan_cap (> SLIDE_CHUNK) and bind_cap bound the chunk's rows;
# recompute uses the same caps (bind_cap numbers the output graphs, so the
# two compare byte for byte only under one bind_cap).
SLIDE_CHUNK = CHUNK // 4
SLIDE_CHUNKS = 8
SLIDE_CAPS = dict(bind_cap=4096, scan_cap=2048, out_cap=4096,
                  intermediate_cap=2048)
SLIDE_GEOMETRY = {"q15": (1000, 250, 8), "q16": (1000, 250, 8),
                  "cquery1": (1000, 250, 8),
                  "artist_classes": (256, 64, 33)}   # the query's own RANGE
SLIDE_CONFIGS = (("auto", False), ("auto", True), ("scan", True))

# phase 7: Qwen2-1.5B generation, cut from the repo's prefill_32k /
# decode_32k shapes (32 x 32,768 prompt, 128 x 32,768 cache) to one card
LM_ARCH = "qwen2-1.5b"
LM_BATCH = 4
LM_PROMPT = 2048
LM_NEW = 64
LM_MAX_LEN = 2112
LM_REPEATS = 3
LM_CPU_PROMPT = 128    # the GPU == CPU gate: 1 prompt, LM_CPU_NEW tokens
LM_CPU_NEW = 4
LM_CPU_TOL = 2e-3      # float32 logits, card against CPU (see phase_lm)
LM_BF16_FACTOR = 2.0   # bf16 kernel path against plain, in units of bf16
                       # noise (see phase_lm)
BF16_PEAK_OPS_PER_S = 989e12      # dense bf16 on the tensor cores

# phase 8: Mamba-2 generation, cut from the repo's prefill_32k shape (32 x
# 32,768 prompt) to one card and a few seconds of script
MAMBA_ARCH = "mamba2-130m"
MAMBA_BATCH = 4
MAMBA_PROMPT = 4096
MAMBA_NEW = 64
MAMBA_CPU_PROMPT = 128
MAMBA_CPU_NEW = 4

# the SSD kernel's float32 tolerance (absolute, relative): the reference's
# own SSD tolerance (tests/test_kernels.py), the chunked cumsum summing in
# another order; its bf16 outputs take ATT_TOL's, its f32 state this one
SSD_F32_TOL = (2e-4, 2e-4)

# attention kernels' tolerances: float32 sums in another order; a bf16
# output is one rounding of an f32 value that the two sides may round on
# either side of a boundary (2^-8 to 2^-7 of its magnitude)
ATT_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-2, 1e-2)}

# torch.profiler sessions per measurement (see profile_device)
PROFILE_ATTEMPTS = 4

# phase 9: observability and recovery, on phase 3's world and caps
OBS_QUERIES = ("q15", "cquery1")
CHAOS_SEED = 0         # FaultPlan.seeded draws one event of each kind
STAGE_TIMEOUT_S = 30.0

# phase 10: multi-query serving, on phase 3's world and caps.  64 standing
# queries are the reference serving benchmark's claim point; they compile
# to 23 distinct plans (2 class plans and 21 filter thresholds)
SERVE_QUERIES = 64
SERVE_DISTINCT = 23
SERVE_METHOD_KERNELS = {"probe": "probe_compact", "scan": "join_compact"}

# phase 11: sharded paths and the launcher.  (a) KB row shards at phase
# 2's join shapes, n = SHARDS on cuda:0 and n = the visible card count;
# (b) phase 3's Q15 and CQuery1 with their windows sharded over a data axis
# of SHARDS x cuda:0 and over make_host_mesh(); (c) the launcher's main on a
# world of its own flags, under scan (unfused by default: the match matrix).
# The launcher's caps are the reference's (4 windows a chunk, scan_cap 512,
# a 2048-triple output chunk), so its windows keep the default 256 triples
SHARDS = 4
LAUNCHER_WORLD = ["--query", "cquery1", "--method", "scan",
                  "--artists", "20000", "--shows", "10000",
                  "--filler", "120000", "--tweets", "2000"]
LAUNCHER_SERVE = 8

# phase 12: the continuous batcher at full width (random bf16 weights):
# (arch, slots, requests, prompt ids (lo, hi), prompts past the window,
# new ids (lo, hi), lane rows, teacher-forced requests (past the window))
BATCH_WORLDS = (
    # 9 requests (12 for Qwen2-VL's, the newest world) keep the whole
    # script near 1000 s; lanes are still reused
    ("h2o-danube-1.8b", 8, 9, (256, 4600), 4, (8, 48), 4672, (6, 2)),
    ("olmo-1b", 8, 9, (256, 2048), 0, (8, 48), 2112, (4, 0)),
    ("mamba2-130m", 4, 9, (256, 2048), 0, (8, 48), 2112, (0, 0)),
    ("mixtral-8x22b", 8, 9, (256, 4600), 4, (8, 48), 4672, (6, 2)),
    # MLA: danube's distributions (the prompts "past the window" are past
    # 4096 ids; these models have no window) over the latent cache
    ("minicpm3-4b", 8, 9, (256, 4600), 4, (8, 48), 4672, (6, 2)),
    ("deepseek-v2-236b", 8, 9, (256, 4600), 4, (8, 48), 4672, (6, 2)),
    # the hybrid pattern (Mamba-1, one attention layer a period, dense and
    # MoE FFNs): danube's draws as the MLA worlds'
    ("jamba-v0.1-52b", 8, 9, (256, 4600), 4, (8, 48), 4672, (6, 2)),
    # M-RoPE (each lane's three position streams from its device length):
    # danube's distributions, 12 requests, all 28 layers
    ("qwen2-vl-7b", 8, 12, (256, 4600), 4, (8, 48), 4672, (6, 2)),
)
# depth cuts: (layers on the card, layers of the card-against-CPU copies);
# an architecture not named here runs all its layers and BATCH_CPU's.
# H2O-Danube-1.8B (24 layers), OLMo-1B (16), Mamba2-130M (24) run 8 and
# MiniCPM3-4B 4 of its 62 to keep the script near 1000 s (PERF.md lists
# each cut).  Mixtral's 56 layers hold 141 B parameters
# (282 GB in bf16), one 2.9 B; DeepSeek-V2's 60 hold 239 B (479 GB), one
# 5.0 B; their float32 copies of 1 layer take about 12 and 20 GB a side.
# Jamba's 32 layers hold 51.5 B (103 GB); one period of 8 holds 13.3 B
# (26.5 GB)
BATCH_DEPTH = {"h2o-danube-1.8b": (8, 2), "olmo-1b": (8, 2),
               "mamba2-130m": (8, 2), "mixtral-8x22b": (1, 1),
               "deepseek-v2-236b": (1, 1), "minicpm3-4b": (4, 2),
               "jamba-v0.1-52b": (8, 2)}
# where a float32 copy of the card's depth does not fit beside it, gates 3
# and 4 run on a copy at full width whose layer pattern is this slice of
# the period: Jamba's layers 4 and 5 (attention with a dense FFN, Mamba-1
# with an MoE; 3.67 B parameters, 7.3 GB in bf16, 14.7 GB in float32)
BATCH_GATE_PATTERN = {"jamba-v0.1-52b": (4, 6)}
MOE_PREFILL = 4600     # the MoE's prefill shape in phase 12's MoE lines
BATCH_SEED = 12
# the card-against-CPU gate: float32 copies at 2 layers, 3 slots, 4
# requests of 32-96 ids (an MoE layer's CPU prefill products grow with
# them), 4 new tokens each, logits within LM_CPU_TOL
BATCH_CPU = dict(layers=2, slots=3, requests=4, prompt=(32, 96), new=4)
PROFILE_TICKS = 8
# phase 2's head-dim-80 shapes: H2O-Danube's lane prefill (the longest
# prompt over a lane of DANUBE_MAX_LEN rows) and a tick over 8 lanes
DANUBE_WINDOW = 4096
DANUBE_PROMPT_MAX = 4600
DANUBE_MAX_LEN = 4672
DANUBE_TICK_LENGTHS = [4601, 257, 4649, 2001, 4098, 1001, 3501, 300]

# phase 13: other LM architectures at full width and depth, random bf16
# weights.  Qwen2-VL-7B: the vision stub's patch embeddings over 2
# sequences of 64 text ids, a 32 x 32 image of merged patches, 64 text, a
# 24 x 32 image and 128 text (64 + 1024 + 64 + 768 + 128 = 2048
# positions, Qwen2-VL's image-grid position ids), then generate after 4
# text prompts.  MusicGen-large: 4 prompts of 500 frames x 4 codebooks
# (10 s of EnCodec tokens at 50 Hz), 64 new frames, and the audio stub's
# frame embeddings of the same length.  The card-against-CPU gates run
# f32 copies of OTHER_CPU_LAYERS layers: phase 7's prompt and a stub of
# 256 positions (Qwen2-VL: text, an 8 x 8 image, text)
VL_ARCH = "qwen2-vl-7b"
VL_LAYOUT = (("text", 64), ("image", 32, 32), ("text", 64),
             ("image", 24, 32), ("text", 128))
VL_FORWARD_BATCH = 2
VL_FORWARD_T = 2048
VL_BATCH, VL_PROMPT, VL_NEW = 4, 1024, 32
VL_CPU_LAYOUT = (("text", 96), ("image", 8, 8), ("text", 96))
AUDIO_ARCH = "musicgen-large"
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW = 4, 500, 64
AUDIO_CPU_T = 256
OTHER_CPU_LAYERS = 2
STUB_STD = 0.02        # the stubs' embeddings: the embedding table's scale

QUERIES = ("q15", "q16", "cquery1", "artist_classes")
MODES = ("monolithic", "single_program")
# phase 3 also runs the pipelined runtime (phase 5 under auto incremental)
MAIN_MODES = MODES + ("pipelined",)
DSCEP_KERNELS = ("join_compact", "probe_compact", "closure_step",
                 "descendants")
METHODS = ("scan", "probe", "auto")

# the __global__ function each kernel wrapper launches (profiler names)
KERNEL_SYMBOLS = {"join_compact": "scan_join",   # count + scatter kernels
                  "probe_compact": "probe_join_kernel",      # one launch
                  "match_matrix": "match_matrix_kernel",
                  # closure_step_pack_kernel + closure_step_kernel
                  "closure_step": "closure_step",
                  "descendants": "descendants_kernel",       # one launch
                  # flash_attention_wgmma_kernel (bf16) and
                  # flash_attention_kernel (f32)
                  "flash_attention": "flash_attention",
                  # decode_attention_mma_kernel (bf16) or
                  # decode_attention_kernel (f32): one launch a call
                  "decode_attention": "decode_",
                  # bf16: ssd_chunk_state_wgmma_kernel, ssd_state_scan_kernel,
                  # ssd_output_wgmma_kernel; f32: ssd_chunk_state_kernel,
                  # ssd_state_scan_kernel, ssd_output_kernel
                  "ssd": "ssd_"}

# the bf16 kernels whose every instantiation must hold HGMMA, by source,
# with their instantiations' count (flash: (D, Dv) = (16, 16), (32, 32),
# (64, 64), (80, 80), (128, 128) and MLA's (96, 64), (192, 128))
TENSOR_CORE_KERNELS = {
    "attention": {"flash_attention_wgmma_kernel": 7},
    "ssd": {"ssd_chunk_state_wgmma_kernel": 4, "ssd_output_wgmma_kernel": 4}}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log("FAIL: " + msg)
    sys.exit(1)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail("nvidia-smi failed: %s" % res.stderr.strip())
    return res.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(prof) -> dict:
    """Device microseconds by kernel name, from kernel events only (an
    operator's self device time repeats the time of its kernels)."""
    from torch.autograd import DeviceType

    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total
    return dev


def profile_device(fn, iters: int = 1) -> dict:
    """Device microseconds by kernel name over ``iters`` calls of ``fn()``
    (``torch.profiler``, after one call outside the session).  On the
    H100 machines a session now and then records no device event at all
    while the launch counters saw the launches (one session of a few
    dozen in a run, at no fixed place): such a session is taken again, up
    to ``PROFILE_ATTEMPTS`` times, each miss logged."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        dev = device_times(prof)
        if dev:
            return dev
        log("  (a profiler session recorded no device event: taken again)")
    return {}


def launch_ms(fn, symbol: str, iters: int = 10, by_kernel=None):
    """Mean device milliseconds per ``fn()`` of the kernels whose name holds
    ``symbol`` (``torch.profiler``): the launches alone, without what the
    wrapper does around them.  None when the profiler saw no such kernel.
    ``by_kernel``, a dict, receives the same per kernel name."""
    ours = {k: t / 1e3 / iters
            for k, t in profile_device(fn, iters).items() if symbol in k}
    if by_kernel is not None:
        by_kernel.update(ours)
    return sum(ours.values()) if ours else None


def kernel_names(fn) -> set:
    """The device kernels one ``fn()`` launches (``torch.profiler``)."""
    return set(profile_device(fn))


def hgmma_count(path: str) -> dict:
    """``HGMMA`` instructions by function in a built library's SASS."""
    from repro_torch.kernels import _cuda

    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail("cuobjdump failed: %s" % res.stderr.strip())
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def max_abs_err(a, b) -> float:
    """Largest |a - b| over matching tensors; inf on any shape mismatch."""
    err = 0.0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            return math.inf
        if x.numel():
            err = max(err, float((x.double() - y.double()).abs().max()))
    return err


# --------------------------------------------------------------------------
# the world: the paper's KB and stream at deployment size
# --------------------------------------------------------------------------

def make_world():
    from repro_torch.core.rdf import Vocab
    from repro_torch.data.dbpedia import KBConfig, generate_kb
    from repro_torch.data.tweets import (
        TweetSchema, TweetStreamConfig, generate_tweets, stream_chunks)

    t0 = time.time()
    vocab = Vocab()
    kbd = generate_kb(vocab, KBConfig(
        num_artist_classes=240, num_show_classes=60,
        num_artists=ARTISTS, num_shows=ARTISTS // 2,
        num_places=10_000, num_countries=200, filler_triples=FILLER,
        seed=0), device="cuda")
    tweets = TweetSchema.create(vocab)
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids])
    rows = generate_tweets(vocab, tweets, pool, TweetStreamConfig(
        num_tweets=TWEETS, mentions_min=2, mentions_max=3, seed=0))
    chunks = list(stream_chunks(rows, CHUNK))[:CHUNKS]
    sync()
    log("world: KB %d rows, %d terms, %d stream chunks of capacity %d "
        "(%d triples), generated in %.1f s"
        % (int(kbd.kb.count()), vocab.num_terms, len(chunks), CHUNK,
           sum(int(c.count()) for c in chunks), time.time() - t0))
    return vocab, kbd, rows, chunks


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card
# --------------------------------------------------------------------------

class KernelRecord:
    """One kernel's phase-2 numbers.  ``ms`` times the wrapper, the function
    the main path calls (argument conversion, zero-fills and scans
    included); ``launch_ms`` times its kernel launches alone."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.symbol = KERNEL_SYMBOLS[name]
        self.err = 0.0
        self.ms = self.launch_ms = self.plain_ms = self.bound_ms = None
        self.bound_by = None
        self.library_ms = None
        self.cases = 0
        self.shapes = []       # more timed shapes: the same keys a case

    def row(self, launches):
        row = {"name": self.name, "route": "cuda", "source": self.source,
               "replaces": self.replaces, "launches": launches,
               "max_abs_err": self.err, "ms": self.ms,
               "launch_ms": self.launch_ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "bound_by": self.bound_by, "library_ms": self.library_ms}
        if self.shapes:
            row["shapes"] = self.shapes
        return row

    def time_case(self, tag, fn, plain, library, bound, smi):
        """Time one more shape of the kernel: the wrapper (CUDA events), its
        launches alone (``torch.profiler``), the plain version, the library
        call (or None) and the bound ``(ms, by)``."""
        ms = cuda_ms(fn)
        alone = launch_ms(fn, self.symbol)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(library) if library is not None else None
        self.shapes.append({"case": tag, "ms": ms, "launch_ms": alone,
                            "plain_ms": plain_ms, "bound_ms": bound[0],
                            "bound_by": bound[1], "library_ms": lib_ms})
        log("  %-16s %s: wrapper %.4f ms, launches alone %s, plain %.4f ms, "
            "library %s, bound %.5f ms (%s) [%s]"
            % (self.name, tag, ms, "%.4f ms" % alone if alone is not None
               else "not measured", plain_ms,
               "%.4f ms" % lib_ms if lib_ms is not None else "none",
               bound[0], bound[1], smi))


def _bound(nbytes: float, ops: float, ops_per_s: float = FP32_CORE_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _bindings(w, m, nv, live, values, rng):
    """Bindings with ``live`` valid rows per window (compacted to the
    front), column 0 drawn from ``values``, the rest random ids."""
    from repro_torch.core.pattern import Bindings

    cols = np.zeros((w, m, nv), np.int64)
    valid = np.zeros((w, m), bool)
    for i in range(w):
        cols[i, :live, 0] = rng.choice(values, size=live)
        cols[i, :live, 1:] = rng.integers(1, 1 << 20, size=(live, nv - 1))
        valid[i, :live] = True
    return Bindings(torch.from_numpy(cols).cuda(),
                    torch.from_numpy(valid).cuda(),
                    torch.zeros((w,), dtype=torch.bool, device="cuda"))


def _same_bindings(a, b):
    return max_abs_err((a.cols, a.valid.long(), a.overflow.long()),
                       (b.cols, b.valid.long(), b.overflow.long()))


def _collide(t1: int) -> int:
    """A numeric-literal id whose composite key equals ``t1``'s."""
    mask = (1 << 20) - 1
    hi1 = t1 >> 20
    low2 = (t1 & mask) ^ (hi1 & mask) ^ ((hi1 + 1) & mask)
    return ((hi1 + 1) << 20) | low2


def _scan_join_ops(bind, kb, pat) -> float:
    """The operations a scan must do on these inputs: the KB-only checks
    (validity, CONST slots, repeated variables) once per KB row, then one
    compare a BOUND slot for every live binding row and every KB row that
    passed them."""
    from repro_torch.core.pattern import SlotMode

    slots = (pat.s, pat.p, pat.o)
    kcols = (kb.s_ps, kb.p_ps, kb.o_ps)
    kmask, checks = kb.valid, 1
    for i, sl in enumerate(slots):
        if sl.mode == SlotMode.CONST:
            kmask, checks = kmask & (kcols[i] == int(sl.const)), checks + 1
    for i in range(3):
        for j in range(i + 1, 3):
            if (slots[i].mode != SlotMode.CONST
                    and slots[j].mode != SlotMode.CONST
                    and slots[i].var == slots[j].var):
                kmask, checks = kmask & (kcols[i] == kcols[j]), checks + 1
    bound = sum(sl.mode == SlotMode.BOUND for sl in slots)
    return (float(bound) * int(bind.valid.sum()) * int(kmask.sum())
            + float(checks) * kb.capacity)


def _scattered(bind, live, rng):
    """``bind`` with ``live`` valid rows a window at random positions, the
    valid rows' ids drawn from its front rows (which were valid)."""
    w, m, _ = bind.cols.shape
    cols = bind.cols.clone()
    valid = torch.zeros_like(bind.valid)
    for i in range(w):
        pos = torch.from_numpy(rng.choice(m, live, replace=False)).cuda()
        front = int(bind.valid[i].sum())
        src = torch.from_numpy(rng.integers(0, front, live)).cuda()
        cols[i, pos] = bind.cols[i, src]
        valid[i, pos] = True
    return bind._replace(cols=cols, valid=valid)


def phase_scan_edges(vocab, kbd, bind, check, rng):
    """The scan join's tile and row-group edges, each byte for byte against
    its plain twin: KB sizes at the 4096-row register tile -1/0/+1, one
    binding row whose matches cross a tile boundary with out_cap cutting
    inside the later tile, a CONST predicate no KB row has, patterns with no
    BOUND slot (cross products past out_cap), validity scattered over the
    row groups, one window, and live rows filling no whole 1024-row group."""
    from repro_torch.core.kb import kb_from_triples
    from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
    from repro_torch.kernels.hash_join import ops as hj_ops

    tile = 4096
    sch, kb = kbd.schema, kbd.kb
    pat_type = CompiledPattern(Slot.bound(0), Slot.const_(sch.rdf_type),
                               Slot.free(1))

    def both(tag, b, k, pat, cap):
        check("join_compact", tag, hj_ops.join_compact(b, k, pat, cap),
              hj_ops.join_compact_torch(b, k, pat, cap))

    typed = kbd.rows[kbd.rows[:, 1] == sch.rdf_type]
    other = kbd.rows[kbd.rows[:, 1] != sch.rdf_type]
    for n in (tile - 1, tile, tile + 1):
        rows = np.concatenate([typed[rng.choice(len(typed), n // 3, False)],
                               other[rng.choice(len(other), n - n // 3,
                                                False)]])
        k = kb_from_triples(rows, capacity=n, device="cuda")
        b = _bindings(3, 1000, 3, 377, rows[:n // 3, 0].astype(np.int64), rng)
        both("N=%d (tile %+d), W=3 M=1000" % (n, n - tile), b, k, pat_type,
             4096)

    # a filler subject whose (p, s) run crosses a tile boundary by >= 100
    # rows on each side; its window's first row is another filler subject
    filler_p = vocab.pred("filler:pred")
    s_ps, p_ps = kb.s_ps.cpu().numpy(), kb.p_ps.cpu().numpy()
    fidx = np.flatnonzero(p_ps == filler_p)     # one run a subject
    fs = s_ps[fidx]
    starts = np.flatnonzero(np.r_[True, fs[1:] != fs[:-1]])
    ends = np.r_[starts[1:], len(fs)] - 1
    lo, hi = fidx[starts], fidx[ends]
    edge = (lo // tile + 1) * tile
    crossing = np.flatnonzero((lo + 100 <= edge) & (hi >= edge + 100))
    if not len(crossing):
        fail("no filler subject's run crosses a KB tile boundary")
    j = int(crossing[0])
    subj, lo, edge = int(fs[starts[j]]), int(lo[j]), int(edge[j])
    jf = (j + 1) % len(starts)
    first, n_first = int(fs[starts[jf]]), int(ends[jf] - starts[jf] + 1)
    cols = np.zeros((2, 64, 4), np.int64)
    valid = np.zeros((2, 64), bool)
    cols[0, :3, 0] = (first, subj, first)
    cols[1, 7, 0] = subj
    valid[0, :3] = valid[1, 7] = True
    b_cross = Bindings(torch.from_numpy(cols).cuda(),
                       torch.from_numpy(valid).cuda(),
                       torch.zeros((2,), dtype=torch.bool, device="cuda"))
    pat_fill = CompiledPattern(Slot.bound(0), Slot.const_(filler_p),
                               Slot.free(1))
    cut = n_first + (edge - lo) + 100     # the cut lands 100 rows past edge
    for cap in (cut, 4096):
        both("a row's matches cross KB row %d, out_cap=%d" % (edge, cap),
             b_cross, kb, pat_fill, cap)

    absent = int(kb.p_ps.max()) + 1
    both("CONST predicate %d in no KB row" % absent, bind, kb,
         CompiledPattern(Slot.bound(0), Slot.const_(absent), Slot.free(1)),
         4096)
    first3 = torch.arange(bind.valid.shape[1], device="cuda") < 3
    few = bind._replace(cols=bind.cols[:2], valid=bind.valid[:2] & first3,
                        overflow=bind.overflow[:2])
    both("?a rdf:type ?c (no BOUND slot), 3 live rows, out_cap 4096", few,
         kb, CompiledPattern(Slot.free(1), Slot.const_(sch.rdf_type),
                             Slot.free(2)), 4096)
    both("?a ?b ?c (no BOUND slot), 3 live rows, out_cap 4096", few, kb,
         CompiledPattern(Slot.free(1), Slot.free(2), Slot.free(3)), 4096)
    scattered = _scattered(bind, LIVE_ROWS, rng)
    both("W=8 M=4096, %d live rows a window at random positions"
         % LIVE_ROWS, scattered, kb, pat_type, 4096)
    one = bind._replace(cols=bind.cols[:1], valid=bind.valid[:1],
                        overflow=bind.overflow[:1])
    both("W=1 M=4096", one, kb, pat_type, 4096)
    ragged = _scattered(_bindings(3, 1500, 4, 1100, kbd.artist_ids.astype(
        np.int64), rng), 1100, rng)
    both("W=3 M=1500 (groups span windows), 1100 live rows at random",
         ragged, kb, pat_type, 4096)


def probe_edge_worlds():
    """The probe join's edge worlds, ``tests/probe_edge_worlds.py`` (the
    card and CPU tests build the same ones), loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_edge_worlds",
        os.path.join(REPO, "tests", "probe_edge_worlds.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_probe_edges(check):
    """Every probe edge world, byte for byte against the twin (at M = 0
    against the contract: zero rows, no valid slot, the bindings'
    overflow), each call one launch."""
    from repro_torch import interop
    from repro_torch.core.kb import build_kb
    from repro_torch.core.pattern import Bindings, CompiledPattern, Slot
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.hash_join import ops as hj_ops

    pew = probe_edge_worlds()
    for e in pew.probe_edge_worlds():
        r = e.kb_rows
        kb = build_kb(r[:, 0], r[:, 1], r[:, 2], e.capacity)
        bind = interop.bindings_from_arrays(e.cols, e.valid, e.overflow)
        pat = pew.pattern(e.pattern, Slot, CompiledPattern)
        before = _cuda.LAUNCHES["probe_compact"]
        got = hj_ops.probe_compact(Bindings(*(t.cuda() for t in bind)),
                                   kb.to("cuda"), pat, e.out_cap, e.k_max)
        if _cuda.LAUNCHES["probe_compact"] != before + 1:
            fail("probe edge %s: not one launch" % e.tag)
        w, m, nv = e.cols.shape
        if m:
            want = hj_ops.probe_compact_torch(bind, kb, pat, e.out_cap,
                                              e.k_max)
        else:
            want = Bindings(torch.zeros((w, e.out_cap, nv), dtype=torch.int64),
                            torch.zeros((w, e.out_cap), dtype=torch.bool),
                            torch.from_numpy(e.overflow))
        check("probe_compact", "edge: %s" % e.tag[:38], got,
              Bindings(*(t.cuda() for t in want)))


def phase_kernels(vocab, kbd):
    from repro_torch.core.kb import kb_from_triples, probe_view
    from repro_torch.core.pattern import CompiledPattern, Slot
    from repro_torch.core.rdf import NUM_BASE, composite_key
    from repro_torch.core.reasoner import (
        adjacency_from_edges, build_class_index, subclass_edges)
    from repro_torch.kernels.closure import ops as cl_ops
    from repro_torch.kernels.closure import ref as cl_ref
    from repro_torch.kernels.hash_join import ops as hj_ops

    rng = np.random.default_rng(0)
    sch = kbd.schema
    kb = kbd.kb
    n_kb = kb.capacity
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids]).astype(np.int64)
    w, m, nv, live = MAX_WINDOWS, CAPS["bind_cap"], 4, LIVE_ROWS
    recs = {
        "join_compact": KernelRecord(
            "join_compact", "src/repro_torch/kernels/csrc/hash_join.cu",
            "src/repro/kernels/hash_join/kernel.py:339"),
        "probe_compact": KernelRecord(
            "probe_compact", "src/repro_torch/kernels/csrc/hash_join.cu",
            "src/repro/kernels/hash_join/kernel.py:285"),
        "match_matrix": KernelRecord(
            "match_matrix", "src/repro_torch/kernels/csrc/hash_join.cu",
            "src/repro/kernels/hash_join/kernel.py:112"),
        "closure_step": KernelRecord(
            "closure_step", "src/repro_torch/kernels/csrc/closure.cu",
            "src/repro/kernels/closure/kernel.py:105"),
        "descendants": KernelRecord(
            "descendants", "src/repro_torch/kernels/csrc/closure.cu",
            "src/repro/kernels/closure/kernel.py:70"),
    }

    def timed(name, fn, plain, library=None, plain_iters=10, by_kernel=None):
        rec = recs[name]
        rec.ms = cuda_ms(fn)
        rec.launch_ms = launch_ms(fn, rec.symbol, by_kernel=by_kernel)
        rec.plain_ms = cuda_ms(plain, iters=plain_iters)
        if library is not None:
            rec.library_ms = cuda_ms(library)

    def check(name, tag, got, want):
        record(name, tag, _same_bindings(got, want) if hasattr(got, "cols")
               else max_abs_err(got, want))

    def record(name, tag, err):
        rec = recs[name]
        rec.err = max(rec.err, err)
        rec.cases += 1
        log("  %-13s %-44s max_abs_err=%g" % (name, tag, err))
        if err != 0.0:
            fail("%s disagrees with its plain version on %s" % (name, tag))

    # ?ent rdf:type ?cls — the subclass-reasoning join of Q15/CQuery1
    pat_type = CompiledPattern(Slot.bound(0), Slot.const_(sch.rdf_type),
                               Slot.free(1))
    bind = _bindings(w, m, nv, live, pool, rng)
    out_cap = CAPS["bind_cap"]

    # -- scan join at the monolithic shape: bind_cap x full KB
    got = hj_ops.join_compact(bind, kb, pat_type, out_cap)
    check("join_compact", "W=%d M=%d N=%d (main-path shape)" % (w, m, n_kb),
          got, hj_ops.join_compact_torch(bind, kb, pat_type, out_cap))
    split = {}
    timed("join_compact",
          lambda: hj_ops.join_compact(bind, kb, pat_type, out_cap),
          lambda: hj_ops.join_compact_torch(bind, kb, pat_type, out_cap),
          plain_iters=3, by_kernel=split)
    rec = recs["join_compact"]
    for k, t in sorted(split.items()):
        log("  join_compact  launches alone: %.4f ms %s" % (t, k[:80]))
    live_rows = int(bind.valid.sum())
    nbytes = (w * m * (nv * 4 + 1) + n_kb * 13
              + w * out_cap * nv * 4 + w * m * 4)
    rec.bound_ms, rec.bound_by = _bound(
        nbytes, _scan_join_ops(bind, kb, pat_type), INT32_CORE_OPS_PER_S)
    log("  join_compact  bound %.5f ms (%s; BOUND compares of the KB rows "
        "passing the KB-only checks, at the INT32 lanes' rate); the earlier "
        "formula (3 x live rows x N at the float32 cores' peak) %.5f ms (%s)"
        % ((rec.bound_ms, rec.bound_by)
           + _bound(nbytes, 3.0 * live_rows * n_kb)))

    # -- probe join at the same shape (fan-out of rdf:type by subject: 1)
    got = hj_ops.probe_compact(bind, kb, pat_type, out_cap, 8)
    check("probe_compact", "W=%d M=%d N=%d k_max=8 (main-path shape)"
          % (w, m, n_kb), got,
          hj_ops.probe_compact_torch(bind, kb, pat_type, out_cap, 8))
    timed("probe_compact",
          lambda: hj_ops.probe_compact(bind, kb, pat_type, out_cap, 8),
          lambda: hj_ops.probe_compact_torch(bind, kb, pat_type, out_cap, 8))
    rec = recs["probe_compact"]
    steps = math.ceil(math.log2(n_kb + 1)) + 1
    matched = int(got.valid.sum())
    nbytes = (w * m * (nv * 4 + 1) + live_rows * 2 * steps * 4
              + matched * 12 + w * out_cap * nv * 4 + w * m * 8)
    rec.bound_ms, rec.bound_by = _bound(
        nbytes, live_rows * (2 * steps + 3 * 8))
    # what one search reads and writes: validity, one anchor word and the
    # fence table's segment plus the k_max + 1 keys after lo a live row,
    # the matches' KB words, int64 rows, valid and overflow out
    shift = kb.fences.shift
    n_fences = -(-n_kb >> shift)
    one_bytes = (w * m + live_rows * (8 + (64 + 9) * 4) + matched * 12
                 + n_fences * 4 + w * out_cap * (nv * 8 + 1) + w)
    log("  probe_compact bound %.5f ms (%s; the earlier formula: two searches "
        "of log2 N steps a live row); one search from a %d-fence table "
        "(every %d-th key) %.5f ms (%s)"
        % ((rec.bound_ms, rec.bound_by, n_fences, 1 << shift)
           + _bound(one_bytes, live_rows * (shift + 64 + 9 + 3 * 8))))
    names = kernel_names(
        lambda: hj_ops.probe_compact(bind, kb, pat_type, out_cap, 8))
    log("  probe_compact one call, device kernels: %s" % sorted(names))
    if len(names) != 1 or KERNEL_SYMBOLS["probe_compact"] not in next(
            iter(names)):
        fail("one probe_compact call launched %s, not one probe_join_kernel"
             % sorted(names))

    # -- edge cases
    small = 64
    check("join_compact", "past out_cap (out_cap=%d)" % small,
          hj_ops.join_compact(bind, kb, pat_type, small),
          hj_ops.join_compact_torch(bind, kb, pat_type, small))
    check("probe_compact", "past out_cap (out_cap=%d)" % small,
          hj_ops.probe_compact(bind, kb, pat_type, small, 8),
          hj_ops.probe_compact_torch(bind, kb, pat_type, small, 8))
    empty = bind._replace(valid=torch.zeros_like(bind.valid))
    check("join_compact", "empty binding table",
          hj_ops.join_compact(empty, kb, pat_type, out_cap),
          hj_ops.join_compact_torch(empty, kb, pat_type, out_cap))
    check("probe_compact", "empty binding table",
          hj_ops.probe_compact(empty, kb, pat_type, out_cap, 8),
          hj_ops.probe_compact_torch(empty, kb, pat_type, out_cap, 8))

    # non-tile sizes: W=3, M=1000, a 5003-row KB slice, a repeated variable
    rows = kbd.rows[rng.choice(len(kbd.rows), size=5000, replace=False)]
    loops = np.stack([pool[:3], np.full(3, sch.same_as), pool[:3]], axis=1)
    kb_small = kb_from_triples(np.concatenate([rows, loops]), device="cuda")
    b_small = _bindings(3, 1000, 3, 377, rows[:, 0].astype(np.int64), rng)
    pat_rep = CompiledPattern(Slot.free(1), Slot.const_(sch.same_as),
                              Slot.free(1))
    check("join_compact", "W=3 M=1000 N=5003, ?x p ?x",
          hj_ops.join_compact(b_small, kb_small, pat_rep, 512),
          hj_ops.join_compact_torch(b_small, kb_small, pat_rep, 512))
    pat_any = CompiledPattern(Slot.bound(0), Slot.free(1), Slot.free(2))
    check("join_compact", "W=3 M=1000 N=5003, variable predicate",
          hj_ops.join_compact(b_small, kb_small, pat_any, 700),
          hj_ops.join_compact_torch(b_small, kb_small, pat_any, 700))

    phase_scan_edges(vocab, kbd, bind, check, rng)

    # fan-out past k_max: filler subjects each hold ~N/997 objects
    filler_p = vocab.pred("filler:pred")
    fill_subj = np.asarray([vocab.term("filler:s%d" % i) for i in range(50)])
    b_fan = _bindings(w, m, nv, 200, fill_subj, rng)
    pat_fan = CompiledPattern(Slot.bound(0), Slot.const_(filler_p),
                              Slot.free(1))
    got = hj_ops.probe_compact(b_fan, kb, pat_fan, out_cap, 16)
    if not bool(got.overflow.all()):
        fail("probe fan-out past k_max did not raise the overflow flag")
    check("probe_compact", "fan-out > k_max=16", got,
          hj_ops.probe_compact_torch(b_fan, kb, pat_fan, out_cap, 16))

    # duplicate keys and composite-key collisions of numeric literals
    base = NUM_BASE + (1 << 29) + 12345
    nums = [base + 7 * i for i in range(40)]
    coll = [_collide(t) for t in nums]
    assert all(int(composite_key(5, a)) == int(composite_key(5, b))
               for a, b in zip(nums, coll))
    trip = [(int(pool[i % 97]), 5, t) for i, t in enumerate(nums + coll)]
    trip += [(int(pool[(i + 3) % 97]), 5, t) for i, t in enumerate(nums)]
    kb_coll = kb_from_triples(np.asarray(trip, np.uint32), device="cuda")
    b_coll = _bindings(2, 300, 3, 250, np.asarray(nums + coll, np.int64), rng)
    pat_coll = CompiledPattern(Slot.free(1), Slot.const_(5), Slot.bound(0))
    keys, _, _, anchor_is_s = probe_view(kb_coll, pat_coll)
    assert not anchor_is_s
    check("probe_compact", "duplicate keys + composite collisions",
          hj_ops.probe_compact(b_coll, kb_coll, pat_coll, 1024, 8),
          hj_ops.probe_compact_torch(b_coll, kb_coll, pat_coll, 1024, 8))
    check("join_compact", "numeric literals, object bound",
          hj_ops.join_compact(b_coll, kb_coll, pat_coll, 1024),
          hj_ops.join_compact_torch(b_coll, kb_coll, pat_coll, 1024))
    phase_probe_edges(check)

    # -- match matrix: the candidate matrix of the unfused scan join
    def check_mm(tag, b, k, pat):
        """The kernel's [W, M, N] matrix against the plain one, a window at
        a time (the plain version's temporaries stay one window wide)."""
        got = hj_ops.match_matrix(b, k, pat)
        if got.dtype != torch.bool or got.shape != (
                b.cols.shape[0], b.cols.shape[1], k.capacity):
            fail("match_matrix gave %s %s" % (got.dtype, tuple(got.shape)))
        err = 0.0
        for i in range(got.shape[0]):
            want = hj_ops.match_matrix_torch(
                b._replace(cols=b.cols[i:i + 1], valid=b.valid[i:i + 1],
                           overflow=b.overflow[i:i + 1]), k, pat)
            err = max(err, float((got[i] != want[0]).any()))
        record("match_matrix", tag, err)
        return got

    torch.cuda.reset_peak_memory_stats()
    got = check_mm("W=%d M=%d N=%d (main-path shape)" % (w, m, n_kb), bind,
                   kb, pat_type)
    log("  match_matrix  W=%d output %.2f GB, max_memory_allocated %.2f GB"
        % (w, got.numel() / 1e9, torch.cuda.max_memory_allocated() / 1e9))
    del got
    rec = recs["match_matrix"]
    mm_fn = lambda: hj_ops.match_matrix(bind, kb, pat_type)    # noqa: E731
    rec.ms = cuda_ms(mm_fn, iters=5)
    rec.launch_ms = launch_ms(mm_fn, rec.symbol, iters=5)
    rec.plain_ms = cuda_ms(lambda: hj_ops.match_matrix_torch(
        bind, kb, pat_type), iters=2, warmup=1)
    rec.bound_ms, rec.bound_by = _bound(
        w * m * n_kb + 13 * n_kb + w * m * 4 * nv, 3.0 * live_rows * n_kb)
    buf = torch.empty((w, m, n_kb), dtype=torch.int8, device="cuda")
    log("  match_matrix  write-rate yardstick: fill_ of the same %.2f GB "
        "%.4f ms" % (buf.numel() / 1e9, cuda_ms(lambda: buf.fill_(0), iters=5)))
    del buf
    # ids straddling 2^31, every slot mode, repeated variables, M and N off
    # the kernel's tiles (64 rows x 1024 columns)
    high = np.asarray([4096, 4097, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
                       0xFFFFFFFE], np.int64)
    hrows = np.stack([rng.choice(high, 5003), rng.integers(1, 4, 5003),
                      rng.choice(high, 5003)], axis=1)
    hrows[:6, 1] = 2
    hrows[:6, 2] = hrows[:6, 0]
    kb_high = kb_from_triples(hrows.astype(np.uint32), capacity=5007,
                              device="cuda")
    b_high = _bindings(3, 1000, 3, 377, high, rng)
    b_high.cols[:, :377, 1:] = torch.from_numpy(
        rng.choice(high, size=(3, 377, 2))).cuda()
    for tag, pat in (
            ("B C F", CompiledPattern(Slot.bound(0), Slot.const_(2),
                                      Slot.free(1))),
            ("F C B", CompiledPattern(Slot.free(2), Slot.const_(2),
                                      Slot.bound(0))),
            ("C C F, const 2^31", CompiledPattern(Slot.const_(1 << 31),
                                                  Slot.const_(1),
                                                  Slot.free(2))),
            ("B F B", CompiledPattern(Slot.bound(0), Slot.free(1),
                                      Slot.bound(2))),
            ("B F F", CompiledPattern(Slot.bound(0), Slot.free(1),
                                      Slot.free(2))),
            ("?x C ?x (repeated free)", CompiledPattern(
                Slot.free(1), Slot.const_(2), Slot.free(1))),
            ("?x F ?x (repeated bound)", CompiledPattern(
                Slot.bound(0), Slot.free(1), Slot.bound(0)))):
        check_mm("W=3 M=1000 N=5007 ids across 2^31, %s" % tag, b_high,
                 kb_high, pat)
    check_mm("W=3 M=1000 N=5003, ?x p ?x", b_small, kb_small, pat_rep)
    kb_none = kb_from_triples(np.zeros((0, 3), np.uint32), capacity=5,
                              device="cuda")
    check_mm("empty KB (5 invalid rows)", b_high, kb_none, pat_type)
    check_mm("empty KB (0 rows)", b_high,
             kb_none._make(c[:0] for c in kb_none), pat_type)

    # -- closure kernels on the world's class hierarchy
    edges = subclass_edges(kb, sch.subclass_of)
    idx, ids = build_class_index(edges)
    adj = adjacency_from_edges(edges, idx)
    reach = cl_ops._reach(adj, 128, "cuda")
    n = reach.shape[0]
    log("  class hierarchy: %d classes, reach matrix %d x %d" % (len(ids), n, n))
    r = reach
    for step in range(cl_ops._steps(len(ids), None) - 1):
        nxt = cl_ops.closure_step(r)
        check("closure_step", "hierarchy n=%d, squaring %d" % (n, step + 1),
              (nxt,), (cl_ref.closure_step_ref(r),))
        r = nxt
    timed("closure_step", lambda: cl_ops.closure_step(reach),
          lambda: cl_ref.closure_step_ref(reach),
          lambda: torch.clamp_max(torch.matmul(reach, reach), 1.0))
    rec = recs["closure_step"]
    # the best rate for a 0/1 product on this card is the int8 tensor-core
    # peak; the float32 cores' bound is logged beside it
    rec.bound_ms, rec.bound_by = _bound(2 * n * n * 4, 2.0 * n ** 3,
                                        INT8_PEAK_OPS_PER_S)
    log("  closure_step  n=%d bound %.5f ms (%s, int8 tensor-core peak); at "
        "the float32 cores' peak %.5f ms (%s)" % (
            (n, rec.bound_ms, rec.bound_by)
            + _bound(2 * n * n * 4, 2.0 * n ** 3)))
    for cn in (64, 128, 512, 1024):
        for dens in (0.01, 0.2, 1.0):
            cr = (torch.rand((cn, cn), device="cuda") < dens).float()
            check("closure_step", "random n=%d density %g" % (cn, dens),
                  (cl_ops.closure_step(cr),), (cl_ref.closure_step_ref(cr),))

    root = idx[sch.musical_artist]
    rootcol = r[:, root]            # a column view, as the path passes it
    got = cl_ops.descendants_step(r, rootcol, len(ids))
    check("descendants", "hierarchy n=%d, root MusicalArtist" % n, got,
          cl_ref.descendants_step_ref(r, rootcol, len(ids)))
    names = kernel_names(
        lambda: cl_ops.descendants_step(r, rootcol, len(ids)))
    log("  descendants   one call, device kernels: %s" % sorted(names))
    if len(names) != 1 or KERNEL_SYMBOLS["descendants"] not in next(
            iter(names)):
        fail("one descendants call launched %s, not one descendants_kernel"
             % sorted(names))
    for tag, col in (("zeros", torch.zeros(n, device="cuda")),
                     ("ones", torch.ones(n, device="cuda"))):
        check("descendants", "hierarchy n=%d, root column of %s" % (n, tag),
              cl_ops.descendants_step(r, col, len(ids)),
              cl_ref.descendants_step_ref(r, col, len(ids)))
    timed("descendants", lambda: cl_ops.descendants_step(r, rootcol, len(ids)),
          lambda: cl_ref.descendants_step_ref(r, rootcol, len(ids)),
          lambda: torch.nonzero(
              torch.clamp_max(torch.mv(r, rootcol), 1.0) > 0.5))
    rec = recs["descendants"]
    rec.bound_ms, rec.bound_by = _bound(n * n * 4 + n * 4 + len(ids) * 4 + 4,
                                        2.0 * n * n)
    check("descendants", "count past out_cap (out_cap=50)",
          cl_ops.descendants_step(r, rootcol, 50),
          cl_ref.descendants_step_ref(r, rootcol, 50))
    rand = (torch.rand((640, 640), device="cuda") < 0.01).float()
    rand = torch.clamp_max(rand + torch.eye(640, device="cuda"), 1.0)
    check("closure_step", "random n=640", (cl_ops.closure_step(rand),),
          (cl_ref.closure_step_ref(rand),))
    for dn in (700, 1100):
        rnd = (torch.rand((dn, dn), device="cuda") < 0.02).float()
        col = rnd[:, 3]
        check("descendants", "random n=%d, a column view" % dn,
              cl_ops.descendants_step(rnd, col, dn),
              cl_ref.descendants_step_ref(rnd, col, dn))
    sync()
    return recs


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def query_texts():
    from repro_torch.core import paper_queries as PQ

    texts = dict(PQ.RQ_TEXTS)
    with open(os.path.join(REPO, "examples", "queries",
                           "artist_classes.rq")) as f:
        texts["artist_classes"] = f.read()
    return texts


def exec_config(mode, method, device, **kw):
    from repro_torch.core.session import ExecutionConfig

    cfg = dict(window_capacity=1000, max_windows=MAX_WINDOWS, **CAPS)
    cfg.update(kw)
    return ExecutionConfig(mode=mode, kb_method=method, device=device, **cfg)


def _launch_delta(before):
    from repro_torch.kernels import _cuda

    return {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}


def same_outputs(a, b) -> bool:
    return len(a) == len(b) and all(
        all(torch.equal(x, y) for x, y in zip(oa, ob)) for oa, ob in zip(a, b))


def run_session(vocab, kb, chunks, text, cfg, repeats=1):
    """Register (plan time) and run the stream.  With ``repeats > 1`` one
    warm-up chunk runs first, then the stream ``repeats`` times, each pass
    timed and held to the first's bytes.  Returns a dict: outputs on the
    host, overflow totals, plan seconds, run seconds per pass, the kernel
    launches of the registration and of one pass, the peak device memory
    (the world's KB included) and the window (capacity, step) in effect."""
    from repro_torch.core.session import Session
    from repro_torch.kernels import _cuda

    # one vocab for every session: a query interns the same names whichever
    # session registers it first, so outputs stay comparable
    gc.collect()        # a Session and its queries form a reference cycle
    sess = Session(cfg, vocab=vocab, kb=kb)
    sync()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    reg = sess.register(text)
    sync()
    plan_s = time.perf_counter() - t0
    plan_launches = _launch_delta(before)
    if repeats > 1:
        reg.run(chunks[:1])
        sync()
    outs = overflow = run_launches = None
    run_s = []
    for _ in range(repeats):
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        got, ovf = reg.run(chunks)
        sync()
        run_s.append(time.perf_counter() - t0)
        if outs is None:
            outs, overflow, run_launches = got, ovf, _launch_delta(before)
        elif not same_outputs(got, outs) or ovf != overflow:
            fail("a repeated pass over the stream gave other bytes (%s)"
                 % cfg.mode)
    return {"outs": [tuple(c.cpu() for c in o) for o in outs],
            "overflow": overflow, "plan_s": plan_s, "run_s": run_s,
            "plan_launches": plan_launches, "run_launches": run_launches,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "geometry": (reg.config.window_capacity,
                         reg.config.window_step),
            "sink": getattr(reg.runtime, "sink_kind", "-"),
            "channels": reg.channel_stats(), "reg": reg}


def check_channels(res, what):
    """A pipelined run's edges: every push popped, nothing dropped, and two
    chunks or more in flight on every edge."""
    chans = res["channels"]
    if not chans:
        fail("no channel statistics for %s" % what)
    for edge, st in chans.items():
        if (st["depth_hw"] < 2 or st["pushes"] != st["pops"]
                or st["overflows"] or st["size"]):
            fail("channel %s of %s: %s" % (edge, what, st))
    return " ".join("%s depth_hw=%d pushes=%d" % (
        edge.split("->")[0], st["depth_hw"], st["pushes"])
        for edge, st in chans.items())


def rate_text(res) -> str:
    """chunks/s of the median pass (slowest-fastest) and peak memory."""
    n = len(res["outs"])
    rates = sorted(n / t for t in res["run_s"])
    return ("%d chunks: %.2f chunks/s median of %d passes (%.2f-%.2f), "
            "peak %.2f GB" % (n, rates[len(rates) // 2], len(rates), rates[0],
                              rates[-1], res["peak_gb"]))


def n_triples(outs) -> int:
    return sum(int(o[5].sum()) for o in outs)


def path_launches(name, needed, smi):
    """Read the counters after a path's run (zeroed just before it) and
    fail if a kernel of the path never launched."""
    from repro_torch.kernels import _cuda

    sync()
    launches = dict(_cuda.LAUNCHES)
    log("%s launches: %s [%s]" % (name, json.dumps(launches), smi))
    for k in needed:
        if launches[k] <= 0:
            fail("kernel %s never launched on the %s" % (k, name))
    return launches


def _short(launches) -> str:
    return ",".join("%s=%d" % (k, v) for k, v in launches.items() if v) or "none"


def phase_main(vocab, kbd, chunks, smi):
    from repro_torch.core.stream import merge_streams
    from repro_torch.core.window import count_windows
    from repro_torch.kernels import _cuda

    texts = query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks]
    log("phase 3: caps %s, window 1000 triples x %d windows, %d chunks, "
        "1 warm-up chunk + %d timed passes per configuration"
        % (" ".join("%s=%d" % kv for kv in CAPS.items()), MAX_WINDOWS,
           len(chunks), REPEATS))
    results, config_launches = {}, {}
    by_mode = {mode: {k: 0 for k in _cuda.LAUNCHES} for mode in MAIN_MODES}
    _cuda.reset_launches()
    for q in QUERIES:
        for method in METHODS:
            for mode in MAIN_MODES:
                before = dict(_cuda.LAUNCHES)
                res = run_session(vocab, kbd.kb, gpu_chunks, texts[q],
                                  exec_config(mode, method, "cuda"), REPEATS)
                for k, v in _launch_delta(before).items():
                    by_mode[mode][k] += v
                outs, ovf = res["outs"], res["overflow"]
                results[(q, mode, method)] = outs
                config_launches[(q, mode, method)] = (res["plan_launches"],
                                                      res["run_launches"])
                log("  %-14s %-14s %-5s sink %-11s plan %.3f s, %s, %d "
                    "output triples, overflow %s, launches plan {%s} pass "
                    "{%s} [%s]"
                    % (q, mode, method, res["sink"], res["plan_s"],
                       rate_text(res), n_triples(outs), ovf,
                       _short(res["plan_launches"]),
                       _short(res["run_launches"]), smi))
                if any(ovf.values()):
                    fail("overflow in %s %s %s: %s" % (q, mode, method, ovf))
                if n_triples(outs) == 0:
                    fail("empty output stream for %s %s %s" % (q, mode, method))
                if mode == "pipelined":
                    log("    channels: %s" % check_channels(
                        res, "%s %s" % (q, method)))
            for mode in MAIN_MODES[1:]:
                if not same_outputs(results[(q, "monolithic", method)],
                                    results[(q, mode, method)]):
                    fail("monolithic != %s for %s %s" % (mode, q, method))
            log("  %-14s %-5s monolithic == single_program == pipelined "
                "byte for byte" % (q, method))
    launches = path_launches("phase 3 (tumbling main path)", DSCEP_KERNELS,
                             smi)
    for mode, counts in by_mode.items():
        log("  launches in %s runs: %s" % (mode, _short(counts)))
        for k in DSCEP_KERNELS:
            if counts[k] <= 0:
                fail("kernel %s never launched in phase 3's %s runs"
                     % (k, mode))

    # host-side window packing of one merged chunk (host clock, synced)
    merged = [merge_streams([c]) for c in gpu_chunks]
    sync()
    t0 = time.perf_counter()
    for mg in merged:
        count_windows(mg, 1000, MAX_WINDOWS)
    sync()
    log("window packing (host numpy + gather): %.3f ms per chunk [%s]"
        % ((time.perf_counter() - t0) * 1e3 / len(merged), smi))

    # the GPU run equals a CPU run of the port (plain versions)
    kb_cpu = kbd.kb.to("cpu")
    combos = [(q, mode, method) for q in QUERIES for mode in MODES
              for method in ("probe", "auto")]
    combos += [(q, "single_program", "scan") for q in QUERIES]
    for q, mode, method in combos:
        res = run_session(vocab, kb_cpu, chunks, texts[q],
                          exec_config(mode, method, "cpu"))
        if not same_outputs(res["outs"],
                            results[(q, mode, method)]):
            fail("GPU != CPU for %s %s %s" % (q, mode, method))
        log("  %-14s %-14s %-5s GPU == CPU on %d chunks (CPU %.1f s)"
            % (q, mode, method, len(res["outs"]), res["run_s"][0]))
    return launches, results, config_launches


def slide_config(q, mode, method, incremental, device):
    """Phase 5's configuration of query ``q``: its (RANGE, STEP) geometry
    with max_windows slides enough for a whole chunk."""
    cap, step, max_windows = SLIDE_GEOMETRY[q]
    geometry = (dict(window_from_query=True) if q == "artist_classes"
                else dict(window_capacity=cap, window_step=step))
    return exec_config(mode, method, device, max_windows=max_windows,
                       incremental=incremental,
                       out_stream_cap=max_windows * SLIDE_CAPS["out_cap"],
                       **SLIDE_CAPS, **geometry)


def phase_sliding(vocab, kbd, rows, smi):
    from repro_torch.core.stream import merge_streams
    from repro_torch.core.window import count_slides
    from repro_torch.data.tweets import stream_chunks
    from repro_torch.kernels import _cuda

    texts = query_texts()
    chunks = list(stream_chunks(rows, SLIDE_CHUNK))[:SLIDE_CHUNKS]
    gpu_chunks = [c.to("cuda") for c in chunks]
    log("phase 5: %d chunks of capacity %d (%d triples), caps %s, "
        "1 warm-up chunk + %d timed passes per configuration"
        % (len(chunks), SLIDE_CHUNK, sum(int(c.count()) for c in chunks),
           " ".join("%s=%d" % kv for kv in SLIDE_CAPS.items()), REPEATS))
    # the slides of every geometry hold the whole chunk: no triple dropped
    for q, (cap, step, max_windows) in SLIDE_GEOMETRY.items():
        dropped, used = 0, 0
        for c in gpu_chunks:
            view = count_slides(merge_streams([c]), cap, max_windows, step)
            dropped += int((view.stream.valid
                            & (view.slide_of_row < 0)).sum())
            used = max(used, int(view.slide_valid.sum()))
        log("  %-14s RANGE %d STEP %d, max_windows %d: %d slides, at most "
            "%d used; %d triples dropped" % (q, cap, step, max_windows,
                                             max_windows + -(-cap // step) - 1,
                                             used, dropped))
        if dropped:
            fail("the slides of %s dropped %d triples" % (q, dropped))

    results = {}
    _cuda.reset_launches()
    for q in QUERIES:
        for method, incremental in SLIDE_CONFIGS:
            # the pipelined runtime under auto incremental: the delta split
            # sink, or CQuery1's augmented fallback (its OPTIONAL)
            modes = MODES + (("pipelined",) if (method, incremental)
                             == ("auto", True) else ())
            for mode in modes:
                cfg = slide_config(q, mode, method, incremental, "cuda")
                res = run_session(vocab, kbd.kb, gpu_chunks, texts[q], cfg,
                                  REPEATS)
                outs, ovf = res["outs"], res["overflow"]
                results[(q, mode, method, incremental)] = outs
                log("  %-14s %-14s %-5s %-11s RANGE %d STEP %d: sink %s, "
                    "%s, %d output triples, overflow %s [%s]"
                    % (q, mode, method,
                       "incremental" if incremental else "recompute",
                       *res["geometry"], res["sink"], rate_text(res),
                       n_triples(outs), ovf, smi))
                if any(ovf.values()):
                    fail("overflow in %s %s %s incremental=%s: %s"
                         % (q, mode, method, incremental, ovf))
                if n_triples(outs) == 0:
                    fail("empty output stream for %s %s %s" % (q, mode, method))
                if mode == "pipelined":
                    log("    channels: %s" % check_channels(
                        res, "%s sliding" % q))
        ref = results[(q, "monolithic", "auto", False)]
        for key, outs in results.items():
            if key[0] == q and not same_outputs(outs, ref):
                fail("%s %s %s incremental=%s != monolithic auto recompute"
                     % key)
        log("  %-14s incremental == recompute, scan == auto, monolithic == "
            "single_program == pipelined byte for byte" % q)
    launches = path_launches("phase 5 (sliding windows)", DSCEP_KERNELS, smi)

    kb_cpu = kbd.kb.to("cpu")
    for q in QUERIES:
        res = run_session(vocab, kb_cpu, chunks[:1], texts[q],
                          slide_config(q, "single_program", "auto", True,
                                       "cpu"))
        if not same_outputs(
                res["outs"], results[(q, "single_program", "auto", True)][:1]):
            fail("GPU != CPU for %s single_program auto incremental" % q)
        log("  %-14s single_program auto incremental GPU == CPU on 1 chunk "
            "(CPU %.1f s)" % (q, res["run_s"][0]))
    return launches


def phase_unfused(vocab, kbd, chunks, fused, smi):
    from repro_torch.kernels import _cuda

    texts = query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks]
    log("phase 6: kb_method=scan, fuse_compaction=False, tumbling, %d "
        "chunks, caps as phase 3" % len(gpu_chunks))
    _cuda.reset_launches()
    for q in QUERIES:
        for mode in MODES:
            res = run_session(vocab, kbd.kb, gpu_chunks, texts[q],
                              exec_config(mode, "scan", "cuda",
                                          fuse_compaction=False), REPEATS)
            outs, ovf = res["outs"], res["overflow"]
            log("  %-14s %-14s unfused scan: %s, %d output triples, overflow "
                "%s, launches pass {%s} [%s]"
                % (q, mode, rate_text(res), n_triples(outs), ovf,
                   _short(res["run_launches"]), smi))
            if any(ovf.values()):
                fail("overflow in %s %s unfused: %s" % (q, mode, ovf))
            if not same_outputs(outs, fused[(q, mode, "scan")]):
                fail("unfused != fused for %s %s" % (q, mode))
        log("  %-14s unfused == fused byte for byte" % q)
    launches = path_launches("phase 6 (unfused scan join)",
                             ("match_matrix", "closure_step", "descendants"),
                             smi)
    if launches["join_compact"]:
        fail("the unfused path launched the fused scan join")
    return launches


def phase_profile(vocab, kbd, chunks, smi):
    """Where the time goes: a torch.profiler window over two chunks of
    CQuery1 per configuration — device time by kernel and by PyTorch
    operator, the four ported kernels' share, and the device's idle share
    of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.session import Session

    texts = query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks[:3]]
    for q, mode, method in (("cquery1", "monolithic", "scan"),
                            ("cquery1", "monolithic", "auto"),
                            ("cquery1", "single_program", "auto"),
                            ("cquery1", "pipelined", "auto")):
        reg = Session(exec_config(mode, method, "cuda"), vocab=vocab,
                      kb=kbd.kb).register(texts[q])
        reg.run(gpu_chunks[:1])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            reg.run(gpu_chunks[1:3])
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = device_times(prof)
        busy = sum(dev.values())
        if busy <= 0:
            log("  profile %s %s %s: no device time recorded (not measured)"
                % (q, mode, method))
            continue
        ours = {k: sum(t for key, t in dev.items() if sym in key)
                for k, sym in KERNEL_SYMBOLS.items()}
        log("  profile %s %s %s, 2 chunks: wall %.1f ms, device busy %.1f ms "
            "(idle share %.3f), ported kernels %.2f ms (%s) [%s]"
            % (q, mode, method, wall_us / 1e3, busy / 1e3,
               max(0.0, 1 - busy / wall_us), sum(ours.values()) / 1e3,
               ", ".join("%s %.2f ms" % (k, v / 1e3) for k, v in ours.items()
                         if v), smi))
        log("    by kernel:")
        for key, t in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
            log("    %8.2f ms  %s" % (t / 1e3, key[:120]))
        # an operator's device time includes that of the operators it calls
        ops = [(e.device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
               and e.device_time_total > 0]
        log("    by PyTorch operator (inclusive device time, calls):")
        for t, n, key in sorted(ops, reverse=True)[:8]:
            log("    %8.2f ms  %5d  %s" % (t / 1e3, n, key))



# --------------------------------------------------------------------------
# phase 9: observability and recovery
# --------------------------------------------------------------------------

def window_rows(outs, bind_cap):
    """The most output triples one window published: ``construct`` numbers
    a window's output graphs from ``window * bind_cap``."""
    most = 0
    for o in outs:
        graph, valid = o[4][o[5]], o[5]
        if valid.any():
            most = max(most, int(torch.bincount(graph // bind_cap).max()))
    return most


def chaos_plan(dag):
    """A seeded schedule over the five fault kinds: one event of each,
    drawn by ``FaultPlan.seeded`` over the stream's chunks and the stages
    where the kind can fire (a transport fault on a stage that pushes: the
    source or an upstream operator; a crash or stall on any stage)."""
    from repro_torch.core.faults import FAULT_KINDS, FaultPlan

    producers = ["source"] + [n for n in dag.subqueries if n != dag.final]
    stages = {"drop_payload": producers, "duplicate_payload": producers}
    return FaultPlan(tuple(
        ev for i, kind in enumerate(FAULT_KINDS)
        for ev in FaultPlan.seeded(
            CHAOS_SEED + i, stages.get(kind, producers + [dag.final]),
            CHUNKS, 1, (kind,)).events))


def aten_ops(fn) -> int:
    """The aten ops ``fn()`` dispatches (host-side count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


class _Timed:
    """Wall time of each call of a runtime's method, synced at its end
    (checkpoints copy to the host; restores copy back to the card)."""

    def __init__(self, obj, name):
        self.ms = []
        real = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = real(*a, **k)
            sync()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, timed)

    def text(self) -> str:
        if not self.ms:
            return "none"
        return "%d, %.2f ms each (%.2f-%.2f)" % (
            len(self.ms), sum(self.ms) / len(self.ms), min(self.ms),
            max(self.ms))


def phase_observability(vocab, kbd, rows, chunks, results, config_launches,
                        smi):
    """Phase 9: traced runs in every mode held to phase 3's bytes and
    launches, the engine metrics' gates, the trace's cost on chunks/s,
    EXPLAIN, incremental counters, and the pipelined runtime under a
    seeded chaos schedule, a stage timeout and a degraded chunk."""
    from repro_torch.core import pipeline as ppipeline
    from repro_torch.core.faults import FaultEvent, FaultPlan
    from repro_torch.core.recovery import RecoveryConfig, tree_bytes
    from repro_torch.core.session import Session
    from repro_torch.data.tweets import stream_chunks
    from repro_torch.kernels import _cuda
    from repro_torch.obs import (
        TraceConfig, bottleneck_stage, format_explain, format_metrics_table,
        format_recovery_table, format_stage_table)

    texts = query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks]
    log("phase 9: observability and recovery, %s, auto, caps as phase 3"
        % ", ".join(OBS_QUERIES))
    _cuda.reset_launches()

    # traced runs: phase 3's bytes and launches, and the metrics' gates
    for q in OBS_QUERIES:
        counters = {}
        for mode in MAIN_MODES:
            res = run_session(vocab, kbd.kb, gpu_chunks, texts[q],
                              exec_config(mode, "auto", "cuda", trace=True))
            reg, outs = res["reg"], res["outs"]
            stats = reg.last_stats
            what = "%s %s traced" % (q, mode)
            if not same_outputs(outs, results[(q, mode, "auto")]):
                fail("%s != phase 3's untraced bytes" % what)
            if any(res["overflow"].values()):
                fail("overflow in %s: %s" % (what, res["overflow"]))
            plan_l, run_l = config_launches[(q, mode, "auto")]
            for k in DSCEP_KERNELS:
                if (res["plan_launches"][k], res["run_launches"][k]) != (
                        plan_l[k], run_l[k]):
                    fail("%s launched %s %d + %d times, untraced %d + %d"
                         % (what, k, res["plan_launches"][k],
                            res["run_launches"][k], plan_l[k], run_l[k]))
            ops = stats["operators"]
            if set(ops) != set(reg.operators):
                fail("%s: metrics for %s, operators %s"
                     % (what, sorted(ops), sorted(reg.operators)))
            for op, entry in ops.items():
                for key, sat in entry["saturation"].items():
                    if sat > 1.0:
                        fail("%s: %s %s saturation %.3f > 1"
                             % (what, op, key, sat))
            counters[mode] = {op: e["counters"] for op, e in ops.items()}
            if mode == "monolithic":
                hw = counters[mode][q]["hw_out"]
                want = window_rows(outs, CAPS["bind_cap"])
                if hw != want:
                    fail("%s: hw_out %d, published %d rows in its fullest "
                         "window" % (what, hw, want))
            if mode == "pipelined":
                stages = {p.split("/")[-1] for p in stats["spans"]}
                want = {"stage:source"} | {"stage:%s" % n
                                           for n in reg.operators}
                if stages != want:
                    fail("%s: spans %s, stages %s"
                         % (what, sorted(stages), sorted(want)))
                for line in format_stage_table(stats["spans"]).splitlines():
                    log("    " + line)
                log("    bottleneck stage: %s"
                    % bottleneck_stage(stats["spans"], prefix="stage"))
                for line in format_metrics_table(ops).splitlines():
                    log("    " + line)
            log("  %-8s %-14s traced: phase 3's bytes and DSCEP launches, "
                "saturation <= 1, zero overflow; counters %s [%s]"
                % (q, mode, json.dumps(counters[mode]), smi))
            del res, reg
        if counters["single_program"] != counters["pipelined"]:
            fail("%s: single_program and pipelined counters differ" % q)
        log("  %-8s single_program == pipelined counters" % q)

    # the trace's cost on one configuration: untraced, traced without and
    # with fences, in turns (A B C C B A), and the aten ops of one chunk
    # (printed, not gated)
    settings = (("untraced", None),
                ("traced, fence=False", TraceConfig(fence=False)),
                ("traced, fence=True", True))
    rates = {label: [] for label, _ in settings}
    ops = {}
    for label, trace in settings + settings[::-1]:
        res = run_session(vocab, kbd.kb, gpu_chunks, texts["cquery1"],
                          exec_config("pipelined", "auto", "cuda",
                                      trace=trace), REPEATS)
        rates[label] += [len(res["outs"]) / t for t in res["run_s"]]
        ops.setdefault(label, aten_ops(lambda: res["reg"].run(gpu_chunks[:1])))
        del res
    for label, _ in settings:
        xs = sorted(rates[label])
        log("  trace cost, cquery1 pipelined auto %-20s %.2f chunks/s median "
            "of %d passes in 2 turns (%.2f-%.2f), %d aten ops a chunk [%s]"
            % (label, xs[len(xs) // 2], len(xs), xs[0], xs[-1], ops[label],
               smi))
    reg = Session(exec_config("single_program", "auto", "cuda"), vocab=vocab,
                  kb=kbd.kb).register(texts["cquery1"])
    for line in format_explain(reg.explain()).splitlines():
        log("    " + line)
    del reg

    # incremental: the delta evaluator's counters equal in both DAG modes
    slide_chunks = [c.to("cuda") for c in
                    list(stream_chunks(rows, SLIDE_CHUNK))[:SLIDE_CHUNKS]]
    inc = {}
    for mode in ("single_program", "pipelined"):
        cfg = slide_config("cquery1", mode, "auto", True, "cuda")
        res = run_session(vocab, kbd.kb, slide_chunks, texts["cquery1"],
                          cfg.replace(trace=True))
        inc[mode] = {op: e["counters"] for op, e in
                     res["reg"].last_stats["operators"].items()}
        if any(res["overflow"].values()):
            fail("overflow in cquery1 %s incremental traced" % mode)
        del res
    if inc["single_program"] != inc["pipelined"]:
        fail("incremental counters differ: %s" % inc)
    log("  cquery1 RANGE 1000 STEP 250 incremental: single_program == "
        "pipelined counters, n_retract %s"
        % {op: c.get("n_retract") for op, c in inc["pipelined"].items()})

    # chaos: a seeded schedule over the five kinds, recovered bit-exact
    for q in OBS_QUERIES:
        plan = chaos_plan(Session(
            exec_config("single_program", "auto", "cuda"), vocab=vocab,
            kb=kbd.kb).register(texts[q]).dag)
        sess = Session(exec_config("pipelined", "auto", "cuda", faults=plan,
                                   recovery=RecoveryConfig(checkpoint_every=2)),
                       vocab=vocab, kb=kbd.kb)
        reg = sess.register(texts[q])
        rt = reg.runtime
        ckpt = _Timed(rt, "_take_checkpoint")
        restore = [_Timed(rt, "_restore_full"), _Timed(rt, "_rebuild_degraded")]
        t0 = time.perf_counter()
        outs, ovf = reg.run(gpu_chunks)
        sync()
        wall = time.perf_counter() - t0
        rec = reg.last_stats["recovery"]
        what = "%s chaos (%s)" % (q, ", ".join(
            "%s@%s:%d" % (e.kind, e.stage, e.chunk) for e in plan.events))
        if not same_outputs([tuple(c.cpu() for c in o) for o in outs],
                            results[(q, "pipelined", "auto")]):
            fail("%s != the fault-free bytes" % what)
        if any(ovf.values()):
            fail("overflow in %s: %s" % (what, ovf))
        if rec["injected"] != rec["scheduled"]:
            fail("%s: injected %s, scheduled %s"
                 % (what, rec["injected"], rec["scheduled"]))
        for edge, st in reg.channel_stats().items():
            if st["size"] or st["overflows"]:
                fail("%s: channel %s not drained: %s" % (what, edge, st))
        log("  %s: the fault-free bytes, every event fired, channels "
            "drained; %d chunks in %.3f s; checkpoints %s, %d bytes the "
            "last (tree_bytes %d); restores %s [%s]"
            % (what, len(outs), wall, ckpt.text(), rec["checkpoint_bytes"],
               tree_bytes([rt._ckpt.win_ch.slots,
                           [c.slots for c in rt._ckpt.out_ch.values()],
                           rt._ckpt.envs]),
               " / ".join(r.text() for r in restore), smi))
        for line in format_recovery_table(rec).splitlines():
            log("    " + line)
        del sess, reg, rt, outs

    # a stall with a stage timeout (every stage's wait polls its events),
    # and a chunk past max_restarts through the channel-free fallback
    q = "cquery1"
    final = Session(exec_config("single_program", "auto", "cuda"),
                    vocab=vocab, kb=kbd.kb).register(texts[q]).dag.final
    for label, plan, rcfg, check in (
            ("stall, stage timeout %.0f s" % STAGE_TIMEOUT_S,
             FaultPlan((FaultEvent("stall_stage", final, 1),)),
             RecoveryConfig(stage_timeout_s=STAGE_TIMEOUT_S),
             lambda rec, waits: rec["retries"] == 1 and waits > 0),
            ("crash past max_restarts=0",
             FaultPlan((FaultEvent("crash_stage", "source", 1),)),
             RecoveryConfig(checkpoint_every=0, max_restarts=0),
             lambda rec, waits: rec["degraded_chunks"] == [1])):
        waits = []
        real_wait = ppipeline.wait_until_ready

        def counted(out, timeout_s):
            waits.append(timeout_s)
            return real_wait(out, timeout_s)

        reg = Session(exec_config("pipelined", "auto", "cuda", faults=plan,
                                  recovery=rcfg),
                      vocab=vocab, kb=kbd.kb).register(texts[q])
        with mock.patch.object(ppipeline, "wait_until_ready", counted):
            outs, ovf = reg.run(gpu_chunks)
        rec = reg.last_stats["recovery"]
        if not same_outputs([tuple(c.cpu() for c in o) for o in outs],
                            results[(q, "pipelined", "auto")]):
            fail("%s %s != the fault-free bytes" % (q, label))
        if any(ovf.values()) or not check(rec, len(waits)):
            fail("%s %s: overflow %s, %d timed waits, recovery %s"
                 % (q, label, ovf, len(waits), rec))
        log("  %s %s: the fault-free bytes; %d timed waits (event polling), "
            "retries %d, restarts %d, degraded %s [%s]"
            % (q, label, len(waits), rec["retries"], rec["restarts"],
               rec["degraded_chunks"], smi))
        del reg, outs
    # every configuration here runs kb_method="auto", which takes the
    # probe join on this world (as phase 3's auto runs do)
    return path_launches("phase 9 (observability and recovery)",
                         ("probe_compact", "closure_step", "descendants"),
                         smi)


# --------------------------------------------------------------------------
# phase 10: multi-query serving
# --------------------------------------------------------------------------

def kb_join_kernels(plan) -> set:
    """The KB-join kernels of a plan's fused steps, as its EXPLAIN names
    their methods (``probe`` the probe join, ``scan`` the scan join)."""
    from repro_torch.core.planner import explain_plan

    found = set()

    def walk(x):
        if isinstance(x, dict):
            if x.get("step") == "KBJoin":
                found.add(SERVE_METHOD_KERNELS[x["method"]])
            for v in x.values():
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(explain_plan(plan))
    return found


def host_outputs(outs):
    return {n: [tuple(c.cpu() for c in o) for o in os]
            for n, os in outs.items()}


def same_served(a, b) -> bool:
    """Two ``{query: [output chunk, ...]}`` maps hold the same bytes."""
    return set(a) == set(b) and all(same_outputs(a[n], b[n]) for n in a)


def serve_arm(vocab, kb, chunks, texts, cfg, dedup=True):
    """Register the population into one ServeEngine (plan time), run one
    warm-up chunk, then the stream ``REPEATS`` times, each pass timed and
    held to the first's bytes.  Outputs stay on the card."""
    from repro_torch.core.session import Session

    gc.collect()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Session(cfg, vocab=vocab, kb=kb).serve(dedup=dedup)
    for t in texts:
        eng.register(t)
    sync()
    plan_s = time.perf_counter() - t0
    eng.process_chunk(chunks[0])
    outs, run_s = None, []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        got, _ = eng.run(chunks)
        sync()
        run_s.append(time.perf_counter() - t0)
        if outs is None:
            outs = got
        elif not same_served(got, outs):
            fail("a repeated serving pass gave other bytes")
    return {"eng": eng, "outs": outs, "plan_s": plan_s, "run_s": run_s,
            "overflow": eng.overflow_totals(), "stats": eng.last_stats,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_rate(n_queries, n_chunks, run_s, peak_gb) -> str:
    rates = sorted(n_queries * n_chunks / t for t in run_s)
    return ("%.1f query-evaluations/s median of %d passes (%.1f-%.1f), "
            "peak %.2f GB" % (rates[len(rates) // 2], len(rates), rates[0],
                              rates[-1], peak_gb))


def phase_serving(vocab, kbd, chunks, smi):
    """Phase 10: ``serve_population(SERVE_QUERIES)`` in one ServeEngine,
    (a) ``auto`` at the default config, (b) the same with dedup off, (c)
    ``scan`` unfused (the batched programs); every query held to its own
    session, the arms to each other and (a)'s first chunk to the CPU."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.session import Session
    from repro_torch.kernels import _cuda
    from repro_torch.launch.dscep_run import serve_population

    texts = serve_population(SERVE_QUERIES)
    names = [t.split()[2] for t in texts]
    gpu_chunks = [c.to("cuda") for c in chunks]
    n_chunks = len(gpu_chunks)
    log("phase 10: serving %d standing queries (serve_population), %d "
        "chunks, caps as phase 3, 1 warm-up chunk + %d timed passes per arm"
        % (len(texts), n_chunks, REPEATS))
    arms = (("a", "auto default, dedup", dict(method="auto"), True),
            ("b", "auto default, no dedup", dict(method="auto"), False),
            ("c", "scan unfused, dedup",
             dict(method="scan", fuse_compaction=False), True))
    res, arm_launches = {}, {}
    _cuda.reset_launches()
    for key, label, kw, dedup in arms:
        kw = dict(kw)
        cfg = exec_config("monolithic", kw.pop("method"), "cuda", **kw)
        before = dict(_cuda.LAUNCHES)
        r = res[key] = serve_arm(vocab, kbd.kb, gpu_chunks, texts, cfg,
                                 dedup)
        arm_launches[key] = _launch_delta(before)
        st = r["stats"]
        log("  (%s) %-22s plan %.3f s, %s; distinct plans %d, singletons %d, "
            "prefix groups %s, cohorts %s, launches {%s} [%s]"
            % (key, label, r["plan_s"],
               serve_rate(len(texts), n_chunks, r["run_s"], r["peak_gb"]),
               st["distinct_plans"], st["singletons"],
               [len(g["queries"]) for g in st["prefix_groups"]],
               st["batch_sizes"], _short(arm_launches[key]), smi))
        if any(r["overflow"].values()):
            fail("overflow in serving arm (%s): %s" % (key, r["overflow"]))
        if sorted(r["outs"]) != sorted(names):
            fail("serving arm (%s) did not publish every query" % key)
    need = set().union(*(kb_join_kernels(u.plan)
                         for u in res["a"]["eng"].units.values()))
    need.add("descendants")
    launches = path_launches("phase 10 (serving)",
                             sorted(need | {"match_matrix"}), smi)

    sa, sc = res["a"]["stats"], res["c"]["stats"]
    if (sa["distinct_plans"], sa["singletons"], sa["prefix_groups"],
            sa["cohorts"]) != (SERVE_DISTINCT, SERVE_DISTINCT, [], []):
        fail("(a) schedule: %s" % {k: sa[k] for k in (
            "distinct_plans", "singletons", "prefix_groups", "cohorts")})
    if res["b"]["stats"]["distinct_plans"] != len(texts):
        fail("(b) deduplicated with dedup off")
    cls = sorted(g["queries"] for g in sc["prefix_groups"])
    if (sc["distinct_plans"] != SERVE_DISTINCT or len(cls) != 1
            or len(cls[0]) != 2 or sc["batch_sizes"] != [SERVE_DISTINCT - 2]
            or not all(n.startswith("thr")
                       for n in sc["cohorts"][0]["queries"])
            or sc["singletons"]):
        fail("(c) schedule: one prefix group of the two class plans and one "
             "cohort of the %d thresholds expected, got %s"
             % (SERVE_DISTINCT - 2, {k: sc[k] for k in (
                 "distinct_plans", "prefix_groups", "batch_sizes",
                 "singletons")}))
    for k in sorted(need):
        if arm_launches["a"][k] <= 0:
            fail("kernel %s never launched in serving arm (a)" % k)
    if arm_launches["c"]["match_matrix"] <= 0:
        fail("match_matrix never launched in the batched programs of (c)")
    log("  (a) launched %s (the KB joins' EXPLAIN methods); (c) launched "
        "match_matrix %d times" % (sorted(need),
                                   arm_launches["c"]["match_matrix"]))
    for key in ("b", "c"):
        if not same_served(res[key]["outs"], res["a"]["outs"]):
            fail("serving arm (%s) != (a)" % key)
    log("  (a) == (b) == (c) byte for byte, zero overflow")

    # every query against its own port session on the card (one session a
    # distinct query body), then all of them timed as independent sessions
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    body = [t.replace(n, "", 1) for t, n in zip(texts, names)]
    sessions = {}
    for t, b in zip(texts, body):
        if b not in sessions:
            sessions[b] = Session(exec_config("monolithic", "auto", "cuda"),
                                  vocab=vocab, kb=kbd.kb).register(t)
    served = host_outputs(res["a"]["outs"])
    for b, reg in sessions.items():
        outs, ovf = reg.run(gpu_chunks)
        if any(ovf.values()):
            fail("overflow in the independent session of %s" % reg.query.name)
        own = [tuple(c.cpu() for c in o) for o in outs]
        for n, bb in zip(names, body):
            if bb == b and not same_outputs(served[n], own):
                fail("served %s != its own session" % n)
    for reg in sessions.values():
        reg.run(gpu_chunks[:1])
    run_s = []
    for _ in range(REPEATS):
        sync()
        t0 = time.perf_counter()
        for b in body:
            sessions[b].run(gpu_chunks)
        sync()
        run_s.append(time.perf_counter() - t0)
    log("  every served query == its own Session on the card (%d distinct "
        "sessions); independent sessions: %s [%s]"
        % (len(sessions), serve_rate(len(texts), n_chunks, run_s,
                                     torch.cuda.max_memory_allocated() / 1e9),
           smi))
    del sessions, served

    # (a)'s first chunk against the port's engine on the CPU
    cpu_eng = Session(exec_config("monolithic", "auto", "cpu"), vocab=vocab,
                      kb=kbd.kb.to("cpu")).serve()
    for t in texts:
        cpu_eng.register(t)
    t0 = time.perf_counter()
    cpu_out = cpu_eng.process_chunk(chunks[0])
    first = {n: os[:1] for n, os in host_outputs(res["a"]["outs"]).items()}
    if not same_served({n: [tuple(o)] for n, o in cpu_out.items()}, first):
        fail("serving (a) GPU != CPU on the first chunk")
    log("  (a) GPU == CPU engine on the first chunk (CPU %.1f s)"
        % (time.perf_counter() - t0))
    del cpu_eng, cpu_out

    # (a)'s device idle share over two chunks
    eng = res["a"]["eng"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        eng.process_chunk(gpu_chunks[1])
        eng.process_chunk(gpu_chunks[2])
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(device_times(prof).values())
    log("  profile (a), 2 chunks: wall %.1f ms, device busy %s [%s]"
        % (wall_us / 1e3, "%.1f ms (idle share %.3f)"
           % (busy / 1e3, max(0.0, 1 - busy / wall_us)) if busy > 0
           else "not measured (no device event recorded)", smi))
    return launches


# --------------------------------------------------------------------------
# phase 11: sharded paths and the launcher
# --------------------------------------------------------------------------

def binding_rows(b) -> list:
    """Each window's valid binding rows as a sorted list of tuples (host)."""
    cols, valid = b.cols.cpu(), b.valid.cpu()
    return [sorted(map(tuple, cols[w][valid[w]].tolist()))
            for w in range(cols.shape[0])]


def kb_mesh(devices):
    from repro_torch.launch.mesh import Mesh

    return Mesh(np.array(devices, dtype=object), ("model",))


def data_mesh(devices):
    from repro_torch.launch.mesh import Mesh

    return Mesh(np.array(devices, dtype=object).reshape(len(devices), 1),
                ("data", "model"))


def launcher(argv):
    """``dscep_run.main(argv)`` on the card: its return value, its report
    lines and the host seconds it took (world generation included)."""
    import io

    from repro_torch.launch import dscep_run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = dscep_run.main(argv)
    sync()
    return ret, buf.getvalue().splitlines(), time.perf_counter() - t0


def phase_sharded(vocab, kbd, chunks, results, smi):
    """Phase 11: (a) ``kb_join_sharded`` against the per-block oracle on the
    card and on the CPU and against the unsharded join, timed beside it;
    (b) sharded ``single_program`` sessions against phase 3's bytes, timed
    beside the unsharded configuration; (c) the launcher's ``main`` in the
    three modes and ``--serve``.  Returns the launches of the three path
    runs (counters zeroed before each, read after it)."""
    from repro_torch.core import algebra, kb_dist
    from repro_torch.core.kb import shard_rows
    from repro_torch.core.pattern import CompiledPattern, Slot
    from repro_torch.kernels import _cuda
    from repro_torch.launch.mesh import make_host_mesh

    total = {k: 0 for k in _cuda.LAUNCHES}

    def path(name, needed, fn):
        _cuda.reset_launches()
        out = fn()
        counts = path_launches(name, needed, smi)
        for k in total:
            total[k] += counts[k]
        return out

    # (a) the KB's rows sharded over a model axis
    rng = np.random.default_rng(0)
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids]).astype(np.int64)
    bind = _bindings(MAX_WINDOWS, CAPS["bind_cap"], 4, LIVE_ROWS, pool, rng)
    bind_cpu = type(bind)(*(t.cpu() for t in bind))
    pat = CompiledPattern(Slot.bound(0), Slot.const_(kbd.schema.rdf_type),
                          Slot.free(1))
    out_cap = CAPS["bind_cap"]
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    log("phase 11 (a): kb_join_sharded, W=%d M=%d (%d live rows a window) "
        "N=%d, out_cap %d, ?ent rdf:type ?cls"
        % (MAX_WINDOWS, CAPS["bind_cap"], LIVE_ROWS, kbd.kb.capacity, out_cap))
    for label, devices in (("%d x cuda:0" % SHARDS, [cards[0]] * SHARDS),
                           ("%d visible card(s)" % len(cards), cards)):
        n, mesh = len(devices), kb_mesh(devices)
        blocks = shard_rows(kbd.kb, n)
        blocks_cpu = type(blocks)(*(c.cpu() for c in blocks))
        for method in ("scan", "probe"):
            kernel = SERVE_METHOD_KERNELS[method]
            got = path("phase 11 (a) %s %s" % (label, method), (kernel,),
                       lambda: kb_dist.kb_join_sharded(
                           bind, blocks, pat, out_cap, mesh, method=method))
            oracle = kb_dist.kb_join_blocks_reference(bind, blocks, pat,
                                                      out_cap, n, method)
            if _same_bindings(got, oracle) != 0.0:
                fail("kb_join_sharded (%s, %s) != the block oracle on the "
                     "card" % (label, method))
            t0 = time.perf_counter()
            oracle_cpu = kb_dist.kb_join_blocks_reference(
                bind_cpu, blocks_cpu, pat, out_cap, n, method)
            cpu_s = time.perf_counter() - t0
            if _same_bindings(got, type(got)(*(
                    t.cuda() for t in oracle_cpu))) != 0.0:
                fail("kb_join_sharded (%s, %s) != the block oracle on the "
                     "CPU" % (label, method))
            whole = algebra.kb_join(bind, kbd.kb, pat, out_cap, method=method)
            if (binding_rows(got) != binding_rows(whole)
                    or not torch.equal(got.overflow, whole.overflow)
                    or bool(got.overflow.any())):
                fail("kb_join_sharded (%s, %s): row sets or overflow differ "
                     "from the unsharded join" % (label, method))
            ms = cuda_ms(lambda: kb_dist.kb_join_sharded(
                bind, blocks, pat, out_cap, mesh, method=method))
            whole_ms = cuda_ms(lambda: algebra.kb_join(
                bind, kbd.kb, pat, out_cap, method=method))
            log("  %-22s %-5s n=%d: == block oracle on the card and on the CPU "
                "(CPU %.1f s), row sets == unsharded, %d matches, no overflow; "
                "sharded %.4f ms, unsharded %.4f ms (%.2fx) [%s]"
                % (label, method, n, cpu_s, int(got.valid.sum()), ms,
                   whole_ms, whole_ms / ms, smi))

    # (b) phase 3's sessions with their windows sharded over a data axis
    texts = query_texts()
    gpu_chunks = [c.to("cuda") for c in chunks]
    host = make_host_mesh()
    log("phase 11 (b): single_program, windows sharded over a data axis "
        "(%s x cuda:0; make_host_mesh() %s), phase 3's world, caps and "
        "chunks" % (SHARDS, host))
    configs = [("auto", "unsharded", None),
               ("auto", "%d x cuda:0" % SHARDS, data_mesh([cards[0]] * SHARDS)),
               ("auto", "make_host_mesh()", host),
               ("scan", "%d x cuda:0" % SHARDS, data_mesh([cards[0]] * SHARDS))]
    for q in OBS_QUERIES:
        for method, label, mesh in configs:
            kw = {} if mesh is None else dict(mesh=mesh)
            cfg = exec_config("single_program", method, "cuda", **kw)
            repeats = REPEATS if method == "auto" else 1
            if mesh is None:
                res = run_session(vocab, kbd.kb, gpu_chunks, texts[q], cfg,
                                  repeats)
            else:
                needed = (("join_compact",) if method == "scan" else
                          ("probe_compact", "closure_step", "descendants"))
                res = path("phase 11 (b) %s %s %s" % (q, method, label),
                           needed, lambda: run_session(
                               vocab, kbd.kb, gpu_chunks, texts[q], cfg,
                               repeats))
            if not same_outputs(res["outs"], results[(q, "single_program",
                                                      method)]):
                fail("sharded %s %s (%s) != phase 3's bytes"
                     % (q, method, label))
            if any(res["overflow"].values()):
                fail("overflow in sharded %s %s (%s): %s"
                     % (q, method, label, res["overflow"]))
            log("  %-8s %-5s %-18s sink %-9s plan %.3f s, %s, == phase 3's "
                "bytes, overflow 0 [%s]"
                % (q, method, label, res["sink"], res["plan_s"],
                   rate_text(res), smi))

    # (c) the launcher
    log("phase 11 (c): python -m repro_torch.launch.dscep_run %s"
        % " ".join(LAUNCHER_WORLD))
    done = {}
    for extra in (["--mode", "monolithic"], ["--mode", "single_program"],
                  ["--mode", "pipelined"], ["--serve", str(LAUNCHER_SERVE)],
                  ["--serve", str(LAUNCHER_SERVE), "--no-dedup"]):
        ret, lines, secs = path(
            "phase 11 (c) %s" % " ".join(extra),
            ("match_matrix", "closure_step", "descendants"),
            lambda: launcher(LAUNCHER_WORLD + extra))
        for line in lines:
            if "chunk" in line or "done:" in line or "schedule" in line:
                log("  | " + line)
        ends = [ln for ln in lines if "] done:" in ln]
        clipped = [ln for ln in lines
                   if re.search(r"[1-9]\d* overflowed windows", ln)
                   or ("per operator:" in ln and not ln.endswith("none"))]
        if len(ends) != 1 or ret <= 0 or clipped:
            fail("launcher %s: returned %s, %s" % (extra, ret, ends + clipped))
        # done: counts, and each chunk's output count where the mode
        # prints one (the stream cap must not have clipped a chunk)
        per_chunk = [int(m.group(1)) for m in (
            re.search(r"chunk \d+: (\d+) output triples", ln)
            for ln in lines) if m]
        if any(c >= 2048 for c in per_chunk):
            fail("launcher %s: a chunk filled the output stream cap: %s"
                 % (extra, per_chunk))
        done[" ".join(extra)] = (ret, per_chunk)
        log("  %-32s %d output triples in %.1f s (world included) [%s]"
            % (" ".join(extra), ret, secs, smi))
    modes = [v[0] for k, v in done.items() if k.startswith("--mode")]
    serves = [v[0] for k, v in done.items() if k.startswith("--serve")]
    if (len(set(modes)) != 1 or len(set(serves)) != 1
            or done["--mode monolithic"][1] != done["--mode single_program"][1]):
        fail("launcher done: or per-chunk counts differ: %s" % done)
    log("  monolithic == single_program == pipelined (%d triples; per "
        "chunk in the first two); --serve %d with and without dedup (%d "
        "triples)"
        % (modes[0], LAUNCHER_SERVE, serves[0]))
    for k in ("join_compact", "probe_compact", "closure_step", "descendants",
              "match_matrix"):
        if total[k] <= 0:
            fail("kernel %s never launched in phase 11" % k)
    log("phase 11 launches: %s [%s]" % (json.dumps(total), smi))
    return total


# --------------------------------------------------------------------------
# phase 2, continued: the attention kernels
# --------------------------------------------------------------------------

def _randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _live_pairs(tq, tk, causal, window, q_offset) -> int:
    """(query, key) pairs the masks keep: the work flash attention does."""
    qpos = q_offset + np.arange(tq, dtype=np.int64)
    hi = np.minimum(qpos, tk - 1) if causal else np.full(tq, tk - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(tq, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def phase_attention(smi):
    """Flash and decode attention against their plain versions on the
    card, at phase 7's shapes (timed there) and edge cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    recs = {
        "flash_attention": KernelRecord(
            "flash_attention", "src/repro_torch/kernels/csrc/attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:84"),
        "decode_attention": KernelRecord(
            "decode_attention", "src/repro_torch/kernels/csrc/attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:73"),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)

    def record(name, tag, got, want, dtype):
        atol, rtol = ATT_TOL[dtype]
        err = float((got.float() - want.float()).abs().max())
        excess = float(((got.float() - want.float()).abs()
                        - rtol * want.float().abs()).max())
        rec = recs[name]
        rec.err = max(rec.err, err)
        rec.cases += 1
        log("  %-16s %-52s max_abs_err=%.3g (tol %g + %g rel)"
            % (name, tag, err, atol, rtol))
        if not math.isfinite(err) or excess > atol:
            fail("%s disagrees with its plain version on %s" % (name, tag))

    hq, hk, d = 12, 2, 128
    b, tq, tk = LM_BATCH, LM_PROMPT, LM_MAX_LEN
    # (tag, b, hq, hk, tq, tk, d, causal, window, q_offset)
    flash_cases = [
        ("path prefill", b, hq, hk, tq, tk, d, True, None, 0),
        ("second prefill, q_offset 1800", 2, hq, hk, 300, tk, d, True, None,
         1800),
        ("ragged Tq 1000 Tk 1077 q_offset 77, group 6 D 64", 1, 6, 1, 1000,
         1077, 64, True, None, 77),
        ("window 128, group 3 D 32", 2, 6, 2, 700, 700, 32, True, 128, 0),
        ("window 50 q_offset 500, group 1 D 16", 1, 4, 4, 100, 612, 16, True,
         50, 500),
        ("group 1 D 64", 2, 4, 4, 333, 333, 64, True, None, 0),
        ("not causal, D 16", 1, 4, 2, 65, 129, 16, False, None, 0),
        ("no live key (window 0)", 1, 2, 1, 70, 70, 16, True, 0, 0),
        # the tensor-core kernel's edges: 128-row query and KV tiles
        ("Tq 127, group 6 D 128", 1, 6, 1, 127, 127, 128, True, None, 0),
        ("Tq 128 Tk 200 q_offset 72, group 3 D 64", 2, 6, 2, 128, 200, 64,
         True, None, 72),
        ("Tq 129, group 1 D 32", 1, 2, 2, 129, 129, 32, True, None, 0),
        ("Tq 129 Tk 333 q_offset 204 window 40, group 3 D 128", 1, 3, 1, 129,
         333, 128, True, 40, 204),
        ("Tq 300 Tk 1000 q_offset 700 window 100, group 6 D 16", 1, 6, 1,
         300, 1000, 16, True, 100, 700),
        ("not causal Tq 129 Tk 65, group 1 D 128", 1, 2, 2, 129, 65, 128,
         False, None, 0),
        ("not causal window 30 Tq 127 Tk 191 q_offset 64, group 6 D 64", 1,
         6, 1, 127, 191, 64, False, 30, 64),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for tag, cb, chq, chk, ctq, ctk, cd, causal, window, off in flash_cases:
            q = _randn((cb, chq, ctq, cd), dtype, gen)
            k = _randn((cb, chk, ctk, cd), dtype, gen)
            v = _randn((cb, chk, ctk, cd), dtype, gen)
            got = fa_ops.flash_attention(q, k, v, causal, window, off)
            record("flash_attention", "%s %s" % (tag, str(dtype)[6:]), got,
                   fa_ref.attention_ref(q, k, v, causal, window, off), dtype)

    # the path's prefill shape, bf16: timed
    q = _randn((b, hq, tq, d), torch.bfloat16, gen)
    k = _randn((b, hk, tk, d), torch.bfloat16, gen)
    v = _randn((b, hk, tk, d), torch.bfloat16, gen)
    sdpa = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)
    log("  flash_attention  SDPA(is_causal, top-left) against the plain "
        "version: max_abs_err=%.3g" % float(
            (sdpa.float() - fa_ref.attention_ref(q, k, v).float()).abs().max()))
    rec = recs["flash_attention"]
    rec.ms = cuda_ms(lambda: fa_ops.flash_attention(q, k, v))
    rec.launch_ms = launch_ms(lambda: fa_ops.flash_attention(q, k, v),
                              rec.symbol)
    rec.plain_ms = cuda_ms(lambda: fa_ref.attention_ref(q, k, v), iters=3)
    rec.library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    # a bf16 tensor reaches only the tensor-core kernel, an f32 one only the
    # SIMT kernel
    qf, kf, vf = q.float(), k.float(), v.float()
    for dtype, args, own, other in (
            ("bf16", (q, k, v), "flash_attention_wgmma_kernel",
             "flash_attention_kernel"),
            ("f32", (qf, kf, vf), "flash_attention_kernel",
             "flash_attention_wgmma_kernel")):
        names = kernel_names(lambda: fa_ops.flash_attention(*args))
        if not any(own in n for n in names) or any(other in n
                                                   for n in names):
            fail("flash_attention %s reached %s" % (dtype, sorted(names)))
    f32_ms = launch_ms(lambda: fa_ops.flash_attention(qf, kf, vf),
                       rec.symbol, iters=3)
    log("  flash_attention  f32 SIMT kernel at the path shape: launches "
        "alone %s, wrapper %.4f ms [%s]" % (
            "%.4f ms" % f32_ms if f32_ms is not None else "not measured",
            cuda_ms(lambda: fa_ops.flash_attention(qf, kf, vf), iters=3),
            smi))
    del qf, kf, vf
    pairs = b * hq * _live_pairs(tq, tk, True, None, 0)
    rec.bound_ms, rec.bound_by = _bound(
        2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * d * pairs,
        BF16_PEAK_OPS_PER_S)
    log("  flash_attention  path shape: %d live pairs, %.3g operations"
        % (pairs, 4.0 * d * pairs))

    # (tag, b, hq, hk, s, d, lengths)
    length = LM_PROMPT + LM_NEW // 2
    decode_cases = [
        ("path step, length %d" % length, b, hq, hk, tk, d, [length] * b),
        ("lengths 0, 1, 2079, 2112", 4, hq, hk, tk, d, [0, 1, 2079, 2112]),
        ("group 1 D 64", 3, 2, 2, 1000, 64, [1000, 513, 64]),
        ("group 3 D 16, S 77", 2, 6, 2, 77, 16, [77, 0]),
        ("group 6 D 32, S 130", 2, 12, 2, 130, 32, [65, 130]),
        # the one-launch kernel's edges (8 splits a (batch, KV head) here):
        # 128 and 1152 end a split, 129 and 1153 put one row in the next
        ("split edges 128, 129, 1152, 1153", 4, hq, hk, tk, d,
         [128, 129, 1152, 1153]),
        ("all splits dead but the first", 4, hq, hk, tk, d, [1, 1, 64, 2]),
        ("group 8 D 128", 2, 16, 2, 1000, 128, [1000, 517]),
        ("group 12 (two head groups) D 64", 2, 24, 2, 300, 64, [300, 171]),
        ("B 1 S 32768", 1, hq, hk, 32768, d, [32768]),
        ("olmo tick, group 1 D 128, 8 ragged lanes", 8, 16, 16, 2112, 128,
         [2049, 300, 1, 2112, 1500, 257, 800, 2000]),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for tag, cb, chq, chk, cs, cd, lengths in decode_cases:
            q = _randn((cb, chq, 1, cd), dtype, gen)
            k = _randn((cb, chk, cs, cd), dtype, gen)
            v = _randn((cb, chk, cs, cd), dtype, gen)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            got = da_ops.decode_attention(q, k, v, lens)
            record("decode_attention", "%s %s" % (tag, str(dtype)[6:]), got,
                   da_ref.decode_attention_ref(q, k, v, lens), dtype)
            if bool((got[lens == 0] != 0).any()):
                fail("decode_attention: a length-0 row is not 0")

    q = _randn((b, hq, 1, d), torch.bfloat16, gen)
    k = _randn((b, hk, tk, d), torch.bfloat16, gen)
    v = _randn((b, hk, tk, d), torch.bfloat16, gen)
    lens = torch.full((b,), length, dtype=torch.int32, device="cuda")
    rec = recs["decode_attention"]
    names = [n for n in kernel_names(
        lambda: da_ops.decode_attention(q, k, v, lens)) if "decode_" in n]
    if len(names) != 1:
        fail("one decode_attention call put %d decode_ kernels on the "
             "profiler: %s" % (len(names), names))
    log("  decode_attention one call, one kernel: %s" % names[0][:80])
    # both calls are host-bound at this shape (a few us of kernel): the
    # wrapper and SDPA take turns, 3 rounds of 20 calls, medians
    wrap, lib = [], []
    for _ in range(3):
        wrap.append(cuda_ms(lambda: da_ops.decode_attention(q, k, v, lens),
                            iters=20))
        lib.append(cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k[:, :, :length], v[:, :, :length], enable_gqa=True),
            iters=20))
    rec.ms, rec.library_ms = med(wrap)[0], med(lib)[0]
    log("  decode_attention wrapper %s ms, SDPA %s ms, in turns [%s]"
        % ([round(x, 4) for x in wrap], [round(x, 4) for x in lib], smi))
    rec.launch_ms = launch_ms(lambda: da_ops.decode_attention(q, k, v, lens),
                              rec.symbol)
    rec.plain_ms = cuda_ms(lambda: da_ref.decode_attention_ref(q, k, v, lens))
    rec.bound_ms, rec.bound_by = _bound(
        2 * (2 * b * hk * length * d + 2 * q.numel()) + 4 * b,
        4.0 * d * b * hq * length, BF16_PEAK_OPS_PER_S)
    del q, k, v
    phase_attention_d80(recs, record, gen, smi)
    phase_attention_mla(recs, record, gen, smi)
    phase_attention_jamba(recs, record, gen, smi)
    phase_attention_other(recs, record, gen, smi)
    sync()
    return recs


def _window_mask(lengths, s, window, device):
    """``[B, 1, 1, S]``: the rows ``[max(0, len - window), min(len, S))``
    decode attention reads (SDPA's boolean mask for the same function)."""
    kpos = torch.arange(s, device=device)[None, :]
    lens = lengths.long()[:, None]
    return ((kpos < lens) & (kpos >= lens - window))[:, None, None, :]


def phase_attention_d80(recs, record, gen, smi):
    """Head dim 80 (H2O-Danube, 32/8 heads) and the windowed decode edges,
    then head dim 128 at group 6 (Mixtral-8x22B, 48/8 heads): each
    model's lane prefill and tick in both dtypes, the bf16 case of each
    shape timed beside SDPA with the same mask."""
    w, tk = DANUBE_WINDOW, DANUBE_MAX_LEN
    lane_attention(recs, record, gen, smi, "danube lane", 32, 8, 80, [
        ("danube tick, 8 ragged lanes", 8, tk, w, DANUBE_TICK_LENGTHS),
        ("window < len", 4, tk, w, [4600, 4097, 4672, 4200]),
        ("window >= len", 2, tk, w, [4096, 100]),
        ("len 0", 2, 1000, 16, [0, 17]),
        ("lengths past S", 3, 300, 100, [301, 350, 410]),
        ("ragged lanes, one row", 8, tk, w,
         [256, 4600, 1, 64, 4161, 65, 2000, 4672]),
    ])
    lane_attention(recs, record, gen, smi, "mixtral lane", 48, 8, 128, [
        ("mixtral tick, 8 ragged lanes", 8, tk, w, DANUBE_TICK_LENGTHS),
        ("window < len", 4, tk, w, [4600, 4097, 4672, 4200]),
    ])


def phase_attention_mla(recs, record, gen, smi):
    """MLA's head dims, q and k of D = nope + rope against v of Dv:
    MiniCPM3-4B (40/40 heads, D 96, Dv 64) and DeepSeek-V2 (128/128 heads,
    D 192, Dv 128), each model's lane prefill (causal, no window) and an
    8-lane tick over DANUBE_TICK_LENGTHS, in both dtypes; the bf16 case of
    each shape timed beside SDPA."""
    for label, h, d, dv in (("minicpm3", 40, 96, 64),
                            ("deepseek", 128, 192, 128)):
        lane_attention(recs, record, gen, smi, label + " lane", h, h, d, [
            ("%s tick, 8 ragged lanes" % label, 8, DANUBE_MAX_LEN, None,
             DANUBE_TICK_LENGTHS),
        ], dv=dv, window=None)


def phase_attention_jamba(recs, record, gen, smi):
    """Jamba's attention layer, D 128 at group 4 (32/8 heads), causal and
    without a window: its lane prefill and an 8-lane tick over
    DANUBE_TICK_LENGTHS, in both dtypes; the bf16 cases timed beside SDPA
    (``is_causal``, and over S with the lanes' mask)."""
    lane_attention(recs, record, gen, smi, "jamba lane", 32, 8, 128, [
        ("jamba tick, 8 ragged lanes", 8, DANUBE_MAX_LEN, None,
         DANUBE_TICK_LENGTHS),
    ], window=None)


def phase_attention_other(recs, record, gen, smi):
    """Phase 13's shapes, causal without a window: Qwen2-VL-7B's vision
    forward (B 2, 28/4 heads, group 7, Tq = Tk = VL_FORWARD_T, D 128) and
    an 8-lane tick at group 7 over DANUBE_TICK_LENGTHS; MusicGen-large's
    prefill (B 4, 32/32 heads, group 1, Tq = Tk = AUDIO_PROMPT, D 64) and
    a tick of its 4 sequences at the last step (AUDIO_PROMPT + AUDIO_NEW
    - 1 rows); both dtypes, the bf16 cases timed beside SDPA."""
    lane_attention(recs, record, gen, smi, "qwen2-vl vision forward", 28, 4,
                   128, [("qwen2-vl tick, 8 ragged lanes", 8, DANUBE_MAX_LEN,
                          None, DANUBE_TICK_LENGTHS)], window=None,
                   prefill=(VL_FORWARD_BATCH, VL_FORWARD_T, VL_FORWARD_T))
    rows = AUDIO_PROMPT + AUDIO_NEW - 1
    lane_attention(recs, record, gen, smi, "musicgen", 32, 32, 64, [
        ("musicgen tick, %d sequences" % AUDIO_BATCH, AUDIO_BATCH, rows + 1,
         None, [rows] * AUDIO_BATCH)], window=None,
        prefill=(AUDIO_BATCH, AUDIO_PROMPT, AUDIO_PROMPT))


def lane_attention(recs, record, gen, smi, label, hq, hk, d, decode_cases,
                   dv=None, window=DANUBE_WINDOW,
                   prefill=(1, DANUBE_PROMPT_MAX, DANUBE_MAX_LEN)):
    """Flash attention at a prefill of ``prefill = (B, Tq, Tk)`` (by
    default a lane prefill: the longest prompt, Tq DANUBE_PROMPT_MAX, over
    a lane of DANUBE_MAX_LEN rows), causal, with ``window`` or none, and
    decode attention in ``decode_cases`` ((tag, b, s, window, lengths):
    lengths[b] - 1 is the query's position), both against their plain
    versions in both dtypes, v of width ``dv`` (D where not given); the
    bf16 case of each shape timed beside SDPA with the same function (a
    boolean mask, or ``is_causal`` without a window: query i keeps keys j
    <= i, SDPA's top-left alignment).  Bounds: the bytes of q, k, v and
    the output once, and 2 (D + Dv) operations a live (query, key) pair
    at the bf16 peak."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    w = window
    dv = dv or d
    b, tq, tk = prefill
    dims = "D %d" % d if dv == d else "D %d Dv %d" % (d, dv)
    rec = recs["flash_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((b, hq, tq, d), dtype, gen)
        k = _randn((b, hk, tk, d), dtype, gen)
        v = _randn((b, hk, tk, dv), dtype, gen)
        record("flash_attention", "%s prefill B %d Tq %d Tk %d %s window "
               "%s %s" % (label, b, tq, tk, dims, w, str(dtype)[6:]),
               fa_ops.flash_attention(q, k, v, True, w, 0),
               fa_ref.attention_ref(q, k, v, True, w, 0), dtype)
        del q, k, v
    q = _randn((b, hq, tq, d), torch.bfloat16, gen)
    k = _randn((b, hk, tk, d), torch.bfloat16, gen)
    v = _randn((b, hk, tk, dv), torch.bfloat16, gen)
    if w is None:
        mask, how = None, "is_causal"
    else:
        qpos = torch.arange(tq, device="cuda")[:, None]
        kpos = torch.arange(tk, device="cuda")[None, :]
        mask, how = (kpos <= qpos) & (kpos > qpos - w), "boolean window mask"
    pairs = b * _live_pairs(tq, tk, True, w, 0)
    rec.time_case(
        "%s prefill, B %d, %d/%d heads, Tq %d, Tk %d, %s, window %s, "
        "bf16 (library: SDPA, %s)" % (label, b, hq, hk, tq, tk, dims, w, how),
        lambda: fa_ops.flash_attention(q, k, v, True, w, 0),
        lambda: fa_ref.attention_ref(q, k, v, True, w, 0),
        lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True),
        _bound(2 * (q.numel() + k.numel() + v.numel() + b * hq * tq * dv),
               2.0 * (d + dv) * hq * pairs, BF16_PEAK_OPS_PER_S), smi)
    del q, k, v, mask

    rec = recs["decode_attention"]
    for tag, cb, cs, cw, lengths in decode_cases:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn((cb, hq, 1, d), dtype, gen)
            k = _randn((cb, hk, cs, d), dtype, gen)
            v = _randn((cb, hk, cs, dv), dtype, gen)
            got = da_ops.decode_attention(q, k, v, lens, cw)
            record("decode_attention", "%s window %s, %s %s"
                   % (dims, cw, tag, str(dtype)[6:]), got,
                   da_ref.decode_attention_ref(q, k, v, lens, cw), dtype)
            if bool((got[lens == 0] != 0).any()):
                fail("decode_attention: a length-0 row is not 0")
        live = sum(max(0, min(n, cs) - max(0, n - (cw or n))) for n in lengths)
        mask = _window_mask(lens, cs, cw or cs + max(lengths), "cuda")
        rec.time_case(
            "%s, %d/%d heads, window %s, %s: B %d, S %d, %d live rows, "
            "bf16 (library: SDPA over S, boolean mask)" % (
                dims, hq, hk, cw, tag, cb, cs, live),
            lambda: da_ops.decode_attention(q, k, v, lens, cw),
            lambda: da_ref.decode_attention_ref(q, k, v, lens, cw),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   enable_gqa=True),
            _bound(2 * (hk * (d + dv) * live + q.numel() + cb * hq * dv)
                   + 4 * cb, 2.0 * (d + dv) * hq * live,
                   BF16_PEAK_OPS_PER_S), smi)


# --------------------------------------------------------------------------
# phase 7: LM generation at full width
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_attention():
    """The same model code with the attention kernels' plain versions (the
    path the kernels are held against)."""
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import attention as attn

    with mock.patch.object(attn.fa_ops, "flash_attention",
                           fa_ref.attention_ref), \
            mock.patch.object(attn.da_ops, "decode_attention",
                              da_ref.decode_attention_ref):
        yield


def as_f32(model, device):
    """A float32 copy of ``model``'s weights on ``device``."""
    from repro_torch.models import lm

    def f32(t):
        return None if t is None else t.detach().to(device, torch.float32)

    return lm.LM(dataclasses.replace(model.cfg, dtype="float32"),
                 f32(model.embed),
                 [copy.deepcopy(blk).to(device, torch.float32)
                  for blk in model.blocks],
                 f32(model.final_norm), f32(model.lm_head))


@torch.no_grad()
def teacher_forced(model, prompt, ids, max_len):
    """Logits ``[B, 1 + steps, Vp]`` (``[B, 1 + steps, K, Vp]`` for K
    codebooks; f32) of the prefill and of each step fed ``ids[:, i]``: both
    sides of a comparison see the same ids."""
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    prefill, step = serve.make_serve_fns(model)
    cache = lm.init_cache(model.cfg, prompt.shape[0], max_len, model.device)
    out = [prefill(prompt, cache).float()]
    for i in range(ids.shape[1] - 1):
        out.append(step(ids[:, i:i + 1], cache).float())
    return torch.stack(out, dim=1)


def med(xs):
    """(median, smallest, largest)."""
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[0], xs[-1]


def time_generation(model, prompt, new, max_len, smi):
    """Prefill and the greedy steps timed apart: LM_REPEATS passes (the
    caller's run of the main path at these shapes just before is the
    warm-up), tokens/s as the median with the slowest and fastest, and the
    peak device memory over the timed passes."""
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    b, t = prompt.shape[:2]
    prefill, step = serve.make_serve_fns(model)
    pre_s, dec_s = [], []
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        for _ in range(LM_REPEATS):
            cache = lm.init_cache(model.cfg, b, max_len)
            sync()
            t0 = time.perf_counter()
            tok = serve.greedy_token(prefill(prompt, cache))
            sync()
            t1 = time.perf_counter()
            for _ in range(new - 1):
                tok = serve.greedy_token(step(tok[:, None], cache))
            sync()
            pre_s.append(t1 - t0)
            dec_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    p_med, p_lo, p_hi = med([b * t / x for x in pre_s])
    d_med, d_lo, d_hi = med([b * (new - 1) / x for x in dec_s])
    s_med, s_lo, s_hi = med([x * 1e3 / (new - 1) for x in dec_s])
    log("  prefill: %.0f tokens/s median of %d passes (%.0f-%.0f), %.1f ms "
        "a pass [%s]" % (p_med, LM_REPEATS, p_lo, p_hi, b * t / p_med * 1e3,
                         smi))
    log("  decode: %.1f output tokens/s median of %d passes (%.1f-%.1f), "
        "%.3f ms a step (%.3f-%.3f) [%s]" % (d_med, LM_REPEATS, d_lo, d_hi,
                                            s_med, s_lo, s_hi, smi))
    log("  peak device memory over the timed passes: %.2f GB" % peak)


def profiled(label, fn, kernels, smi):
    """One torch.profiler window over ``fn()``: wall, device busy time, the
    device's idle share and the device time of ``kernels``."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = device_times(prof)
    busy = sum(dev.values())
    if busy <= 0:
        log("  profile %s: no device time recorded (not measured)" % label)
        return None
    ours = {k: sum(t for kname, t in dev.items() if KERNEL_SYMBOLS[k] in kname)
            for k in kernels}
    log("  profile %s: wall %.2f ms, device busy %.2f ms (idle share %.3f), "
        "%s [%s]" % (label, wall_us / 1e3, busy / 1e3,
                     max(0.0, 1 - busy / wall_us),
                     ", ".join("%s %.3f ms" % (k, v / 1e3)
                               for k, v in ours.items()), smi))
    for kname, t in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
        log("    %8.3f ms  %s" % (t / 1e3, kname[:110]))
    return busy / 1e3


def profile_serving(model, prompt, max_len, kernels, smi):
    """One prefill, then 8 decode steps, each under the profiler."""
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    prefill, step = serve.make_serve_fns(model)
    cache = lm.init_cache(model.cfg, prompt.shape[0], max_len)
    last = {}

    def run_prefill():
        last["tok"] = serve.greedy_token(prefill(prompt, cache))

    def run_steps():
        tok = last["tok"]
        for _ in range(8):
            tok = serve.greedy_token(step(tok[:, None], cache))

    with torch.no_grad():
        profiled("1 prefill", run_prefill, kernels, smi)
        profiled("8 decode steps", run_steps, kernels, smi)


def gate_plain(model, logits_of, plain_path, what="teacher-forced",
               ids=None, f32=None):
    """Gate 1: kernel path == plain path on the f32 logits
    ``logits_of(model)`` (teacher-forced on ``ids``, which must be their
    argmax, or a forward).  bf16 rounding noise compounds over the layers,
    so the tolerance is measured in the same run: the kernels may move the
    logits by at most LM_BF16_FACTOR times what bf16 arithmetic itself
    does (plain bf16 against an f32 copy of the weights, ``f32`` where
    given), in the largest and in the mean difference.  Compared over the
    real vocabulary: the padded rows hold -1e30 in each dtype.  Returns
    the f32 copy on the card."""
    v = model.cfg.vocab_size
    kern = logits_of(model)
    if ids is not None and not torch.equal(kern.argmax(-1).int(), ids):
        fail("teacher-forced kernel logits do not reproduce generate's ids")
    with plain_path():
        plain = logits_of(model)
    if not torch.equal(kern[..., v:], plain[..., v:]):
        fail("the padded vocabulary rows differ between the paths")
    kern, plain = kern[..., :v], plain[..., :v]
    f32 = as_f32(model, "cuda") if f32 is None else f32
    with plain_path():
        noise = (plain - logits_of(f32)[..., :v]).abs()
    diff = (kern - plain).abs()
    got_max, got_mean = float(diff.max()), float(diff.mean())
    floor_max, floor_mean = float(noise.max()), float(noise.mean())
    log("  gate 1, kernel path against plain path (bf16, %s, %s logits, "
        "std %.3f): max |diff| %.4g, mean %.4g; bf16 against f32 (plain): "
        "max %.4g, mean %.4g; tolerance %gx those"
        % (what, " x ".join(map(str, kern.shape)), float(plain.std()),
           got_max, got_mean, floor_max, floor_mean, LM_BF16_FACTOR))
    if not (got_max <= LM_BF16_FACTOR * floor_max
            and got_mean <= LM_BF16_FACTOR * floor_mean):
        fail("the kernel path moves the logits more than %gx what bf16 "
             "itself does" % LM_BF16_FACTOR)
    return f32


def gate_cpu(model, f32, prompt, new, stub=None):
    """Gate 2: the card == the CPU on the float32 copy, one prompt: equal
    ids and teacher-forced logits within LM_CPU_TOL; with ``stub``
    (``(embeds, positions)`` on the CPU, positions None without M-RoPE)
    also ``lm.forward`` on the frontend stub's inputs."""
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    v = model.cfg.vocab_size
    cpu = as_f32(model, "cpu")
    t = prompt.shape[1]
    ids_gpu = serve.generate(f32, prompt, new)
    t0 = time.time()
    ids_cpu = serve.generate(cpu, prompt.cpu(), new, device="cpu")
    got = teacher_forced(f32, prompt, ids_gpu, t + new)
    want = teacher_forced(cpu, prompt.cpu(), ids_gpu.cpu(), t + new)
    err = float((got.cpu() - want)[..., :v].abs().max())
    log("  gate 2, card against CPU (f32, TF32 off, 1 x %d prompt, %d new "
        "tokens): max |logit diff| %.3g (tol %g), ids %s / %s, CPU %.1f s"
        % (t, new, err, LM_CPU_TOL, ids_gpu[0].tolist(), ids_cpu[0].tolist(),
           time.time() - t0))
    if not err <= LM_CPU_TOL:
        fail("GPU != CPU on the f32 LM path: %g > %g" % (err, LM_CPU_TOL))
    if not torch.equal(ids_gpu.cpu(), ids_cpu):
        fail("the card and the CPU generate other ids on the f32 LM path")
    if stub is None:
        return
    embeds, positions = stub
    t0 = time.time()
    with torch.no_grad():
        got = lm.forward(f32, None, embeds=embeds.cuda(),
                         positions=None if positions is None
                         else positions.cuda())
        want = lm.forward(cpu, None, embeds=embeds, positions=positions)
    err = float((got.cpu() - want)[..., :v].abs().max())
    log("  gate 2, card against CPU (f32, TF32 off, lm.forward on the "
        "frontend stub: embeddings %s%s): max |logit diff| %.3g (tol %g), "
        "CPU %.1f s" % (tuple(embeds.shape), "" if positions is None
                        else ", image-grid positions", err, LM_CPU_TOL,
                        time.time() - t0))
    if not err <= LM_CPU_TOL:
        fail("GPU != CPU on the f32 stub forward: %g > %g"
             % (err, LM_CPU_TOL))


def lm_config(arch, layers=None, pattern=None):
    """The architecture's configuration at full width: ``layers`` of its
    layers where given, and the slice ``pattern`` (start, stop) of its
    layer pattern as the pattern where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if pattern is not None:
        cfg = dataclasses.replace(
            cfg, layer_pattern=cfg.layer_pattern[slice(*pattern)])
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def make_lm(arch, layers=None, pattern=None):
    """The architecture at full width (``lm_config``), random weights from
    a seeded generator on the card; float32 products in full float32 for
    the f32 gates (the default; set so that no earlier setting leaks
    in)."""
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = lm_config(arch, layers, pattern)
    t0 = time.time()
    model = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    return cfg, model, n_params, time.time() - t0


def check_ids(ids, shape, vocab):
    if ids.shape != shape or not bool(((ids >= 0) & (ids < vocab)).all()):
        fail("generate gave ids of shape %s outside [0, %d)"
             % (tuple(ids.shape), vocab))


def phase_lm(smi):
    from repro_torch.kernels import _cuda
    from repro_torch.serve import lm as serve

    cfg, model, n_params, made_s = make_lm(LM_ARCH)
    log("phase 7: %s, %d layers, d_model %d, %d/%d heads of %d, d_ff %d, "
        "vocab %d (padded %d), %s, %.3f B parameters (%.2f GB), made in "
        "%.1f s; %d prompts of %d ids, %d new tokens, cache %d rows [%s]"
        % (cfg.name, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size,
           cfg.padded_vocab, cfg.dtype, n_params / 1e9,
           n_params * 2 / 1e9, made_s, LM_BATCH, LM_PROMPT,
           LM_NEW, LM_MAX_LEN, smi))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(LM_BATCH, LM_PROMPT))).cuda()
    serve.generate(model, prompt[:, :64], 2, max_len=LM_MAX_LEN)   # warm-up

    # the main path, through the entry point, counted
    sync()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ids = serve.generate(model, prompt, LM_NEW, max_len=LM_MAX_LEN)
    sync()
    gen_s = time.perf_counter() - t0
    launches = path_launches("phase 7 (LM generation)",
                             ("flash_attention", "decode_attention"), smi)
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * (LM_NEW - 1)}
    for k, n in want.items():
        if launches[k] != n:
            fail("%s launched %d times on the LM path, expected %d"
                 % (k, launches[k], n))
    log("  generate: %d x %d ids in %.3f s, peak %.2f GB, ids of sequence 0 "
        "start %s [%s]" % (ids.shape[0], ids.shape[1], gen_s,
                           torch.cuda.max_memory_allocated() / 1e9,
                           ids[0, :8].tolist(), smi))
    check_ids(ids, (LM_BATCH, LM_NEW), cfg.vocab_size)

    time_generation(model, prompt, LM_NEW, LM_MAX_LEN, smi)
    profile_serving(model, prompt, LM_MAX_LEN,
                    ("flash_attention", "decode_attention"), smi)
    f32 = gate_plain(model, lambda m: teacher_forced(m, prompt, ids,
                                                     LM_MAX_LEN),
                     plain_attention, ids=ids)
    gate_cpu(model, f32, prompt[:1, :LM_CPU_PROMPT], LM_CPU_NEW)
    return launches


# --------------------------------------------------------------------------
# phase 2, continued: the SSD kernel
# --------------------------------------------------------------------------

def _ssd_inputs(b, t, h, p, g, s, dtype, init, rng):
    """The reference tests' distributions (dt in [0.01, 0.2], A in [-2,
    -0.5], x, B, C normal), x, B and C slices of one [B, T, H*P + 2*G*S]
    tensor on the card, as the model passes them."""
    def put(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()

    xbc = put(rng.standard_normal((b, t, h * p + 2 * g * s))).to(dtype)
    x = xbc[..., :h * p].reshape(b, t, h, p)
    Bm = xbc[..., h * p:h * p + g * s].reshape(b, t, g, s)
    Cm = xbc[..., h * p + g * s:].reshape(b, t, g, s)
    dt = put(rng.uniform(0.01, 0.2, (b, t, h)))
    A = put(-rng.uniform(0.5, 2.0, (h,)))
    s0 = put(rng.standard_normal((b, h, s, p))) if init else None
    return x, dt, A, Bm, Cm, s0


def _ssd_bound(b, t, h, p, g, s, chunk, dtype, init):
    """Least time for the SSD function: x and y, B and C in their dtype, dt
    and the states in f32, each once; operations at the peak of the
    inputs' type: C B^T (2 L.L.S) once a (batch, group, chunk), shared by
    the group's heads, and 2 (L.L.P + 2 L.S.P) a (batch, head, chunk)."""
    nl = -(-t // chunk)
    ops = (b * g * nl * 2.0 * chunk * chunk * s
           + b * h * nl * 2.0 * chunk * (chunk * p + 2 * s * p))
    esz = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * t * h * p * esz + 2 * b * t * g * s * esz
              + b * t * h * 4 + h * 4 + b * h * s * p * 4 * (2 if init else 1))
    return _bound(nbytes, ops, BF16_PEAK_OPS_PER_S if dtype == torch.bfloat16
                  else FP32_CORE_OPS_PER_S)


def phase_ssd(smi):
    """The SSD kernel against its plain chunked version on the card, at
    phase 8's prefill shape (timed there) and edge cases, each case timed;
    then once against the sequential oracle."""
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    torch.backends.cuda.matmul.allow_tf32 = False    # the plain version's
    rec = KernelRecord("ssd", "src/repro_torch/kernels/csrc/ssd.cu",
                       "src/repro/kernels/ssd/kernel.py:76")
    rng = np.random.default_rng(0)

    def record(tag, got, want, dtype):
        (y, st), (wy, wst) = got, want
        worst = 0.0
        for a, w, (atol, rtol) in (
                (y.float(), wy.float(), SSD_F32_TOL if dtype == torch.float32
                 else ATT_TOL[dtype]), (st, wst, SSD_F32_TOL)):
            d = (a - w).abs()
            if a.shape != w.shape or not bool(torch.isfinite(d).all()) or \
                    float((d - rtol * w.abs()).max()) > atol:
                fail("ssd disagrees with its plain version on %s" % tag)
            worst = max(worst, float(d.max()))
        rec.err = max(rec.err, worst)
        rec.cases += 1
        return worst

    d = MAMBA_PROMPT
    # (tag, b, t, h, p, g, s, chunk, init)
    cases = [
        ("path prefill", MAMBA_BATCH, d, 24, 64, 1, 128, 128, False),
        ("initial state, T 1000 (ragged tail)", 2, 1000, 24, 64, 1, 128, 128,
         True),
        ("T 96 (one chunk of 96)", 2, 96, 24, 64, 1, 128, 96, False),
        ("T 96 chunk 128 (ragged tail)", 2, 96, 24, 64, 1, 128, 128, True),
        ("T 40 (below a tile)", 2, 40, 24, 64, 1, 128, 40, False),
        ("G 2 H 4 S 64", 2, 256, 4, 64, 2, 64, 128, True),
        ("S 16 P 16 chunk 32", 1, 64, 2, 16, 1, 16, 32, False),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        for tag, b, t, h, p, g, s, chunk, init in cases:
            x, dt, A, Bm, Cm, s0 = _ssd_inputs(b, t, h, p, g, s, dtype, init,
                                               rng)

            def kern():
                return ssd_kernel.ssd_cuda(x, dt, A, Bm, Cm, chunk, s0)

            def plain():
                return ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, chunk, s0)

            err = record(tag, kern(), plain(), dtype)
            ms = cuda_ms(kern, iters=5)
            passes = {}
            alone = launch_ms(kern, rec.symbol, iters=5, by_kernel=passes)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            bound, by = _ssd_bound(b, t, h, p, g, s, chunk, dtype, init)
            log("  %-16s %-40s max_abs_err=%.3g; wrapper %.4f ms, launches "
                "alone %s, plain %.4f ms, bound %.5f ms (%s)"
                % ("ssd", "%s %s" % (tag, str(dtype)[6:]), err, ms,
                   "%.4f ms" % alone if alone is not None else "not measured",
                   plain_ms, bound, by))
            if tag == "path prefill":
                for kname, kms in sorted(passes.items(), key=lambda kv: -kv[1]):
                    log("  %-16s   %s pass %.4f ms  %s" % (
                        "ssd", str(dtype)[6:], kms, kname[:90]))
            if tag == "path prefill" and dtype == torch.bfloat16:
                rec.ms, rec.launch_ms, rec.plain_ms = ms, alone, plain_ms
                rec.bound_ms, rec.bound_by = bound, by

    # ops.ssd (kernel, D skip) against the step-by-step oracle
    x, dt, A, Bm, Cm, s0 = _ssd_inputs(2, 100, 4, 32, 2, 32, torch.float32,
                                       True, rng)
    D = torch.linspace(-1, 1, 4, device="cuda")
    err = record("the sequential oracle",
                 ssd_ops.ssd(x, dt, A, Bm, Cm, D, chunk=32, init_state=s0),
                 ssd_ref.ssd_ref(x, dt, A, Bm, Cm, D, s0), torch.float32)
    log("  %-16s %-40s max_abs_err=%.3g (tol %g + %g rel)"
        % ("ssd", "ops.ssd vs ssd_ref, T 100 chunk 32 G 2", err,
           *SSD_F32_TOL))
    sync()
    return {"ssd": rec}


# --------------------------------------------------------------------------
# phase 8: Mamba-2 generation at full width
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_ssd():
    """The same model code with the SSD kernel's plain version."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref

    with mock.patch.object(ssd_ops.kernel, "ssd_cuda", ssd_ref.ssd_chunked):
        yield


def phase_mamba(smi):
    from repro_torch.kernels import _cuda
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    cfg, model, n_params, made_s = make_lm(MAMBA_ARCH)
    mc = cfg.mamba
    log("phase 8: %s, %d layers, d_model %d, %d heads of %d, d_state %d, "
        "%d group(s), vocab %d (padded %d), %s, %.2f M parameters, made in "
        "%.1f s; %d prompts of %d ids, %d new tokens [%s]"
        % (cfg.name, cfg.num_layers, cfg.d_model, mc.nheads(cfg.d_model),
           mc.headdim, mc.d_state, mc.ngroups, cfg.vocab_size,
           cfg.padded_vocab, cfg.dtype, n_params / 1e6, made_s, MAMBA_BATCH,
           MAMBA_PROMPT, MAMBA_NEW, smi))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(MAMBA_BATCH, MAMBA_PROMPT))).cuda()
    max_len = MAMBA_PROMPT + MAMBA_NEW
    serve.generate(model, prompt[:, :64], 2)                        # warm-up

    # the main path, through the entry points, counted: generate (the
    # prefill's 24 launches), then the cache-free forward (24 more)
    sync()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ids = serve.generate(model, prompt, MAMBA_NEW)
    sync()
    gen_s = time.perf_counter() - t0
    after_generate = _cuda.LAUNCHES["ssd"]
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = lm.forward(model, prompt[:1])
    sync()
    fwd_s = time.perf_counter() - t0
    launches = path_launches("phase 8 (Mamba-2 generation and forward)",
                             ("ssd",), smi)
    if after_generate != cfg.num_layers or \
            launches["ssd"] != 2 * cfg.num_layers:
        fail("ssd launched %d times in generate and %d in all, expected %d "
             "and %d" % (after_generate, launches["ssd"], cfg.num_layers,
                         2 * cfg.num_layers))
    if any(n for k, n in launches.items() if k != "ssd"):
        fail("the Mamba-2 path launched another kernel: %s" % _short(launches))
    log("  generate: %d x %d ids in %.3f s, peak %.2f GB, ids of sequence 0 "
        "start %s [%s]" % (ids.shape[0], ids.shape[1], gen_s,
                           torch.cuda.max_memory_allocated() / 1e9,
                           ids[0, :8].tolist(), smi))
    check_ids(ids, (MAMBA_BATCH, MAMBA_NEW), cfg.vocab_size)
    real = logits[..., :cfg.vocab_size].float()
    if logits.shape != (1, MAMBA_PROMPT, cfg.padded_vocab) or not bool(
            torch.isfinite(real).all()):
        fail("lm.forward gave logits of shape %s, or non-finite ones"
             % (tuple(logits.shape),))
    log("  forward: 1 x %d ids -> logits %s in %.3f s, std %.3f [%s]"
        % (MAMBA_PROMPT, tuple(logits.shape), fwd_s, float(real.std()), smi))
    del logits, real

    time_generation(model, prompt, MAMBA_NEW, max_len, smi)
    profile_serving(model, prompt, max_len, ("ssd",), smi)
    f32 = gate_plain(model, lambda m: teacher_forced(m, prompt, ids, max_len),
                     plain_ssd, ids=ids)
    gate_cpu(model, f32, prompt[:1, :MAMBA_CPU_PROMPT], MAMBA_CPU_NEW)
    return launches


# --------------------------------------------------------------------------
# phase 12: the continuous batcher at full width
# --------------------------------------------------------------------------

def batch_requests(vocab, n, lo, hi, past, window, new_lo, new_hi, seed):
    """``n`` (prompt, max_new) pairs from a seeded generator: prompt lengths
    in [lo, hi], ``past`` of them past ``window``, max_new in [new_lo,
    new_hi]."""
    rng = np.random.default_rng(seed)
    if past:
        lens = np.concatenate([rng.integers(lo, window + 1, n - past),
                               rng.integers(window + 1, hi + 1, past)])
        rng.shuffle(lens)
    else:
        lens = rng.integers(lo, hi + 1, n)
    news = rng.integers(new_lo, new_hi + 1, n)
    return [(rng.integers(0, vocab, int(t)).astype(np.int32), int(m))
            for t, m in zip(lens, news)]


def run_batcher(model, requests, slots, max_len, record=()):
    """Drain ``requests`` through ``ContinuousBatcher`` over
    ``launch.serve.make_slot_fns``: ``(ids by request, logits [n, Vp] f32
    by request for the requests in record, ticks, decode calls, seconds)``.
    The callables are wrapped to record lane logits (on the device) and to
    count the decode calls; request r is the r-th admitted (FIFO)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    prefill, decode = launch.make_slot_fns(model, max_len)
    logits = {rid: [] for rid in record}
    admitted, calls = [], [0]
    batcher = None

    def prefill_rec(tokens, cache, slot):
        out, cache = prefill(tokens, cache, slot)
        if len(admitted) in logits:
            logits[len(admitted)].append(out[0].float())
        admitted.append(slot)
        return out, cache

    def decode_rec(tokens, cache):
        out, cache = decode(tokens, cache)
        calls[0] += 1
        for i in batcher.active():
            rid = batcher.slots[i].request.rid
            if rid in logits:
                logits[rid].append(out[i].float())
        return out, cache

    batcher = serve.ContinuousBatcher(slots, prefill_rec, decode_rec)
    for rid, (prompt, new) in enumerate(requests):
        batcher.submit(serve.Request(rid, prompt, new))
    cache = lm.init_cache(model.cfg, slots, max_len, model.device,
                          per_seq=True)
    sync()
    t0 = time.perf_counter()
    cache, ticks = batcher.run_until_drained(cache)
    sync()
    secs = time.perf_counter() - t0
    if batcher.queue or batcher.active() or \
            len(batcher.completed) != len(requests):
        fail("the batcher left %d queued, %d active, %d of %d completed"
             % (len(batcher.queue), len(batcher.active()),
                len(batcher.completed), len(requests)))
    ids = {r.rid: r.generated for r in batcher.completed}
    return (ids, {k: torch.stack(v) for k, v in logits.items()}, ticks,
            calls[0], secs)


def gate_batched(model, requests, ids, logits, label, slots, max_len):
    """Gate 3: the batcher's lane logits against the single-sequence path
    (a batch-1 cache with a shared length: the prompt, then the batcher's
    own ids one at a time), teacher-forced.  The tolerance is phase 7's: at
    most LM_BF16_FACTOR times the in-run difference between bf16 and an
    f32 copy on the same ids (single path), in the largest and the mean
    difference; and the batcher's ids equal the single path's argmax
    wherever its top-2 gap exceeds that bound.  For an MoE model, whose
    bf16 routing flips near-tied experts (so that bound is wide), the
    same comparison also runs on the f32 copy (``gate_batched_f32``)."""
    v = model.cfg.vocab_size
    f32 = as_f32(model, "cuda")
    if model.cfg.moe is not None:
        gate_batched_f32(f32, requests, slots, max_len, list(logits), label)
    stats = dict(d_max=0.0, d_sum=0.0, n_max=0.0, n_sum=0.0, n=0)
    singles = {}
    for rid, got in logits.items():
        prompt = torch.from_numpy(requests[rid][0].astype(np.int64))[None]
        prompt = prompt.cuda()
        tok = torch.tensor([ids[rid]], dtype=torch.int64, device="cuda")
        max_len = prompt.shape[1] + tok.shape[1]
        single = teacher_forced(model, prompt, tok, max_len)[0, :, :v]
        noise = (single - teacher_forced(f32, prompt, tok, max_len)[
            0, :, :v]).abs()
        diff = (got[:, :v] - single).abs()
        stats["d_max"] = max(stats["d_max"], float(diff.max()))
        stats["n_max"] = max(stats["n_max"], float(noise.max()))
        stats["d_sum"] += float(diff.double().sum())
        stats["n_sum"] += float(noise.double().sum())
        stats["n"] += diff.numel()
        singles[rid] = single
    del f32
    bound = LM_BF16_FACTOR * stats["n_max"]
    d_mean, n_mean = stats["d_sum"] / stats["n"], stats["n_sum"] / stats["n"]
    checked = 0
    for rid, single in singles.items():
        top = single.topk(2, dim=-1).values
        sure = (top[:, 0] - top[:, 1]) > bound
        want = single.argmax(-1).cpu()
        got_ids = torch.tensor(ids[rid])
        sure = sure.cpu()
        checked += int(sure.sum())
        if not torch.equal(got_ids[sure], want[sure]):
            fail("%s: the batcher's ids leave the single path's argmax where "
                 "its top-2 gap exceeds %.4g (request %d)" % (label, bound,
                                                             rid))
    log("  gate 3, batcher against the single-sequence path (%s, bf16, "
        "teacher-forced, %d requests, %d positions): max |diff| %.4g, mean "
        "%.4g; bf16 against f32 (single path): max %.4g, mean %.4g; "
        "tolerance %gx those; ids equal its argmax at the %d positions "
        "whose top-2 gap exceeds %.4g"
        % (label, len(logits), stats["n"] // v, stats["d_max"], d_mean,
           stats["n_max"], n_mean, LM_BF16_FACTOR, checked, bound))
    if not (stats["d_max"] <= bound and d_mean <= LM_BF16_FACTOR * n_mean):
        fail("%s: the batcher moves the logits more than %gx what bf16 "
             "itself does" % (label, LM_BF16_FACTOR))


def gate_batched_f32(f32, requests, slots, max_len, record, label):
    """Gate 3 on a float32 copy: the batcher drains ``requests`` on it and
    the lanes of ``record`` are held against the single-sequence path
    teacher-forced on their own ids.  Both run dropless, so they route
    alike and differ by float32 rounding only (other GEMM shapes at a tick
    of 8 lanes and at batch 1): lane logits within LM_CPU_TOL, TF32 off,
    and the lanes' ids equal to the single path's argmax at every
    position."""
    v = f32.cfg.vocab_size
    t0 = time.time()
    ids, logits, ticks, _, _ = run_batcher(f32, requests, slots, max_len,
                                           record)
    err, positions = 0.0, 0
    for rid, got in logits.items():
        prompt = torch.from_numpy(requests[rid][0].astype(np.int64))[None]
        prompt = prompt.cuda()
        tok = torch.tensor([ids[rid]], dtype=torch.int64, device="cuda")
        single = teacher_forced(f32, prompt, tok,
                                prompt.shape[1] + tok.shape[1])[0, :, :v]
        err = max(err, float((got[:, :v] - single).abs().max()))
        positions += single.shape[0]
        if ids[rid] != single.argmax(-1).tolist():
            fail("%s: the f32 batcher's ids leave the single path's argmax "
                 "(request %d)" % (label, rid))
    log("  gate 3, batcher against the single-sequence path (%s, f32 copy, "
        "TF32 off, dropless, teacher-forced, %d requests drained in %d "
        "ticks, %d recorded, %d positions): max |diff| %.3g (tol %g); ids "
        "equal its argmax at all %d positions, %.1f s"
        % (label, len(requests), ticks, len(logits), positions, err,
           LM_CPU_TOL, positions, time.time() - t0))
    if not err <= LM_CPU_TOL:
        fail("%s: the f32 batcher's lane logits leave the single path's: "
             "%g > %g" % (label, err, LM_CPU_TOL))


def gate_batched_cpu(arch, layers, smi, pattern=None):
    """Gate 4: the batcher on the card == on the CPU, float32 copies at
    ``layers`` layers (of the pattern slice ``pattern`` where given) and
    full width: equal ids, lane logits within LM_CPU_TOL (TF32 off)."""
    from repro_torch.models import lm

    c = BATCH_CPU
    cfg = lm_config(arch, layers, pattern)
    model = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda")
    f32, cpu = as_f32(model, "cuda"), as_f32(model, "cpu")
    del model
    reqs = batch_requests(cfg.vocab_size, c["requests"], *c["prompt"], 0,
                          None, c["new"], c["new"], BATCH_SEED + 1)
    max_len = c["prompt"][1] + c["new"] + 4
    every = range(c["requests"])
    t0 = time.time()
    with torch.no_grad():
        ids_g, log_g, ticks_g, _, _ = run_batcher(f32, reqs, c["slots"],
                                                  max_len, every)
        ids_c, log_c, ticks_c, _, _ = run_batcher(cpu, reqs, c["slots"],
                                                  max_len, every)
    v = cfg.vocab_size
    err = max(float((log_g[r].cpu() - log_c[r])[:, :v].abs().max())
              for r in every)
    log("  gate 4, card against CPU (%s, f32, %d layers %s, TF32 off, %d "
        "slots, %d requests of %d-%d ids, %d new tokens): max |logit diff| "
        "%.3g (tol %g), ticks %d / %d, ids of request 0 %s / %s, %.1f s [%s]"
        % (arch, layers, pattern_text(cfg), c["slots"], c["requests"],
           c["prompt"][0],
           c["prompt"][1], c["new"], err, LM_CPU_TOL, ticks_g, ticks_c,
           ids_g[0], ids_c[0], time.time() - t0, smi))
    if not err <= LM_CPU_TOL:
        fail("%s: the batcher's card logits leave the CPU's: %g > %g"
             % (arch, err, LM_CPU_TOL))
    if ids_g != ids_c or ticks_g != ticks_c:
        fail("%s: the batcher drains other ids on the card and the CPU"
             % arch)


def profile_ticks(model, requests, slots, max_len, kernels, smi):
    """The device's idle share over PROFILE_TICKS ticks with every lane
    busy (the first ``slots`` prompts admitted, each to run past the
    window of ticks)."""
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    batcher = serve.ContinuousBatcher(slots, *launch.make_slot_fns(
        model, max_len))
    for rid in range(slots):
        batcher.submit(serve.Request(rid, requests[rid][0],
                                     PROFILE_TICKS + 4))
    state = {"cache": lm.init_cache(model.cfg, slots, max_len, model.device,
                                    per_seq=True)}
    state["cache"], _ = batcher.step(state["cache"])     # admits every lane

    def ticks():
        for _ in range(PROFILE_TICKS):
            state["cache"], _ = batcher.step(state["cache"])

    return profiled("%d ticks of %d busy lanes" % (PROFILE_TICKS, slots),
                    ticks, kernels, smi)


GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's names


def busy_ms(fn, iters: int = 5):
    """Device busy milliseconds per ``fn()`` from one torch.profiler
    session (what the device works, without the gaps a host read leaves):
    ``(every kernel, the cuBLAS GEMM kernels among them)``, or ``(None,
    None)`` when no session recorded a device event (not measured)."""
    dev = profile_device(fn, iters)
    if not dev:
        return None, None
    gemm = sum(t for k, t in dev.items()
               if any(g in k.lower() for g in GEMM_KERNELS))
    return sum(dev.values()) / 1e3 / iters, gemm / 1e3 / iters


def ms_text(ms) -> str:
    return "%.4f" % ms if ms is not None else "(not measured)"


def moe_share(model, slots, tick_busy, smi):
    """The MoE of one tick (``slots`` tokens, dropless, every layer)
    against the tick's device busy time from ``profile_ticks``, split
    within one profiler session into cuBLAS's GEMM kernels (the expert
    products of ``moe.experts``; the router's float32 product, a few us,
    falls on the side its kernel's name puts it) and the rest (softmax,
    top-k, sort, gather, combine); then the MoE of one lane prefill
    (MOE_PREFILL tokens) with the products over the filled slots, as the
    port runs them, against the reference's ``cap = n`` slots an expert
    (``moe.experts`` on zeros of that shape).  Device busy times
    (torch.profiler) and wall (CUDA events).  Both sides of the trim:
    the tick keeps all its ``cap`` slots and its MoE, and a whole
    ``lm.decode_step`` of ``slots`` lanes, read nothing back to the host
    (``torch.cuda.set_sync_debug_mode("error")``), and its wall is timed
    in turns against the tick trimmed (``TRIM_MIN_CAP`` 0: a host read a
    layer); the prefill trims."""
    from repro_torch.models import lm, moe

    cfg = model.cfg
    mo, d, e, k = cfg.moe, cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    moes = [blk.moe for blk in model.blocks if blk.moe is not None]
    p = moes[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n in (slots, MOE_PREFILL):
        x = _randn((1, n, d), torch.bfloat16, gen)
        cap = moe.dropless_capacity(n)
        probs = torch.softmax(x[0].float() @ p.router, dim=-1)
        rows = moe.dispatch_group(x, probs[None], k, e, cap)[0].shape[2]
        whole, prod = busy_ms(lambda: moe.moe_forward(p, mo, x,
                                                      dropless=True))
        wall = cuda_ms(lambda: moe.moe_forward(p, mo, x, dropless=True))
        if n == slots:
            if rows != cap:
                fail("a tick's MoE ran %d of its %d slots" % (rows, cap))
            cache = lm.init_cache(cfg, slots, 64, model.device, per_seq=True)
            tokens = torch.zeros((slots, 1), dtype=torch.int64,
                                 device="cuda")
            lm.decode_step(model, tokens, cache, last_only=True)
            sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                moe.moe_forward(p, mo, x, dropless=True)
                lm.decode_step(model, tokens, cache, last_only=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync()
            del cache
            # against the trim the tick no longer does (a host read a
            # layer), in turns within this call
            walls = {True: [], False: []}
            keep = moe.TRIM_MIN_CAP
            try:
                for trim in (False, True, False, True):
                    moe.TRIM_MIN_CAP = 0 if trim else keep
                    walls[trim].append(cuda_ms(
                        lambda: moe.moe_forward(p, mo, x, dropless=True)))
            finally:
                moe.TRIM_MIN_CAP = keep
            measured = whole is not None
            log("  MoE of one tick (%d tokens, dropless, all %d slots an "
                "expert; it and a whole decode step of %d lanes read "
                "nothing back to the host): %d layers x (busy %s ms: GEMM "
                "kernels %s, the rest %s; wall %.4f ms; in turns, wall "
                "%.4f ms against %.4f trimmed with a host read) = %.3f of "
                "the tick's %s ms device busy [%s]"
                % (n, cap, slots, len(moes), ms_text(whole),
                   ms_text(prod), ms_text(whole - prod if measured else None),
                   wall, np.mean(walls[False]), np.mean(walls[True]),
                   len(moes) * whole / tick_busy
                   if tick_busy and measured else float("nan"),
                   "%.3f" % tick_busy if tick_busy else "(not measured)",
                   smi))
            continue
        if not rows < cap:
            fail("a %d-token prefill's MoE ran all %d slots" % (n, cap))
        zeros = torch.zeros((1, e, cap, d), dtype=x.dtype, device="cuda")
        full_prod = busy_ms(lambda: moe.experts(p, zeros), iters=2)[0]
        log("  MoE of one lane prefill (%d tokens, dropless): busy %s ms "
            "(GEMM kernels %s ms, the expert products over the %d filled "
            "slots of %d an expert; over all %d, as the reference: %s "
            "ms), wall %.4f ms [%s]" % (n, ms_text(whole), ms_text(prod),
                                        rows, cap, cap, ms_text(full_prod),
                                        wall, smi))
        del zeros


def tick_reads_nothing_back(model, slots, max_len, smi):
    """A whole ``lm.decode_step`` of ``slots`` lanes over a per-sequence
    cache of ``max_len`` rows (MLA: every lane's latent rows expanded, the
    decode kernel at (D, Dv), no host read) under
    ``torch.cuda.set_sync_debug_mode("error")``, after one step outside
    it; its wall time (CUDA events) beside the device's."""
    from repro_torch.models import lm

    cache = lm.init_cache(model.cfg, slots, max_len, model.device,
                          per_seq=True)
    cache["len"].copy_(torch.tensor(DANUBE_TICK_LENGTHS[:slots],
                                    dtype=torch.int32))
    tokens = torch.zeros((slots, 1), dtype=torch.int64, device="cuda")
    lm.decode_step(model, tokens, cache, last_only=True)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lm.decode_step(model, tokens, cache, last_only=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    wall = cuda_ms(lambda: lm.decode_step(model, tokens, cache,
                                          last_only=True), iters=3, warmup=1)
    busy = busy_ms(lambda: lm.decode_step(model, tokens, cache,
                                          last_only=True), iters=3)
    log("  one decode step of %d lanes over %d rows a lane (lengths %s) "
        "read nothing back to the host; wall %.3f ms, device busy %s ms "
        "(cuBLAS GEMM kernels %s) [%s]" % (slots, max_len,
                                           DANUBE_TICK_LENGTHS[:slots], wall,
                                           ms_text(busy[0]), ms_text(busy[1]),
                                           smi))
    del cache


def pattern_text(cfg) -> str:
    """A layer pattern as ``mixer+ffn`` a layer, e.g. ``attn+dense``."""
    return "[%s]" % ", ".join("%s+%s" % (sp.mixer, sp.ffn)
                              for sp in cfg.layer_pattern)


def device_split(label, fn, parts, smi):
    """Device busy ms of one ``fn()`` and of its parts.  Each part is a
    function ``(module, name)``: its calls in one ``fn()`` are recorded
    and replayed alone in one profiler session.  Parts named with a
    ``/`` (``mixer/scan``) lie inside the part before the slash and are
    not taken off the rest again; the rest is the whole less the other
    parts.  A part whose sessions all recorded no device event (seen for
    the replays of one attention launch alone) is timed with CUDA events
    instead, and marked so.  Returns ``{part: ms}`` with ``"whole"`` and
    ``"rest"``, None where the whole's sessions recorded nothing."""
    calls = {name: [] for name in parts}

    def spy(name, orig):
        def wrapped(*a, **kw):
            calls[name].append((a, kw))
            return orig(*a, **kw)
        return wrapped

    with contextlib.ExitStack() as stack:
        for name, (mod, attr) in parts.items():
            stack.enter_context(mock.patch.object(
                mod, attr, spy(name, getattr(mod, attr))))
        fn()
    whole = busy_ms(fn, iters=1)[0]
    out, by_events = {"whole": whole}, set()
    for name, (mod, attr) in parts.items():
        orig = getattr(mod, attr)

        def replay():
            for a, kw in calls[name]:
                orig(*a, **kw)

        out[name] = busy_ms(replay, iters=1)[0] if calls[name] else 0.0
        if out[name] is None:
            out[name] = cuda_ms(replay, iters=3, warmup=1)
            by_events.add(name)
    top = [out[n] for n in parts if "/" not in n]
    out["rest"] = (whole - sum(top) if whole is not None
                   and all(t is not None for t in top) else None)
    log("  device split of %s: busy %s ms; %s; rest %s ms [%s]"
        % (label, ms_text(whole), "; ".join(
            "%s (%d calls) %s ms%s%s" % (
                n, len(calls[n]), ms_text(out[n]),
                " by CUDA events" if n in by_events else "",
                " (%.3f of the whole)" % (out[n] / whole)
                if whole and out[n] is not None else "")
            for n in parts), ms_text(out["rest"]), smi))
    return out


def hybrid_split(model, slots, max_len, smi):
    """Where a lane prefill of the longest prompt (DANUBE_PROMPT_MAX ids)
    and a tick of ``slots`` lanes (DANUBE_TICK_LENGTHS) spend the device's
    time: the Mamba-1 mixers (``mamba1_forward``) and their scan
    (``selective_scan``, the prefill's; a tick takes the one-step
    recurrence inside the mixer), the MoE FFNs, the attention kernel, and
    the rest."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve as launch
    from repro_torch.models import lm, mamba

    prefill, decode = launch.make_slot_fns(model, max_len)
    cache = lm.init_cache(model.cfg, slots, max_len, model.device,
                          per_seq=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, DANUBE_PROMPT_MAX),
                           generator=gen, device="cuda")
    tokens = torch.randint(0, model.cfg.vocab_size, (slots, 1),
                           generator=gen, device="cuda")
    common = {"Mamba-1 mixers": (mamba, "mamba1_forward"),
              "Mamba-1 mixers/scan": (mamba, "selective_scan"),
              "MoE": (lm, "moe_forward")}
    pre = device_split(
        "a lane prefill of %d ids" % DANUBE_PROMPT_MAX,
        lambda: prefill(prompt, cache, 0),
        {**common, "flash attention": (fa_ops, "flash_attention")}, smi)

    def tick():
        cache["len"].copy_(torch.tensor(DANUBE_TICK_LENGTHS[:slots],
                                        dtype=torch.int32))
        decode(tokens, cache)

    tk = device_split("a tick of %d lanes" % slots, tick,
                      {**common, "decode attention": (da_ops,
                                                      "decode_attention")},
                      smi)
    del cache
    return pre, tk


def gate_on_copy(arch, pattern, reqs, slots, max_len, record, smi):
    """Gate 3 where the card's depth has no room for its float32 copy: the
    batcher drains ``reqs`` on a copy at full width whose layer pattern is
    the slice ``pattern`` of the period (one layer each), and its lanes of
    ``record`` are held to the single-sequence path as ``gate_batched``
    holds them (bf16 against the bf16-vs-f32 noise; and, for an MoE, the
    float32 copy within LM_CPU_TOL with equal ids)."""
    layers = pattern[1] - pattern[0]
    cfg, model, n_params, made_s = make_lm(arch, layers, pattern)
    label = "%s, %d-layer copy %s" % (arch, layers, pattern_text(cfg))
    log("  gate copy: %s, %.3f B parameters, made in %.1f s [%s]"
        % (label, n_params / 1e9, made_s, smi))
    t0 = time.time()
    with torch.no_grad():
        ids, logits, ticks, _, _ = run_batcher(model, reqs, slots, max_len,
                                               record)
        gate_batched(model, reqs, ids, logits, label, slots, max_len)
    log("  gate 3 (%s, %d ticks) took %.1f s" % (label, ticks,
                                                 time.time() - t0))
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase_batcher(smi):
    """Phase 12: requests queued, each prefilled into a free lane of a
    per-sequence cache, every tick decoding all lanes in one fixed-shape
    step, finished lanes reused; at full width, random bf16 weights."""
    from repro_torch.kernels import _cuda
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    total = {k: 0 for k in _cuda.LAUNCHES}
    for (arch, slots, n, (lo, hi), past, (new_lo, new_hi), max_len,
         (forced, forced_past)) in BATCH_WORLDS:
        t_world = time.time()
        layers, cpu_layers = BATCH_DEPTH.get(arch, (None,
                                                    BATCH_CPU["layers"]))
        gate_pattern = BATCH_GATE_PATTERN.get(arch)
        cfg, model, n_params, made_s = make_lm(arch, layers)
        # a model without a window draws danube's traffic: "past" counts
        # prompts past DANUBE_WINDOW ids
        window = cfg.swa_window or (DANUBE_WINDOW if past else None)
        reqs = batch_requests(cfg.vocab_size, n, lo, hi, past, window,
                              new_lo, new_hi, BATCH_SEED)
        lens = [len(p) for p, _ in reqs]
        log("phase 12: %s, %d of %d layers, d_model %d, %s, %.3f B "
            "parameters summed from its tensors (%.3f B by the reference's "
            "param_counts), made in %.1f s; %d slots of %d rows, %d "
            "requests, prompts %d-%d ids (%d past %s ids; the model's "
            "window %s), %d-%d new [%s]"
            % (arch, cfg.num_layers, get_config(arch).num_layers,
               cfg.d_model, cfg.dtype, n_params / 1e9,
               cfg.param_counts()["total"] / 1e9, made_s, slots, max_len, n,
               min(lens), max(lens),
               sum(t > (window or 1 << 30) for t in lens), window,
               cfg.swa_window, min(m for _, m in reqs),
               max(m for _, m in reqs), smi))
        with torch.no_grad():                                  # warm-up
            run_batcher(model, [(p[:64], 2) for p, _ in reqs[:2]], slots,
                        max_len)
        if window:
            record = ([i for i, t in enumerate(lens) if t <= window][
                :forced - forced_past]
                + [i for i, t in enumerate(lens) if t > window][:forced_past])
        else:
            record = list(range(forced))
        kinds = [kind for kind, _ in lm.cache_slots(cfg)]
        n_attn = kinds.count("attn")
        n_ssd = len(kinds) - n_attn if cfg.mamba and cfg.mamba.version == 2 \
            else 0
        want_per = {"flash_attention": n_attn, "decode_attention": n_attn,
                    "ssd": n_ssd}
        kernels = tuple(k for k, c in want_per.items() if c)

        # the main path, through the entry points, counted
        sync()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        with torch.no_grad():
            ids, logits, ticks, calls, secs = run_batcher(model, reqs, slots,
                                                          max_len, record)
        launches = path_launches("phase 12 (%s batcher)" % arch, kernels, smi)
        want = {"flash_attention": n_attn * n,
                "decode_attention": n_attn * calls, "ssd": n_ssd * n}
        for k, cnt in launches.items():
            if cnt != want.get(k, 0):
                fail("%s launched %d times on the %s batcher, expected %d"
                     % (k, cnt, arch, want.get(k, 0)))
        if calls != ticks:
            fail("%d of %d ticks decoded" % (calls, ticks))
        for rid, got in ids.items():
            if not (1 <= len(got) <= reqs[rid][1] and
                    all(0 <= t < cfg.vocab_size for t in got)):
                fail("request %d drained %s" % (rid, got))
        toks = sum(len(g) for g in ids.values())
        log("  drained %d requests in %d ticks (%d decode steps of %d "
            "lanes), %d generated tokens in %.3f s: %.1f generated tokens/s "
            "(prefills of %d prompt ids included; lane logits recorded for "
            "%d requests), peak %.2f GB [%s]"
            % (n, ticks, calls, slots, toks, secs, toks / secs, sum(lens),
               len(record), torch.cuda.max_memory_allocated() / 1e9, smi))
        for k in total:
            total[k] += launches[k]
        with torch.no_grad():
            if record and gate_pattern is None:
                t0 = time.time()
                gate_batched(model, reqs, ids, logits, arch, slots, max_len)
                log("  gate 3 (%s) took %.1f s" % (arch, time.time() - t0))
            tick_busy = profile_ticks(model, reqs, slots, max_len, kernels,
                                      smi)
            hybrid = cfg.mamba is not None and cfg.mamba.version == 1
            if cfg.moe is not None and not hybrid:
                moe_share(model, slots,
                          tick_busy / PROFILE_TICKS if tick_busy else None,
                          smi)
            if cfg.mla is not None or hybrid or cfg.mrope_sections:
                tick_reads_nothing_back(model, slots, max_len, smi)
            if hybrid:      # the MoE's share of a tick and a prefill too
                hybrid_split(model, slots, max_len, smi)
        del model, logits
        gc.collect()
        torch.cuda.empty_cache()
        if record and gate_pattern is not None:
            gate_on_copy(arch, gate_pattern, reqs, slots, max_len, record,
                         smi)
        if n_attn:
            gate_batched_cpu(arch, cpu_layers, smi, gate_pattern)
        log("  %s world: %.1f s" % (arch, time.time() - t_world))
    return total


# --------------------------------------------------------------------------
# phase 13: other LM architectures (M-RoPE, codebook heads, frontend stubs)
# --------------------------------------------------------------------------

def rope_index(segments):
    """M-RoPE position ids ``[3, T]`` (temporal, height, width) of one
    sequence, as Qwen2-VL's ``get_rope_index`` lays them out: a segment is
    ``("text", n)`` or ``("image", h, w)`` (a grid of merged patches, one
    frame).  Text counts on in all three streams; inside an image t stays
    fixed while h and w step over the grid; each segment starts at the
    previous segment's largest id + 1."""
    cols, start = [], 0
    for seg in segments:
        if seg[0] == "text":
            ids = np.broadcast_to(np.arange(seg[1]), (3, seg[1]))
        else:
            _, h, w = seg
            ids = np.stack([np.zeros(h * w, np.int64),
                            np.repeat(np.arange(h), w),
                            np.tile(np.arange(w), h)])
        cols.append(start + ids)
        start = int(cols[-1].max()) + 1
    return np.concatenate(cols, axis=1).astype(np.int32)


def stub_inputs(cfg, batch, layout, seed, device):
    """The frontend stub's inputs for ``batch`` sequences: embeddings
    ``[batch, T, d]`` (normal x STUB_STD from a seeded generator on
    ``device``) and, with M-RoPE, the position ids ``[3, batch, T]`` of
    ``layout`` (``rope_index``'s segments, each sequence alike); without
    M-RoPE ``layout`` is T and the positions None."""
    positions = None
    if cfg.mrope_sections:
        grid = torch.from_numpy(rope_index(layout)).to(device)
        layout = grid.shape[1]
        positions = grid[:, None].expand(3, batch, layout).contiguous()
    gen = torch.Generator(device=device).manual_seed(seed)
    embeds = STUB_STD * torch.randn((batch, layout, cfg.d_model),
                                    generator=gen, device=device)
    return embeds, positions


def forward_logits(model, embeds, positions):
    """``lm.forward`` on the frontend stub's inputs, f32 logits."""
    from repro_torch.models import lm

    with torch.no_grad():
        return lm.forward(model, None, embeds=embeds,
                          positions=positions).float()


def phase_other(smi):
    """Phase 13: Qwen2-VL-7B (M-RoPE, the vision stub) and MusicGen-large
    (4 codebooks, the audio stub) at full width and depth."""
    total = {}
    for arch, (b, t, new), (fb, layout), cpu_layout in (
            (VL_ARCH, (VL_BATCH, VL_PROMPT, VL_NEW),
             (VL_FORWARD_BATCH, VL_LAYOUT), VL_CPU_LAYOUT),
            (AUDIO_ARCH, (AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW),
             (AUDIO_BATCH, AUDIO_PROMPT), AUDIO_CPU_T)):
        for k, n in other_lm(arch, b, t, new, fb, layout, cpu_layout,
                             smi).items():
            total[k] = total.get(k, 0) + n
    return total


def other_lm(arch, batch, prompt_len, new, fwd_batch, layout, cpu_layout,
             smi):
    """One architecture of phase 13: ``lm.forward`` on ``fwd_batch``
    sequences of the frontend stub's inputs (``layout``), then
    ``generate`` of ``new`` greedy tokens (frames of K codes) after
    ``batch`` prompts of ``prompt_len``, counted (flash once a layer in
    the forward and in the prefill, decode once a layer a step); phase
    7's throughput, profile and gates (gate 1 on the generation and on
    the stub's forward; gate 2 on an f32 copy of OTHER_CPU_LAYERS layers,
    the stub's forward on ``cpu_layout`` included)."""
    from repro_torch.kernels import _cuda
    from repro_torch.models import lm
    from repro_torch.serve import lm as serve

    t_world = time.time()
    cfg, model, n_params, made_s = make_lm(arch)
    books = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    embeds, positions = stub_inputs(cfg, fwd_batch, layout, 0, "cuda")
    fwd_t = embeds.shape[1]
    log("phase 13: %s (%s frontend stub), %d layers, d_model %d, %d/%d "
        "heads of %d, d_ff %d, vocab %d (padded %d)%s%s, %s, %.3f B "
        "parameters summed from its tensors (%.3f B by the reference's "
        "param_counts, %.2f GB), made in %.1f s; forward on %d x %d stub "
        "positions, then %d prompts of %d ids, %d new [%s]"
        % (arch, cfg.frontend, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff,
           cfg.vocab_size, cfg.padded_vocab,
           ", M-RoPE sections %s" % (cfg.mrope_sections,)
           if cfg.mrope_sections else "",
           ", %d codebooks" % cfg.num_codebooks if books else "", cfg.dtype,
           n_params / 1e9, cfg.param_counts()["total"] / 1e9,
           n_params * 2 / 1e9, made_s, fwd_batch, fwd_t, batch, prompt_len,
           new, smi))
    if positions is not None:
        log("  stub positions of each sequence: %s, largest id of the t, h "
            "and w streams %s" % (layout,
                                  positions[:, 0].amax(dim=1).tolist()))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(batch, prompt_len) + books)).cuda()
    max_len = prompt_len + new
    serve.generate(model, prompt[:, :64], 2, max_len=max_len)   # warm-up
    forward_logits(model, embeds[:1, :64], None if positions is None
                   else positions[:, :1, :64])

    # the main path, through the entry points, counted
    sync()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = lm.forward(model, None, embeds=embeds, positions=positions)
    sync()
    fwd_s = time.perf_counter() - t0
    after_forward = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    ids = serve.generate(model, prompt, new, max_len=max_len)
    sync()
    gen_s = time.perf_counter() - t0
    kernels = ("flash_attention", "decode_attention")
    launches = path_launches("phase 13 (%s forward and generate)" % arch,
                             kernels, smi)
    layers = cfg.num_layers
    if after_forward["flash_attention"] != layers or \
            after_forward["decode_attention"]:
        fail("the stub's forward launched %s, expected flash %d"
             % (_short(after_forward), layers))
    want = {"flash_attention": 2 * layers,
            "decode_attention": layers * (new - 1)}
    for k, n in launches.items():
        if n != want.get(k, 0):
            fail("%s launched %d times on the %s path, expected %d"
                 % (k, n, arch, want.get(k, 0)))
    v = cfg.vocab_size
    real = logits[..., :v].float()
    if logits.shape != (fwd_batch, fwd_t) + books + (cfg.padded_vocab,) \
            or not bool(torch.isfinite(real).all()) \
            or not bool((logits[..., v:] == -1e30).all()):
        fail("lm.forward on the stub gave logits of shape %s, non-finite "
             "ones or unmasked padded rows" % (tuple(logits.shape),))
    log("  forward on the stub: %d x %d positions -> logits %s in %.3f s "
        "(%.0f positions/s), std %.3f; flash %d launches [%s]"
        % (fwd_batch, fwd_t, tuple(logits.shape), fwd_s,
           fwd_batch * fwd_t / fwd_s, float(real.std()),
           after_forward["flash_attention"], smi))
    del logits, real
    log("  generate: %s ids in %.3f s, peak %.2f GB (forward and generate), "
        "ids of sequence 0 start %s [%s]"
        % (" x ".join(map(str, ids.shape)), gen_s,
           torch.cuda.max_memory_allocated() / 1e9, ids[0, :4].tolist(),
           smi))
    check_ids(ids, (batch, new) + books, v)

    time_generation(model, prompt, new, max_len, smi)
    profile_serving(model, prompt, max_len, kernels, smi)
    f32 = gate_plain(model, lambda m: teacher_forced(m, prompt, ids,
                                                     max_len),
                     plain_attention, ids=ids)
    gate_plain(model, lambda m: forward_logits(m, embeds, positions),
               plain_attention, "lm.forward on the stub", f32=f32)
    del model, f32
    gc.collect()
    torch.cuda.empty_cache()

    # gate 2 on a copy of OTHER_CPU_LAYERS layers: an f32 copy of all of
    # them on the CPU would take 4 bytes a parameter and minutes
    _, small, _, _ = make_lm(arch, OTHER_CPU_LAYERS)
    f32 = as_f32(small, "cuda")
    log("  gate 2 on a copy of %d layers" % OTHER_CPU_LAYERS)
    gate_cpu(small, f32, prompt[:1, :LM_CPU_PROMPT], LM_CPU_NEW,
             stub_inputs(cfg, 1, cpu_layout, 1, "cpu"))
    del small, f32
    gc.collect()
    torch.cuda.empty_cache()
    log("  %s world: %.1f s" % (arch, time.time() - t_world))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = os.path.join(REPO, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: %s holds no repro_torch package" % src,
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    t_start = time.time()
    from repro_torch.kernels import _cuda

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log("card: %s | torch %s, CUDA %s, %s" % (
        smi, torch.__version__, torch.version.cuda, kind))
    t0 = time.time()
    paths = _cuda.build_all()
    log("phase 1 build: %d sources in %.1f s -> %s" % (
        len(paths), time.time() - t0, ", ".join(str(v) for v in paths.values())))
    for name, text in _cuda.BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "wgmma")):
                log("  ptxas %s: %s" % (name, line.strip()))
    for src, kernels in TENSOR_CORE_KERNELS.items():
        counts = hgmma_count(str(paths[src]))
        for kern, n in kernels.items():
            hgmma = {fn: c for fn, c in counts.items() if kern in fn}
            for fn, c in sorted(hgmma.items()):
                log("  sass %s: %d HGMMA in %s" % (src, c, fn))
            if len(hgmma) != n or not all(hgmma.values()):
                fail("%s's SASS does not hold HGMMA in each of its %d "
                     "instantiations: %s" % (kern, n, hgmma))

    vocab, kbd, rows, chunks = make_world()

    log("phase 2: kernels against their plain versions (tolerance 0 for the "
        "DSCEP kernels)")
    recs = phase_kernels(vocab, kbd)
    recs.update(phase_attention(smi))
    recs.update(phase_ssd(smi))
    for rec in recs.values():
        log("  %-16s %d cases, max_abs_err %.3g; wrapper %.4f ms, launches alone %s, "
            "plain %.4f ms, library %s, bound %.5f ms (%s) [%s]" % (
                rec.name, rec.cases, rec.err, rec.ms,
                "%.4f ms" % rec.launch_ms if rec.launch_ms is not None
                else "not measured", rec.plain_ms,
                "%.4f ms" % rec.library_ms if rec.library_ms is not None
                else "none", rec.bound_ms, rec.bound_by, smi))

    log("phase 2 done at %.1f s" % (time.time() - t_start))
    launches, results, config_launches = phase_main(vocab, kbd, chunks, smi)
    log("phase 3 done at %.1f s" % (time.time() - t_start))
    log("phase 4: where the time goes (torch.profiler)")
    phase_profile(vocab, kbd, chunks, smi)
    log("phase 4 done at %.1f s" % (time.time() - t_start))
    slide_launches = phase_sliding(vocab, kbd, rows, smi)
    log("phase 5 done at %.1f s" % (time.time() - t_start))
    unfused_launches = phase_unfused(vocab, kbd, chunks, results, smi)
    log("phase 6 done at %.1f s" % (time.time() - t_start))
    lm_launches = phase_lm(smi)
    log("phase 7 done at %.1f s" % (time.time() - t_start))
    mamba_launches = phase_mamba(smi)
    log("phase 8 done at %.1f s" % (time.time() - t_start))
    obs_launches = phase_observability(vocab, kbd, rows, chunks, results,
                                       config_launches, smi)
    log("phase 9 done at %.1f s" % (time.time() - t_start))
    serve_launches = phase_serving(vocab, kbd, chunks, smi)
    log("phase 10 done at %.1f s" % (time.time() - t_start))
    shard_launches = phase_sharded(vocab, kbd, chunks, results, smi)
    log("phase 11 done at %.1f s" % (time.time() - t_start))
    batch_launches = phase_batcher(smi)
    log("phase 12 done at %.1f s" % (time.time() - t_start))
    other_launches = phase_other(smi)
    log("phase 13 done at %.1f s" % (time.time() - t_start))
    total = {k: launches[k] + slide_launches[k] + unfused_launches[k]
             + lm_launches[k] + mamba_launches[k] + obs_launches[k]
             + serve_launches[k] + shard_launches[k] + batch_launches[k]
             + other_launches[k] for k in launches}
    for name, count in total.items():
        if count <= 0:
            fail("kernel %s never launched on any path" % name)
    log("total %.1f s" % (time.time() - t_start))
    log(smi)
    print(json.dumps({"kernels": [recs[k].row(total[k]) for k in recs]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
