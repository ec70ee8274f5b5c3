#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Prints the card, builds the CUDA kernels from
   ``src/repro_torch/kernels/csrc/`` with nvcc (sm_90a) and prints the
   build time and the ptxas report.
2. Holds each kernel (K1 count, K2 stable scatter, K3 fused word reducer,
   K4 column histogram) against its plain PyTorch version on the card,
   exactly, on edge cases (K5 in phase 7, K6 and K7 in phase 8). K1 and K2
   at D in {1, 2, 9, 257, 1025} destinations, rows ragged across their
   4,096-record tile, rows of a length that is no multiple of 4, every
   record on one destination, invalid rows and destinations out of
   range. K3 and K4
   also on the cases of their hot-site design at P in {1, 4, 8}: every
   record on one cell or one site, more hot sites than a tile holds, a
   hot list that misses every record, empty rows, sites and weeks out of
   range (and bit-31 words for K3); their hot lists equal the plain
   selection.
3. Drives the port's main path once through ``repro_torch.core.run``:
   MalStone B over MalGen records generated on the card (``MalGenConfig()``
   defaults: 100,000 sites, 1,000,000 entities, 52 weeks), 8 nodes x 2^23
   records, the counting exchange at capacity factor 2.0 and the fused
   reducer. Every kernel's launch counter must rise in that run: K1-K3,
   K6 (the generated records' sites: one launch a node and one for the
   marked stream) and K7 (the MalStone B finalize, once), and K9 (the
   shuffle round's words, counted in ``ship_buckets.launches``, outside
   ``launch_counts()``) once a round, as K3. Then timed runs,
   a per-stage breakdown (with the part of generation that is
   ``sample_sites``), a profile, peak memory and the checks: lossless
   shuffle, byte accounting, and the histogram against a direct
   ``torch.bincount`` over the generated log.
4. Times each kernel at the main path's shapes against its plain version,
   one library call computing the same function (a yardstick the port
   never calls) and its byte bound at 3.35 TB/s, after checking it equal;
   K3 also over the same records with sites drawn uniformly; K1 and K2
   also beside their first design (``tools/first_designs.py``, a tile of
   1,024 records) on the same records, K2 also as a CUDA graph (no host
   work) and cold (after its inputs were evicted from the L2). Then K9
   on the main path's ordered words, bit-equal to its plain version (the
   torch path: slot index, mask, int64 gather, ``where``, transposed
   copy) at every round of the main path's capacity and at the
   benchmark's mapreduce step (capacity factor 4.0, C = 2^22), timed
   with its wrapper and as a CUDA graph beside the torch path, against
   its bound 4 P P C + 4 (live words) bytes at 3.35 TB/s, with the bytes
   each allocates beyond its output.
5. Drives the other backends at the same width, each with the launch
   counts set to 0 just before it and read just after: ``streams``,
   ``sphere`` and ``mapreduce_combiner`` over the same generated records,
   and ``mapreduce`` with the columns exchange, ``partitioned=True``, over
   the same shards as a log. Histograms and the rho bits of A, B and
   B-fixed equal the counting path's; the columns exchange's shuffle stats
   equal its (``bytes_exchanged`` at 17 bytes a slot). Each run launches
   exactly its kernels: K4 (and K1, K2 a round for columns), K6 nodes + 1
   times where it generates, K7 once for statistic B, K8 (the combiner's
   block exchange, counted in ``combine_blocks.launches``, outside
   ``launch_counts()``) once for the combiner and never for the others,
   K9 never.
   Prints each backend's stage times, records/s, peak memory and profile,
   then checks and times K4 at these shapes as in 4, over sites drawn
   uniformly and at a service step's 2^20 records a node. Then K8: on
   these records' local histograms bit-equal to its plain version (the
   torch path: ``nodes.all_to_all``, ``nodes.psum``, the add), and at the
   benchmark's combiner step (``[8, 120,000, 52, 2]`` int32 over every
   value, so the sums wrap, into ``[8, 15,000, 52, 2]``) bit-equal to it
   and to a two-op torch yardstick (one int32 sum over a view, an add
   through a permuted view), each timed (K8 with its wrapper and as a
   CUDA graph, the yardstick also as a graph) against K8's byte bound
   8 S W (P + 2) at 3.35 TB/s, with the bytes each allocates.
6. At 8 x 2^20 records, the card's result equals the port's own CPU run of
   the same log (histogram, rho bits, every ShuffleStats field).
7. The query service: (a) K5, the masked window-ratio kernel, bit-equal to
   its plain version on edge cases (N, W and S sweeps; every mask shape:
   none, one run at either end, all weeks, alternating weeks, a window,
   random, at N up to 129; zero denominators; counts above 2^24 and past
   2^31); (b) ``MalStoneService`` at full width, each backend
   with the launch counts set to 0 just before it is driven and read just
   after: ``streams`` and ``mapreduce`` (counting exchange) fold 8 ingest
   steps of 8 x 2^20 records from a streaming seed, ``sphere`` and
   ``mapreduce_combiner`` 2 steps. The resident snapshot equals the
   streaming engine (rho bits of A, B and B-fixed, every ShuffleStats
   field) and the one-shot counting run over ``generate_chunked_log``;
   each ingest step launches K6 twice a node (a chunk's marked and
   unmarked draws), K8 once on the combiner (never elsewhere) and K9
   once a mapreduce round (as K3; never elsewhere), and
   each B result K7 once;
   the ``mixed`` and ``growing`` query batches launch K5 once each, equal
   its plain version, and the 52 growing B answers equal ``malstone_b``'s
   rho columns. Prints ingest and query latency percentiles, records/s,
   sustained queries/s, peak memory, a profile, and K5 against its plain
   version, its first design, a matmul yardstick and its bound, at N = 52,
   N = 9 and over 52 alternating-week masks (the worst shape): on the
   device (a CUDA graph), with the wrapper's host work, and cold.
8. The bench (``repro_torch.bench``): (a) K6, the power-law sampler, and
   K7, the MalStone B finalizer, bit-equal to their plain versions on edge
   cases (K6: S in {1, 7, 2048, 100,000}, n in {1, 1023, 2^18 - 1, 2^18,
   2^23}, ties, runs of equal entries, NaN, +-inf, -0.0, the MalGen CDFs
   with draws on their entries and on the guide's bucket edges, u at an
   odd offset, a last entry below 1, entries outside [0, 1]; K7: W in {1,
   2, 31, 32, 33, 52, 64, 65, 130}, S in {1, 7, 1001, 100,000}, zero
   weeks, sums above 2^24 and past 2^31, NodeDoctor's S in {4, 6, 12} at
   W in {8, 52}, a histogram at an odd offset);
   (b) the six ``kernel_*`` scenarios at n = 2^23, S = 100,000 through
   ``run_scenarios``, each with the launch counts set to 0 just before it
   and read just after (K4, K6 and K7 launch only in their ``_pallas``
   rows), each kernel equal to its plain version on the scenario's inputs,
   and K6 and K7 timed against their plain versions, a library yardstick,
   their first designs (``tools/first_designs.py``) and their bounds; K6
   also on the MalGen unmarked CDF at a node's draws and at a service
   step's chunk sizes, the wrapper against ``torch.searchsorted`` with
   the host work of both; (c) the
   port's ``smoke`` selection (44 scenarios: the overlap pair is left
   out, since its 64-record chunks would take 16,384 steps a node at this
   depth, and ``faulty_run_transient``, whose schedule exhausts its
   retries at 8 nodes, runs at the bench's 2 in phase 10; the two
   ``sweep_multiproc`` rows run the launcher as a gang of 1 and 2
   processes) at the same widths, 8 nodes x 2^20 records, into a document
   that must validate and compare clean against itself; prints its
   records/s and queries/s.
9. Overlap (``repro_torch.core.overlap``): (a) K6 launched on a
   non-default stream equals its plain version at a chunk's draws; the
   overlap runner at ``MalGenConfig()`` widths, 8 nodes x 8 steps of 2^20
   records, mapreduce counting at capacity factor 2.0, statistic B, with
   overlap on and off equals ``malstone_run_streaming(overlap=None)``
   (histogram, rho bits, every ShuffleStats field), each run launching
   exactly K6 twice a node a step, K1 and K2 once a step, K3 and K9 once
   a round and K7 once (counts set to 0 just before and read just after); a
   profile shows generation (K6) and the fold (K1-K3) on two streams;
   prints, for the engine, on and off, the medians of interleaved runs,
   records/s, the card's idle share, the time both streams were busy and
   peak memory, and a step's host-clock breakdown (not gated); (b) the
   launcher in subprocesses at that width with ``--stream-chunks 8
   --overlap on|off --check --bench-json`` and one-shot ``--check``: each
   exits 0 and prints the check line, each document validates, and the
   CPU oracle's time is printed; (c) the bench's overlap pair through
   ``run_scenarios`` at 4,096 records a node (64 chunks of 64 records),
   launches in the path's exact ratios; (d) the runner on ``streams`` and
   ``mapreduce_combiner`` at 2 steps equal to their streaming engine, K4
   once a step, K8 once a combiner step, K9 never.
10. Resumable runs (``repro_torch.core.resume``) at ``MalGenConfig()``
   widths, 8 nodes x 8 steps of 2^20 records, mapreduce counting at
   capacity factor 2.0, statistic B, in 4 segments of 2 steps: (1) equal
   to ``malstone_run_streaming(overlap=None)`` (histogram, rho bits, every
   ShuffleStats field) with exact launches (K6 128, K1 8, K2 8, K3 and K9
   one a round, K7 1, no K4 or K5; counts set to 0 just before and read just
   after); (2) killed (raised) at the segment 2 boundary and inside step
   2's checkpoint write, each resumed equal, the torn step swept, and a
   complete checkpoint restored; (3) the launcher in a child process
   killed by ``os._exit(17)`` at segment 2, ``--resume`` in a second
   child, and the killed run's directory resumed in process, equal; (4)
   transients (seed 11, 25% a shard, 6 attempts, 4 hosts) exhausting
   segment 2, resumed without faults equal, and host 0 down, alarmed by
   NodeDoctor (K7 once a diagnosis) with its two shards rerouted, equal;
   each run's telemetry diagnosed again afterwards, K7 at ``[4, 8, 2]``
   bit-equal to its plain version and the card's report (rho and CUSUM
   bits, alarm, ranking) equal to the CPU's;
   (5) streams at its full ``[8, 100,000, 52, 2]`` carry, 4 steps with a
   checkpoint every 2, equal with K4 once a step, and restored; (6) the
   segmented run against the engine in interleaved turns, checkpoint save
   ms a segment, bytes a checkpoint and restore ms, and the card's idle
   share from one profile of each mode; (7) the bench's
   ``faulty_run_transient`` at 2 nodes through ``run_scenarios``, its
   runner and plan run again and held against the streaming engine; the
   temporary directory is removed.
11. Gangs of processes (``launch/coordinator.py``; the worker script
   ``tools/gang_check.py``) whose ranks share the card and join over
   gloo, each holding P/N of the 8 nodes, at ``MalGenConfig()`` widths,
   8 nodes x 8 steps of 2^20 records: mapreduce counting at N = 1, 2 and
   4 ranks in one turn (three, interleaved, until phase 16 came: cut for
   the script's time limit), and at N = 2 streams and
   the overlap runner on and off. Every rank's histogram, rho bits and
   ShuffleStats equal this process's one-process engine over the same
   seed, and every rank launches exactly its nodes' kernels (K6 twice a
   local node a step, K1 and K2 once a step, K3 once a round or K4 once a
   step, K7 once, and K9, in the senders' layout, once a round, as K3;
   counts set to 0 by each rank just before its run and read just
   after). Prints the run ms by N (rank 0's CUDA events after a
   barrier; the median of the turns), the exchange's bytes handed to gloo
   and its host-clock parts (waiting for the card, the copy to pinned
   memory, gloo, the copy back), peak memory a rank and rank 0's idle
   share. Then the launcher's one-shot log at N = 2 with ``--check``: each
   rank's rho bit-equals its CPU oracle. A gang that fails or outlives
   its timeout (its session killed whole) fails the script. Phase 2 also
   holds K3 over the rows of nodes first_node .. P - 1, as a rank holds
   them, at P in {4, 8} and first_node in {1, 3, P - 1}.
12. The static checker suite (``repro_torch.analysis``) against the card:
   Hopper's limits in ``analysis.registry`` equal what
   ``torch.cuda.get_device_properties`` exposes; every kernel analysis
   case's wrapper runs once under ``torch.profiler`` (the 2^31-record
   rows included, one at a time), and the profiler's grid, block, shared
   memory (static plus dynamic) and registers equal the case's
   ``launch_plan``, the static bytes of each ``ops.py`` table and the
   registers equal ``cudaFuncGetAttributes`` (each source's
   ``kernel_attributes``), and its largest block each kernel's
   ``__launch_bounds__``; prints the plan of every case, planned for the
   card's own SM count. (The records are taken in a fresh process,
   ``python -m repro_torch.analysis.card_launches``: once a process's
   first profiled session is a minute or so old, torch.profiler drops the
   first kernel records of each later session, more as the process ages,
   whatever the device did meanwhile; ``tools/profiler_record_probe.py``.)
   Then the whole suite
   runs with its programs on the card (the drivers under
   ``torch.cuda.set_sync_debug_mode("warn")``, the exchanges' collectives
   and a gang of 2 sharing the card): no finding outside
   ``results/analysis_baseline_torch.json``, every driver within its
   host-sync budget; prints each driver's count and the card's. Then
   ``compute-sanitizer`` (beside nvcc): a one-line torch program under
   its memcheck first; if the tool says "Device not supported", the
   kernel checks are left out and the sanitizer line says so; any other
   failure fails the script; else the seven kernels run at small shapes
   in a child (``chip_smoke.py --sanitizer-child``) under memcheck,
   racecheck, synccheck and initcheck, with zero errors required.

13. The trainer (``repro_torch.runtime``, ``data``, ``optim``): (a) at
   the JAX launcher's defaults (``--data malgen --batch 8 --seq-len
   256``, vocabulary 256, the pipeline's MalGenConfig) the one-parameter
   toy step of ``tests/test_runtime.py`` runs 80 steps (checkpoint every
   10, doctor every 8, 8 hosts) while host 5 fails every step it serves
   past step 8: it ends at step 80 with host 5 blocklisted and absent
   from the last 16 steps, K7 launched once a doctor run and K6 once a
   batch plus once for the marked stream (counts set to 0 just before
   the pipeline is built and read after the run), no other kernel; K7 on
   the doctor's ``[8, 16, 2]`` histogram and K6 at a batch's and the
   marked stream's draws equal their plain versions, the final diagnosis
   on the card equals the CPU's; on a fake clock (2^-10 s a call) the
   same run on the card and on the CPU over the card's batches give equal
   histories, retries, restarts and blocklists and losses within rtol
   1e-6; one card batch equals the CPU path's on the card's draws and
   seed tables. Prints steps/s, doctor ms and the kernels' ms at these
   shapes. (b) A run of 20 steps dropped and resumed from its checkpoint
   equals an uninterrupted run of 25 over steps 20-24. (c) AdamW at one
   llama3-8b decoder layer's width (218,112,000 parameters, seeded on the
   card): 3 updates with f32 and with bf16 moments, each against the
   CPU's update of the same inputs (params and f32 moments rtol 1e-5,
   atol 1e-6; bf16 moments within one bf16 ulp, plus 2^-20 of the
   magnitude of the terms the update summed; ``step`` exact), then the
   ms of one update (CUDA events, median of 5) against its byte bound at
   3.35 TB/s; two rounds of ``tree_ef_compress`` bit-equal to the CPU
   (``q``, ``scale``, estimate, error); peak device memory.
14. The language-model forward (ROADMAP Queue 1 items 9b and 9c), which
   launches none of K1-K7 (checked), with the card's name, power limit and
   TF32 flags on its lines: (1) llama3-8b (S = 256), gemma2-2b,
   granite-moe-1b-a400m, rwkv6-7b (2 layers) and recurrentgemma-2b (3
   layers: two RG-LRU blocks and a local attention) at full width, S =
   512 and f32, from one set of parameters on the card and on the CPU:
   the MoE router's choices on the card's inputs equal, its choices on
   the CPU's own inputs explained by their drift, the dropped fractions
   equal; each block on the card's input to it within 2e-3 (2e-2 for
   MoE), the head within 2e-3, the logits and loss end to end within 2e-3
   (the MoE's loss within 2e-2, its logits printed with the CPU routed by
   the card's choices); causality at f32 (1e-5; 2e-2 for the MoE); for
   the recurrent two, each decode step (RG-LRU, RWKV-6 time-mix and
   channel-mix) after the block's state on 511 tokens against the block
   on 512, within 2e-3. (2) The ten architectures at full width and bf16,
   B = 1, S = 4096 (gemma2 8192; internvl2 256 patches + 3840 tokens;
   whisper 448 tokens over 1500 frames; grok-1 2 of 64 layers, rwkv6-7b
   8 of 32): logits
   shape and finite, loss finite, causality (printed where the bits
   differ), forward ms (median of 3), tokens/s, peak memory, the FLOPs
   the code computes and their share of the 989 TFLOP/s bf16 peak. (3)
   The top operators and kernels by device time of one profiled forward
   in a fresh process (``--model-profile-child ARCH LAYERS``):
   llama3-8b and recurrentgemma-2b at full depth, rwkv6-7b at 1 layer
   (2 until phase 16 came: cut for the script's time limit) with one
   block profiled alone (its launches x 31 more layers give a full
   forward's), and each recurrent scan's launches. (4) The RG-LRU scan
   over ``[1, 4096, 2560]`` and the WKV loop over ``[1, 4096, 64, 64]``
   alone at f32, ms (median of 5, CUDA events) against their bounds.
15. Training and decoding the language models (ROADMAP Queue 1 item 9d):
   (1) llama3-8b, gemma2-2b, granite-moe-1b-a400m, rwkv6-7b (2 layers),
   recurrentgemma-2b (3) and whisper-small (2 + 2 over 1,500 frames) at
   full width and f32, B = 2, a prompt of 256, from one set of parameters:
   on the card the fused prefill's logits and every cache leaf against the
   replay oracle (``prefill_reference``), the card's against the CPU's
   (the MoE's choices first, as in phase 14), two decode steps against
   teacher forcing on the card, all within 2e-3 (2e-2 for the MoE; length
   and ring positions exact); one ``make_train_step`` of llama3-8b,
   recurrentgemma-2b and rwkv6-7b on the card against the CPU's: loss and
   grad norm within 2e-3 relative, every gradient leaf within 2e-3 x its
   max |g| + 1e-6. (2) The ten architectures serving at full width and
   bf16 through ``launch/serve_lm.py``'s ``greedy_generate``, 32 greedy
   tokens (B = 4, a prompt of 2,048; gemma2 B = 1 and 4,096; internvl2
   256 patches + 1,792 tokens; whisper 384 tokens; grok-1 2 of 64 layers
   at B = 1): finite logits, ids in the real vocabulary, each ring's
   positions exact after the prefill and every step (recurrentgemma's and
   gemma2's rings wrap); prefill ms, decode ms a token (median of 31
   steps, CUDA events) against the floor of the weights and the cache
   read once, tokens/s, peak memory, cache bytes, and the kernels a decode
   step launches (profiled in a fresh process, ``--decode-profile-child``);
   no K1-K7 launch. (3) qwen1.5-4b, granite-moe-1b-a400m and
   recurrentgemma-2b train 10 steps at full width through
   ``launch/train.py``'s ``main`` (8 x 256 malgen tokens, no checkpoint):
   finite losses, K6 once a batch plus once for the marked stream, K7 once
   a doctor run, nothing else; steps/s, tokens/s, peak memory (in a
   fresh process with expandable segments, ``--lm-train-child DIR``:
   qwen1.5-4b's old and new state alone take 73.6 GiB). (4) Phase
   13's bad-host run with llama3-8b's smoke model step at bf16: host 5
   blocklisted and absent from the last 16 steps, finite losses.
16. Pipeline parallelism (ROADMAP Queue 1 item 9e,
   ``repro_torch.distributed.pipeline_apply``): (a) llama3-8b's 32
   blocks at full width and bf16 as 4 stages of 8 (``block_apply``, layer
   ``stage * 8 + j``; stage i's blocks from a generator seeded 30 + i,
   ``tools/pipeline_gang.py``), 8 microbatches of ``[1, 2048, 4096]``
   hidden states under ``torch.no_grad``: the output bit-equal to the
   same blocks applied to each microbatch in turn, and within
   ``PIPE_WHOLE_TOL`` x its mean |value| of the whole ``[8, 2048]``
   batch through them;
   pipeline and sequential ms (interleaved turns, CUDA events), their
   ratio, and JAX's bubble fraction (s - 1) / (m + s - 1) = 3/11. (b)
   Gloo gangs sharing the card (``tools/pipeline_gang.py``, each rank
   building only its own stages): 4 ranks of one stage, then 2 of two;
   every rank's output bit-equal to (a)'s; run ms, the bytes a rank hands
   to gloo and gloo's share of a run (``ExchangeClock``). (c) JAX's toy
   (``tests/md_scripts/pipeline_check.py``: s = 4, m in {4, 8}, mb = 2, d
   = 8) on the card against the port on the CPU within 1e-5. No K1-K7
   launch.

Prints one JSON line of per-kernel numbers (``launches`` from the main
path, ``overlap_launches`` from phase 9's runner, ``resume_launches`` from
phase 10's two fault-free runs, mapreduce and streams, ``gang_launches``
from rank 0 of phase 11's mapreduce gang of 2, ``trainer_launches`` from
phase 13's real-clock run, ``lm_train_launches`` from phase 15's three
training runs, ``pipe_launches`` from phase 16; K8's entry, last, has
``launches`` from phase 5's three combiner runs, ``serve_launches`` from
phase 7 and ``overlap_launches`` from phase 9 (d)), then
``{"sanitizer": ...}`` (what phase 12's
compute-sanitizer did), then the card's name and power limit as
nvidia-smi gives them, then ``{"ok": true, "device": ...}`` as the last
line. Exits non-zero, printing no result, without a CUDA device or when
the repository's ``src/`` is not beside this file; any failed check exits
non-zero.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
# H100 SXM HBM3, NVIDIA data sheet. K1-K4 do a few integer operations per
# 4-byte element they read, so their operation time at any of the card's
# ALU rates is far below their byte time: their bound_ms is the byte time
# (inputs read once, outputs written once) at this rate. K5's integer adds,
# K6's search steps and K7's adds and divides are counted too, at the
# card's 32-bit rate outside the tensor cores (the data sheet's float32
# 67 T/s; it gives no separate INT32 rate); a bound is the larger of the
# two times.
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12
NODES, RPS = 8, 1 << 23            # main path: 67,108,864 records
EQ_RPS = 1 << 20                   # equality phase: 8,388,608 records
SERVE_CHUNK, SERVE_STEPS = 1 << 20, 8   # service: 8 x 8 x 2^20 records
SERVE_SMALL_STEPS = 2                   # sphere and the combiner
QUERY_BATCHES = 20
# phase 8: the bench's kernel pairs at the MalGenConfig() widths, then its
# smoke selection at the same widths and a smaller depth
BENCH_WIDTHS = dict(num_sites=100_000, num_entities=1_000_000,
                    marked_event_fraction=0.1, warmup=1)
BENCH_KERNELS = dict(records_per_node=1 << 23, chunk_records=1 << 20,
                     iters=5, **BENCH_WIDTHS)
BENCH_SMOKE = dict(records_per_node=1 << 20, chunk_records=1 << 18,
                   iters=3, **BENCH_WIDTHS)
# phase 9: the overlap runner at the service's widths and depth, the
# launcher's gate over the same records, the bench's overlap pair at a
# depth of its own (64 chunks of 64 records a node) and the runner on
# streams and the combiner at 2 steps
OVERLAP_CHUNK, OVERLAP_STEPS = 1 << 20, 8   # 8 x 8 x 2^20 records
OVERLAP_SMALL_STEPS = 2
OVERLAP_TURNS = 5
OVERLAP_PAIR = ("streaming_overlap_on", "streaming_overlap_off")
BENCH_OVERLAP = dict(records_per_node=4096, chunk_records=1 << 18, iters=1,
                     **BENCH_WIDTHS)
# phase 10: resumable runs at the service's widths and chunk: mapreduce
# counting over 8 steps a node in segments of 2 (4 segments), streams over
# 4 steps at its full [8, 100,000, 52, 2] carry
RESUME_CHUNK, RESUME_STEPS, RESUME_SEGMENT = 1 << 20, 8, 2
RESUME_STREAMS_STEPS = 4
RESUME_TURNS = 5
RESUME_HOSTS = 4
BENCH_TRANSIENT = "faulty_run_transient"
# phase 11: gangs of processes over gloo sharing the card, at the service's
# widths and depth (gang_check's "full" width: 8 x 8 x 2^20 records);
# mapreduce counting at every gang size, streams and the overlap runner at
# 2 ranks
GANG_SIZES = (1, 2, 4)
GANG_TURNS = 1          # 3 until phase 16 came: cut for the time limit
GANG_MAIN = "seed_mapreduce_counting"
GANG_CASES = {1: (GANG_MAIN,),
              2: (GANG_MAIN, "seed_streams",
                  "seed_mapreduce_counting_overlap_on",
                  "seed_mapreduce_counting_overlap_off"),
              4: (GANG_MAIN,)}
GANG_TIMEOUT = 300
# phase 13: the trainer port at the JAX launcher's defaults
# (launch/train.py:32-40: --data malgen --batch 8 --seq-len 256) with
# tests/test_runtime.py's bad-host run (host 5 fails every step it serves
# past step 8), and AdamW and int8 error feedback at one llama3-8b decoder
# layer's width (configs/llama3_8b.py:15-21: d_model 4096, 32 x 128 query
# heads, 8 x 128 kv heads, d_ff 14336)
TRAIN_DATA = dict(source="malgen", global_batch=8, seq_len=256,
                  vocab_size=256)
TRAIN_RUN = dict(total_steps=80, ckpt_every=10, doctor_every=8,
                 telemetry_hosts=8)
TRAIN_BAD_HOST, TRAIN_BAD_AFTER = 5, 8
TRAIN_CHECK_STEP = 37
LLAMA_LAYER = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
               "wo": (4096, 4096), "w_gate": (4096, 14336),
               "w_up": (4096, 14336), "w_down": (14336, 4096),
               "attn_norm": (4096,), "mlp_norm": (4096,)}
LLAMA_LAYER_PARAMS = 218_112_000
ADAMW_STEPS, ADAMW_TURNS, ADAMW_SEED = 3, 5, 26
# phase 14: the language-model forward (ROADMAP Queue 1 items 9b, 9c). (1)
# card against CPU at f32, full width, 2 layers (gemma2: one local, one
# global; recurrentgemma 3: two RG-LRU blocks and its local attention);
# (2) each architecture at full width and the configs' bf16, B = 1, S =
# 4096 (train_4k, models/steps.py:37), gemma2 at 8192 so that its
# 4096-token window masks, internvl2 256 patches + 3840 tokens, whisper
# 448 decoder tokens over 1500 frames, grok-1 at 2 of 64 layers (631 GB at
# full depth), rwkv6-7b at 8 of 32 (its host-bound forward took 10-12 s
# at full depth: cut for the script's time limit when phase 15 came); (3)
# the top device ops of llama3-8b and recurrentgemma-2b at full depth and
# rwkv6-7b at 1 layer (a full-depth rwkv6 trace would hold about a million
# kernel records; 2 layers until phase 16 came: cut for the time limit),
# each profiled in a fresh process; (4) the recurrent scans alone
# at one layer's shape
MODEL_SEED = 27
MODEL_CHECKS = (("llama3_8b", 2, 256), ("gemma2_2b", 2, 512),
                ("granite_moe_1b_a400m", 2, 512),
                ("recurrentgemma_2b", 3, 512), ("rwkv6_7b", 2, 512))
MODEL_RUNS = (("llama3_8b", None, 4096), ("gemma2_2b", None, 8192),
              ("qwen1_5_4b", None, 4096), ("granite_20b", None, 4096),
              ("granite_moe_1b_a400m", None, 4096),
              ("grok_1_314b", 2, 4096), ("internvl2_1b", None, 4096),
              ("whisper_small", None, 448),
              ("recurrentgemma_2b", None, 4096), ("rwkv6_7b", 8, 4096))
MODEL_PROFILES = (("llama3_8b", None), ("recurrentgemma_2b", None),
                  ("rwkv6_7b", 1))
MODEL_TURNS = 3
SCAN_TURNS = 5
SCAN_SEQ = 4096
DECODE_LEN = 512
RECURRENT_ARCHS = ("recurrentgemma_2b", "rwkv6_7b")
PEAK_F32 = 67e12                   # f32 FLOP/s off the tensor cores
MODEL_TOP_OPS = 12
PEAK_BF16 = 989e12                 # dense bf16 FLOP/s, H100 SXM data sheet
# phase 15: train and decode (ROADMAP Queue 1 item 9d). (1) card against
# CPU at f32, full width, B = 2, a prompt of 256 (2 layers, recurrentgemma
# 3, whisper 2 + 2 over its 1,500 frames); (2) the ten architectures
# serving at full width and bf16 (B = 4 and a prompt of 2,048, so that
# recurrentgemma's 2,048-slot ring wraps; gemma2 B = 1 and 4,096 so that
# its 4,096-slot ring wraps, its prefill's f32 logits over 256,000 ids
# being the bound; internvl2 256 patches + 1,792 tokens; whisper 384
# tokens; grok-1 2 of 64 layers at B = 1); (3) three models training
# through launch/train.py at its malgen defaults (qwen1.5-4b with f32
# moments: 7.36 GiB of bf16 parameters, 29.4 of moments); (4) the bad-host
# run of phase 13 with a model's train step
LM_SEED = 29
LM_F32 = (("llama3_8b", 2), ("gemma2_2b", 2), ("granite_moe_1b_a400m", 2),
          ("recurrentgemma_2b", 3), ("rwkv6_7b", 2), ("whisper_small", 2))
LM_F32_TRAIN = ("llama3_8b", "recurrentgemma_2b", "rwkv6_7b")
LM_F32_BATCH, LM_F32_PROMPT = 2, 256
SERVE_RUNS = (("llama3_8b", None, 4, 2048), ("gemma2_2b", None, 1, 4096),
              ("qwen1_5_4b", None, 4, 2048), ("granite_20b", None, 4, 2048),
              ("granite_moe_1b_a400m", None, 4, 2048),
              ("grok_1_314b", 2, 1, 2048), ("internvl2_1b", None, 4, 1792),
              ("whisper_small", None, 4, 384),
              ("recurrentgemma_2b", None, 4, 2048),
              ("rwkv6_7b", None, 4, 2048))
SERVE_TOKENS = 32
LM_TRAIN_RUNS = ("qwen1_5_4b", "granite_moe_1b_a400m", "recurrentgemma_2b")
LM_TRAIN_STEPS = 10       # 12 until phase 16 came; 10 keeps a doctor run
LM_TRAIN_ARGS = ("--steps", str(LM_TRAIN_STEPS), "--batch", "8",
                 "--seq-len", "256",
                 "--data", "malgen", "--ckpt-every", "100")
# phase 16: pipeline parallelism (ROADMAP Queue 1 item 9e): llama3-8b's 32
# blocks at full width and bf16 (configs/llama3_8b.py) in 4 stages of 8, 8
# microbatches of [1, 2048, 4096] hidden states; in one process, then over
# gloo gangs of 4 x 1 and 2 x 2 stages sharing the card; JAX's toy
# (tests/md_scripts/pipeline_check.py) on the card against the CPU
PIPE_ARCH = "llama3_8b"
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 2048
PIPE_GANGS = (4, 2)
PIPE_TURNS = 3
PIPE_GANG_RUNS = 3
PIPE_TIMEOUT = 240
# the pipeline's output against the whole batch through the same blocks:
# every chip run read max |diff| 0 (PERF.md), so the bar is a few bf16 ulps
# of the mean |value| (one ulp is 2^-8 to 2^-7 of a value): the largest
# difference within 2^-6 of the mean |value|
PIPE_WHOLE_TOL = 2.0**-6
PIPE_TOY_S, PIPE_TOY_MB, PIPE_TOY_D = 4, 2, 8
PIPE_TOY_M = (4, 8)
PIPE_TOY_TOL = 1e-5
# kernel names in a profile: generation (K6) and the fold (K1-K3)
GEN_KERNELS = ("sample_kernel", "direct_kernel", "guide_kernel")
FOLD_KERNELS = ("count_tiles_kernel", "scatter_tiles_kernel",
                "packed_hist_kernel")
CAPACITY_FACTOR = 2.0
KERNEL_INFO = {
    "count_scatter.count": (
        "src/repro_torch/kernels/csrc/count_scatter.cu",
        "src/repro/kernels/count_scatter/count_scatter.py:52"),
    "count_scatter.scatter": (
        "src/repro_torch/kernels/csrc/count_scatter.cu",
        "src/repro/kernels/count_scatter/count_scatter.py:78"),
    "segment_hist.packed": (
        "src/repro_torch/kernels/csrc/segment_hist_packed.cu",
        "src/repro/kernels/segment_hist/segment_hist.py:87"),
    "segment_hist": (
        "src/repro_torch/kernels/csrc/segment_hist.cu",
        "src/repro/kernels/segment_hist/segment_hist.py:66"),
    "windowed_ratio.masked": (
        "src/repro_torch/kernels/csrc/windowed_ratio_masked.cu",
        "src/repro/kernels/windowed_ratio/windowed_ratio.py:53"),
    "powerlaw_sample": (
        "src/repro_torch/kernels/csrc/powerlaw_sample.cu",
        "src/repro/kernels/powerlaw_sample/powerlaw_sample.py:32"),
    "windowed_ratio": (
        "src/repro_torch/kernels/csrc/windowed_ratio.cu",
        "src/repro/kernels/windowed_ratio/windowed_ratio.py:29"),
    # K8 replaces no TPU kernel: the JAX package's combiner exchange is
    # XLA's all_to_all and a sum
    "combine_blocks": (
        "src/repro_torch/kernels/csrc/combine_blocks.cu",
        "none (src/repro/core/backends/mapreduce.py:"
        "mapreduce_combiner_histogram)"),
    # K9 replaces no TPU kernel: the JAX package fills the shuffle's
    # buckets with XLA's gather and ships them with all_to_all
    "ship_buckets": (
        "src/repro_torch/kernels/csrc/ship_buckets.cu",
        "none (src/repro/core/backends/mapreduce.py:"
        "_word_shuffle_histogram)"),
}
# K8 at the benchmark's combiner step: 8 nodes' [8, 120,000, 52, 2] local
# histograms into the [8, 15,000, 52, 2] owned carry (P, S/P, W)
K8_CELL = (8, 15_000, 52)
# K9 at the benchmark's mapreduce step: capacity factor 4.0, so 2^22-slot
# buckets of a node's 2^23 words
K9_CAPACITY_FACTOR = 4.0
# the kernels of the counting main path (phase 3): K6 samples the sites of
# the generated records, K7 finalizes MalStone B
MAIN_KERNELS = ("count_scatter.count", "count_scatter.scatter",
                "segment_hist.packed", "powerlaw_sample", "windowed_ratio")
STATISTICS = ("A", "B-fixed", "B")     # B last: its run is the one read


class CheckFailed(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, iters: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``iters`` calls
    after ``warmup`` calls, ended by a synchronize (host clock on CPU)."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def graph_ms(fn, device, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``iters`` calls captured in
    one CUDA graph and replayed, so that no host work is timed (the best
    of three replays). The port runs eagerly; this is a kernel's time
    without its wrapper's Python."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def cold_ms(fn, device, calls: int = 5) -> float:
    """Median milliseconds of single calls of ``fn``, each timed alone with
    CUDA events right after a write of 256 MB has evicted its inputs from
    the card's 50 MB L2."""
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    fn()
    out = []
    for _ in range(calls):
        scratch.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def first_designs():
    """``tools/first_designs.py``: the first designs of K2 and K5, the
    yardsticks timed beside them (built with the port's flags)."""
    sys.path.insert(0, str(ROOT / "tools"))
    import first_designs as fd

    return fd


def exact(name: str, got, want) -> float:
    """Require bit equality; return the max absolute difference (0)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
        if a.numel():
            err = max(err, float((a.to(torch.int64) - b.to(torch.int64))
                                 .abs().max()))
    check(err == 0.0, f"{name}: kernel differs from its plain version "
                      f"(max abs err {err})")
    return err


def k8_module():
    """K8's wrapper module. Its launch counter, ``combine_blocks.
    launches``, is outside ``launch_counts()``: a phase that runs the
    combiner sets it to 0 just before and reads it just after."""
    from repro_torch.kernels.combine_blocks import ops

    return ops


def k9_module():
    """K9's wrapper module. Its launch counter, ``ship_buckets.launches``,
    is outside ``launch_counts()``: a phase that runs the record shuffle
    sets it to 0 just before and reads it just after."""
    from repro_torch.kernels.ship_buckets import ops

    return ops


def check_k9(name: str, k9: int, launches: dict, device) -> None:
    """One process's card path writes every shuffle round's words with one
    K9 launch, and reduces them with one K3 launch: K9's launches equal
    K3's (0 where no record is shuffled, and on the CPU)."""
    want = launches["segment_hist.packed"] if device.type == "cuda" else 0
    check(k9 == want, f"{name}: {k9} K9 launches, expected {want} (one a "
                      f"shuffle round)")


# ------------------------------------------------------------- phase 1
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    log("build", f"{len(reports)} sources built in "
                 f"{time.perf_counter() - t0:.2f} s into {_build.BUILD_DIR}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("build", f"{name}.cu: {line.strip()}")


# ------------------------------------------------------------- phase 2
def packed_words_case(seed: int, p: int, length: int, s_local: int,
                      num_weeks: int, device) -> torch.Tensor:
    """Shipped words with every kind of slot: owned and foreign words,
    zero words, and words whose site sets bit 31."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    site = torch.randint(0, s_local * p, (p, length), generator=g)
    week = torch.randint(0, num_weeks, (p, length), generator=g)
    mark = torch.randint(0, 2, (p, length), generator=g)
    words = (site << 8) | (week << 2) | (mark << 1) | 1
    kind = torch.rand((p, length), generator=g)
    big = (torch.randint(1 << 23, 1 << 24, (p, length), generator=g) << 8) | 3
    words = torch.where(kind < 0.15, torch.zeros_like(words), words)
    words = torch.where((kind >= 0.15) & (kind < 0.25), big, words)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32).to(device)


def kernel_edge_cases(device) -> None:
    from repro_torch.kernels.count_scatter import count_scatter_ref
    from repro_torch.kernels.count_scatter import ops as cs
    from repro_torch.kernels.segment_hist import ops as sh

    g = torch.Generator(device="cpu").manual_seed(7)
    # (rows, n, P): D = P + 1 destinations; rows ragged across the tile,
    # and rows whose length is no multiple of 4 (16-byte loads only where
    # a row is aligned)
    tile = cs.TILE
    cases = [(1, 1000, 3), (1, 100, 4), (2, 5000, 1), (3, 70_000, 3),
             (4, 4 * tile, 4), (8, 100_000, 8), (2, 30_000, 16),
             (1, tile - 1, 0), (2, tile + 1, 1), (3, 3 * tile + 77, 8),
             (2, 2 * tile + 5, 256), (3, 3 * tile + 77, 1024)]
    for rows, n, p in cases:
        dest = torch.randint(0, p + 1, (rows, n), generator=g,
                             dtype=torch.int32)
        words = torch.randint(-2**31, 2**31 - 1, (rows, n), generator=g,
                              dtype=torch.int32)
        variants = {"random": dest,
                    "one dest": torch.full_like(dest, p // 2),
                    "pseudo dest": torch.full_like(dest, p)}
        invalid = torch.rand((rows, n), generator=g) < 0.3
        variants["invalid rows"] = torch.where(invalid, p, dest)
        # K1/K2 only: destinations outside [0, P] land nowhere
        k = torch.randint(0, 7, (rows, n), generator=g, dtype=torch.int32)
        variants["out of range"] = torch.where(
            invalid, torch.where(k % 2 == 0, -1 - k, p + 1 + k), dest)
        for name, d in variants.items():
            w = torch.where(invalid, 0, words) if name == "invalid rows" \
                else words
            w, d = w.to(device), d.to(device)
            if name != "out of range":
                exact(f"count_scatter {name} rows={rows} n={n} P={p}",
                      cs.count_scatter(w, d, p), count_scatter_ref(w, d, p))
            counts = cs.count_tiles(d, p + 1)
            exact(f"count_tiles {name} n={n} P={p}", counts,
                  cs.count_tiles_plain(d, p + 1))
            base, _ = cs.tile_bases(counts)
            exact(f"scatter_tiles {name} n={n} P={p}",
                  cs.scatter_tiles(w, d, base),
                  cs.scatter_tiles_plain(w, d, base))
    for p, s_local in ((1, 37), (3, 300), (8, 12_500)):
        words = packed_words_case(p, p, 50_000, s_local, 52, device)
        kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=52)
        exact(f"packed hist P={p}", sh.segment_hist_packed_words(words, **kw),
              sh.segment_hist_packed_words_plain(words, **kw))
    # bit-31 sites that this node owns and counts
    p, s_local = 2, 1 << 23
    site = torch.randint((1 << 24) - 64, 1 << 24, (p, 4000), generator=g)
    words = (site << 8) | 3
    words = torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32).to(device)
    kw = dict(num_sites_local=s_local, num_partitions=p, num_weeks=1)
    hist = sh.segment_hist_packed_words(words, **kw)
    exact("packed hist bit-31 sites", hist,
          sh.segment_hist_packed_words_plain(words, **kw))
    check(int(hist.sum()) == 2 * int((site % p == torch.arange(p)[:, None])
                                     .sum()), "bit-31 sites were dropped")
    k4 = k4_edge_cases(g, device)
    hot = hot_site_cases(device)
    first = k3_first_node_cases(g, device)
    log("kernel", f"K1/K2 bit-equal to plain on {len(cases) * 5} edge "
                  f"cases, K3 on {4 + hot['K3'] + first}, K4 on "
                  f"{k4 + hot['K4']}; the hot lists equal their plain "
                  f"version on {hot['lists'] + first // 2}")


def k3_first_node_cases(g, device) -> int:
    """K3 over the rows of nodes first_node .. P - 1, as a rank of a gang
    holds them (phase 11), at P in {4, 8} and first_node in {1, 3, P - 1}:
    random words (owned, foreign, zero and bit-31 words) and words all on
    one site, at 2^20 a row. The histogram and the hot list equal
    their plain versions and the one-process launch's rows. Returns the
    number of cases."""
    from repro_torch.kernels.segment_hist import ops as sh

    count = 0
    for p in (4, 8):
        s_local = 12_500
        one_site = case_words(hist_case("one site", p, 1 << 20, s_local * p,
                                        52, g), p, s_local)
        for kind, words in (
                ("random", packed_words_case(40 + p, p, 1 << 20, s_local,
                                             52, device)),
                ("one site", one_site.to(device))):
            kw = dict(num_sites_local=s_local, num_partitions=p,
                      num_weeks=52)
            every = sh.segment_hist_packed_words(words, **kw)
            for first in (1, 3, p - 1):
                mine = words[first:].contiguous()
                what = f"K3 {kind} P={p} first_node={first}"
                got = sh.segment_hist_packed_words(mine, first_node=first,
                                                   **kw)
                exact(what, got, sh.segment_hist_packed_words_plain(
                    mine, first_node=first, **kw))
                exact(f"{what} against the one-process rows", got,
                      every[first:])
                geo = sh.launch_geometry(mine, mine.shape[1], 52)
                exact(f"{what} hot list",
                      sh.segment_hist_packed_hot_sites(
                          mine, first_node=first, **kw),
                      sh.hot_sites_plain(sh.word_sites(
                          mine, first_node=first, **kw), geo.sample,
                          geo.threshold))
                count += 2
    return count


def k4_edge_cases(g, device) -> int:
    """K4 on invalid rows, sites below 0 and at num_sites or above, weeks
    out of range, marks in {-1, 0, 1, 2}, every record on one site,
    record counts that are not a multiple of the block and site offsets.
    Returns the number of cases."""
    from repro_torch.kernels.segment_hist import ops as sh

    cases = [(1, 1, 5, 52, 0), (1, 1000, 37, 52, 0), (3, 70_001, 300, 52, 0),
             (8, 100_000, 12_500, 52, 0), (2, 257, 10, 65, 17),
             (4, 5000, 40, 52, -3)]
    for rows, n, num_sites, num_weeks, offset in cases:
        site = torch.randint(offset - 3, offset + num_sites + 3, (rows, n),
                             generator=g, dtype=torch.int32)
        week = torch.randint(-2, num_weeks + 2, (rows, n), generator=g,
                             dtype=torch.int32)
        mark = torch.randint(-1, 3, (rows, n), generator=g, dtype=torch.int32)
        valid = torch.rand((rows, n), generator=g) < 0.8
        kw = dict(num_sites=num_sites, num_weeks=num_weeks,
                  site_offset=offset)
        for name, st in (("edges", site), ("one site", torch.full_like(
                site, offset + num_sites - 1))):
            cols = [c.to(device) for c in (st, week, mark, valid)]
            exact(f"segment_hist {name} rows={rows} n={n} S={num_sites} "
                  f"W={num_weeks} offset={offset}",
                  sh.segment_hist(*cols, **kw),
                  sh.segment_hist_plain(*cols, **kw))
    return 2 * len(cases)


HOT_CASES = ("random", "one cell", "one site", "many hot sites",
             "sample misses", "empty rows")


def hist_case(name: str, p: int, n: int, num_sites: int, num_weeks: int,
              g, owned: bool = False):
    """K4's columns for one case of the hot-site design, on the CPU:
    ``random`` has invalid rows, sites and weeks out of range and marks in
    {-1, 0, 1, 2}; ``one cell`` and ``one site`` put every record on one;
    ``many hot sites`` spreads valid records evenly over 100 sites (50
    past 64 weeks), all of them hot at n = 2^22 and more than a tile holds
    (with ``owned``, row r's sites are r modulo P, as K3's owned words);
    ``sample misses`` puts every sampled
    record on one site that no other record has, so the hot list misses
    almost every record; ``empty rows`` has every other row invalid."""
    from repro_torch.kernels.segment_hist import ops as sh

    site = torch.randint(-3, num_sites + 3, (p, n), generator=g,
                         dtype=torch.int32)
    week = torch.randint(-2, num_weeks + 2, (p, n), generator=g,
                         dtype=torch.int32)
    mark = torch.randint(-1, 3, (p, n), generator=g, dtype=torch.int32)
    valid = torch.rand((p, n), generator=g) < 0.9
    if name == "one cell":
        site.fill_(num_sites // 2)
        week.fill_(num_weeks - 1)
        valid.fill_(True)
    elif name == "one site":
        site.fill_(num_sites // 2)
    elif name == "many hot sites":
        site = torch.randint(0, 100 if num_weeks <= 64 else 50, (p, n),
                             generator=g, dtype=torch.int32)
        week = torch.randint(0, num_weeks, (p, n), generator=g,
                             dtype=torch.int32)
        valid.fill_(True)
        if owned:
            site = site * p + torch.arange(p, dtype=torch.int32)[:, None]
    elif name == "sample misses":
        site = torch.randint(0, num_sites - 1, (p, n), generator=g,
                             dtype=torch.int32)
        sample = min(n, sh.SAMPLE)
        site[:, torch.arange(sample) * n // sample] = num_sites - 1
    elif name == "empty rows":
        valid[1::2] = False
    return site, week, mark, valid


def case_words(cols, p: int, s_local: int):
    """K3's words from a case's columns: sites folded into [0, P * S_local
    + 3P) (owned, foreign and out-of-block words), weeks into [0, 64)."""
    site, week, mark, valid = cols
    site = site.to(torch.int64) % (p * s_local + 3 * p)
    week = week.to(torch.int64) % 64
    words = ((site << 8) | (week << 2) | ((mark > 0).to(torch.int64) << 1)
             | valid.to(torch.int64))
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def hot_site_cases(device) -> dict:
    """K3 and K4 bit-equal to their plain versions on every case of
    ``hist_case`` at P in {1, 4, 8}, n = 2^20 (W = 52; for K4 also W = 130,
    whose tile holds 39 sites), and with a hot list that names only sites
    no record has; each hot list equal to its plain version. Returns the
    number of cases of each."""
    from repro_torch.kernels.segment_hist import ops as sh

    g = torch.Generator(device="cpu").manual_seed(16)
    count = {"K3": 0, "K4": 0, "lists": 0}
    num_sites = 12_500
    for p in (1, 4, 8):
        for name in HOT_CASES:
            n = 1 << (22 if name == "many hot sites" else 20)
            for weeks in (52, 130):
                cols = [c.to(device) for c in hist_case(name, p, n, num_sites,
                                                        weeks, g)]
                kw = dict(num_sites=num_sites, num_weeks=weeks)
                what = f"{name} P={p} W={weeks}"
                exact(f"K4 {what}", sh.segment_hist(*cols, **kw),
                      sh.segment_hist_plain(*cols, **kw))
                geo = sh.launch_geometry(cols[0], n, weeks)
                hot = sh.segment_hist_hot_sites(cols[0], cols[1], cols[3],
                                                **kw)
                exact(f"K4 hot list {what}", hot, sh.hot_sites_plain(
                    sh.record_sites(cols[0], cols[1], cols[3], **kw),
                    geo.sample, geo.threshold))
                count["K4"] += 1
                count["lists"] += 1
                if name == "many hot sites":
                    check(int(hot[0, 0]) > geo.hot_capacity
                          or int(hot[0, 0]) == sh.HOT_SITES,
                          f"K4 {what}: {int(hot[0, 0])} hot sites listed, "
                          f"the tile holds {geo.hot_capacity}")
            absent = torch.full((p, sh.HOT_LIST), -1, dtype=torch.int32)
            absent[:, 0] = sh.HOT_SITES
            absent[:, 1:] = num_sites + torch.arange(sh.HOT_SITES)
            words = case_words(hist_case(name, p, n, num_sites, 52, g,
                                         owned=True), p, num_sites).to(device)
            kw = dict(num_sites_local=num_sites, num_partitions=p,
                      num_weeks=52)
            want = sh.segment_hist_packed_words_plain(words, **kw)
            exact(f"K3 {name} P={p}",
                  sh.segment_hist_packed_words(words, **kw), want)
            exact(f"K3 {name} P={p}, a hot list of absent sites",
                  sh.segment_hist_packed_words_tiled(
                      words, absent.to(device), **kw), want)
            geo = sh.launch_geometry(words, n, 52)
            hot = sh.segment_hist_packed_hot_sites(words, **kw)
            exact(f"K3 hot list {name} P={p}", hot,
                  sh.hot_sites_plain(sh.word_sites(words, **kw), geo.sample,
                                     geo.threshold))
            if name == "many hot sites":
                check(int(hot[:, 0].min()) == sh.HOT_SITES,
                      f"K3 {name} P={p}: hot lists {hot[:, 0].tolist()}")
            cols = [c.to(device) for c in hist_case(name, p, n, num_sites,
                                                    52, g)]
            kw = dict(num_sites=num_sites, num_weeks=52)
            exact(f"K4 {name} P={p}, a hot list of absent sites",
                  sh.segment_hist_tiled(*cols, absent.to(device), **kw),
                  sh.segment_hist_plain(*cols, **kw))
            count["K3"] += 2
            count["K4"] += 1
            count["lists"] += 1
    return count


# ------------------------------------------------------------- phase 3
def main_path(device, nodes: int, rps: int, runs: int = 3) -> dict:
    """Drive the main path through ``repro_torch.core.run`` and check it.
    Returns what later phases and the summary need."""
    from repro_torch.common import nodes as nodes_lib
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import run
    from repro_torch.core import spm
    from repro_torch.core.backends.mapreduce import (
        exchange_and_reduce,
        order_words,
        shuffle_round_bound,
        static_capacity,
    )
    from repro_torch.core.plan import resolve_histogram_fns
    from repro_torch.core.runner import _finalize
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cfg = MalGenConfig()
    total = nodes * rps
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    seed = make_seed(0, cfg, total, device=device)
    sync(device)

    def drive():
        return run(seed, engine="generated", nodes=nodes, cfg=cfg,
                   records_per_shard=rps, statistic="B", plan=plan,
                   device=device, return_shuffle_stats=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    k9 = k9_module()
    k9.ship_buckets.launches = 0
    result, stats = drive()
    sync(device)
    launches = launch_counts()
    k9_launches = k9.ship_buckets.launches
    check_k9("main path", k9_launches, launches, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log("main", f"{total:,} records on {nodes} nodes, {cfg.num_sites:,} "
                f"sites, {cfg.num_entities:,} entities; launches {launches}")
    log("main", f"peak device memory {peak / 2**30:.3f} GiB")

    capacity = static_capacity(rps, nodes, CAPACITY_FACTOR)
    log("main", f"shuffle rounds={stats.rounds} capacity={stats.capacity} "
                f"sent={int(stats.sent)} residual={int(stats.residual)} "
                f"overflow={int(stats.overflow)} "
                f"bytes_exchanged={int(stats.bytes_exchanged)}")
    check(int(stats.overflow) == 0, "shuffle left records undelivered")
    check(int(stats.sent) == total, f"sent {int(stats.sent)} != {total}")
    check(stats.capacity == capacity, "capacity differs from the formula")
    check(int(stats.bytes_exchanged) == stats.rounds * nodes * capacity * 4
          * nodes, "bytes_exchanged != rounds * P * C * 4 summed over nodes")
    check(1 <= stats.rounds <= 3, f"{stats.rounds} rounds (expected <= 3)")
    check(stats.rounds <= shuffle_round_bound(rps, capacity),
          "rounds exceed the static bound")
    for name in MAIN_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the main path")
    check(launches["segment_hist"] == 0, "K4 ran on the counting path")
    # one K6 launch a node's unmarked draws plus the marked stream's, one
    # K7 launch for the finalize
    check(launches["powerlaw_sample"] == nodes + 1,
          f"{launches['powerlaw_sample']} K6 launches, expected {nodes + 1}")
    check(launches["windowed_ratio"] == 1,
          f"{launches['windowed_ratio']} K7 launches, expected 1")

    # MapReduce must equal the plain site-week histogram of the same log
    log_t = generate_shards_device(seed, cfg, nodes, rps, device=device)
    keys = (log_t.site_id.reshape(-1).to(torch.int64) * WEEKS_PER_YEAR
            + log_t.week().reshape(-1))
    size = cfg.num_sites * WEEKS_PER_YEAR
    hist = torch.stack(
        [torch.bincount(keys, minlength=size),
         torch.bincount(keys[log_t.mark.reshape(-1) > 0], minlength=size)],
        -1).to(torch.int32).reshape(cfg.num_sites, WEEKS_PER_YEAR, 2)
    want = spm.malstone_b(hist)
    check(torch.equal(result.total, want.total)
          and torch.equal(result.marked, want.marked),
          "histogram differs from a direct bincount over the log")
    check(torch.equal(result.rho.view(torch.int32),
                      want.rho.view(torch.int32)), "rho bits differ")
    check(bool(torch.isfinite(result.rho).all())
          and result.rho.shape == (cfg.num_sites, WEEKS_PER_YEAR),
          "rho not finite or of the wrong shape")
    log("main", "histogram equals a direct bincount over the generated log;"
                f" rho {tuple(result.rho.shape)} finite, mean "
                f"{float(result.rho.double().mean()):.6f}")
    del log_t, keys, hist, want

    samples = []
    for _ in range(runs):
        samples.append(time_ms(drive, device, iters=1, warmup=0))
    med = statistics.median(samples)
    log("main", f"run ms {samples}; median {med:.3f} ms = "
                f"{total / (med / 1e3):.1f} records/s")

    # stages, each timed on its own (the sum runs the path once)
    _, word_fn = resolve_histogram_fns(plan)
    s_pad = -(-cfg.num_sites // nodes) * nodes
    stage = {}
    box = {}
    stage["generate"] = time_ms(lambda: box.__setitem__(
        "log", generate_shards_device(seed, cfg, nodes, rps, device=device)),
        device, iters=1, warmup=0)
    stage["generate.sample_sites"] = sample_sites_ms(seed, cfg, nodes, rps,
                                                     device)
    stage["order"] = time_ms(lambda: box.__setitem__(
        "ordered", order_words(box["log"], WEEKS_PER_YEAR, "counting")),
        device, iters=1, warmup=0)
    stage["exchange+reduce"] = time_ms(lambda: box.__setitem__(
        "owned", exchange_and_reduce(
            *box["ordered"], num_sites=s_pad, num_weeks=WEEKS_PER_YEAR,
            capacity=capacity, max_rounds=shuffle_round_bound(rps, capacity),
            word_histogram_fn=word_fn)[0]), device, iters=1, warmup=0)
    stage["finalize"] = time_ms(lambda: _finalize(
        nodes_lib.all_gather_unstride(box["owned"])[:cfg.num_sites], "B"),
        device, iters=1, warmup=0)
    log("main", "stage ms " + json.dumps(stage))
    main_log = box["log"]
    ordered = box["ordered"]
    del box

    prof = {}
    if device.type == "cuda":
        prof = profile(drive, device)
    return dict(seed=seed, cfg=cfg, launches=launches,
                k9_launches=k9_launches, log=main_log,
                ordered=ordered, capacity=capacity, run_ms=samples,
                records_per_s=total / (med / 1e3), stage_ms=stage,
                peak_bytes=peak, rounds=stats.rounds, profile=prof)


def sample_sites_ms(seed, cfg, nodes: int, rps: int, device) -> float:
    """The part of a generation that is ``sample_sites`` (K6 on the card):
    the marked stream's draws on the marked CDF and each node's unmarked
    draws on the unmarked CDF, timed alone on draws of the same sizes."""
    from repro_torch.malgen import sample_sites

    g = torch.Generator(device=device).manual_seed(5)
    n_unmarked = rps - len(range(0, seed.num_marked_events, nodes))
    marked = torch.rand(seed.num_marked_events, generator=g, device=device)
    unmarked = torch.rand(n_unmarked, generator=g, device=device)

    def calls():
        sample_sites(seed.marked_cdf, marked)
        for _ in range(nodes):
            sample_sites(seed.unmarked_cdf, unmarked)

    return time_ms(calls, device, iters=3, warmup=1)


def profile(drive, device, top: int = 12) -> dict:
    """Device busy time and the top kernels of one main-path run: the sum
    of the device-side (kernel and memcpy/memset) events, against the wall
    time of the run inside the profiler (its start-up excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log("profile", f"wall {wall_ms:.3f} ms (profiled), device busy "
                   f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}")
    for ms, count, key in rows[:top]:
        log("profile", f"{ms:10.4f} ms x{count:<3d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                top=[(key[:90], ms, count) for ms, count, key in rows[:top]])


# ------------------------------------------------------------- phase 4
def kernel_row(name, launches, err, ms, plain_ms, library_ms, bytes_moved,
               ops: int = 0, **extra) -> dict:
    """One kernel's entry of the kernels line; the bound is the larger of
    its bytes (inputs read once, outputs written once) at the card's memory
    rate and its ``ops`` at the 32-bit rate."""
    source, replaces = KERNEL_INFO[name]
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS32_PER_S * 1e3
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": library_ms, "match": err == 0.0, **extra}
    log("kernel", json.dumps(row))
    return row


def kernels_at_main_shapes(device, mp: dict) -> list:
    from repro_torch.common.types import (
        WEEKS_PER_YEAR,
        pack_site_week_mark,
        unpack_site_week_mark,
    )
    from repro_torch.core.backends.mapreduce import order_words, ship_round
    from repro_torch.kernels.count_scatter import ops as cs
    from repro_torch.kernels.segment_hist import ops as sh

    lg = mp["log"]
    p, n = lg.site_id.shape
    words_sorted, starts = mp["ordered"]
    dest = (lg.site_id % p).to(torch.int32).contiguous()
    words = pack_site_week_mark(lg.site_id, lg.week(), lg.mark,
                                lg.valid_mask()).contiguous()
    num_dests = p + 1
    t = cs.num_tiles(n)
    out = []

    # K1: per-tile destination histogram of the main path's destinations
    counts = cs.count_tiles(dest, num_dests)
    err = exact("K1 main shapes", counts, cs.count_tiles_plain(dest,
                                                               num_dests))
    tile = torch.arange(n, device=device) // cs.TILE
    node = torch.arange(p, device=device).unsqueeze(1)
    keys = ((node * t + tile) * num_dests + dest).reshape(-1)
    fd = first_designs()
    out.append(kernel_row(
        "count_scatter.count", mp["launches"]["count_scatter.count"], err,
        time_ms(lambda: cs.count_tiles(dest, num_dests), device, 10, 2),
        time_ms(lambda: cs.count_tiles_plain(dest, num_dests), device, 2,
                1),
        time_ms(lambda: torch.bincount(keys, minlength=p * t * num_dests),
                device, 10, 2),
        4 * p * n + 4 * p * t * num_dests, tile=cs.TILE,
        graph_ms=graph_ms(lambda: cs.count_tiles(dest, num_dests), device),
        first_design_tile=fd.TILE,
        first_design_ms=time_ms(lambda: fd.count_tiles(dest, num_dests),
                                device, 10, 2),
        tile_bases_ms=time_ms(lambda: cs.tile_bases(counts), device, 10,
                              2)))
    del tile, keys

    # K2: the stable scatter, given the bases K1's counts give
    base, _ = cs.tile_bases(counts)
    got = cs.scatter_tiles(words, dest, base)
    err = exact("K2 main shapes", got, cs.scatter_tiles_plain(words, dest,
                                                              base))
    exact("K2 vs the ordered words of the main path", got, words_sorted)

    def library_sort():
        order = torch.sort(dest, dim=1, stable=True).indices
        return words.gather(1, order)

    # the first design (tile of 1,024 records) on the same records
    fbase = fd.tile_bases(fd.count_tiles(dest, num_dests))
    exact("K2 first design", fd.scatter_tiles(words, dest, fbase), got)
    out.append(kernel_row(
        "count_scatter.scatter", mp["launches"]["count_scatter.scatter"],
        err,
        time_ms(lambda: cs.scatter_tiles(words, dest, base), device, 10, 2),
        time_ms(lambda: cs.scatter_tiles_plain(words, dest, base), device,
                2, 1),
        time_ms(library_sort, device, 5, 1),
        4 * p * n * 3 + 4 * p * t * num_dests,
        graph_ms=graph_ms(lambda: cs.scatter_tiles(words, dest, base),
                          device),
        cold_ms=cold_ms(lambda: cs.scatter_tiles(words, dest, base),
                        device),
        first_design_ms=time_ms(lambda: fd.scatter_tiles(words, dest, fbase),
                                device, 10, 2)))
    del got, base, counts, fbase

    # K3: round 0's shipped words, reduced per receiving node
    shipped, _ = ship_round(words_sorted, starts, 0, mp["capacity"])
    s_local = -(-mp["cfg"].num_sites // p)
    kw = dict(num_sites_local=s_local, num_partitions=p,
              num_weeks=WEEKS_PER_YEAR)
    err = exact("K3 main shapes", sh.segment_hist_packed_words(shipped, **kw),
                sh.segment_hist_packed_words_plain(shipped, **kw))
    site, week, mark, valid = unpack_site_week_mark(shipped)
    own = valid & (site % p == node)
    flat = ((node * s_local + site // p) * WEEKS_PER_YEAR + week).to(
        torch.int64) * 2
    hkeys = torch.cat([flat[own], flat[own & (mark > 0)] + 1])
    del site, week, mark, valid, own, flat
    # the same records with sites drawn uniformly, ordered and shipped as
    # the main path does: what the power law's hot sites cost K3
    uniform_log = lg._replace(site_id=torch.randint(
        0, mp["cfg"].num_sites, lg.site_id.shape, device=device,
        dtype=torch.int32))
    uniform, _ = ship_round(*order_words(uniform_log, WEEKS_PER_YEAR,
                                         "counting"), 0, mp["capacity"])
    del uniform_log
    exact("K3 uniform sites", sh.segment_hist_packed_words(uniform, **kw),
          sh.segment_hist_packed_words_plain(uniform, **kw))
    out.append(kernel_row(
        "segment_hist.packed", mp["launches"]["segment_hist.packed"], err,
        time_ms(lambda: sh.segment_hist_packed_words(shipped, **kw),
                device, 10, 2),
        time_ms(lambda: sh.segment_hist_packed_words_plain(shipped, **kw),
                device, 2, 1),
        time_ms(lambda: torch.bincount(
            hkeys, minlength=p * s_local * WEEKS_PER_YEAR * 2),
            device, 10, 2),
        4 * shipped.numel() + 4 * p * s_local * WEEKS_PER_YEAR * 2,
        hot_sites=sh.segment_hist_packed_hot_sites(shipped, **kw)[:, 0]
        .tolist(),
        uniform_sites_ms=time_ms(
            lambda: sh.segment_hist_packed_words(uniform, **kw), device, 10,
            2),
        uniform_sites_plain_ms=time_ms(
            lambda: sh.segment_hist_packed_words_plain(uniform, **kw),
            device, 2, 1)))
    return out


# ------------------------------------------------------------- phase 5
def other_backends(device, nodes: int, rps: int, runs: int = 3):
    """Drive streams, sphere and mapreduce_combiner over the main path's
    generated records, and mapreduce with the columns exchange,
    partitioned, over the same shards as a log; check each against the
    counting path and K4's and K8's launches; time stages and runs.
    Returns K4's and K8's kernels-line entries."""
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import run
    from repro_torch.core.backends.mapreduce import static_capacity
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.segment_hist import ops as sh
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cuda = device.type == "cuda"
    cfg = MalGenConfig()
    total, num_sites, weeks = nodes * rps, cfg.num_sites, WEEKS_PER_YEAR
    s_pad = -(-num_sites // nodes) * nodes
    capacity = static_capacity(rps, nodes, CAPACITY_FACTOR)
    seed = make_seed(0, cfg, total, device=device)     # the main path's
    gen = dict(engine="generated", nodes=nodes, cfg=cfg,
               records_per_shard=rps, device=device,
               return_shuffle_stats=True)
    want = {stat: run(seed, backend="mapreduce", statistic=stat,
                      plan=ExchangePlan(impl="counting",
                                        capacity_factor=CAPACITY_FACTOR),
                      **gen)
            for stat in STATISTICS}
    flat = generate_shards_device(seed, cfg, nodes, rps, device=device).map(
        lambda c: c.reshape(-1))
    columns = ExchangePlan(impl="columns", capacity_factor=CAPACITY_FACTOR)

    def drive(path, stat):
        if path == "mapreduce+columns":
            return run(flat, num_sites, nodes=nodes, backend="mapreduce",
                       plan=columns, partitioned=True, statistic=stat,
                       device=device, return_shuffle_stats=True)
        return run(seed, backend=path, statistic=stat, **gen)

    cb, k9 = k8_module(), k9_module()
    k4_launches, k8_launches = {}, {}
    for path in ("streams", "sphere", "mapreduce_combiner",
                 "mapreduce+columns"):
        blocks = path == "mapreduce+columns"
        for stat in STATISTICS:
            sync(device)
            base = peak = 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
            reset_launch_counts()
            cb.combine_blocks.launches = 0
            k9.ship_buckets.launches = 0
            result, stats = drive(path, stat)
            sync(device)
            launches = launch_counts()
            k8 = cb.combine_blocks.launches
            # no backend here ships words: the columns exchange its columns
            check(k9.ship_buckets.launches == 0,
                  f"{path} {stat}: {k9.ship_buckets.launches} K9 launches")
            if cuda:
                peak = torch.cuda.max_memory_allocated(device)
            ref, ref_stats = want[stat]
            for f in ("total", "marked", "rho"):
                got = getattr(result, f)
                if blocks:     # [P, s_pad/P, ...] blocks in node order
                    got = got.reshape(-1, *got.shape[2:])[:num_sites]
                check(torch.equal(got.view(torch.int32),
                                  getattr(ref, f).view(torch.int32)),
                      f"{path} {stat}: {f} differs from the counting path")
            rounds = 1
            if blocks:
                rounds = stats.rounds
                for f in ("sent", "overflow", "capacity", "rounds",
                          "residual"):
                    check(int(getattr(stats, f)) == int(getattr(ref_stats,
                                                                 f)),
                          f"columns ShuffleStats.{f} differs from counting")
                per_node = rounds * nodes * capacity * 17
                check(int(stats.bytes_exchanged) == (
                    per_node * nodes + 2**31) % 2**32 - 2**31,
                    "columns bytes_exchanged != rounds * P * C * 17 summed "
                    "over the nodes (int32, wrapping as the psum does)")
            else:
                check(stats is None, f"{path} returned ShuffleStats")
            # K6 samples the sites of a generation (a node's unmarked
            # draws each and the marked stream); the columns path is
            # handed its log. K7 finalizes statistic B.
            expect = {"segment_hist": rounds, "segment_hist.packed": 0,
                      "count_scatter.count": rounds if blocks else 0,
                      "count_scatter.scatter": rounds if blocks else 0,
                      "windowed_ratio.masked": 0,
                      "powerlaw_sample": 0 if blocks else nodes + 1,
                      "windowed_ratio": int(stat == "B")}
            check(launches == expect, f"{path} {stat}: launches "
                                      f"{launches}, expected {expect}")
            # the combiner's one fold exchanges its blocks through K8
            check(k8 == int(cuda and path == "mapreduce_combiner"),
                  f"{path} {stat}: {k8} K8 launches")
            k8_launches[path] = k8_launches.get(path, 0) + k8
        k4_launches[path] = launches["segment_hist"]
        samples = [time_ms(lambda: drive(path, "B"), device, iters=1,
                           warmup=0) for _ in range(runs)]
        med = statistics.median(samples)
        stage = backend_stages(path, seed, cfg, flat, nodes, rps, s_pad,
                               capacity, device)
        row = dict(run_ms=samples, median_ms=med,
                   records_per_s=total / (med / 1e3), stage_ms=stage,
                   peak_bytes=peak, allocated_before_bytes=base,
                   k4_launches=launches["segment_hist"], rounds=rounds)
        log("path", f"{path}: " + json.dumps(row))
        if cuda:
            profile(lambda: drive(path, "B"), device, top=6)
    log("path", "streams, sphere, mapreduce_combiner and mapreduce+columns "
                "equal the counting path (histograms, A/B/B-fixed rho bits, "
                "columns shuffle stats)")

    # K4 at these shapes: the local combine of the generated records
    lg = flat.map(lambda c: c.reshape(nodes, -1))
    cols = (lg.site_id, lg.week(), lg.mark, lg.valid_mask())
    kw = dict(num_sites=s_pad, num_weeks=weeks)
    err = exact("K4 main shapes", sh.segment_hist(*cols, **kw),
                sh.segment_hist_plain(*cols, **kw))
    node = torch.arange(nodes, device=device).unsqueeze(1)
    flat_key = ((node * s_pad + cols[0]) * weeks + cols[1]).to(
        torch.int64) * 2
    keys = torch.cat([flat_key.reshape(-1),
                      flat_key[cols[2] > 0].reshape(-1) + 1])
    del flat_key
    # the same columns with sites drawn uniformly: what the power law's
    # hot sites cost K4 and its plain version
    uniform = (torch.randint(0, num_sites, cols[0].shape, device=device,
                             dtype=torch.int32),) + cols[1:]
    exact("K4 uniform sites", sh.segment_hist(*uniform, **kw),
          sh.segment_hist_plain(*uniform, **kw))
    # a service ingest step's chunk: the first 2^20 records of each node
    chunk = [c[:, :SERVE_CHUNK].contiguous() for c in cols]
    exact("K4 at 2^20 records a node", sh.segment_hist(*chunk, **kw),
          sh.segment_hist_plain(*chunk, **kw))
    k4 = kernel_row(
        "segment_hist", sum(k4_launches.values()), err,
        time_ms(lambda: sh.segment_hist(*cols, **kw), device, 10, 2),
        time_ms(lambda: sh.segment_hist_plain(*cols, **kw), device, 2, 1),
        time_ms(lambda: torch.bincount(
            keys, minlength=nodes * s_pad * weeks * 2), device, 10, 2),
        13 * total + 4 * nodes * s_pad * weeks * 2,
        launches_by_path=k4_launches,
        hot_sites=sh.segment_hist_hot_sites(cols[0], cols[1], cols[3], **kw)
        [:, 0].tolist(),
        uniform_sites_ms=time_ms(lambda: sh.segment_hist(*uniform, **kw),
                                 device, 10, 2),
        uniform_sites_plain_ms=time_ms(
            lambda: sh.segment_hist_plain(*uniform, **kw), device, 2, 1),
        chunk_2_20_ms=time_ms(lambda: sh.segment_hist(*chunk, **kw), device,
                              10, 2))
    # K8 on these records' local histograms (counts), into a zero carry
    local = sh.segment_hist(*cols, **kw)
    owned = torch.zeros(nodes, s_pad // nodes, weeks, 2, dtype=torch.int32,
                        device=device)
    exact("K8 on the local histograms of these records",
          cb.combine_blocks(local, owned.clone()),
          cb.combine_blocks_plain(local, owned))
    del local, owned, keys, uniform, chunk
    k8 = combine_blocks_row(device, k8_launches["mapreduce_combiner"])
    k8["launches_by_path"] = k8_launches
    return k4, k8


def k8_library(local, carry):
    """The combine in two torch ops, a yardstick the port never calls: one
    int32 sum over the senders of a view of ``local`` (the owners' blocks
    in site order), added into ``carry`` through a permuted view. Wraps
    modulo 2^32 as K8 does."""
    p, s, w, _ = local.shape
    carry += local.view(p, s // p, p, w, 2).sum(
        0, dtype=torch.int32).permute(1, 0, 2, 3)
    return carry


def extra_bytes(fn, device) -> int:
    """Bytes one call of ``fn`` allocates on the card beyond what was
    allocated before it (0 on the CPU)."""
    if device.type != "cuda":
        fn()
        return 0
    sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    sync(device)
    return torch.cuda.max_memory_allocated(device) - base


def combine_blocks_row(device, launches: int, shape=K8_CELL) -> dict:
    """K8 at the benchmark's combiner step (``shape`` = P, S/P, W) over
    every int32 value, so its sums wrap: bit-equal to its plain version
    (the torch path it replaced: the transposed copy, the int64 sum and
    its wrap, the add) and to the two-op yardstick; timed with the
    wrapper (``ms``), as a CUDA graph (``graph_ms``) and beside both, with
    the bytes each allocates; K8's entry of the kernels line."""
    cb = k8_module()
    p, s_local, w = shape
    g = torch.Generator(device=device).manual_seed(8)

    def ints(*size):
        return torch.randint(-2**31, 2**31 - 1, size, generator=g,
                             dtype=torch.int32, device=device)

    local, carry = ints(p, p * s_local, w, 2), ints(p, s_local, w, 2)
    want = cb.combine_blocks_plain(local, carry.clone())
    before = cb.combine_blocks.launches
    err = exact("K8 at the combiner cell's step",
                cb.combine_blocks(local, carry.clone()), want)
    check(cb.combine_blocks.launches - before == int(device.type == "cuda"),
          "K8: a call did not launch once")
    exact("K8's two-op torch yardstick", k8_library(local, carry.clone()),
          want)
    del want

    def kernel():
        cb.combine_blocks(local, carry)

    def plain():
        cb.combine_blocks_plain(local, carry)

    def library():
        k8_library(local, carry)

    cuda = device.type == "cuda"
    return kernel_row(
        "combine_blocks", launches, err,
        time_ms(kernel, device, 20, 2), time_ms(plain, device, 5, 1),
        time_ms(library, device, 20, 2),
        8 * p * s_local * w * (p + 2), shape=[p, p * s_local, w, 2],
        graph_ms=graph_ms(kernel, device) if cuda else None,
        library_graph_ms=graph_ms(library, device) if cuda else None,
        extra_bytes=extra_bytes(kernel, device),
        plain_extra_bytes=extra_bytes(plain, device),
        library_extra_bytes=extra_bytes(library, device))


def ship_buckets_row(device, mp: dict) -> dict:
    """K9 on the main path's ordered words (``[8, 2^23]``): at the
    benchmark's mapreduce step (capacity factor 4.0, C = 2^22) rounds 0
    and 1 bit-equal to its plain version (the torch path it replaced: the
    slot index, the mask, the int64 gather, the ``where``, the transposed
    copy), and every round at the main path's capacity; timed with the
    wrapper (``ms``) and as a CUDA graph beside the torch path, against
    its bound 4 P P C + 4 (live words) bytes at 3.35 TB/s, with the bytes
    each allocates beyond its ``[P, P C]`` output; K9's entry of the
    kernels line."""
    from repro_torch.core.backends.mapreduce import static_capacity

    sb = k9_module()
    words, starts = mp["ordered"]
    p, n = words.shape
    cuda = device.type == "cuda"
    counts = starts[:, 1:] - starts[:, :-1]
    for capacity in (mp["capacity"], static_capacity(n, p,
                                                     K9_CAPACITY_FACTOR)):
        rounds = -(-int(counts.max()) // capacity)
        for r in range(rounds + 1):
            before = sb.ship_buckets.launches
            got = sb.ship_buckets(words, starts, r, capacity)
            check(sb.ship_buckets.launches - before == int(cuda),
                  "K9: a call did not launch once")
            err = exact(f"K9 round {r} of {rounds} at C = {capacity}", got,
                        sb.ship_buckets_plain(words, starts, r, capacity))
        check(int(got.count_nonzero()) == 0,
              f"K9 at C = {capacity}: round {rounds} shipped a word")
    del got
    live = int(counts.clamp(max=capacity).sum())

    def kernel():
        return sb.ship_buckets(words, starts, 0, capacity)

    def plain():
        return sb.ship_buckets_plain(words, starts, 0, capacity)

    shipped = 4 * p * p * capacity
    return kernel_row(
        "ship_buckets", mp["k9_launches"], err,
        time_ms(kernel, device, 20, 2), time_ms(plain, device, 5, 1), None,
        shipped + 4 * live, shape=[p, n], capacity=capacity,
        live_words=live,
        graph_ms=graph_ms(kernel, device) if cuda else None,
        plain_graph_ms=graph_ms(plain, device, iters=3) if cuda else None,
        extra_bytes=extra_bytes(kernel, device) - shipped * cuda,
        plain_extra_bytes=extra_bytes(plain, device) - shipped * cuda)


def backend_stages(path, seed, cfg, flat, nodes, rps, s_pad, capacity,
                   device) -> dict:
    """Each stage of one backend's run timed on its own (one pass each):
    generate, the local combine (K4) or the columns exchange, the
    collective, the finalize."""
    from repro_torch.common import nodes as nodes_lib
    from repro_torch.common.types import WEEKS_PER_YEAR as weeks
    from repro_torch.core.backends import (
        mapreduce_combiner_histogram,
        shuffle_stats,
        sphere_histogram,
        streams_histogram,
    )
    from repro_torch.core.backends.mapreduce import (
        columns_shuffle_histogram,
        shuffle_round_bound,
    )
    from repro_torch.core.runner import _finalize
    from repro_torch.kernels.segment_hist import segment_hist_eventlog
    from repro_torch.malgen import generate_shards_device

    box, stage = {}, {}

    def timed(name, key, fn):
        stage[name] = time_ms(lambda: box.__setitem__(key, fn()), device,
                              iters=1, warmup=0)

    if path == "mapreduce+columns":
        lg = flat.map(lambda c: c.reshape(nodes, -1))
        timed("exchange+reduce", "out", lambda: columns_shuffle_histogram(
            lg, num_sites=s_pad, num_weeks=weeks, capacity=capacity,
            max_rounds=shuffle_round_bound(rps, capacity),
            histogram_fn=segment_hist_eventlog))
        owned, stats = box["out"]
        timed("collective", "stats", lambda: shuffle_stats(stats))
        timed("finalize", "result", lambda: _finalize(
            nodes_lib.all_gather_unstride(owned).reshape(
                nodes, s_pad // nodes, weeks, 2), "B"))
        return stage
    timed("generate", "log", lambda: generate_shards_device(
        seed, cfg, nodes, rps, device=device))
    timed("local combine", "local", lambda: segment_hist_eventlog(
        box["log"], s_pad, weeks))
    local = box["local"]
    backend_fn, gather = {
        "streams": (streams_histogram, lambda h: h),
        "sphere": (sphere_histogram, nodes_lib.all_gather),
        "mapreduce_combiner": (mapreduce_combiner_histogram,
                               nodes_lib.all_gather_unstride)}[path]
    timed("collective", "out", lambda: backend_fn(
        box["log"], s_pad, weeks, histogram_fn=lambda *_: local))
    timed("finalize", "result", lambda: _finalize(
        gather(box["out"])[:cfg.num_sites], "B"))
    return stage


# ------------------------------------------------------------- phase 6
def card_equals_cpu(device, nodes: int, rps: int) -> None:
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run
    from repro_torch.malgen import MalGenConfig, generate_shards_device
    from repro_torch.malgen import make_seed

    cfg = MalGenConfig()
    seed = make_seed(1, cfg, nodes * rps, device=device)
    lg = generate_shards_device(seed, cfg, nodes, rps, device=device).map(
        lambda c: c.reshape(-1))
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    got, gs = malstone_run(lg, cfg.num_sites, nodes=nodes, plan=plan,
                           device=device, return_shuffle_stats=True)
    want, ws = malstone_run(lg.to("cpu"), cfg.num_sites, nodes=nodes,
                            plan=plan, device="cpu",
                            return_shuffle_stats=True)
    for f in ("total", "marked"):
        check(torch.equal(getattr(got, f).cpu(), getattr(want, f)),
              f"card {f} != CPU {f}")
    check(torch.equal(got.rho.cpu().view(torch.int32),
                      want.rho.view(torch.int32)), "card rho bits != CPU")
    for f in gs._fields:
        check(int(getattr(gs, f)) == int(getattr(ws, f)),
              f"card ShuffleStats.{f} != CPU")
    log("equal", f"{nodes * rps:,} records: card == CPU (histogram, rho "
                 f"bits, all ShuffleStats; rounds={gs.rounds})")


# ------------------------------------------------------------- phase 7
def k5_case(seed: int, n: int, w: int, s: int, device, *, high: int = 1000,
            density: float = 0.5):
    """A histogram with empty sites and random masks (int32 counts in
    ``[0, high)``)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    hist = torch.randint(0, high, (s, w, 2), generator=g, dtype=torch.int32)
    hist[torch.rand(s, generator=g) < 0.2] = 0
    nm = torch.rand((n, w), generator=g) < density
    dm = torch.rand((n, w), generator=g) < density
    return hist.to(device), nm.to(device), dm.to(device)


def k5_exact(name: str, got, want) -> float:
    """K5 against its plain version: rho by its bits, num, den."""
    return exact(name, (got[0].view(torch.int32), got[1], got[2]),
                 (want[0].view(torch.int32), want[1], want[2]))


K5_MASK_KINDS = ("none", "first", "last", "all", "alternating", "window",
                 "random")


def k5_masks(kind: str, n: int, w: int, g) -> torch.Tensor:
    """N masks of one shape (on the CPU): no week; one run from the first
    week or to the last; every week; alternating weeks (both phases, 26
    runs at W = 52); one run anywhere; or each week at random."""
    weeks = torch.arange(w)[None, :]
    k = torch.randint(0, w + 1, (n, 1), generator=g)
    if kind == "none":
        return torch.zeros(n, w, dtype=torch.bool)
    if kind == "first":
        return weeks < k.clamp(min=1)
    if kind == "last":
        return weeks >= k.clamp(max=w - 1)
    if kind == "all":
        return torch.ones(n, w, dtype=torch.bool)
    if kind == "alternating":
        return (weeks + torch.arange(n)[:, None]) % 2 == 0
    if kind == "window":
        a = torch.randint(0, w, (n, 1), generator=g)
        return (weeks >= a) & (weeks < a + 1 + k % (w - a))
    return torch.rand((n, w), generator=g) < 0.5


def k5_edge_cases(device) -> int:
    """K5 over N in {1, 9, 52, 57}, W in {1, 52, 64, 65} and S in {1, 700,
    1000} (1000 is no multiple of the 64-site tile), every mask shape at N
    in {1, 9, 52, 57, 129} (129: three query blocks) and the same W, S =
    1000, all-zero denominators, and sums above 2^24 and past 2^31 (int32
    wrap). Returns the number of cases."""
    from repro_torch.kernels.windowed_ratio import ops as wr

    count = 0
    for n in (1, 9, 52, 57):
        for w in (1, 52, 64, 65):
            for s in (1, 700, 1000):
                args = k5_case(n * 10_000 + w * 100 + s, n, w, s, device)
                k5_exact(f"K5 N={n} W={w} S={s}",
                         wr.masked_window_ratio(*args),
                         wr.masked_window_ratio_plain(*args))
                count += 1
    g = torch.Generator(device="cpu").manual_seed(5)
    for n in (1, 9, 52, 57, 129):
        for w in (1, 52, 64, 65):
            hist = k5_case(n + w, 1, w, 1000, device)[0]
            for kind in K5_MASK_KINDS:
                nm = k5_masks(kind, n, w, g).to(device)
                dm = k5_masks(kind, n, w, g).to(device)
                k5_exact(f"K5 {kind} N={n} W={w} S=1000",
                         wr.masked_window_ratio(hist, nm, dm),
                         wr.masked_window_ratio_plain(hist, nm, dm))
                count += 1
    hist, nm, _ = k5_case(1, 57, 52, 700, device)
    zero = torch.zeros_like(nm)
    got = wr.masked_window_ratio(hist, nm, zero)
    k5_exact("K5 zero denominators", got,
             wr.masked_window_ratio_plain(hist, nm, zero))
    check(not bool(got[0].any()), "K5: rho != 0 where den == 0")
    for name, high in (("above 2^24", 1 << 20), ("past 2^31", 1 << 27)):
        hist, nm, dm = k5_case(2, 52, 65, 1000, device, high=high,
                               density=0.9)
        got = wr.masked_window_ratio(hist, nm, dm)
        k5_exact(f"K5 sums {name}", got,
                 wr.masked_window_ratio_plain(hist, nm, dm))
        check(int(got[1].max()) > 1 << 24, f"K5 {name}: no sum above 2^24")
        for kind in ("alternating", "last"):
            m = k5_masks(kind, 52, 65, g).to(device)
            k5_exact(f"K5 sums {name}, {kind} masks",
                     wr.masked_window_ratio(hist, m, m),
                     wr.masked_window_ratio_plain(hist, m, m))
            count += 1
    check(int(got[1].min()) < 0, "K5 past 2^31: no sum wrapped")
    count += 3
    log("kernel", f"K5 bit-equal to plain on {count} cases")
    return count


def timed_samples(fn, n: int, device) -> list:
    """Milliseconds of ``n`` calls, each between two synchronizes."""
    out = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def serving(device, nodes: int, chunk: int, steps: int,
            small_steps: int) -> dict:
    """Drive ``MalStoneService`` for every backend and check it; returns
    K5's kernels-line entry and K8's launches (the combiner's ingest
    steps)."""
    from repro_torch.bench.schema import latency_percentiles as percentiles
    from repro_torch.common.types import ExchangePlan, WEEKS_PER_YEAR
    from repro_torch.core import malstone_run, run
    from repro_torch.core import spm
    from repro_torch.core.backends.mapreduce import (
        shuffle_round_bound,
        static_capacity,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve_malstone import build_query_mix
    from repro_torch.malgen import (
        MalGenConfig,
        generate_chunked_log,
        make_seed_streaming,
    )
    from repro_torch.serve import MalStoneService, encode_query_batch

    cuda = device.type == "cuda"
    cfg = MalGenConfig()
    num_sites, weeks = cfg.num_sites, WEEKS_PER_YEAR
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR)
    mixes = {m: build_query_mix(m, num_sites=num_sites, top_k=8)
             for m in ("mixed", "growing")}
    seeds, oneshot = {}, {}
    k5_launches, k5_inputs, k7_launches, k8_launches = 0, None, 0, 0
    k9_launches = 0
    cb, k9 = k8_module(), k9_module()
    round_bound = shuffle_round_bound(
        chunk, static_capacity(chunk, nodes, CAPACITY_FACTOR))
    for backend, n_steps in (("streams", steps), ("mapreduce", steps),
                             ("sphere", small_steps),
                             ("mapreduce_combiner", small_steps)):
        num_chunks = nodes * n_steps
        if n_steps not in seeds:
            seeds[n_steps] = make_seed_streaming(2, cfg, num_chunks, chunk,
                                                 device=device)
            lg = generate_chunked_log(seeds[n_steps], cfg, num_chunks, chunk)
            oneshot[n_steps] = {
                stat: malstone_run(lg, num_sites, nodes=nodes,
                                   backend="mapreduce", statistic=stat,
                                   plan=plan, device=device)
                for stat in STATISTICS}
            del lg
        seed = seeds[n_steps]
        svc = MalStoneService(nodes=nodes, num_sites=num_sites,
                              chunk_records=chunk, backend=backend,
                              seed=seed, cfg=cfg, num_chunks=num_chunks,
                              plan=plan, device=device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device) if cuda else 0
        # the main path of this phase: ingest every step, snapshot, answer
        # both batches; launch counts read per step and per batch
        ingest_ms, per_step = [], []
        for _ in range(n_steps):
            reset_launch_counts()
            cb.combine_blocks.launches = 0
            k9.ship_buckets.launches = 0
            ingest_ms += timed_samples(lambda: svc.ingest_chunks(1), 1,
                                       device)
            per_step.append(launch_counts()
                            | {"combine_blocks": cb.combine_blocks.launches,
                               "ship_buckets": k9.ship_buckets.launches})
        hist, stats = svc.snapshot()
        answers = {}
        for mix, specs in mixes.items():
            reset_launch_counts()
            answers[mix] = svc.query(specs)
            got = launch_counts()
            check(got == dict.fromkeys(got, 0) | {"windowed_ratio.masked": 1},
                  f"{backend} {mix} batch: launches {got}")
            k5_launches += got["windowed_ratio.masked"]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        for i, got in enumerate(per_step):
            # the combiner folds a step's blocks into its carry through K8
            k8 = got.pop("combine_blocks")
            check(k8 == int(cuda and backend == "mapreduce_combiner"),
                  f"{backend} ingest step {i}: {k8} K8 launches")
            k8_launches += k8
            # the record shuffle writes each round's words through K9
            k9_step = got.pop("ship_buckets")
            check_k9(f"{backend} ingest step {i}", k9_step, got, device)
            k9_launches += k9_step
            k3 = got["segment_hist.packed"]
            if backend == "mapreduce":
                want = {"count_scatter.count": 1, "count_scatter.scatter": 1,
                        "segment_hist.packed": k3, "segment_hist": 0}
                check(1 <= k3 <= round_bound,
                      f"mapreduce step {i}: {k3} K3 launches (rounds)")
            else:
                want = {"count_scatter.count": 0, "count_scatter.scatter": 0,
                        "segment_hist.packed": 0, "segment_hist": 1}
            # each node's chunk samples its marked and unmarked draws
            want.update({"windowed_ratio.masked": 0,
                         "powerlaw_sample": 2 * nodes, "windowed_ratio": 0})
            check(got == want, f"{backend} ingest step {i}: launches {got}, "
                               f"expected {want}")

        # the snapshot equals the streaming engine and the one-shot run
        for stat in STATISTICS:
            reset_launch_counts()
            res = svc.result(stat)
            got = launch_counts()
            check(got == dict.fromkeys(got, 0) | {
                "windowed_ratio": int(stat == "B")},
                f"{backend} result {stat}: launches {got}")
            k7_launches += got["windowed_ratio"]
            ref, ref_stats = run(seed, num_sites, nodes=nodes,
                                 engine="streaming", cfg=cfg,
                                 num_chunks=num_chunks, chunk_records=chunk,
                                 backend=backend, statistic=stat, plan=plan,
                                 device=device, return_shuffle_stats=True)
            for want, what in ((ref, "streaming engine"),
                               (oneshot[n_steps][stat], "one-shot run")):
                for f in ("total", "marked", "rho"):
                    check(torch.equal(getattr(res, f).view(torch.int32),
                                      getattr(want, f).view(torch.int32)),
                          f"{backend} {stat}: {f} differs from the {what}")
            if backend == "mapreduce":
                for f in ref_stats._fields:
                    check(int(getattr(stats, f)) == int(getattr(ref_stats, f)),
                          f"{backend}: ShuffleStats.{f} differs from the "
                          f"streaming engine")
                check(int(stats.overflow) == 0 and int(stats.sent)
                      == nodes * n_steps * chunk, "service shuffle lost "
                                                  "records")
            else:
                check(stats is None, f"{backend} returned ShuffleStats")

        # the answers: K5 equals its plain version, B columns, top-k
        from repro_torch.kernels.windowed_ratio import ops as wr

        b_rho = spm.malstone_b(hist).rho.cpu().numpy()
        for mix, specs in mixes.items():
            batch = encode_query_batch(specs, weeks, num_sites)
            nm = torch.from_numpy(batch.num_masks).to(device)
            dm = torch.from_numpy(batch.den_masks).to(device)
            got = [torch.from_numpy(getattr(a, f)).to(device)
                   for f in ("rho", "num", "den") for a in answers[mix]]
            n = len(specs)
            got = [torch.stack(got[i * n:(i + 1) * n]) for i in range(3)]
            k5_exact(f"{backend} {mix}: the answers",
                     got, wr.masked_window_ratio_plain(hist, nm, dm))
            if mix == "growing":
                for i, a in enumerate(answers[mix]):
                    check((a.rho.view("int32")
                           == b_rho[:, i].view("int32")).all(),
                          f"{backend}: growing B answer {i} != malstone_b")
                k5_inputs = (hist, nm, dm)
            else:
                a = answers[mix][3]                # B over the year, top-8
                order = (-a.rho).argsort(kind="stable")[:8]
                check((a.top_sites == order).all(),
                      f"{backend}: top-k {a.top_sites} != stable order "
                      f"{order}")
        row = {"steps": n_steps,
               "records": nodes * n_steps * chunk,
               "ingest_ms": ingest_ms,
               "ingest_ms_pct": percentiles(ingest_ms[1:] or ingest_ms),
               "records_per_s": nodes * chunk / (
                   statistics.median(ingest_ms[1:] or ingest_ms) / 1e3),
               "peak_bytes": peak, "allocated_before_bytes": base}
        for mix, specs in mixes.items():
            lat = timed_samples(lambda: svc.query(specs), QUERY_BATCHES,
                                device)
            sync(device)
            t0 = time.perf_counter()
            tickets = [svc.submit(specs) for _ in range(QUERY_BATCHES)]
            for t in tickets:
                svc.wait(t)
            wall = time.perf_counter() - t0
            row[f"query_{mix}_ms_pct"] = percentiles(lat)
            row[f"sustained_{mix}_queries_per_s"] = (
                len(specs) * QUERY_BATCHES / wall)
        row["stage_ms"] = serve_stages(svc, cfg, chunk, mixes, device)
        log("serve", f"{backend}: " + json.dumps(row))
        if cuda:
            def window():
                svc.reset()
                svc.ingest_chunks(1)
                svc.query(mixes["mixed"])
            profile(window, device, top=6)
        del svc
    log("serve", "the resident snapshot of every backend equals the "
                 "streaming engine and the one-shot counting run; every "
                 "ingest step launched K6 twice a node, every B result K7 "
                 f"once ({k7_launches} in all), every combiner step K8 "
                 f"once ({k8_launches} in all), every mapreduce round K9 "
                 f"once ({k9_launches} in all), every batch launched K5 "
                 "once and equals its plain version")
    return (k5_at_service_shapes(device, k5_inputs, k5_launches),
            k8_launches, k9_launches)


def serve_stages(svc, cfg, chunk: int, mixes: dict, device) -> dict:
    """Each layer of one ingest step and one query batch, timed on its
    own: generating the step's chunks, folding them (the backend's
    dataflow), the snapshot; encoding a batch on the host, its device work
    (``batched_query``: K5, the top-k sort, the drill-down gather), and
    decoding it (the copy to the host)."""
    from repro_torch.core.streaming import fold_chunk, snapshot, state_init
    from repro_torch.malgen import generate_chunks
    from repro_torch.serve import (
        batched_query,
        decode_answers,
        encode_query_batch,
    )

    stage, box = {}, {}

    def timed(name, key, fn):
        stage[name] = time_ms(lambda: box.__setitem__(key, fn()), device,
                              iters=1, warmup=0)

    ids = [d * svc.cpd for d in range(svc.parts)]
    timed("generate", "chunk",
          lambda: generate_chunks(svc.seed, cfg, ids, chunk))
    state = state_init(svc.backend, svc.parts, svc.s_pad, svc.num_weeks,
                       device)
    timed("fold", "state", lambda: fold_chunk(
        state, box["chunk"], backend=svc.backend, s_pad=svc.s_pad,
        num_weeks=svc.num_weeks, plan=svc.plan))
    timed("snapshot", "snap", lambda: snapshot(
        box["state"], backend=svc.backend, s_pad=svc.s_pad,
        num_weeks=svc.num_weeks))
    hist = svc.snapshot()[0]
    for mix, specs in mixes.items():
        sync(device)
        t0 = time.perf_counter()
        batch = encode_query_batch(specs, svc.num_weeks, svc.num_sites)
        args = [torch.from_numpy(x).to(device) for x in
                (batch.num_masks, batch.den_masks, batch.sites)]
        sync(device)
        stage[f"encode_{mix}"] = (time.perf_counter() - t0) * 1e3
        timed(f"query_{mix}", "out", lambda: batched_query(
            hist, *args, max_top_k=batch.max_top_k))
        t0 = time.perf_counter()
        decode_answers(batch, box["out"])
        stage[f"decode_{mix}"] = (time.perf_counter() - t0) * 1e3
    return stage


def k5_at_service_shapes(device, inputs, launches: int) -> dict:
    """K5 timed on the service's full-width snapshot with the growing batch
    (N = 52), the mixed batch's size (N = 9, its first 9 masks) and 52
    alternating-week masks (26 runs each, the worst shape): on the device
    (calls replayed as a CUDA graph), with the wrapper's host work and
    cold (each call after the 41.6 MB snapshot was evicted from the L2),
    beside the first design and a matmul yardstick in the same call."""
    from repro_torch.kernels.windowed_ratio import ops as wr

    fd = first_designs()
    hist, nm, dm = inputs
    s, w, _ = hist.shape
    weeks = torch.arange(w, device=hist.device)
    alt = ((weeks[None, :] + torch.arange(52, device=hist.device)[:, None])
           % 2 == 0).contiguous()
    extra = {}

    def library(nmask, dmask):
        # one batched f32 matmul of both mask sets with both count columns
        # (exact below 2^24; the ratio is left out)
        masks = torch.stack([dmask, nmask]).float()
        cols = hist.permute(2, 1, 0).float()
        return lambda: torch.bmm(masks, cols)

    for key, a, b in (("n52", nm, dm), ("n9", nm[:9].contiguous(),
                                        dm[:9].contiguous()),
                      ("alternating", alt, alt)):
        n = a.shape[0]
        got = wr.masked_window_ratio(hist, a, b)
        err = k5_exact(f"K5 service shapes {key}", got,
                       wr.masked_window_ratio_plain(hist, a, b))
        k5_exact(f"K5 first design {key}", fd.masked_window_ratio(hist, a, b),
                 got)
        runs = sum(int(((m[:, 1:] != m[:, :-1]).sum() + m[:, 0].sum()
                        + m[:, -1].sum()) // 2) for m in (a, b))
        # ms: the device's time (a CUDA graph of the calls); a call's host
        # work (checks, allocations, two launches) is 40-70 us, so events
        # around repeated wrapper calls (wrapper_ms) time the host at N = 9
        extra[key] = dict(
            ms=graph_ms(lambda: wr.masked_window_ratio(hist, a, b), device),
            wrapper_ms=time_ms(lambda: wr.masked_window_ratio(hist, a, b),
                               device, 20, 3),
            cold_ms=cold_ms(lambda: wr.masked_window_ratio(hist, a, b),
                            device),
            first_design_ms=graph_ms(lambda: fd.masked_window_ratio(
                hist, a, b), device),
            plain_ms=time_ms(lambda: wr.masked_window_ratio_plain(
                hist, a, b), device, 3, 1),
            library_ms=graph_ms(library(a, b), device),
            bytes=4 * s * w * 2 + 2 * n * w + 12 * n * s,
            # the running sums of both channels, a subtract and an add per
            # run and site, one divide per answer
            ops=2 * s * w + 2 * runs * s + n * s, runs=runs, err=err)
    main = extra.pop("n52")
    for e in extra.values():
        e["bound_ms"] = max(e.pop("bytes") / HBM_BYTES_PER_S,
                            e.pop("ops") / OPS32_PER_S) * 1e3
        e.pop("err")
    return kernel_row(
        "windowed_ratio.masked", launches, main.pop("err"), main.pop("ms"),
        main.pop("plain_ms"), main.pop("library_ms"), main.pop("bytes"),
        ops=main.pop("ops"), shape="S=100000 W=52 N=52 (growing)", **main,
        n9=extra["n9"], alternating_n52=extra["alternating"])


# ------------------------------------------------------------- phase 8
def k6_case(seed: int, n: int, s: int, device):
    """A CDF with runs of equal entries (zero-weight sites) and draws on
    and between its entries, with NaN, +-inf, -0.0, 0.0, 1.0 and 2.0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    w = torch.rand(s, generator=g)
    w[torch.rand(s, generator=g) < 0.3] = 0
    cdf = torch.cumsum(w, 0)
    cdf = cdf / torch.clamp(cdf[-1], min=1e-30)
    u = torch.rand(n, generator=g)
    on = torch.rand(n, generator=g) < 0.3
    u[on] = cdf[torch.randint(0, s, (int(on.sum()),), generator=g)]
    edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                          0.0, 1.0, 2.0])
    k = min(n, len(edges))
    u[torch.randperm(n, generator=g)[:k]] = edges[:k]
    return u.to(device), cdf.to(device)


def k7_outputs(out):
    """K7's outputs with rho as its bits, for ``exact``."""
    return (out[0].view(torch.int32), out[1], out[2])


def k6_malgen_cdfs(device) -> dict:
    """The marked and unmarked CDFs of ``MalGenConfig()`` (seed 0): permuted
    power laws restricted to a mask, so with leading zero entries, runs of
    equal entries and a last run of 1.0."""
    from repro_torch.malgen import MalGenConfig, make_seed

    seed = make_seed(0, MalGenConfig(), NODES << 20, device=device)
    return {"marked": seed.marked_cdf, "unmarked": seed.unmarked_cdf}


def k6_cases(device):
    """(name, u, cdf) of K6's edge cases beyond ``k6_case``: the MalGen
    CDFs with uniform draws, draws on their entries and on the guide's
    bucket edges b / 2^13, at 2^20 + 3 draws (the table) and 100,003 (the
    direct search), and u at an offset of one float (no 16-byte loads); a
    CDF whose last entry is 0.75; one with entries from -0.5 to 2.0."""
    g = torch.Generator(device="cpu").manual_seed(9)
    out = []
    for name, cdf in k6_malgen_cdfs(device).items():
        s = cdf.shape[0]
        for n in ((1 << 20) + 3, 100_003):
            u = torch.rand(n, generator=g)
            on = torch.rand(n, generator=g) < 0.2
            u[on] = cdf.cpu()[torch.randint(0, s, (int(on.sum()),),
                                            generator=g)]
            edge = torch.rand(n, generator=g) < 0.1
            u[edge] = torch.randint(0, 1 << 13, (int(edge.sum()),),
                                    generator=g).float() / (1 << 13)
            u = u.to(device)
            out.append((f"MalGen {name} n={n}", u, cdf))
            out.append((f"MalGen {name} n={n - 1}, u offset by 4 bytes",
                        u[1:], cdf))
    for n in (1000, (1 << 20) + 1):
        u, cdf = k6_case(n, n, 5000, device)
        out.append((f"last entry 0.75 n={n}", u, cdf * 0.75))
        u = torch.rand(n, generator=g).to(device) * 3 - 1
        out.append((f"entries in [-0.5, 2] n={n}", u,
                    torch.linspace(-0.5, 2.0, 5000, device=device)))
    return out


def k7_cases(device):
    """(name, hist) of K7's edge cases: W in {1, 2, 31, 32, 33, 52, 64, 65,
    130} (odd W takes 4-byte loads, W > 64 more than one chunk), S in {1,
    7, 1001} (no multiple of a block's 8 sites), counts below 1000, above
    2^24 and past 2^31, zero weeks and empty sites; S = 100,000 at W = 52;
    NodeDoctor's few hosts at W in {8, 52}; and histograms at an offset of
    one int (no 16-byte loads)."""
    g = torch.Generator(device="cpu").manual_seed(8)
    out = []
    for w in (1, 2, 31, 32, 33, 52, 64, 65, 130):
        for s in (1, 7, 1001):
            for high in (1000, 1 << 20, 1 << 27):
                hist = torch.randint(0, high, (s, w, 2), generator=g,
                                     dtype=torch.int32)
                hist[torch.rand(s, generator=g) < 0.2] = 0
                hist[:, torch.rand(w, generator=g) < 0.2] = 0
                out.append((f"S={s} W={w} high={high}", hist.to(device)))
    out.append(("S=100000 W=52", torch.randint(
        0, 1000, (100_000, 52, 2), generator=g, dtype=torch.int32)
        .to(device)))
    # NodeDoctor's: S = hosts, W = its telemetry's 8 buckets or the
    # default 52, counts of a few events a bucket
    for s, w in ((4, 8), (6, 8), (4, 52), (12, 52)):
        hist = torch.randint(0, 9, (s, w, 2), generator=g,
                             dtype=torch.int32)
        hist[..., 1] = torch.minimum(hist[..., 1], hist[..., 0])
        out.append((f"S={s} W={w} NodeDoctor", hist.to(device)))
    for w in (52, 33):
        flat = torch.randint(0, 1 << 27, (1 + 999 * w * 2,), generator=g,
                             dtype=torch.int32).to(device)
        out.append((f"S=999 W={w} offset by 4 bytes",
                    flat[1:].view(999, w, 2)))
    return out


def k6_k7_edge_cases(device) -> dict:
    """K6 at S in {1, 7, 2048, 100,000} and n in {1, 1023, 2^18 - 1, 2^18,
    2^23} (both sides of its direct-search threshold), and on
    ``k6_cases``; K7 on ``k7_cases`` (a wrapped denominator gives rho 0).
    Both bit-equal to their plain versions. Also whether
    ``torch.searchsorted`` (K6's library yardstick) gives the same sites
    on the card, NaN draws included."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.kernels.windowed_ratio import ops as wr

    library_equal = True
    cases = []
    for s in (1, 7, 2048, 100_000):
        for n in (1, 1023, (1 << 18) - 1, 1 << 18, RPS):
            cases.append((f"S={s} n={n}",) + k6_case(s * 31 + n, n, s,
                                                     device))
    cases += k6_cases(device)
    for name, u, cdf in cases:
        got = ps.powerlaw_sample(u, cdf)
        exact(f"K6 {name}", got, ps.powerlaw_sample_plain(u, cdf))
        s = cdf.shape[0]
        lib = torch.searchsorted(cdf, u, right=True).clamp(0, s - 1)
        library_equal &= bool(torch.equal(lib.to(torch.int32), got))
        check(int(got[torch.isnan(u)].ne(s - 1).sum()) == 0,
              f"K6 {name}: a NaN draw did not give S-1")
    k7 = k7_cases(device)
    for name, hist in k7:
        got = wr.windowed_ratio(hist)
        exact(f"K7 {name}", k7_outputs(got),
              k7_outputs(wr.windowed_ratio_plain(hist)))
        big = hist.shape[0] == 1001 and hist.shape[1] >= 52
        if big and "high=1048576" in name:
            check(int(got[1].max()) > 1 << 24, f"K7 {name}: no sum above "
                                               f"2^24")
        if big and "high=134217728" in name:
            wrapped = got[1] <= 0
            check(bool(wrapped.any()), f"K7 {name}: no sum wrapped past "
                                       f"2^31")
            check(not bool(got[0][wrapped].any()),
                  f"K7 {name}: rho != 0 where the wrapped denominator is "
                  f"<= 0")
    log("kernel", f"K6 bit-equal to plain on {len(cases)} cases, K7 on "
                  f"{len(k7)}; torch.searchsorted equal to K6 on the card: "
                  f"{library_equal}")
    return {"k6_library_equal": library_equal}


def k6_timings(device, seed, cfg) -> dict:
    """K6 on the MalGen unmarked CDF at a node's unmarked draws of the
    main path, and at a service step's chunk (2^20 records: the marked
    and unmarked draws on their CDFs), against its first design and the
    library call. ``ms`` and ``library_ms`` are CUDA events around repeated
    calls, the wrapper's and ``torch.searchsorted``'s host work included;
    ``graph_ms`` the device alone."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.malgen.seeding import chunk_marked_records

    fd = first_designs()
    g = torch.Generator(device=device).manual_seed(6)
    n_marked = chunk_marked_records(cfg, SERVE_CHUNK)
    shapes = {
        "malgen_unmarked_node": (
            seed.unmarked_cdf,
            RPS - len(range(0, seed.num_marked_events, NODES))),
        "service_marked": (seed.marked_cdf, n_marked),
        "service_unmarked": (seed.unmarked_cdf, SERVE_CHUNK - n_marked)}
    out = {}
    for key, (cdf, n) in shapes.items():
        u = torch.rand(n, generator=g, device=device)
        got = ps.powerlaw_sample(u, cdf)
        exact(f"K6 {key}", got, ps.powerlaw_sample_plain(u, cdf))
        exact(f"K6 first design {key}", fd.powerlaw_sample(u, cdf), got)

        def library():
            return torch.searchsorted(cdf, u, right=True).clamp(
                0, cdf.shape[0] - 1).to(torch.int32)

        out[key] = dict(
            n=n, ms=time_ms(lambda: ps.powerlaw_sample(u, cdf), device, 20,
                            3),
            graph_ms=graph_ms(lambda: ps.powerlaw_sample(u, cdf), device),
            first_design_ms=graph_ms(lambda: fd.powerlaw_sample(u, cdf),
                                     device),
            library_ms=time_ms(library, device, 20, 3),
            library_graph_ms=graph_ms(library, device),
            bound_ms=(8 * n + 4 * cdf.shape[0]) / HBM_BYTES_PER_S * 1e3)
        log("kernel", f"K6 {key}: " + json.dumps(out[key]))
    return out


def k6_join_timings(device, seed) -> dict:
    """K6's join pass (``powerlaw_sample_join``) at the streaming step's
    shapes: one row of 2^23 records, the 838,861 marked from its start
    under the marked CDF, the 7,549,747 unmarked from 838,861 (one int
    past a 16-byte boundary) under the unmarked one; each half bit-equal
    to plain K6 plus the torch join, timed beside them (``unfused_ms``:
    the same, as the step ran before the pass), the plain version
    (``torch.searchsorted`` and the gather) and its bound: K6's 8 bytes a
    record and the CDF, the join's 20 (entity and timestamp read; mark,
    event id and hash written)."""
    from repro_torch.kernels.powerlaw_sample import ops as ps

    c, n_m = 1 << 23, 838_861
    g = torch.Generator(device=device).manual_seed(34)
    e_count = seed.entity_mark_time.shape[0]
    u = torch.rand(c, generator=g, device=device)
    entity = torch.randint(0, e_count, (c,), generator=g, device=device,
                           dtype=torch.int32)
    ts = torch.randint(0, 31_536_000, (c,), generator=g, device=device,
                       dtype=torch.int32)
    out = [torch.empty(c, dtype=torch.int32, device=device)
           for _ in range(4)]
    out_plain = [torch.empty_like(o) for o in out]
    mt = seed.entity_mark_time
    rows = {}
    for key, lo, hi, cdf in (("join_marked", 0, n_m, seed.marked_cdf),
                             ("join_unmarked", n_m, c, seed.unmarked_cdf)):
        args = (u[lo:hi], cdf, entity[lo:hi], ts[lo:hi], mt)

        def fused():
            ps.powerlaw_sample_join(*args, *[x[lo:hi] for x in out],
                                    seq_start=lo, hash_value=-77)

        def unfused():
            return (ps.powerlaw_sample(u[lo:hi].contiguous(), cdf),
                    (mt[entity[lo:hi].long()] <= ts[lo:hi]).int(),
                    torch.arange(lo, hi, dtype=torch.int32, device=device),
                    torch.full((hi - lo,), -77, dtype=torch.int32,
                               device=device))

        def plain():
            ps.powerlaw_sample_join_plain(
                *args, *[x[lo:hi] for x in out_plain], seq_start=lo,
                hash_value=-77)

        fused()
        plain()
        want = unfused()
        exact(f"K6 {key} against K6 and the torch join",
              [x[lo:hi] for x in out], list(want))
        exact(f"K6 {key} against its plain version",
              [x[lo:hi] for x in out], [x[lo:hi] for x in out_plain])
        n = hi - lo
        rows[key] = dict(
            n=n, ms=time_ms(fused, device, 20, 3),
            graph_ms=graph_ms(fused, device),
            unfused_ms=time_ms(unfused, device, 20, 3),
            plain_ms=time_ms(plain, device, 10, 2),
            bound_ms=(28 * n + 4 * cdf.shape[0]) / HBM_BYTES_PER_S * 1e3)
        log("kernel", f"K6 {key}: " + json.dumps(rows[key]))
    return rows


def bench_kernel_pairs(device, edge: dict, mp: dict) -> list:
    """The six ``kernel_*`` scenarios at full width through
    ``run_scenarios``, each with the launch counts set to 0 just before it
    and read just after; each kernel against its plain version on the
    same inputs; K6 and K7 timed (K6 also by ``k6_timings``). Returns their
    kernels-line entries, whose launches are the main path's (phase 3)."""
    from repro_torch.bench import registry, schema
    from repro_torch.bench.run import run_scenarios
    from repro_torch.kernels import launch_counts, reset_launch_counts

    scale = registry.Scale(**BENCH_KERNELS)
    ctx = registry.BenchContext(nodes=NODES, device=device)
    doc = schema.new_document("torch_kernel_pairs", device=device)
    launches = {}
    for kernel in registry.KERNELS:
        for path in registry.KERNEL_PATHS:
            name = f"kernel_{kernel}_{path}"
            sync(device)
            reset_launch_counts()
            run_scenarios([name], scale, ctx, doc)
            sync(device)
            got = launch_counts()
            want = dict.fromkeys(got, 0)
            if path == "pallas":
                check(got[kernel] > 0, f"{name}: {kernel} not launched")
                want[kernel] = got[kernel]
            check(got == want, f"{name}: launches {got}")
            launches[name] = got[kernel]
    rows = schema.results_by_scenario(doc)
    log("bench", "kernel pairs (us/call, records/s): " + json.dumps(
        {n: (r["us_per_call"], r["records_per_s"]) for n, r in rows.items()}))

    fd = first_designs()
    entries = []
    for kernel in registry.KERNELS:
        args = registry._kernel_inputs(scale, kernel, device)
        fast, plain = registry.kernel_fns(kernel, scale)
        got, want = fast(*args), plain(*args)
        if kernel == "windowed_ratio":
            got, want = k7_outputs(got), k7_outputs(want)
        err = exact(f"{kernel} at the bench's full width", got, want)
        bench = dict(bench_launches=launches[f"kernel_{kernel}_pallas"],
                     bench_us={p: rows[f"kernel_{kernel}_{p}"]["us_per_call"]
                               for p in registry.KERNEL_PATHS})
        if kernel == "powerlaw_sample":
            u, cdf = args
            n, s = u.shape[0], cdf.shape[0]
            exact("K6 first design at the bench's full width",
                  fd.powerlaw_sample(u, cdf), got)
            entries.append(kernel_row(
                kernel, mp["launches"][kernel], err,
                time_ms(lambda: fast(u, cdf), device, 20, 3),
                time_ms(lambda: plain(u, cdf), device, 10, 2),
                time_ms(lambda: torch.searchsorted(cdf, u, right=True)
                        .clamp(0, s - 1), device, 20, 3),
                4 * n + 4 * n + 4 * s,
                ops=n * s.bit_length(),    # search steps
                shape=f"n={n} S={s} (the bench's sorted CDF)",
                graph_ms=graph_ms(lambda: fast(u, cdf), device),
                first_design_ms=time_ms(lambda: fd.powerlaw_sample(u, cdf),
                                        device, 20, 3),
                library_equal_on_card=edge["k6_library_equal"],
                **k6_timings(device, mp["seed"], mp["cfg"]),
                **k6_join_timings(device, mp["seed"]), **bench))
        elif kernel == "windowed_ratio":
            (hist,) = args
            s, w, _ = hist.shape
            exact("K7 first design at the bench's full width",
                  k7_outputs(fd.windowed_ratio(hist)), got)
            entries.append(kernel_row(
                kernel, mp["launches"][kernel], err,
                time_ms(lambda: fast(hist), device, 20, 3),
                time_ms(lambda: plain(hist), device, 10, 2),
                time_ms(lambda: torch.cumsum(hist, dim=1,
                                             dtype=torch.int32),
                        device, 20, 3),
                20 * s * w, ops=3 * s * w, shape=f"S={s} W={w}",
                library="torch.cumsum of both channels, no ratio",
                graph_ms=graph_ms(lambda: fast(hist), device),
                first_design_ms=time_ms(lambda: fd.windowed_ratio(hist),
                                        device, 20, 3),
                cold_ms=cold_ms(lambda: fast(hist), device), **bench))
        else:
            log("bench", f"K4 at the bench's [1, {scale.records_per_node}] "
                         f"uniform columns equals its plain version; "
                         f"launches {bench['bench_launches']}, us/call "
                         f"{bench['bench_us']}")
    return entries


def bench_smoke(device) -> None:
    """The port's smoke selection at the full widths and a reduced depth,
    through ``run_scenarios`` into a document that must validate and
    compare clean against itself."""
    import tempfile

    from repro_torch.bench import compare, registry, schema
    from repro_torch.bench.run import run_scenarios

    scale = registry.Scale(**BENCH_SMOKE)
    ctx = registry.BenchContext(nodes=NODES, device=device)
    # the overlap pair cuts chunks to 64 records: at this depth that is
    # 16,384 steps a node for each of its 32 runs, so it runs in phase 9
    # at a depth of its own; the transient row's schedule (25% a shard)
    # passes an attempt of 8 shards one time in ten and exhausts its
    # retries here, so it runs at the bench's 2 nodes in phase 10
    names = [n for n in registry.preset_scenario_names("smoke")
             if n not in OVERLAP_PAIR + (BENCH_TRANSIENT,)]
    doc = schema.new_document("torch_smoke_chip", preset="smoke",
                              device=device)
    t0 = time.perf_counter()
    skipped = run_scenarios(names, scale, ctx, doc)
    wall = time.perf_counter() - t0
    check(not skipped and len(doc["results"]) == len(names) == 44,
          f"smoke selection: {len(doc['results'])} rows, skipped {skipped}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        path = schema.write_document(doc, pathlib.Path(tmp) / "BENCH.json")
        schema.load_document(path)
        code = compare.main([str(path), str(path)])
        check(code == 0, f"compare of the smoke document with itself "
                         f"exited {code}")
    rates = {r["scenario"]: r.get("records_per_s") for r in doc["results"]}
    qps = {r["scenario"]: r["derived"]["queries_per_s"]
           for r in doc["results"]
           if "queries_per_s" in (r.get("derived") or {})}
    log("bench", f"smoke: {len(doc['results'])} scenarios in {wall:.1f} s; "
                 f"the document validates and compares clean against "
                 f"itself")
    log("bench", "records/s " + json.dumps(rates))
    log("bench", "queries/s " + json.dumps(qps))


# ------------------------------------------------------------- phase 9
def merged(spans) -> list:
    """The union of ``(start, end)`` spans as sorted disjoint spans."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def merged_ms(spans) -> float:
    """Milliseconds covered by the union of ``(start, end)`` spans in
    microseconds."""
    return sum(b - a for a, b in merged(spans)) / 1e3


def both_ms(spans_a, spans_b) -> float:
    """Milliseconds during which both sets of spans (microseconds) are
    busy: the length of the intersection of their unions."""
    a, b = merged(spans_a), merged(spans_b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3


def stream_profile(drive, device) -> dict:
    """One call of ``drive`` under ``torch.profiler``, read from its
    trace: the streams the generation kernels (K6) and the fold kernels
    (K1-K3) ran on, each stream's busy ms, the ms during which those two
    streams were busy at once, and the card's busy ms (the union of every
    kernel, copy and set on any stream) and idle share of the wall time."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile as tprofile

    sync(device)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        drive()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    spans, gen, fold = {}, set(), set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        stream = e.get("args", {}).get("stream")
        spans.setdefault(stream, []).append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] == "kernel":
            if any(k in e["name"] for k in GEN_KERNELS):
                gen.add(stream)
            if any(k in e["name"] for k in FOLD_KERNELS):
                fold.add(stream)
    busy = merged_ms([x for v in spans.values() for x in v])
    both = None
    if len(gen) == 1 and len(fold) == 1 and gen != fold:
        (g,), (f,) = gen, fold
        both = both_ms(spans[g], spans[f])
    return dict(wall_ms=wall_ms, busy_ms=busy, idle_share=1 - busy / wall_ms,
                both_busy_ms=both, gen_streams=sorted(map(str, gen)),
                fold_streams=sorted(map(str, fold)),
                stream_busy_ms={str(k): merged_ms(v)
                                for k, v in spans.items()})


def step_rounds(runner) -> list:
    """Shuffle rounds each step of a mapreduce runner takes, from its
    chunks: the most records one node holds for one destination (``site %
    P``) over the bucket capacity, rounded up. Generates every chunk, so
    call it outside a counted window."""
    from repro_torch.core.backends.mapreduce import static_capacity

    p = runner.nodes
    cap = static_capacity(runner.chunk_records, p,
                          runner.plan.capacity_factor)
    out = []
    for k in range(runner.cpd):
        site = runner._chunk(k).site_id.to(torch.int64)
        dest = site % p + p * torch.arange(p, device=site.device)[:, None]
        most = int(torch.bincount(dest.reshape(-1), minlength=p * p).max())
        out.append(-(-most // cap))
    return out


def runner_launches(runner, rounds) -> dict:
    """The launches of one ``run_result("B")``: K6 for each node's marked
    and unmarked draws a step, K1 and K2 a step and K3 a round
    (mapreduce) or K4 a step (the other backends), K7 once."""
    from repro_torch.kernels import launch_counts
    from repro_torch.malgen.seeding import chunk_marked_records

    want = dict.fromkeys(launch_counts(), 0)
    nm = chunk_marked_records(runner.cfg, runner.chunk_records)
    draws = int(nm > 0) + int(runner.chunk_records - nm > 0)
    want["powerlaw_sample"] = draws * runner.nodes * runner.cpd
    if runner.backend == "mapreduce":
        want["count_scatter.count"] = runner.cpd
        want["count_scatter.scatter"] = runner.cpd
        want["segment_hist.packed"] = sum(rounds)
    else:
        want["segment_hist"] = runner.cpd
    want["windowed_ratio"] = 1
    return want


def same_result(name: str, got, want, got_stats, want_stats) -> None:
    """Equal totals, marks, rho bits and every ShuffleStats field."""
    check(torch.equal(got.total, want.total)
          and torch.equal(got.marked, want.marked),
          f"{name}: histogram differs from the streaming engine")
    check(torch.equal(got.rho.view(torch.int32), want.rho.view(torch.int32)),
          f"{name}: rho bits differ from the streaming engine")
    if want_stats is None:
        check(got_stats is None, f"{name}: stats where there are none")
    else:
        check([int(x) for x in got_stats] == [int(x) for x in want_stats],
              f"{name}: ShuffleStats {[int(x) for x in got_stats]} != "
              f"{[int(x) for x in want_stats]}")


def overlap_k6_on_side_stream(seed, cfg, device) -> None:
    """K6 launched under a non-default stream, at a chunk's marked and
    unmarked draws, equals its plain version."""
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.malgen.seeding import chunk_marked_records, draw_events

    nm = chunk_marked_records(cfg, OVERLAP_CHUNK)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    for stream, cdf, n in (("chunk_marked", seed.marked_cdf, nm),
                           ("chunk_unmarked", seed.unmarked_cdf,
                            OVERLAP_CHUNK - nm)):
        u = draw_events(seed.rng_seed, stream, 3, n, cfg, device).u_site
        with torch.cuda.stream(side):
            got = ps.powerlaw_sample(u, cdf)
        side.synchronize()
        exact(f"K6 on a side stream, {stream} n={n}", got,
              ps.powerlaw_sample_plain(u, cdf))
    log("overlap", f"K6 on a non-default stream equals its plain version "
                   f"at a chunk's {nm:,} marked and {OVERLAP_CHUNK - nm:,} "
                   f"unmarked draws")


def step_breakdown(runner, device) -> dict:
    """Where a step's time goes, on the host's clock, over one pass of the
    serialised schedule (overlap off): enqueueing the generation, waiting
    for its device work, the fold (its host work and the round loop's own
    waits for the counts) and waiting for the fold's last device work.
    Medians over the steps, ms."""
    from repro_torch.core.streaming import state_init

    main = torch.cuda.current_stream(device)
    gen = torch.cuda.Stream(device)
    state = state_init(runner.backend, runner.nodes, runner.s_pad,
                       runner.num_weeks, device)
    gen.wait_stream(main)
    sync(device)
    parts = {"generate_enqueue": [], "generate_wait": [], "fold_host": [],
             "fold_wait": []}
    for k in range(runner.cpd):
        t0 = time.perf_counter()
        chunk, ready = runner._generate_on(gen, k, main)
        t1 = time.perf_counter()
        gen.synchronize()
        t2 = time.perf_counter()
        main.wait_event(ready)
        state = runner._fold(state, chunk)
        t3 = time.perf_counter()
        main.synchronize()
        t4 = time.perf_counter()
        for key, a, b in (("generate_enqueue", t0, t1),
                          ("generate_wait", t1, t2), ("fold_host", t2, t3),
                          ("fold_wait", t3, t4)):
            parts[key].append((b - a) * 1e3)
    med = {k: statistics.median(v) for k, v in parts.items()}
    log("overlap", f"a step (off, host clock, median ms of {runner.cpd}): "
                   + json.dumps(med))
    return med


def overlap_runner(device) -> dict:
    """(a) The overlap runner at full width, 8 nodes x 8 steps of 2^20
    records, mapreduce counting at capacity factor 2.0, statistic B: on
    and off equal ``malstone_run_streaming(overlap=None)`` (histogram, rho
    bits, ShuffleStats) with exact launch counts, generation and fold on
    two streams; interleaved timings, records/s, idle share, both-busy
    time and peak memory, printed and not gated."""
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run_streaming
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.core.streaming import streaming_histogram_generate
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, make_seed_streaming

    cfg = MalGenConfig()
    num_chunks = NODES * OVERLAP_STEPS
    total = num_chunks * OVERLAP_CHUNK
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    seed = make_seed_streaming(0, cfg, num_chunks, OVERLAP_CHUNK,
                               device=device)
    overlap_k6_on_side_stream(seed, cfg, device)
    runner = OverlapStreamingRunner(
        seed, cfg, nodes=NODES, num_chunks=num_chunks,
        chunk_records=OVERLAP_CHUNK, backend="mapreduce", plan=plan,
        device=device)
    rounds = step_rounds(runner)
    want_launches = runner_launches(runner, rounds)

    def engine():
        return malstone_run_streaming(
            seed, cfg.num_sites, nodes=NODES, cfg=cfg, num_chunks=num_chunks,
            chunk_records=OVERLAP_CHUNK, backend="mapreduce", statistic="B",
            plan=plan, device=device, return_shuffle_stats=True)

    sync(device)
    reset_launch_counts()
    k9 = k9_module()
    k9.ship_buckets.launches = 0
    want, want_stats = engine()
    sync(device)
    check(launch_counts() == want_launches,
          f"streaming engine: launches {launch_counts()}, expected "
          f"{want_launches}")
    check_k9("streaming engine", k9.ship_buckets.launches, want_launches,
             device)
    check(int(want_stats.overflow) == 0 and int(want_stats.sent) == total,
          f"streaming engine: sent {int(want_stats.sent)} of {total}")
    want_hist, _ = streaming_histogram_generate(
        runner.seed, cfg, runner.s_pad, parts=NODES,
        chunks_per_node=OVERLAP_STEPS, chunk_records=OVERLAP_CHUNK,
        backend="mapreduce", plan=plan)
    out = {"rounds": rounds, "launches": want_launches, "peak_gib": {},
           "base_gib": {}, "profile": {}, "k9_launches": 0}
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    engine()
    sync(device)
    out["peak_gib"]["engine"] = torch.cuda.max_memory_allocated(device) / 2**30
    out["base_gib"]["engine"] = base / 2**30
    prof = stream_profile(engine, device)
    check(prof["gen_streams"] == prof["fold_streams"]
          and len(prof["gen_streams"]) == 1,
          f"engine: generation on {prof['gen_streams']}, fold on "
          f"{prof['fold_streams']}: not one stream")
    out["profile"]["engine"] = prof
    log("overlap", f"engine (overlap=None): peak "
                   f"{out['peak_gib']['engine']:.3f} GiB (before "
                   f"{out['base_gib']['engine']:.3f}); profile "
                   + json.dumps(prof))
    for ov in (True, False):
        name = f"overlap={'on' if ov else 'off'}"
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        reset_launch_counts()
        k9.ship_buckets.launches = 0
        got, got_stats = runner.run_result("B", overlap=ov)
        sync(device)
        got_launches = launch_counts()
        # K9 on the fold's stream, once a round
        check_k9(name, k9.ship_buckets.launches, got_launches, device)
        out["k9_launches"] += k9.ship_buckets.launches
        out["peak_gib"][name] = (torch.cuda.max_memory_allocated(device)
                                 / 2**30)
        out["base_gib"][name] = base / 2**30
        check(got_launches == want_launches,
              f"{name}: launches {got_launches}, expected {want_launches}")
        same_result(name, got, want, got_stats, want_stats)
        hist, _ = runner.run(overlap=ov)
        check(torch.equal(hist, want_hist),
              f"{name}: padded histogram differs from the streaming engine")
        check(bool(torch.isfinite(got.rho).all()) and got.rho.shape
              == (cfg.num_sites, 52), f"{name}: rho not finite or shape")
        prof = stream_profile(lambda: runner.run_result("B", overlap=ov),
                              device)
        check(len(prof["gen_streams"]) == 1 and len(prof["fold_streams"])
              == 1 and prof["gen_streams"] != prof["fold_streams"],
              f"{name}: generation on streams {prof['gen_streams']}, fold "
              f"on {prof['fold_streams']}: not two streams")
        out["profile"][name] = prof
        log("overlap", f"{name}: equals the streaming engine (histogram, "
                       f"rho bits, ShuffleStats {[int(x) for x in got_stats]}"
                       f"); launches {got_launches}; peak "
                       f"{out['peak_gib'][name]:.3f} GiB (before "
                       f"{out['base_gib'][name]:.3f}); profile "
                       + json.dumps(prof))
    log("overlap", f"rounds a step {rounds}; K3 launches a run "
                   f"{sum(rounds)}")
    out["step_ms"] = step_breakdown(runner, device)

    modes = {"on": lambda: runner.run_result("B", overlap=True),
             "off": lambda: runner.run_result("B", overlap=False),
             "engine": engine}
    order = list(modes)
    samples = {m: [] for m in modes}
    for turn in range(OVERLAP_TURNS):
        for m in order[turn % 3:] + order[:turn % 3]:
            samples[m].append(time_ms(modes[m], device, iters=1, warmup=0))
    med = {m: statistics.median(v) for m, v in samples.items()}
    out["run_ms"] = samples
    out["median_ms"] = med
    out["records_per_s"] = {m: total / (v / 1e3) for m, v in med.items()}
    log("overlap", f"{total:,} records, {OVERLAP_TURNS} interleaved turns; "
                   f"run ms {json.dumps(samples)}; medians "
                   f"{json.dumps(med)}; records/s "
                   f"{json.dumps(out['records_per_s'])}")
    del runner, want_hist
    return out


def overlap_gate(device) -> dict:
    """(b) The launcher at the same width in subprocesses: ``--stream-chunks
    8 --overlap on|off --check --bench-json`` and a one-shot ``--check``;
    each must exit 0 and print the check line, the documents validate."""
    import tempfile

    from repro_torch.bench import schema

    rpn = OVERLAP_STEPS * OVERLAP_CHUNK
    base = [sys.executable, "-m", "repro_torch.launch.malstone",
            "--nodes", str(NODES), "--records-per-node", str(rpn),
            "--sites", "100000", "--entities", "1000000",
            "--backend", "mapreduce", "--exchange-impl", "counting",
            "--capacity-factor", str(CAPACITY_FACTOR), "--runs", "3",
            "--check"]
    runs = {"overlap on": ["--stream-chunks", str(OVERLAP_STEPS),
                           "--overlap", "on"],
            "overlap off": ["--stream-chunks", str(OVERLAP_STEPS),
                            "--overlap", "off"],
            "one-shot": []}
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        for name, flags in runs.items():
            path = pathlib.Path(tmp) / f"BENCH_gate_{len(out)}.json"
            t0 = time.perf_counter()
            proc = subprocess.run(
                base + flags + ["--bench-json", str(path)],
                capture_output=True, text=True, timeout=400, env=env,
                cwd=ROOT)
            wall = time.perf_counter() - t0
            check(proc.returncode == 0,
                  f"launcher {name} exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            lines = proc.stdout.splitlines()
            check(any("bit-equals the single-device oracle" in line
                      for line in lines),
                  f"launcher {name}: no check line")
            doc = schema.load_document(path)
            (row,) = doc["results"]
            check(row["params"]["overlap"] == (flags[-1] if flags
                                               else "auto"),
                  f"launcher {name}: params {row['params']}")
            for line in lines:
                if any(k in line for k in ("median", "--check", "oracle:",
                                           "shuffle:")):
                    log("gate", f"{name}: {line.strip()}")
            out[name] = dict(wall_s=wall, us_per_call=row["us_per_call"],
                             records_per_s=row["records_per_s"],
                             scenario=row["scenario"])
            log("gate", f"{name}: exit 0 in {wall:.1f} s; document "
                        f"{row['scenario']} validates; " + json.dumps(
                            out[name]))
    return out


def overlap_bench_pair(device) -> dict:
    """(c) The bench's overlap pair through ``run_scenarios`` at the full
    widths and 4,096 records a node (64 chunks of 64 records), with the
    launch counts set to 0 just before and read just after."""
    from repro_torch.bench import registry, schema
    from repro_torch.bench.run import run_scenarios
    from repro_torch.kernels import launch_counts, reset_launch_counts

    scale = registry.Scale(**BENCH_OVERLAP)
    ctx = registry.BenchContext(nodes=NODES, device=device)
    doc = schema.new_document("torch_overlap_chip", device=device)
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    skipped = run_scenarios(list(OVERLAP_PAIR), scale, ctx, doc)
    wall = time.perf_counter() - t0
    sync(device)
    got = launch_counts()
    check(not skipped and len(doc["results"]) == 2,
          f"overlap pair: {len(doc['results'])} rows, skipped {skipped}")
    schema.validate_document(doc)
    ((runner, chunk, num_chunks),) = ctx._overlap.values()
    runs = got["windowed_ratio"]
    want = {k: runs * v for k, v in
            runner_launches(runner, step_rounds(runner)).items()}
    check(runs > 0 and got == want,
          f"overlap pair: launches {got}, expected {want} ({runs} runs)")
    rows = {r["scenario"]: r for r in doc["results"]}
    out = {n: dict(us_per_call=r["us_per_call"],
                   records_per_s=r["records_per_s"],
                   rel_dispersion=r["rel_dispersion"])
           for n, r in rows.items()}
    log("bench", f"overlap pair: {num_chunks} chunks of {chunk} records, "
                 f"{runs} runs in {wall:.1f} s, launches {got}; "
                 + json.dumps(out))
    return out


def overlap_small_backends(device) -> int:
    """(d) The runner on streams and the combiner at 2 steps of 8 x 2^20
    records, on and off, equal to their streaming engine, with K4 counted
    once a step and K8 once a combiner step; returns K8's launches."""
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run_streaming
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, make_seed_streaming

    cfg = MalGenConfig()
    num_chunks = NODES * OVERLAP_SMALL_STEPS
    plan = ExchangePlan(histogram_impl="kernel")
    seed = make_seed_streaming(1, cfg, num_chunks, OVERLAP_CHUNK,
                               device=device)
    cb, k9 = k8_module(), k9_module()
    k8_launches = 0
    for backend in ("streams", "mapreduce_combiner"):
        runner = OverlapStreamingRunner(
            seed, cfg, nodes=NODES, num_chunks=num_chunks,
            chunk_records=OVERLAP_CHUNK, backend=backend, plan=plan,
            device=device)
        want_launches = runner_launches(runner, [])
        want, want_stats = malstone_run_streaming(
            seed, cfg.num_sites, nodes=NODES, cfg=cfg,
            num_chunks=num_chunks, chunk_records=OVERLAP_CHUNK,
            backend=backend, statistic="B", plan=plan, device=device,
            return_shuffle_stats=True)
        for ov in (True, False):
            name = f"{backend} overlap={'on' if ov else 'off'}"
            sync(device)
            reset_launch_counts()
            cb.combine_blocks.launches = 0
            k9.ship_buckets.launches = 0
            got, got_stats = runner.run_result("B", overlap=ov)
            sync(device)
            check(k9.ship_buckets.launches == 0,
                  f"{name}: {k9.ship_buckets.launches} K9 launches")
            check(launch_counts() == want_launches,
                  f"{name}: launches {launch_counts()}, expected "
                  f"{want_launches}")
            k8 = cb.combine_blocks.launches
            check(k8 == (OVERLAP_SMALL_STEPS if backend == "mapreduce_combiner"
                         and device.type == "cuda" else 0),
                  f"{name}: {k8} K8 launches")
            k8_launches += k8
            same_result(name, got, want, got_stats, want_stats)
            ms = time_ms(lambda: runner.run_result("B", overlap=ov), device,
                         iters=1, warmup=0)
            log("overlap", f"{name}: equals its streaming engine at "
                           f"{OVERLAP_SMALL_STEPS} steps; launches "
                           f"{want_launches}, K8 {k8}; {ms:.3f} ms")
    return k8_launches


def overlap(device) -> dict:
    """Phase 9: (a) the runner, (b) the launcher's gate, (c) the bench's
    overlap pair, (d) the runner on streams and the combiner."""
    t0 = time.perf_counter()
    out = overlap_runner(device)
    out["gate"] = overlap_gate(device)
    out["bench"] = overlap_bench_pair(device)
    out["k8_launches"] = overlap_small_backends(device)
    log("overlap", f"phase 9 took {time.perf_counter() - t0:.1f} s")
    return out


def dir_bytes(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def expect_kill(fn) -> bool:
    """Whether ``fn`` raised the injected ``SimulatedKill``."""
    from repro_torch.faults import SimulatedKill

    try:
        fn()
    except SimulatedKill:
        return True
    return False


def same_outcome(name: str, out, want, want_stats) -> None:
    same_result(name, out.result, want, out.shuffle_stats, want_stats)
    check(bool(torch.isfinite(out.result.rho).all())
          and out.result.rho.device.type == "cuda",
          f"{name}: rho not finite or not on the card")


def resume_kills(runner, want, want_stats, root: pathlib.Path) -> dict:
    """(2) Raised kills at the segment 2 boundary and inside step 2's
    checkpoint write, each resumed; a complete checkpointed run and its
    restore, for the checkpoint numbers."""
    from repro_torch.faults import FaultPlan

    d = root / "boundary"
    check(expect_kill(lambda: runner.run(
        checkpoint_dir=str(d),
        faults=FaultPlan(kill_at_segment=2, kill_mode="raise"))),
          "kill at the segment 2 boundary did not fire")
    out = runner.run(checkpoint_dir=str(d))
    rep = out.report
    check(rep.resumed_from_step == 2 and rep.chunks_skipped == 32
          and rep.segments_run == 2,
          f"boundary kill: resumed {rep.to_derived()}")
    same_outcome("resumed after a boundary kill", out, want, want_stats)

    d = root / "mid_checkpoint"
    check(expect_kill(lambda: runner.run(
        checkpoint_dir=str(d),
        faults=FaultPlan(kill_mid_checkpoint_step=2, kill_mode="raise"))),
          "kill inside step 2's checkpoint did not fire")
    names = sorted(p.name for p in d.iterdir())
    check(any(n.startswith(".tmp_step_2_") for n in names)
          and "step_00000002.COMMITTED" not in names
          and "step_00000001.COMMITTED" in names,
          f"mid-checkpoint kill left {names}")
    out = runner.run(checkpoint_dir=str(d))
    check(out.report.resumed_from_step == 1
          and out.report.chunks_skipped == 16,
          f"mid-checkpoint kill: resumed {out.report.to_derived()}")
    check(not any(p.name.startswith(".tmp_") for p in d.iterdir()),
          "the next manager did not sweep the torn step")
    same_outcome("resumed after a mid-checkpoint kill", out, want,
                 want_stats)

    d = root / "complete"
    full = runner.run(checkpoint_dir=str(d), resume=False)
    same_outcome("checkpointed", full, want, want_stats)
    step_bytes = dir_bytes(d / "step_00000004")
    again = runner.run(checkpoint_dir=str(d))
    check(again.report.segments_run == 0
          and again.report.chunks_skipped == NODES * RESUME_STEPS,
          f"complete checkpoint: {again.report.to_derived()}")
    same_outcome("restored from a complete checkpoint", again, want,
                 want_stats)
    out = dict(save_ms_per_segment=full.report.checkpoint_save_ms
               / full.report.segments_run,
               bytes_per_checkpoint=step_bytes,
               restore_ms=again.report.checkpoint_restore_ms)
    log("resume", "mapreduce kills: the boundary kill resumed from step 2"
                  " (32 chunks restored), the mid-checkpoint kill from step"
                  " 1 with the torn step swept; both equal the engine; "
                  "checkpoint " + json.dumps(out))
    return out


def resume_crash(runner, want, want_stats, root: pathlib.Path) -> dict:
    """(3) The launcher's resumable path in a child process, killed by
    ``os._exit(17)`` at the segment 2 boundary; ``--resume`` in a second
    child; then an in-process resume from a copy of the killed run's
    directory."""
    import shutil

    from repro_torch.bench import schema

    d = root / "crash"
    base = [sys.executable, "-m", "repro_torch.launch.malstone",
            "--nodes", str(NODES),
            "--records-per-node", str(RESUME_STEPS * RESUME_CHUNK),
            "--sites", str(runner.cfg.num_sites),
            "--entities", str(runner.cfg.num_entities),
            "--backend", "mapreduce", "--exchange-impl", "counting",
            "--capacity-factor", str(CAPACITY_FACTOR),
            "--stream-chunks", str(RESUME_STEPS),
            "--segment-chunks", str(RESUME_SEGMENT),
            "--checkpoint-dir", str(d)]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = {}
    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--inject-faults", "kill_at_segment=2"],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    out["killed_s"] = time.perf_counter() - t0
    check(proc.returncode == 17,
          f"launcher with kill_at_segment=2 exited {proc.returncode}, not "
          f"17: {proc.stderr[-2000:]}")
    names = sorted(p.name for p in d.iterdir())
    check("step_00000002.COMMITTED" in names
          and "step_00000003.COMMITTED" not in names,
          f"killed launcher left {names}")
    shutil.copytree(d, root / "crash_copy")
    bench = root / "BENCH_resume.json"
    t0 = time.perf_counter()
    proc = subprocess.run(base + ["--resume", "--bench-json", str(bench)],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    out["resumed_s"] = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"launcher --resume exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check("resumed from checkpoint step 2" in proc.stdout,
          f"launcher --resume did not resume: {proc.stdout[-2000:]}")
    for line in proc.stdout.splitlines():
        if any(k in line for k in ("resumable", "checkpoint:", "shuffle:")):
            log("resume", f"launcher --resume: {line.strip()}")
    doc = schema.load_document(bench)
    (row,) = doc["results"]
    check(row["scenario"] == "launch_malstone_b_mapreduce_resume"
          and row["derived"]["resumed_from_step"] == 2,
          f"launcher document: {row['scenario']} {row['derived']}")
    got = runner.run(checkpoint_dir=str(root / "crash_copy"))
    check(got.report.resumed_from_step == 2,
          f"resume from the killed launcher's copy: "
          f"{got.report.to_derived()}")
    same_outcome("resumed after a process exit", got, want, want_stats)
    log("resume", f"launcher killed by os._exit(17) at segment 2 in "
                  f"{out['killed_s']:.1f} s, --resume exited 0 in "
                  f"{out['resumed_s']:.1f} s; the killed run's copy "
                  f"resumed in process equals the engine")
    return out


def doctor_on_card(name: str, telemetry, device) -> dict:
    """NodeDoctor over a run's telemetry, after the run: K7 on the
    ``[hosts, buckets, 2]`` histogram the diagnosis builds, held against
    its plain version, and the report on the card (one K7 launch) against
    the same diagnosis on the CPU: rho and CUSUM bits, alarm, ranking."""
    import copy

    from repro_torch.common.types import SECONDS_PER_WEEK
    from repro_torch.core import nodedoctor
    from repro_torch.core.spm import site_week_histogram
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.windowed_ratio import ops as wr

    hosts, segments, buckets, failed = (
        torch.tensor(c, dtype=torch.int32, device=device)
        for c in zip(*telemetry._events))
    hist = site_week_histogram(
        nodedoctor.host_telemetry_log(hosts, segments,
                                      buckets * SECONDS_PER_WEEK, failed),
        telemetry.num_hosts, telemetry.num_buckets)
    shape = (telemetry.num_hosts, telemetry.num_buckets, 2)
    check(tuple(hist.shape) == shape and int(hist[..., 1].sum())
          == telemetry.failures,
          f"NodeDoctor ({name}): histogram {tuple(hist.shape)} with "
          f"{int(hist[..., 1].sum())} failures, expected {shape} with "
          f"{telemetry.failures}")
    err = exact(f"K7 in NodeDoctor ({name}) at {shape}",
                k7_outputs(wr.windowed_ratio(hist)),
                k7_outputs(wr.windowed_ratio_plain(hist)))
    sync(device)
    reset_launch_counts()
    got = telemetry.diagnose()
    sync(device)
    k7 = launch_counts()["windowed_ratio"]
    on_cpu = copy.copy(telemetry)
    on_cpu.device = "cpu"
    want = on_cpu.diagnose()
    check(k7 == 1 and got.rho.device.type == "cuda",
          f"NodeDoctor ({name}) on the card: {k7} K7 launches, rho on "
          f"{got.rho.device}")
    for f in ("rho", "cusum"):
        check(torch.equal(getattr(got, f).cpu().view(torch.int32),
                          getattr(want, f).view(torch.int32)),
              f"NodeDoctor ({name}): {f} on the card differs from the CPU")
    check(torch.equal(got.alarm.cpu(), want.alarm)
          and torch.equal(got.suspect_rank.cpu(), want.suspect_rank),
          f"NodeDoctor ({name}): alarm {got.alarm.tolist()} / "
          f"{want.alarm.tolist()}, rank {got.suspect_rank.tolist()} / "
          f"{want.suspect_rank.tolist()} (card / CPU)")
    return dict(events=len(telemetry), failures=telemetry.failures,
                alarm=want.alarm.tolist(),
                suspect_rank=want.suspect_rank.tolist(), max_abs_err=err)


def resume_faults(runner, want, want_stats, want_launches, device,
                  root: pathlib.Path) -> dict:
    """(4) Seeded faults with bounded retry (6 attempts) over 4 hosts.

    Transients at 25% a shard: an attempt passes only if all 8 shards do
    (0.75^8 = 0.10), and this schedule (seed 11) exhausts segment 2's six
    attempts, as on the CPU, since the coin is a function of the plan and
    the (segment, shard, host, attempt) only. The run raises
    ``SegmentRetriesExhausted`` after committing steps 1 and 2, and the
    resume without faults equals the engine: no record is lost. Host 0
    down: it alarms on the second attempt, its shards 0 and 4 move, and
    the run completes equal to the engine. K7 launches once a diagnosis
    (each failed attempt) and once for a finalize."""
    from repro_torch.faults import (
        FaultPlan,
        RetryPolicy,
        SegmentRetriesExhausted,
        TelemetryBuffer,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts

    retry = RetryPolicy(max_attempts=6, backoff_s=0.0)
    out = {}
    d = root / "transient"
    telemetry = TelemetryBuffer(RESUME_HOSTS, device=device)
    sync(device)
    reset_launch_counts()
    exhausted = None
    try:
        runner.run(checkpoint_dir=str(d),
                   faults=FaultPlan(seed=11, transient_rate=0.25,
                                    kill_mode="raise"),
                   retry=retry, num_hosts=RESUME_HOSTS,
                   telemetry=telemetry)
    except SegmentRetriesExhausted as e:
        exhausted = e
    sync(device)
    launches = launch_counts()
    check(exhausted is not None and exhausted.segment == 2
          and exhausted.attempts == 6,
          f"transients: expected segment 2 to exhaust its 6 attempts, got "
          f"{exhausted!r}")
    steps_done = 2 * RESUME_SEGMENT
    check(launches["count_scatter.count"] == steps_done
          and launches["powerlaw_sample"]
          == want_launches["powerlaw_sample"] * steps_done // RESUME_STEPS
          and launches["windowed_ratio"] >= retry.max_attempts,
          f"transients: launches {launches}")
    resumed = runner.run(checkpoint_dir=str(d))
    check(resumed.report.resumed_from_step == 2,
          f"transients: resumed {resumed.report.to_derived()}")
    same_outcome("resumed after exhausted retries", resumed, want,
                 want_stats)
    out["transient"] = dict(exhausted_segment=exhausted.segment,
                            k7_launches=launches["windowed_ratio"],
                            last_error=str(exhausted.last_error),
                            doctor=doctor_on_card("transients", telemetry,
                                                  device))
    log("resume", "faults transient (seed 11, 25%): segment 2 exhausted "
                  "its 6 attempts, as predicted; resumed from step 2 "
                  "without faults, equal to the engine; "
                  + json.dumps(out["transient"]))

    telemetry = TelemetryBuffer(RESUME_HOSTS, device=device)
    sync(device)
    reset_launch_counts()
    got = runner.run(faults=FaultPlan(bad_hosts=(0,), kill_mode="raise"),
                     retry=retry, num_hosts=RESUME_HOSTS,
                     telemetry=telemetry)
    sync(device)
    launches = launch_counts()
    rep = got.report
    same_outcome("faults badhost", got, want, want_stats)
    check(launches["windowed_ratio"] == 1 + rep.segments_retried
          and {k: v for k, v in launches.items() if k != "windowed_ratio"}
          == {k: v for k, v in want_launches.items()
              if k != "windowed_ratio"},
          f"faults badhost: launches {launches}, "
          f"{rep.segments_retried} retries")
    check(rep.alarmed_hosts == [0] and rep.rerouted_shards == 2,
          f"bad host 0: alarmed {rep.alarmed_hosts}, rerouted "
          f"{rep.rerouted_shards} (predicted [0], 2)")
    doctor = doctor_on_card("bad host 0", telemetry, device)
    check(doctor["alarm"] == [h in rep.alarmed_hosts
                              for h in range(RESUME_HOSTS)],
          f"bad host 0: the last diagnosis alarms {doctor['alarm']}, the "
          f"run rerouted from {rep.alarmed_hosts}")
    out["badhost"] = dict(rep.to_derived(),
                          k7_launches=launches["windowed_ratio"],
                          doctor=doctor)
    log("resume", "faults badhost (host 0 down): equals the engine; "
                  + json.dumps(out["badhost"]))
    return out


def resume_streams(device, root: pathlib.Path) -> dict:
    """(5) Streams at its full carry, 4 steps a node in segments of 2 with
    a checkpoint after each (2 x 332.8 MB), equal to the streaming engine
    with K4 once a step; then the restore."""
    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run_streaming
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.core.resume import ResumableRunner
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, make_seed_streaming

    cfg = MalGenConfig()
    num_chunks = NODES * RESUME_STREAMS_STEPS
    plan = ExchangePlan(histogram_impl="kernel")
    seed = make_seed_streaming(1, cfg, num_chunks, RESUME_CHUNK,
                               device=device)
    runner = ResumableRunner(
        seed, cfg, nodes=NODES, num_chunks=num_chunks,
        chunk_records=RESUME_CHUNK, segment_chunks=RESUME_SEGMENT,
        backend="streams", plan=plan, device=device)
    want_launches = runner_launches(OverlapStreamingRunner(
        seed, cfg, nodes=NODES, num_chunks=num_chunks,
        chunk_records=RESUME_CHUNK, backend="streams", plan=plan,
        device=device), [])
    want, _ = malstone_run_streaming(
        seed, cfg.num_sites, nodes=NODES, cfg=cfg, num_chunks=num_chunks,
        chunk_records=RESUME_CHUNK, backend="streams", statistic="B",
        plan=plan, device=device, return_shuffle_stats=True)
    d = root / "streams"
    sync(device)
    reset_launch_counts()
    got = runner.run(checkpoint_dir=str(d))
    sync(device)
    launches = launch_counts()
    check(launches == want_launches,
          f"streams resumable: launches {launches}, expected "
          f"{want_launches}")
    same_outcome("streams, checkpointed", got, want, None)
    step_bytes = dir_bytes(d / "step_00000002")
    carry_bytes = NODES * runner.s_pad * runner.num_weeks * 2 * 4
    check(step_bytes >= carry_bytes,
          f"streams checkpoint {step_bytes} bytes < carry {carry_bytes}")
    again = runner.run(checkpoint_dir=str(d))
    check(again.report.resumed_from_step == 2
          and again.report.segments_run == 0,
          f"streams restore: {again.report.to_derived()}")
    same_outcome("streams, restored", again, want, None)
    out = dict(launches=launches,
               save_ms_per_segment=got.report.checkpoint_save_ms
               / got.report.segments_run,
               bytes_per_checkpoint=step_bytes, carry_bytes=carry_bytes,
               restore_ms=again.report.checkpoint_restore_ms)
    log("resume", "streams at its full carry: equals the engine, launches "
                  + json.dumps(launches) + "; checkpoint "
                  + json.dumps({k: v for k, v in out.items()
                                if k != "launches"}))
    return out


def resume_bench(device) -> dict:
    """(7) The bench's ``faulty_run_transient`` at the bench's default 2
    nodes and phase 8's widths and depth, through ``run_scenarios`` (at
    8 nodes its schedule exhausts segment 2, as step 4 shows)."""
    from repro_torch.bench import registry, schema
    from repro_torch.bench.run import run_scenarios
    from repro_torch.core import malstone_run_streaming
    from repro_torch.faults import FaultPlan, RetryPolicy

    scale = registry.Scale(**BENCH_SMOKE)
    ctx = registry.BenchContext(nodes=2, device=device)
    doc = schema.new_document("torch_resume_chip", preset="smoke",
                              device=device)
    skipped = run_scenarios([BENCH_TRANSIENT], scale, ctx, doc)
    check(not skipped and len(doc["results"]) == 1,
          f"{BENCH_TRANSIENT}: {len(doc['results'])} rows, skipped "
          f"{skipped}")
    schema.validate_document(doc)
    (row,) = doc["results"]
    derived = row["derived"]
    check(derived["segments_run"] == derived["segments_total"]
          and derived["fault_events"] > 0,
          f"{BENCH_TRANSIENT}: derived {derived}")
    # the row's runner and plan once more, against the engine
    runner, _ = registry._resume_runner(scale, ctx)
    seed, num_chunks = ctx.seed(scale)
    got = runner.run(faults=FaultPlan(seed=11, transient_rate=0.25,
                                      kill_mode="raise"),
                     retry=RetryPolicy(max_attempts=6, backoff_s=0.0),
                     num_hosts=RESUME_HOSTS)
    check(got.report.to_derived() == derived,
          f"{BENCH_TRANSIENT}: rerun {got.report.to_derived()}, row "
          f"{derived}")
    want = malstone_run_streaming(
        seed, scale.num_sites, nodes=ctx.nodes, cfg=ctx.cfg(scale),
        num_chunks=num_chunks, chunk_records=scale.chunk_records,
        backend="streams", statistic="B", device=device)
    same_outcome(f"{BENCH_TRANSIENT} at 2 nodes", got, want, None)
    out = dict(us_per_call=row["us_per_call"],
               records_per_s=row["records_per_s"], derived=derived)
    log("bench", f"{BENCH_TRANSIENT} at 2 nodes: equals the streaming "
                 f"engine; " + json.dumps(out))
    return out


def resumable(device) -> dict:
    """Phase 10: (1) the resumable runner, mapreduce counting at full
    width, equal to the streaming engine with exact launches; (2) raised
    kills and resumes; (3) a real process exit of the launcher, resumed;
    (4) faults with retry and NodeDoctor rerouting; (5) streams at its
    full carry with checkpoints; (7) the bench's transient row at 2
    nodes; (6) timings, checkpoint cost and the card's idle share."""
    import shutil
    import tempfile

    from repro_torch.common.types import ExchangePlan
    from repro_torch.core import malstone_run_streaming
    from repro_torch.core.overlap import OverlapStreamingRunner
    from repro_torch.core.resume import ResumableRunner
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import MalGenConfig, make_seed_streaming

    t_phase = time.perf_counter()
    cfg = MalGenConfig()
    num_chunks = NODES * RESUME_STEPS
    total = num_chunks * RESUME_CHUNK
    plan = ExchangePlan(impl="counting", capacity_factor=CAPACITY_FACTOR,
                        histogram_impl="kernel")
    # rng seed 0: the launcher's, so that its checkpoints resume here
    seed = make_seed_streaming(0, cfg, num_chunks, RESUME_CHUNK,
                               device=device)
    runner = ResumableRunner(
        seed, cfg, nodes=NODES, num_chunks=num_chunks,
        chunk_records=RESUME_CHUNK, segment_chunks=RESUME_SEGMENT,
        backend="mapreduce", plan=plan, device=device)
    # the same chunks through the overlap runner's step: each step's
    # shuffle rounds, and so the exact launches of a run
    stepper = OverlapStreamingRunner(
        seed, cfg, nodes=NODES, num_chunks=num_chunks,
        chunk_records=RESUME_CHUNK, backend="mapreduce", plan=plan,
        device=device)
    rounds = step_rounds(stepper)
    want_launches = runner_launches(stepper, rounds)
    del stepper

    def engine():
        return malstone_run_streaming(
            seed, cfg.num_sites, nodes=NODES, cfg=cfg, num_chunks=num_chunks,
            chunk_records=RESUME_CHUNK, backend="mapreduce", statistic="B",
            plan=plan, device=device, return_shuffle_stats=True)

    want, want_stats = engine()
    check(int(want_stats.overflow) == 0 and int(want_stats.sent) == total,
          f"streaming engine: sent {int(want_stats.sent)} of {total}")

    # (1) the path, counted
    sync(device)
    reset_launch_counts()
    k9 = k9_module()
    k9.ship_buckets.launches = 0
    out = runner.run()
    sync(device)
    launches = launch_counts()
    check(launches == want_launches,
          f"resumable mapreduce: launches {launches}, expected "
          f"{want_launches}")
    k9_launches = k9.ship_buckets.launches
    check_k9("resumable mapreduce", k9_launches, launches, device)
    rep = out.report
    check(rep.segments_run == rep.segments_total == 4
          and rep.chunks_processed == num_chunks
          and rep.resumed_from_step is None,
          f"resumable mapreduce: report {rep.to_derived()}")
    same_outcome("resumable mapreduce", out, want, want_stats)
    log("resume", f"mapreduce counting, {NODES} x {RESUME_STEPS} steps of "
                  f"{RESUME_CHUNK:,} records in 4 segments: equals the "
                  f"streaming engine (histogram, rho bits, ShuffleStats "
                  f"{[int(x) for x in out.shuffle_stats]}); launches "
                  + json.dumps(launches) + f"; rounds a step {rounds}")
    result = {"launches": launches, "rounds": rounds,
              "k9_launches": k9_launches}

    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        result["checkpoint"] = resume_kills(runner, want, want_stats, root)
        result["crash"] = resume_crash(runner, want, want_stats, root)
        result["faults"] = resume_faults(runner, want, want_stats,
                                         want_launches, device, root)
        result["streams"] = resume_streams(device, root)
        result["bench"] = resume_bench(device)

        # (6) numbers: interleaved runs, then one profile of each mode
        modes = {"segmented": runner.run, "engine": engine}
        samples = {m: [] for m in modes}
        for turn in range(RESUME_TURNS):
            for m in (("segmented", "engine") if turn % 2 == 0
                      else ("engine", "segmented")):
                samples[m].append(time_ms(modes[m], device, iters=1,
                                          warmup=0))
        med = {m: statistics.median(v) for m, v in samples.items()}
        result["run_ms"] = samples
        result["median_ms"] = med
        fresh = iter(range(1000))
        prof = {
            "segmented": stream_profile(runner.run, device),
            "engine": stream_profile(engine, device),
            "checkpointed": stream_profile(lambda: runner.run(
                checkpoint_dir=str(root / f"profiled{next(fresh)}"),
                resume=False), device)}
        result["profile"] = {m: {k: p[k] for k in ("wall_ms", "busy_ms",
                                                   "idle_share")}
                             for m, p in prof.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = card_line()
    log("resume", f"[{card}] {total:,} records, {RESUME_TURNS} interleaved "
                  f"turns; run ms {json.dumps(samples)}; medians "
                  f"{json.dumps(med)}; segmented / engine "
                  f"{med['segmented'] / med['engine']:.4f}")
    log("resume", f"[{card}] checkpoint, mapreduce: "
                  + json.dumps(result["checkpoint"]) + "; streams: "
                  + json.dumps({k: v for k, v in result["streams"].items()
                                if k != "launches"}))
    log("resume", f"[{card}] profile (wall ms, busy ms, idle share): "
                  + json.dumps(result["profile"]))
    log("resume", f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return result


# ------------------------------------------------------------- phase 11
def gang_tool():
    """``tools/gang_check.py``, the gang's worker script, as a module."""
    sys.path.insert(0, str(ROOT / "tools"))
    import gang_check

    return gang_check


def run_in_session(args, timeout: float) -> tuple:
    """(exit status, stdout, stderr) of ``python args``, run in a session
    of its own: at the timeout the whole session (a gang's parent and its
    ranks) is killed, and the status is 124."""
    from repro_torch.launch import coordinator

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return coordinator.run_in_session([sys.executable, *args], cwd=ROOT,
                                      env=env, timeout=timeout)


def gang_launches(stepper, rounds, ranks: int) -> dict:
    """A rank's exact launches of one run of a gang of ``ranks`` over the
    stepper's chunks: K6 for the marked and unmarked draws of each of its
    nodes a step, K1 and K2 a step and K3 a round (mapreduce) or K4 a step
    (streams), K7 once (every rank finalizes)."""
    want = runner_launches(stepper, rounds)
    want["powerlaw_sample"] //= ranks
    return want


def gang(device, width: str = "full") -> dict:
    """Phase 11: gangs of ``tools/gang_check.py`` over gloo, their ranks
    sharing the card, at ``MalGenConfig()`` widths and 8 nodes x 8 steps of
    2^20 records: mapreduce counting at N = 1, 2 and 4 ranks in
    ``GANG_TURNS`` interleaved turns, and at N = 2 (first turn) streams
    and the overlap runner on and off. Every rank's histogram, rho bits and ShuffleStats
    equal this process's one-process engine; each rank launches exactly
    its nodes' kernels. Then the launcher's one-shot log at N = 2 with
    ``--check``. (``width="small"`` is gang_check's test width, for a
    rehearsal on the CPU.)"""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.common.types import ExchangePlan
    from repro_torch.core.overlap import OverlapStreamingRunner

    t_phase = time.perf_counter()
    gc = gang_tool()
    inputs = gc.make_inputs(width, NODES, device, with_log=False)
    cases = sorted({c for v in GANG_CASES.values() for c in v})
    want = {c: gc.result_arrays(*gc.case_result(c, inputs, NODES, device))
            for c in cases}
    expected = {}
    for backend in ("mapreduce", "streams"):
        stepper = OverlapStreamingRunner(
            inputs.seed, inputs.cfg, nodes=NODES,
            num_chunks=inputs.num_chunks, chunk_records=inputs.chunk_records,
            backend=backend, device=device,
            plan=ExchangePlan(impl="counting", histogram_impl="kernel"))
        expected[backend] = (stepper, step_rounds(stepper)
                             if backend == "mapreduce" else None)
    cfg, rpn = inputs.cfg, inputs.num_chunks // NODES * inputs.chunk_records
    total = NODES * rpn
    del inputs
    sync(device)
    result = {"ms": {n: [] for n in GANG_SIZES}, "clock": {}, "peak_gib": {},
              "idle_share": {}, "launches": {}}
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_gang_"))
    try:
        for turn in range(GANG_TURNS):
            order = GANG_SIZES if turn % 2 == 0 else GANG_SIZES[::-1]
            for n in order:
                names = GANG_CASES[n] if turn == 0 else (GANG_MAIN,)
                out = root / f"t{turn}n{n}"
                t0 = time.perf_counter()
                rc, stdout, stderr = run_in_session(
                    [str(ROOT / "tools" / "gang_check.py"),
                     "--num-processes", str(n), "--nodes", str(NODES),
                     "--width", width, "--device", device.type,
                     "--runs", "1", "--out", str(out),
                     "--timeout", str(GANG_TIMEOUT - 30), "--cases", *names]
                    + (["--profile"] if turn == 0 else []), GANG_TIMEOUT)
                wall = time.perf_counter() - t0
                check(rc == 0, f"gang of {n} exited {rc}: "
                               f"{stdout[-2000:]}\n{stderr[-3000:]}")
                ranks = [dict(np.load(out / f"rank{r}.npz"))
                         for r in range(n)]
                for name in names:
                    backend = gc.CASES[name]["backend"]
                    stepper, rounds = expected[backend]
                    launches = gang_launches(stepper, rounds, n)
                    for r, got in enumerate(ranks):
                        key = f"P{NODES}/{name}/"
                        for field, value in want[name].items():
                            a, b = got[key + field], value
                            if field == "rho":
                                a, b = a.view("int32"), b.view("int32")
                            check(a.shape == b.shape and (a == b).all(),
                                  f"gang of {n}, rank {r}, {name}: {field} "
                                  f"differs from the one-process engine")
                        got_l = {k: int(got[key + f"launches_{k}"])
                                 for k in launches}
                        check(got_l == launches,
                              f"gang of {n}, rank {r}, {name}: launches "
                              f"{got_l}, expected {launches}")
                        # K9, outside launch_counts(): once a round
                        got_l["k9"] = int(got[key + "launches_k9"])
                        check_k9(f"gang of {n}, rank {r}, {name}",
                                 got_l["k9"], got_l, device)
                        if r == 0:
                            counted = got_l
                    r0 = ranks[0]
                    key = f"P{NODES}/{name}/"
                    if name == GANG_MAIN:
                        result["ms"][n].append(float(r0[key + "ms"][0]))
                    if turn == 0:
                        tag = f"N={n} {name}"
                        result["launches"][tag] = counted   # rank 0's
                        result["clock"][tag] = {
                            k: float(r0[key + f"clock_{k}"]) for k in
                            ("bytes", "calls", "wait_ms", "d2h_ms",
                             "gloo_ms", "h2d_ms")}
                        # (a CPU rehearsal has neither)
                        result["peak_gib"][tag] = [
                            int(g[key + "peak_bytes"]) / 2**30
                            if key + "peak_bytes" in g else None
                            for g in ranks]
                        result["idle_share"][tag] = (
                            float(r0[key + "idle_share"])
                            if key + "idle_share" in r0 else None)
                        stats = [int(v) for k, v in want[name].items()
                                 if k.startswith("stats_")]
                        log("gang", f"{tag}: {n} rank(s) equal the "
                                    f"one-process engine (histogram, rho "
                                    f"bits, ShuffleStats {stats}); launches "
                                    f"a rank {json.dumps(counted)}; run ms "
                                    f"{float(r0[key + 'ms'][0]):.3f}; "
                                    f"exchange, rank 0, "
                                    f"{json.dumps(result['clock'][tag])}; "
                                    f"peak GiB a rank "
                                    f"{result['peak_gib'][tag]}; rank 0 idle "
                                    f"share {result['idle_share'][tag]}")
                log("gang", f"turn {turn}: gang of {n} in {wall:.1f} s wall "
                            f"(processes started, built, run)")

        # the launcher's one-shot log, checked against its CPU oracle on
        # every rank
        rc, stdout, stderr = run_in_session(
            ["-m", "repro_torch.launch.malstone", "--nodes", str(NODES),
             "--num-processes", "2",
             "--records-per-node", str(rpn), "--device", device.type,
             "--sites", str(cfg.num_sites),
             "--entities", str(cfg.num_entities),
             "--backend", "mapreduce", "--exchange-impl", "counting",
             "--capacity-factor", str(CAPACITY_FACTOR), "--runs", "2",
             "--check"], GANG_TIMEOUT)
        check(rc == 0 and stdout.count("bit-equals the single-device "
                                       "oracle") == 2,
              f"launcher one-shot gang of 2 exited {rc}: {stdout[-2000:]}"
              f"\n{stderr[-3000:]}")
        for line in stdout.splitlines():
            if any(k in line for k in ("[process", "run ", "exchange,",
                                       "--check", "shuffle:")):
                log("gang", f"launcher one-shot N=2: {line.strip()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = {n: statistics.median(v) for n, v in result["ms"].items()}
    result["median_ms"] = med
    card = card_line()
    log("gang", f"[{card}] mapreduce counting, {total:,} records, "
                f"{GANG_TURNS} interleaved turns; run ms by ranks "
                f"{json.dumps(result['ms'])}; medians {json.dumps(med)}; "
                f"N=2 / N=1 {med[2] / med[1]:.4f}, N=4 / N=1 "
                f"{med[4] / med[1]:.4f}")
    log("gang", f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return result


# ------------------------------------------------------------- phase 12
SANITIZER = pathlib.Path("/usr/local/cuda/bin/compute-sanitizer")
SANITIZER_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
# the tool's own message on a card it cannot attach to: the only reason
# the kernel checks are left out
SANITIZER_UNSUPPORTED = "Error: Device not supported"


def hopper_limits_on_card(device) -> None:
    from repro_torch.analysis import registry as lim

    props = torch.cuda.get_device_properties(device)
    want = {"max_threads_per_block": lim.MAX_THREADS_PER_BLOCK,
            "warp_size": lim.WARP_SIZE,
            "shared_memory_per_block": lim.SMEM_DEFAULT,
            "shared_memory_per_block_optin": lim.SMEM_PER_BLOCK_OPTIN,
            "shared_memory_per_multiprocessor": lim.SMEM_PER_SM,
            "max_threads_per_multi_processor": lim.MAX_THREADS_PER_SM}
    for attr, value in want.items():
        got = getattr(props, attr, None)
        if got is None:
            log("static", f"{attr}: not exposed by torch {torch.__version__}")
            continue
        check(got == value, f"the card's {attr} is {got}, the analysis "
                            f"registry says {value}")
    log("static", "Hopper's limits equal the card's properties "
                  f"({', '.join(want)}); the grid limits are not exposed")


def launch_plans_on_card(device) -> list:
    """Every analysis case once under the profiler (in a fresh process:
    ``kernel_passes.card_launches_in_child``), held against its plan;
    returns one row a planned launch."""
    from repro_torch.analysis import kernel_passes as kp

    sources = kp.read_sources()
    attrs = {name: kp.card_attributes(name) for name in sources}
    for name, src in sources.items():
        for k, (max_threads, _) in src.bounds.items():
            check(attrs[name][k]["max_threads"] == (max_threads or 1024),
                  f"{k}: the card takes blocks of up to "
                  f"{attrs[name][k]['max_threads']} threads, its "
                  f"__launch_bounds__ says {max_threads}")
    log("static", f"kernel attributes: {json.dumps(attrs)}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    diffs, rows = [], []
    t0 = time.perf_counter()
    try:
        card = kp.card_launches_in_child()
    except RuntimeError as e:
        check(False, str(e))
    for case in kp.kernel_analysis_cases():
        records = card[case["name"]]
        diffs += kp.compare_with_card(case, records, attrs[case["source"]],
                                      sms)
        for launch, rec in zip(case["plan"](sms), records):
            rows.append({"case": case["name"], "kernel": launch.kernel,
                         "grid": list(launch.grid), "block": launch.block[0],
                         "static_smem": case["static_smem"][launch.kernel],
                         "dynamic_smem": launch.dynamic_smem,
                         "registers": rec["registers"]})
    for d in diffs:
        log("static", f"MISMATCH {d}")
    check(not diffs, f"{len(diffs)} launch records differ from their plans")
    log("static", f"{len(rows)} launches of "
                  f"{len(kp.kernel_analysis_cases())} cases equal their "
                  f"plans for {sms} SMs ({time.perf_counter() - t0:.1f} s): "
                  f"{json.dumps(rows)}")
    return rows


def suite_on_card(device) -> dict:
    """The whole suite with its programs on the card: the driver family,
    and the collective family's exchanges and its gang of 2 sharing the
    card."""
    from repro_torch.analysis import (
        FAMILIES,
        AnalysisContext,
        diff_against_baseline,
        load_report,
        run_passes,
    )
    from repro_torch.analysis.cli import DEFAULT_BASELINE

    ctx = AnalysisContext(device=device)
    t0 = time.perf_counter()
    findings = run_passes(FAMILIES, ctx)
    diff = diff_against_baseline(findings, load_report(DEFAULT_BASELINE))
    syncs = {}
    for name, r in ctx.cache["driver_runs"].items():
        budget = ctx.cache["driver_targets"][name].budget(r.out)
        syncs[name] = {"counted": sum(r.syncs.values()), "budget": budget,
                       "card": r.card_syncs}
        log("static", f"{name}: {syncs[name]['counted']} host syncs on "
                      f"CUDA tensors (budget {budget}), {r.card_syncs} "
                      f"reported by the card")
    for note in ctx.notes:
        if not note.startswith("drivers:"):
            log("static", note)
    for f in diff.new:
        log("static", f"NEW {f.key}: {f.message}")
    check(not diff.new, f"{len(diff.new)} findings outside the baseline")
    log("static", f"suite on the card: {len(findings)} findings, none new "
                  f"({time.perf_counter() - t0:.1f} s)")
    return syncs


def sanitizer_child() -> int:
    """The seven kernels at small shapes (``--sanitizer-child``)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import count_scatter, powerlaw_sample
    from repro_torch.kernels import segment_hist as sh
    from repro_torch.kernels import windowed_ratio as wr

    d = torch.device("cuda")
    g = torch.Generator().manual_seed(12)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(d)

    dest, words = ints(5, 2, 5000), ints(1 << 20, 2, 5000)
    count_scatter.count_scatter(words, dest, 4)
    site, week, mark = ints(50, 2, 5000), ints(52, 2, 5000), ints(2, 2, 5000)
    valid = torch.ones(2, 5000, dtype=torch.bool, device=d)
    sh.segment_hist(site, week, mark, valid, num_sites=50)
    packed = (site << 8) | (week << 2) | (mark << 1) | 1
    sh.segment_hist_packed_words(packed, num_sites_local=25,
                                 num_partitions=2)
    hist = ints(100, 300, 52, 2)
    masks = (ints(2, 5, 52) > 0).contiguous()
    wr.masked_window_ratio(hist, masks, masks)
    wr.windowed_ratio(hist)
    cdf = torch.cumsum(torch.rand(300, generator=g), 0)
    cdf = (cdf / cdf[-1]).to(d)
    for n in (1000, 1 << 18):
        powerlaw_sample.powerlaw_sample(torch.rand(n, generator=g).to(d),
                                        cdf)
    torch.cuda.synchronize()
    print("sanitizer child: seven kernels ran")
    return 0


def sanitizer_checks() -> dict:
    if not SANITIZER.exists():
        log("static", f"compute-sanitizer: not at {SANITIZER}; left out")
        return {"present": False}
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    probe = subprocess.run(
        [str(SANITIZER), "--tool", "memcheck", "--error-exitcode", "9",
         sys.executable, "-c", "import torch; x = torch.ones(4, "
         "device='cuda'); print(float((x + 1).sum()))"],
        capture_output=True, text=True, timeout=180, env=env)
    said = probe.stdout + probe.stderr
    if probe.returncode != 0 and SANITIZER_UNSUPPORTED in said:
        log("static", f"compute-sanitizer: {SANITIZER_UNSUPPORTED!r} (exit "
                      f"{probe.returncode}); the kernel checks are left out")
        return {"present": True, "ran": False,
                "skipped": SANITIZER_UNSUPPORTED}
    check(probe.returncode == 0,
          f"compute-sanitizer --tool memcheck on a one-line torch program: "
          f"exit {probe.returncode}\n{said[-3000:]}")
    errors = {}
    for tool in SANITIZER_TOOLS:
        r = subprocess.run(
            [str(SANITIZER), "--tool", tool, "--error-exitcode", "9",
             sys.executable, str(ROOT / "chip_smoke.py"),
             "--sanitizer-child"],
            capture_output=True, text=True, timeout=300, env=env)
        check(r.returncode == 0 and "seven kernels ran" in r.stdout,
              f"compute-sanitizer --tool {tool}: exit {r.returncode}\n"
              f"{r.stdout[-3000:]}")
        errors[tool] = 0
        log("static", f"compute-sanitizer --tool {tool}: 0 errors")
    return {"present": True, "ran": True, "errors": errors}


def static_checks(device) -> dict:
    t0 = time.perf_counter()
    hopper_limits_on_card(device)
    rows = launch_plans_on_card(device)
    syncs = suite_on_card(device)
    san = sanitizer_checks()
    log("static", f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return {"launches": rows, "syncs": syncs, "sanitizer": san}


# ------------------------------------------------------------- phase 13
def toy_step(state, batch):
    """The one-parameter model of tests/test_runtime.py:16-22, in torch."""
    w, opt_step = state
    x = batch["tokens"].to(torch.float32)
    loss = torch.mean((x.mean() - w) ** 2)
    w = w - 0.1 * 2 * (w - x.mean())
    return (w, opt_step + 1), {"loss": loss}


def bad_host_hook(step, host):
    """tests/test_runtime.py's host-tied fault: the bad host fails every
    step it serves past step 8."""
    if host == TRAIN_BAD_HOST and step > TRAIN_BAD_AFTER:
        raise RuntimeError(f"flaky host {TRAIN_BAD_HOST}")


class FakeClock:
    """``time`` for the trainer module: ``monotonic`` adds 2^-10 s a call,
    so every step lasts exactly as long on the card as on the CPU and the
    straggler test cannot tell them apart."""

    def __init__(self):
        self.calls = 0

    def monotonic(self) -> float:
        self.calls += 1
        return self.calls / 1024.0


@contextlib.contextmanager
def trainer_patched(device, fake_clock: bool):
    """Count and time (host clock, to the device's end) each NodeDoctor
    diagnosis the trainer runs, and give it the fake clock if asked;
    yields the list of diagnosis ms."""
    from repro_torch.runtime import trainer as trainer_mod

    doctor_ms = []
    real_diagnose, real_time = trainer_mod.diagnose, trainer_mod.time

    def diagnose(*args, **kw):
        t0 = time.perf_counter()
        rep = real_diagnose(*args, **kw)
        sync(rep.alarm.device)
        doctor_ms.append((time.perf_counter() - t0) * 1e3)
        return rep

    trainer_mod.diagnose = diagnose
    if fake_clock:
        trainer_mod.time = FakeClock()
    try:
        yield doctor_ms
    finally:
        trainer_mod.diagnose, trainer_mod.time = real_diagnose, real_time


def make_trainer(device, batch_fn, ckpt_dir, hook, **kw):
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = TrainConfig(ckpt_dir=str(ckpt_dir), **dict(TRAIN_RUN, **kw))
    state = (torch.zeros((), device=device),
             torch.zeros((), dtype=torch.int32, device=device))
    return Trainer(cfg, toy_step, state, batch_fn, fault_hook=hook,
                   device=device)


def same_report(name: str, got, want, exact_losses: bool) -> float:
    """History steps and hosts, retries, restarts, final step and
    blocklist equal; losses equal or within rtol 1e-6. Returns the largest
    loss difference."""
    for key in ("final_step", "restarts", "retries", "blocklist"):
        check(got[key] == want[key],
              f"{name}: {key} {got[key]} vs {want[key]}")
    sh = [(h["step"], h["host"]) for h in got["history"]]
    check(sh == [(h["step"], h["host"]) for h in want["history"]],
          f"{name}: the histories' steps and hosts differ")
    diff = 0.0
    for a, b in zip(got["history"], want["history"]):
        d = abs(a["loss"] - b["loss"])
        diff = max(diff, d)
        check(d == 0.0 if exact_losses else d <= 1e-6 * abs(b["loss"]),
              f"{name}: step {a['step']} loss {a['loss']!r} vs "
              f"{b['loss']!r}")
    return diff


def trainer_doctor_and_k6(tr, pipe, device, card: str) -> dict:
    """The path's kernels against their plain versions at its shapes: K7
    on the trainer's ``[hosts, buckets, 2]`` histogram, K6 at a batch's
    unmarked draws and at the marked stream's; and the trainer's final
    diagnosis on the card against the CPU's (rho and CUSUM bits, alarm,
    ranking)."""
    import copy

    from repro_torch.core.nodedoctor import diagnose
    from repro_torch.core.spm import site_week_histogram
    from repro_torch.kernels.powerlaw_sample import ops as ps
    from repro_torch.kernels.windowed_ratio import ops as wr
    from repro_torch.malgen.seeding import draw_events

    cfg = tr.cfg
    hist = site_week_histogram(tr.telemetry.as_log(), cfg.telemetry_hosts,
                               cfg.doctor_buckets)
    shape = (cfg.telemetry_hosts, cfg.doctor_buckets, 2)
    check(tuple(hist.shape) == shape
          and int(hist[..., 1].sum()) == sum(tr.telemetry.mark),
          f"trainer doctor: histogram {tuple(hist.shape)}")
    err7 = exact(f"K7 in the trainer's doctor at {shape}",
                 k7_outputs(wr.windowed_ratio(hist)),
                 k7_outputs(wr.windowed_ratio_plain(hist)))
    got = diagnose(tr.telemetry.as_log(), cfg.telemetry_hosts,
                   num_buckets=cfg.doctor_buckets)
    on_cpu = copy.copy(tr.telemetry)
    on_cpu.device = torch.device("cpu")
    want = diagnose(on_cpu.as_log(), cfg.telemetry_hosts,
                    num_buckets=cfg.doctor_buckets)
    for f in ("rho", "cusum"):
        check(torch.equal(getattr(got, f).cpu().view(torch.int32),
                          getattr(want, f).view(torch.int32)),
              f"trainer doctor: {f} on the card differs from the CPU")
    check(torch.equal(got.alarm.cpu(), want.alarm)
          and torch.equal(got.suspect_rank.cpu(), want.suspect_rank),
          f"trainer doctor: alarm {got.alarm.tolist()} / "
          f"{want.alarm.tolist()} (card / CPU)")
    seed = pipe.malgen_seed
    u = pipe.malgen_draws(TRAIN_CHECK_STEP).u_site
    err6 = exact(f"K6 at a batch's {u.numel()} unmarked draws",
                 ps.powerlaw_sample(u, seed.unmarked_cdf),
                 ps.powerlaw_sample_plain(u, seed.unmarked_cdf))
    marked = draw_events(seed.rng_seed, "marked", 0, seed.num_marked_events,
                         pipe.malgen_cfg, device)
    sites = ps.powerlaw_sample(marked.u_site, seed.marked_cdf)
    err6 = max(err6, exact(
        f"K6 at the marked stream's {marked.u_site.numel()} draws", sites,
        ps.powerlaw_sample_plain(marked.u_site, seed.marked_cdf)))
    check(torch.equal(sites, pipe.marked[0]),
          "the pipeline's marked sites differ from K6 on its draws")
    ms = dict(
        k7=time_ms(lambda: wr.windowed_ratio(hist), device, iters=20),
        k7_plain=time_ms(lambda: wr.windowed_ratio_plain(hist), device,
                         iters=20),
        k6=time_ms(lambda: ps.powerlaw_sample(u, seed.unmarked_cdf), device,
                   iters=20),
        k6_plain=time_ms(lambda: ps.powerlaw_sample_plain(
            u, seed.unmarked_cdf), device, iters=20))
    log("train", f"{card}: K7 at {shape} {ms['k7']:.4f} ms (plain "
                 f"{ms['k7_plain']:.4f}); K6 at {u.numel()} draws over "
                 f"{seed.unmarked_cdf.numel()} sites {ms['k6']:.4f} ms "
                 f"(plain {ms['k6_plain']:.4f}); wrapper calls, CUDA events")
    return dict(max_abs_err=max(err6, err7), alarm=want.alarm.tolist(), **ms)


def trainer_bad_host(device, root: pathlib.Path, card: str) -> dict:
    """(a) The trainer at the JAX launcher's defaults with host 5 failing,
    on the real clock and then, with the CPU, on the fake one."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.malgen import EventDraws

    data = DataConfig(**TRAIN_DATA)
    made = []

    def batch_fn(step):
        made.append(step)
        return pipe.batch_at(step)

    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    pipe = TokenPipeline(data, device=device)
    sync(device)
    pipe_ms = (time.perf_counter() - t0) * 1e3
    tr = make_trainer(device, batch_fn, root / "real", bad_host_hook)
    straggles = []
    real_straggled = tr.telemetry.straggled

    def straggled(duration, factor):
        if real_straggled(duration, factor):
            straggles.append(duration * 1e3)
            return True
        return False

    tr.telemetry.straggled = straggled
    with trainer_patched(device, fake_clock=False) as doctor_ms:
        t0 = time.perf_counter()
        report = tr.run()
        wall = time.perf_counter() - t0
    sync(device)
    launches = launch_counts()
    hist = report["history"]
    tail = {h["host"] for h in hist[-16:]}
    check(report["final_step"] == TRAIN_RUN["total_steps"],
          f"trainer: final step {report['final_step']}")
    check(TRAIN_BAD_HOST in report["blocklist"],
          f"trainer: blocklist {report['blocklist']} lacks host "
          f"{TRAIN_BAD_HOST}")
    check(TRAIN_BAD_HOST not in tail,
          f"trainer: host {TRAIN_BAD_HOST} served one of the last 16 steps")
    check(launches["windowed_ratio"] == len(doctor_ms),
          f"trainer: {launches['windowed_ratio']} K7 launches for "
          f"{len(doctor_ms)} doctor runs")
    check(launches["powerlaw_sample"] == len(made) + 1,
          f"trainer: {launches['powerlaw_sample']} K6 launches for "
          f"{len(made)} batches and the marked stream")
    others = {k: v for k, v in launches.items()
              if k not in ("windowed_ratio", "powerlaw_sample") and v}
    check(not others, f"trainer: other kernels launched: {others}")
    durs = [h["dur"] * 1e3 for h in hist]
    out = dict(
        launches=dict(launches), batches=len(made), doctor_runs=len(doctor_ms),
        steps=len(hist), wall_s=wall, steps_per_s=len(hist) / wall,
        steps_per_s_without_doctor=len(hist) / (wall - sum(doctor_ms) / 1e3),
        step_ms_p50=statistics.median(durs), straggles_ms=straggles,
        doctor_ms_p50=statistics.median(doctor_ms), pipeline_ms=pipe_ms,
        blocklist=report["blocklist"], retries=report["retries"],
        restarts=report["restarts"])
    log("train", f"{card}: {out['steps']} steps in {wall:.3f} s = "
                 f"{out['steps_per_s']:.1f} steps/s "
                 f"({out['steps_per_s_without_doctor']:.1f} without the "
                 f"doctor runs; step p50 {out['step_ms_p50']:.3f} ms, host "
                 f"clock; straggles marked {straggles} ms), "
                 f"{out['retries']} retries, {out['restarts']} restarts, "
                 f"blocklist {out['blocklist']}; {len(doctor_ms)} doctor runs, "
                 f"p50 {out['doctor_ms_p50']:.3f} ms, max "
                 f"{max(doctor_ms):.3f}; {len(made)} batches; pipeline built "
                 f"in {pipe_ms:.1f} ms; launches K6 "
                 f"{launches['powerlaw_sample']}, K7 "
                 f"{launches['windowed_ratio']}")
    out.update(trainer_doctor_and_k6(tr, pipe, device, card))

    # the same run on the fake clock, on the card and then on the CPU on
    # the card's batches
    card_batches = {}

    def card_fn(step):
        card_batches[step] = pipe.batch_at(step)
        return card_batches[step]

    def cpu_fn(step):
        b = card_batches[step] if step in card_batches else pipe.batch_at(step)
        return {k: v.cpu() for k, v in b.items()}

    cpu = torch.device("cpu")
    with trainer_patched(device, fake_clock=True):
        on_card = make_trainer(device, card_fn, root / "fake_card",
                               bad_host_hook).run()
    with trainer_patched(cpu, fake_clock=True):
        on_cpu = make_trainer(cpu, cpu_fn, root / "fake_cpu",
                              bad_host_hook).run()
    diff = same_report("trainer on the fake clock, card against CPU",
                       on_card, on_cpu, exact_losses=False)
    check(TRAIN_BAD_HOST in on_card["blocklist"],
          f"trainer on the fake clock: blocklist {on_card['blocklist']}")
    log("train", f"{card}: fake clock: card equals CPU ({len(on_card['history'])}"
                 f" steps, {on_card['retries']} retries, "
                 f"{on_card['restarts']} restarts, blocklist "
                 f"{on_card['blocklist']}; max loss difference {diff!r})")
    # one card batch against the CPU path given the card's draws and seed
    cpu_pipe = TokenPipeline(data, device="cpu",
                             seed=pipe.malgen_seed.to("cpu"),
                             marked=tuple(x.cpu() for x in pipe.marked))
    draws = pipe.malgen_draws(TRAIN_CHECK_STEP)
    want = cpu_pipe.tokens_at(TRAIN_CHECK_STEP, unmarked=EventDraws(
        *(x.cpu() for x in draws)))
    got = pipe.tokens_at(TRAIN_CHECK_STEP).cpu()
    check(torch.equal(got, want) and got.shape == (
        TRAIN_DATA["global_batch"], TRAIN_DATA["seq_len"] + 1),
          f"batch {TRAIN_CHECK_STEP}: the card's tokens differ from the "
          f"CPU path's on the card's draws")
    out.update(fake_loss_diff=diff, pipe=pipe)
    return out


def trainer_resume(device, pipe, root: pathlib.Path, card: str) -> None:
    """(b) A run of 20 steps dropped, a new trainer resumed from its
    checkpoint, against an uninterrupted run of 25 (fake clock)."""
    kw = dict(total_steps=25)
    with trainer_patched(device, fake_clock=True):
        first = make_trainer(device, pipe.batch_at, root / "crash", None,
                             **kw)
        first.cfg.total_steps = 20
        first.run()
        del first
        second = make_trainer(device, pipe.batch_at, root / "crash", None,
                              **kw)
        start = second.resume_if_possible()
        report = second.run()
        whole = make_trainer(device, pipe.batch_at, root / "whole", None,
                             **kw)
        want = whole.run()
    check(start == 20 and report["final_step"] == 25,
          f"resume: started at {start}, ended at {report['final_step']}")
    tail = dict(want, history=[h for h in want["history"]
                               if h["step"] >= 20])
    same_report("resumed trainer against an uninterrupted run", report,
                tail, exact_losses=True)
    check(torch.equal(second.state[0].view(torch.int32),
                      whole.state[0].view(torch.int32))
          and int(second.state[1]) == int(whole.state[1]) == 25,
          "resume: the final state differs from the uninterrupted run's")
    log("train", f"{card}: resumed at 20, steps 20-24 equal to the "
                 f"uninterrupted run's")


def bf16_moments_close(a: torch.Tensor, b: torch.Tensor,
                       old: torch.Tensor) -> tuple:
    """Two bf16 moments from one update: ``(ok, max ulps)``. ``ok`` holds
    each pair within one bf16 ulp of the larger, plus 2^-20 of the
    magnitude of the terms the f32 update summed (``|new| + |old|``):
    where ``b1 * mu`` and ``(1 - b1) * g`` cancel, the clip factor's one
    f32 ulp (the grad norm's reduction order) is more than a bf16 ulp of
    the small result. ``max ulps`` is in ulps of the larger value."""
    af, bf = a.to(torch.float32), b.to(torch.float32)
    big = torch.maximum(af.abs(), bf.abs())
    _, e = torch.frexp(big)
    ulp = torch.ldexp(torch.ones_like(big), (e - 8).clamp(min=-133))
    diff = (af - bf).abs()
    slack = ulp + (big + old.to(torch.float32).abs()) * 2.0**-20
    return bool((diff <= slack).all()), float((diff / ulp).max())


def adamw_full_width(device, card: str) -> dict:
    """(c) AdamW and int8 error feedback at one llama3-8b decoder layer's
    width: 3 updates with f32 and with bf16 moments, each held against the
    CPU's update of the same inputs, then timed against its byte bound;
    ``tree_ef_compress`` on the card bit-equal to the CPU."""
    from repro_torch.common import tree as tr
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim import compress_int8
    from repro_torch.optim.compression import tree_ef_compress

    cpu = torch.device("cpu")
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    g = torch.Generator(device=device)
    g.manual_seed(ADAMW_SEED)

    def leaves(scale):
        return {k: torch.randn(s, generator=g, device=device) * scale
                for k, s in LLAMA_LAYER.items()}

    params = leaves(0.02)
    grads = [leaves(1e-3) for _ in range(ADAMW_STEPS)]
    n = tr.tree_count_params(params)
    check(n == LLAMA_LAYER_PARAMS, f"llama3-8b layer: {n} parameters")
    on_cpu = lambda t: tr.tree_map(lambda x: x.to(cpu), t)  # noqa: E731
    on_card = lambda t: tr.tree_map(lambda x: x.to(device), t)  # noqa: E731
    out = {}
    for md in ("float32", "bfloat16"):
        cfg = AdamWConfig(moment_dtype=md)
        p, state = params, adamw_init(params, cfg)
        worst = dict(params=0.0, mu=0.0, nu=0.0, grad_norm=0.0)
        t0 = time.perf_counter()
        for i in range(ADAMW_STEPS):
            p_new, s_new, m = adamw_update(p, grads[i], state, cfg)
            cp, cs, cm = adamw_update(on_cpu(p), on_cpu(grads[i]),
                                      on_cpu(state), cfg)
            check(s_new.step.dtype == cs.step.dtype == torch.int32
                  and int(s_new.step) == int(cs.step) == i + 1,
                  f"AdamW ({md}): step {int(s_new.step)} / {int(cs.step)}")
            gn = abs(float(m["grad_norm"]) - float(cm["grad_norm"]))
            worst["grad_norm"] = max(worst["grad_norm"],
                                     gn / float(cm["grad_norm"]))
            groups = (("params", p_new, cp, p), ("mu", s_new.mu, cs.mu,
                                                 state.mu),
                      ("nu", s_new.nu, cs.nu, state.nu))
            for part, got_t, want_t, old_t in groups:
                for (name, a), b, old in zip(
                        tr.tree_flatten_with_paths(got_t),
                        tr.tree_leaves(on_card(want_t)),
                        tr.tree_leaves(old_t)):
                    check(a.dtype == b.dtype and a.shape == b.shape,
                          f"AdamW ({md}) {part}/{name}: {a.dtype} vs "
                          f"{b.dtype}")
                    if a.dtype == torch.bfloat16:
                        ok, ulps = bf16_moments_close(a, b, old)
                        worst[part] = max(worst[part], ulps)
                        check(ok, f"AdamW ({md}) {part}/{name}: {ulps} bf16 "
                                  f"ulps from the CPU")
                        continue
                    d = (a - b).abs()
                    ok = bool((d <= 1e-6 + 1e-5 * b.abs()).all())
                    worst[part] = max(worst[part], float(d.max()))
                    check(ok, f"AdamW ({md}) {part}/{name}: max |card - CPU| "
                              f"{float(d.max())} beyond rtol 1e-5, atol 1e-6")
                    del d
            del cp, cs
            p, state = p_new, s_new
        checked_s = time.perf_counter() - t0
        times = []
        for _ in range(ADAMW_TURNS + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            adamw_update(p, grads[0], state, cfg)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        ms = statistics.median(times[1:])
        # the norm pass reads g; the update reads p, g, mu and nu and
        # writes p, mu and nu
        moved = (2 * tr.tree_bytes(grads[0]) + 2 * tr.tree_bytes(p)
                 + 2 * tr.tree_bytes(state.mu) + 2 * tr.tree_bytes(state.nu))
        bound = moved / HBM_BYTES_PER_S * 1e3
        out[md] = dict(ms=ms, bound_ms=bound, bytes=moved,
                       times=times[1:], worst=worst, checked_s=checked_s)
        log("adamw", f"{card}: {md} moments: one update of {n:,} parameters "
                     f"{ms:.3f} ms (median of {ADAMW_TURNS}, CUDA events; "
                     f"{times[1:]}) against a bound of {bound:.3f} ms "
                     f"({moved:,} B at 3.35 TB/s): {ms / bound:.2f}x; "
                     f"card against CPU over {ADAMW_STEPS} steps: {worst} "
                     f"(params and f32 moments max |diff|, bf16 moments in "
                     f"ulps of the larger value, grad_norm relative); "
                     f"checked in "
                     f"{checked_s:.1f} s")
        del p, state
    # int8 error feedback: two rounds, the second with the first's errors
    errors = tr.tree_map(torch.zeros_like, grads[0])
    for r in range(2):
        est, new_err = tree_ef_compress(grads[r], errors)
        c_est, c_err = tree_ef_compress(on_cpu(grads[r]), on_cpu(errors))
        for part, a_t, b_t in (("estimate", est, c_est),
                               ("error", new_err, c_err)):
            for (name, a), b in zip(tr.tree_flatten_with_paths(a_t),
                                    tr.tree_leaves(b_t)):
                check(torch.equal(a.view(torch.int32).cpu(),
                                  b.view(torch.int32)),
                      f"int8 EF round {r} {part}/{name}: card and CPU bits "
                      f"differ")
        for name, x in tr.tree_flatten_with_paths(grads[r]):
            target = x + errors[name]
            q, s = compress_int8(target)
            cq, cs = compress_int8(target.cpu())
            check(torch.equal(q.cpu(), cq)
                  and torch.equal(s.view(torch.int32).cpu(),
                                  cs.view(torch.int32)),
                  f"int8 round {r} {name}: q or scale bits differ")
        errors = new_err
    ef_ms = time_ms(lambda: tree_ef_compress(grads[0], errors), device)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    out.update(ef_ms=ef_ms, peak_gib=peak / 2**30, before_gib=before / 2**30)
    log("adamw", f"{card}: int8 error feedback bit-equal to the CPU (q, "
                 f"scale, estimate, error; 2 rounds); one tree_ef_compress "
                 f"{ef_ms:.3f} ms; peak device memory {peak / 2**30:.3f} GiB "
                 f"({before / 2**30:.3f} before)")
    return out


def trainer_phase(device, card: str) -> dict:
    t0 = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        bad = trainer_bad_host(device, root, card)
        pipe = bad.pop("pipe")
        trainer_resume(device, pipe, root, card)
        del pipe
        opt = adamw_full_width(device, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("train", f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return dict(trainer=bad, adamw=opt)


# ------------------------------------------------------------- phase 14
def tf32_state() -> str:
    return (f"TF32 flags: torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            f"torch.backends.cudnn.allow_tf32="
            f"{torch.backends.cudnn.allow_tf32} (no cuDNN op runs), "
            f"float32 matmul precision "
            f"{torch.get_float32_matmul_precision()!r}")


@contextlib.contextmanager
def recorded_routes(forced=None):
    """Each MoE call's router input, weights, probabilities and expert
    choices (``[n, g, k]``), and its dropped fraction, as the forward runs,
    in call order (copied to the host). With ``forced`` (another run's
    records), call i keeps its own record but routes by ``forced[i]``'s
    choices, its gate values taken from its own probabilities, so that
    everything after the router can be compared with that run."""
    from repro_torch.models import mlp as M

    routes = []
    real_route, real_apply = M.moe_route, M.moe_apply

    def moe_route(router, xg, top_k):
        probs, gates, idx = real_route(router, xg, top_k)
        routes.append(dict(router=router.cpu(), x=xg.cpu(),
                           probs=probs.cpu(), idx=idx.cpu()))
        if forced is not None:
            idx = forced[len(routes) - 1]["idx"].to(idx.device)
            gates = torch.gather(probs, -1, idx)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
        return probs, gates, idx

    def moe_apply(p, x, **kw):
        y, metrics = real_apply(p, x, **dict(kw, return_metrics=True))
        routes[-1]["dropped"] = float(metrics["moe_dropped_frac"])
        return y

    M.moe_route, M.moe_apply = moe_route, moe_apply
    try:
        yield routes
    finally:
        M.moe_route, M.moe_apply = real_route, real_apply


def same_routes(arch: str, card, cpu, top_k: int) -> dict:
    """The card's MoE choices against the CPU's, call by call: (a) on the
    card's router input the CPU chooses exactly what the card chose; (b)
    where the CPU's own choices (on its own input, which drifts by float
    order from the card's) differ, each is explained by that drift: with
    delta = max |p_card - p_cpu|, the CPU's probability of the card's j-th
    choice is within 2 delta of its own j-th largest, for every j (order
    statistics move by at most delta); (c) the dropped fractions, with
    the CPU routed by the card's choices, are equal."""
    from repro_torch.models import mlp as M

    check(len(card) == len(cpu), f"{arch}: {len(card)} / {len(cpu)} MoE "
                                 f"calls")
    flips, worst_delta = 0, 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        _, _, idx = M.moe_route(a["router"], a["x"], top_k)
        check(torch.equal(idx, a["idx"]), f"{arch}: MoE call {i}: the CPU "
              f"routes the card's input differently from the card")
        delta = float((a["probs"] - b["probs"]).abs().max())
        worst_delta = max(worst_delta, delta)
        at_card = torch.gather(b["probs"], -1, a["idx"])
        at_cpu = torch.gather(b["probs"], -1, b["idx"])
        gap = float((at_card - at_cpu).abs().max())
        check(gap <= 2 * delta, f"{arch}: MoE call {i}: a choice the card "
              f"made is {gap} below the CPU's, beyond 2 x the drift {delta}")
        flips += int((a["idx"] != b["idx"]).any(-1).sum())
        check(a["dropped"] == b["dropped"], f"{arch}: MoE call {i}: dropped "
              f"{a['dropped']} / {b['dropped']} under the same choices")
    return dict(calls=len(card), flips=flips, prob_drift=worst_delta,
                dropped=[a["dropped"] for a in card])


def model_cfg(arch: str, layers=None, f32: bool = False):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, param_dtype="float32",
                                  compute_dtype="float32")
    return cfg


def model_batch(cfg, seq: int, device, seed: int, b: int = 1) -> dict:
    """B = ``b`` (1 unless asked): ``seq`` positions (for a VLM the patch
    prefix and the rest tokens), labels the tokens; frames for an
    encoder-decoder, at the compute dtype, 0.1 x a normal draw."""
    g = torch.Generator(device=device).manual_seed(seed)
    dt = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16
    n_tok = seq - (cfg.num_patches if cfg.family == "vlm" else 0)
    toks = torch.randint(0, cfg.vocab_size, (b, n_tok), generator=g,
                         device=device, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["patches"] = (0.1 * torch.randn(
            (b, cfg.num_patches, cfg.d_model), generator=g,
            device=device)).to(dt)
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.1 * torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=g,
            device=device)).to(dt)
    return batch


def causality(params, cfg, batch: dict) -> float:
    """The largest change of the earlier positions' logits when the last
    token changes. A MoE runs at capacity factor 8.0 here, as JAX's
    causality test does (``tests/test_models.py:21-25``): where a group
    drops tokens, the last token's first choice takes a slot that can push
    an earlier token's second choice past the capacity (GShard's
    priority), so causality holds only without drops. Even without drops
    that choice moves the slot index of earlier tokens' later choices, and
    with it where their terms fall in the combine product's K = E x C
    reduction, so their sums round differently (one MoE layer at
    granite-moe's width moves earlier rows by 1.2e-7, on the card and on
    the CPU alike), and the next layer's bf16 dispatch turns that into
    bf16 ulps: a MoE's earlier logits are not bit-stable."""
    import dataclasses

    from repro_torch.models import transformer as T

    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    toks = batch["tokens"].clone()
    toks[:, -1] = (toks[:, -1] + 7) % cfg.vocab_size
    first = T.forward(params, cfg, batch)[:, :-1]
    later = T.forward(params, cfg, {**batch, "tokens": toks})[:, :-1]
    return float((later - first).abs().max())


def forward_flops(cfg, batch: dict) -> int:
    """The matmul FLOPs of one forward as the code computes them (every kv
    chunk, masked or not; the MoE's E x C slots a group; the dispatch and
    combine products; the WKV loop's products a token), counted by
    ``FlopCounterMode`` over the same forward on the meta device. A
    stacked model (its pattern repeated n times) is counted at one
    repetition, each layer's FLOPs (its cross-attention projections
    included) taken as it runs: the other n - 1 repetitions run the same
    ops on the same shapes, so the total is exact. (rwkv6-7b's 4,096-step
    loop takes seconds a layer on meta.)"""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import transformer as T

    period = cfg.uniform_period
    n_rep = cfg.num_layers // period if period < cfg.num_layers else 1
    one = dataclasses.replace(cfg, num_layers=period) if n_rep > 1 else cfg
    meta = torch.device("meta")
    params, _ = T.init_params(one, device=meta)
    shapes = {k: torch.empty(v.shape, dtype=v.dtype, device=meta)
              for k, v in batch.items()}
    per_layer, real = [], T._layer_params

    def layer_params(p, c):
        for item in real(p, c):
            before = counter.get_total_flops()
            yield item
            per_layer.append(counter.get_total_flops() - before)

    T._layer_params = layer_params
    try:
        with FlopCounterMode(display=False) as counter:
            T.forward(params, one, shapes)
    finally:
        T._layer_params = real
    return counter.get_total_flops() + (n_rep - 1) * sum(per_layer)


@contextlib.contextmanager
def recorded_blocks():
    """Each decoder block's ``(layer, params, input, output)`` as the
    forward runs, in call order."""
    from repro_torch.models import transformer as T

    blocks, real = [], T.block_apply

    def block_apply(lp, cfg, layer, x, **kw):
        y = real(lp, cfg, layer, x, **kw)
        blocks.append((layer, lp, x, y))
        return y

    T.block_apply = block_apply
    try:
        yield blocks
    finally:
        T.block_apply = real


def close_f32(name: str, got, want, tol: float) -> float:
    """``got`` (anywhere) within rtol = atol = ``tol`` of ``want`` (on the
    CPU); returns the largest |difference|."""
    d = (got.cpu() - want).abs()
    err = float(d.max())
    check(bool((d <= tol + tol * want.abs()).all()),
          f"{name}: card against CPU max |diff| {err} beyond {tol}")
    return err


def model_card_vs_cpu(device, card: str) -> dict:
    """(1) Full width, 2 layers, f32 on both sides from the same
    parameters. The router's choices first (``same_routes``); then block
    by block, each on the card's input to it: outputs within 2e-3 (2e-2
    for MoE), and the head on the card's last hidden state within 2e-3;
    then end to end: logits and loss within 2e-3 for the dense models,
    the loss within 2e-2 for the MoE (the CPU routed by the card's
    choices: its logits' difference is printed, since the bf16 dispatch
    rounds the float drift of earlier layers into bf16 ulps); and
    causality at f32 on the card: within 1e-5, 2e-2 for the MoE, whose
    slots are not bit-stable (``causality``)."""
    from repro_torch.common import tree as tr
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    out = {}
    for arch, layers, seq in MODEL_CHECKS:
        t0 = time.perf_counter()
        cfg = model_cfg(arch, layers, f32=True)
        moe = cfg.family == "moe"
        tol = 2e-2 if moe else 2e-3
        gen = torch.Generator(device=device).manual_seed(MODEL_SEED)
        p, _ = T.init_params(cfg, generator=gen, device=device)
        batch = model_batch(cfg, seq, device, MODEL_SEED)
        to_cpu = lambda tree: tr.tree_map(lambda x: x.to(cpu), tree)  # noqa: E731
        with torch.inference_mode():
            with recorded_routes() as card_routes:
                with recorded_blocks() as blocks:
                    got = T.forward(p, cfg, batch)
                loss, _ = T.lm_loss(p, cfg, batch)
            cpu_p = to_cpu(p)
            cpu_batch = {k: v.to(cpu) for k, v in batch.items()}
            with recorded_routes(forced=card_routes) as cpu_routes:
                want = T.forward(cpu_p, cfg, cpu_batch)
                cpu_loss, _ = T.lm_loss(cpu_p, cfg, cpu_batch)
            block_err = 0.0
            for layer, lp, x, y in blocks:
                block_err = max(block_err, close_f32(
                    f"{arch} block {layer} on the card's input", y,
                    T.block_apply(to_cpu(lp), cfg, layer, x.to(cpu)), tol))
            head = cpu_p["embed"] if cfg.tie_embeddings else cpu_p["unembed"]
            head_err = close_f32(
                f"{arch} head on the card's last hidden state", got,
                L.unembed(head, T._norm(cfg, cpu_p["final_norm"],
                                        blocks[-1][3].to(cpu)),
                          cfg.logit_softcap), 2e-3)
            del blocks
            causal = causality(p, cfg, batch)
        del cpu_p
        # forward and lm_loss each route every MoE layer once
        check(len(card_routes) == (2 * cfg.num_layers if moe else 0),
              f"{arch}: {len(card_routes)} MoE calls")
        routed = (same_routes(arch, card_routes, cpu_routes,
                              cfg.num_experts_per_tok) if moe else None)
        del card_routes, cpu_routes
        d = (got.cpu() - want).abs()
        err = float(d.max())
        check(moe or bool((d <= tol + tol * want.abs()).all()),
              f"{arch}: card against CPU at f32: logits max |diff| {err} "
              f"beyond {tol}")
        loss_err = abs(float(loss) - float(cpu_loss))
        check(loss_err <= tol + tol * abs(float(cpu_loss)),
              f"{arch}: card against CPU at f32: loss |diff| {loss_err} "
              f"beyond {tol}")
        causal_bar = 2e-2 if moe else 1e-5
        check(causal <= causal_bar, f"{arch}: f32 causality: earlier logits "
                                    f"moved by {causal} (bar {causal_bar})")
        out[arch] = dict(max_abs_err=err, loss_err=loss_err, causal=causal,
                         block_err=block_err, head_err=head_err,
                         routes=routed, seconds=time.perf_counter() - t0)
        log("model", f"{card}: {arch} f32, {cfg.num_layers} layers, S={seq}: "
                     + (f"{routed['calls']} MoE calls: the CPU routes the "
                        f"card's inputs as the card did, on its own inputs "
                        f"{routed['flips']} token(s) otherwise, all within "
                        f"2 x the probability drift "
                        f"{routed['prob_drift']:.3e}; dropped fractions "
                        f"{routed['dropped']}; " if moe else "")
                     + f"card against CPU, blocks on the card's inputs max "
                       f"|diff| {block_err:.3e} (bar {tol}), head "
                       f"{head_err:.3e} (bar 2e-3); end to end logits max "
                       f"|diff| {err:.3e} "
                     + ("(the CPU routed by the card's choices; not held) "
                        if moe else f"(bar {tol}) ")
                     + f"and loss {loss_err:.3e} (bar {tol}); f32 causality "
                       f"max |diff| {causal:.3e} (bar {causal_bar}); "
                       f"{out[arch]['seconds']:.1f} s")
        if arch in RECURRENT_ARCHS:
            with torch.inference_mode():
                out[arch]["decode"] = decode_vs_block(arch, p, cfg, device,
                                                      card)
        del p, got, want, batch
    return out


def decode_vs_block(arch: str, params, cfg, device, card: str) -> dict:
    """On the card, full width and f32, each recurrent function of the
    first layer: the block with its state over the first DECODE_LEN - 1
    tokens of a seeded normal input, then one decode step on the last
    token, against the block over all DECODE_LEN at that token, within
    2e-3 (JAX's decode bar, ``tests/test_models.py``)."""
    from repro_torch.models import rglru as R
    from repro_torch.models import rwkv6 as W
    from repro_torch.models import transformer as T

    _, lp = next(T._layer_params(params, cfg))
    g = torch.Generator(device=device).manual_seed(MODEL_SEED)
    x = torch.randn((1, DECODE_LEN, cfg.d_model), generator=g, device=device)
    s = DECODE_LEN - 1
    errs = {}
    if cfg.mixer_of(0) == "rglru":
        full = R.rglru_block(lp["mixer"], x)
        _, state = R.rglru_block(lp["mixer"], x[:, :s], return_state=True)
        step, _ = R.rglru_decode_step(lp["mixer"], x[:, s:], state)
        errs["rglru_decode_step"] = close_f32(
            f"{arch} rglru_decode_step after {s} tokens", step,
            full[:, s:].cpu(), 2e-3)
    else:
        hs = cfg.rwkv_head_size
        full = W.rwkv6_time_mix(lp["mixer"], x, hs)
        _, (st, shift) = W.rwkv6_time_mix(lp["mixer"], x[:, :s], hs,
                                          return_state=True)
        step, _, _ = W.rwkv6_time_mix_step(lp["mixer"], x[:, s:], st, shift,
                                           hs)
        errs["rwkv6_time_mix_step"] = close_f32(
            f"{arch} rwkv6_time_mix_step after {s} tokens", step,
            full[:, s:].cpu(), 2e-3)
        full, _ = W.rwkv6_cmix(lp["mlp"], x)
        _, last = W.rwkv6_cmix(lp["mlp"], x[:, :s])
        step, _ = W.rwkv6_cmix(lp["mlp"], x[:, s:], shift=last)
        errs["rwkv6_cmix(shift)"] = close_f32(
            f"{arch} rwkv6_cmix with the shift after {s} tokens", step,
            full[:, s:].cpu(), 2e-3)
    log("model", f"{card}: {arch} f32 layer 0, the block on {s} tokens then "
                 f"one decode step against the block on {DECODE_LEN}: "
                 + ", ".join(f"{k} max |diff| {v:.3e}"
                             for k, v in errs.items()) + " (bar 2e-3)")
    return errs


def model_full_width(device, card: str, fallback: dict) -> list:
    """(2) Every architecture at full width and its bf16, B = 1,
    forward and lm_loss: shapes, finite values, causality; the median of
    MODEL_TURNS timed forwards (CUDA events) after a warm-up, tokens/s,
    peak device memory and the share of the bf16 peak."""
    from repro_torch.common import tree as tr
    from repro_torch.models import transformer as T

    rows = []
    for arch, layers, seq in MODEL_RUNS:
        t0 = time.perf_counter()
        cfg = model_cfg(arch, layers)
        gen = torch.Generator(device=device).manual_seed(MODEL_SEED)
        p, _ = T.init_params(cfg, generator=gen, device=device)
        batch = model_batch(cfg, seq, device, MODEL_SEED)
        param_gib = tr.tree_bytes(p) / 2**30
        n_params = tr.tree_count_params(p)
        n_tok = batch["tokens"].shape[1]
        with torch.inference_mode():
            sync(device)
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            logits = T.forward(p, cfg, batch)                  # warm-up
            times = []
            for _ in range(MODEL_TURNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                logits = T.forward(p, cfg, batch)
                end.record()
                torch.cuda.synchronize(device)
                times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated(device)
            check(tuple(logits.shape) == (1, n_tok, cfg.padded_vocab)
                  and logits.dtype == torch.float32,
                  f"{arch}: logits {logits.dtype}{tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()),
                  f"{arch}: logits not finite")
            del logits
            causal = causality(p, cfg, batch)
            loss, metrics = T.lm_loss(p, cfg, batch)
            check(bool(torch.isfinite(loss)), f"{arch}: loss {float(loss)}")
        if causal > 1e-5:
            # the two calls' products did not give the same bits: hold
            # causality at f32 on phase 14 (1)'s models instead
            log("model", f"{card}: {arch} bf16: earlier logits moved by "
                         f"{causal} (bar 1e-5); causality held at f32 on "
                         f"{sorted(fallback)} instead"
                         + (" (a MoE: its slots are not bit-stable)"
                            if cfg.family == "moe" else ""))
        ms = statistics.median(times)
        flops = forward_flops(cfg, batch)
        row = dict(arch=arch, layers=cfg.num_layers, seq=seq, tokens=n_tok,
                   ms=ms, times=times, tokens_per_s=seq / (ms / 1e3),
                   peak_gib=peak / 2**30, param_gib=param_gib,
                   params=n_params,
                   before_gib=before / 2**30, flops=flops,
                   peak_share=flops / (ms / 1e3) / PEAK_BF16,
                   loss=float(loss), logit_max=float(metrics["logit_max"]),
                   causal=causal, seconds=time.perf_counter() - t0)
        rows.append(row)
        log("model", f"{card}: {arch} bf16 {cfg.num_layers} layers "
                     f"{'(reduced) ' if layers else ''}S={seq}"
                     + (f" ({cfg.num_patches} patches + {n_tok} tokens)"
                        if cfg.family == "vlm" else "")
                     + (f" over {cfg.encoder_seq} frames"
                        if cfg.is_encoder_decoder else "")
                     + f": forward {ms:.3f} ms (median of {MODEL_TURNS}, "
                       f"CUDA events; {[round(t, 3) for t in times]}), "
                       f"{row['tokens_per_s']:.1f} tokens/s, "
                       f"{flops / 1e12:.3f} TFLOP = "
                       f"{row['peak_share']:.4f} of the 989 TFLOP/s bf16 "
                       f"peak; peak {row['peak_gib']:.3f} GiB (params "
                       f"{param_gib:.3f}, {n_params:,}); loss "
                       f"{row['loss']:.6g}; "
                       f"causality max |diff| {causal:.3e}; "
                       f"{row['seconds']:.1f} s")
        del p, batch, loss, metrics
        torch.cuda.empty_cache()
    return rows


def scan_case(arch: str, device):
    """The recurrent scan of one full-width layer of ``arch`` (B = 1, S =
    SCAN_SEQ, f32, seeded inputs) as ``(name, call, bytes, operations)``:
    RG-LRU's ``associative_scan`` of ``(a, b)``, a in [0, 1) and b normal,
    over ``[1, S, lru_width]``; the WKV loop over ``[1, S, H, hs]`` (w in
    [0, 1), r, k, v normal). Bytes: inputs read once, outputs written
    once. Operations: the sequential recurrence's, 3 a scanned element
    (RG-LRU), and a token's outer product, bonus, add, r-product (2 a
    state element), decay and add, 7 a state element (WKV)."""
    from repro_torch.configs import get_config
    from repro_torch.models import rglru as R
    from repro_torch.models import rwkv6 as W

    cfg = get_config(arch)
    g = torch.Generator(device=device).manual_seed(MODEL_SEED)
    if cfg.mixer_of(0) == "rglru":
        shape = (1, SCAN_SEQ, cfg.lru_width)
        a = torch.rand(shape, generator=g, device=device)
        b = torch.randn(shape, generator=g, device=device)
        return ("rglru associative_scan", lambda: R.associative_scan(
            R._linear_combine, (a, b), dim=1), 4 * a.numel() * 4,
            3 * a.numel())
    hs = cfg.rwkv_head_size
    h = cfg.d_model // hs
    shape = (1, SCAN_SEQ, h, hs)
    r, k, v = (torch.randn(shape, generator=g, device=device)
               for _ in range(3))
    w = torch.rand(shape, generator=g, device=device)
    u = torch.randn((h, hs), generator=g, device=device)
    state = h * hs * hs
    return ("rwkv6 wkv_recurrence", lambda: W.wkv_recurrence(
        r, k, v, w, u), (5 * r.numel() + u.numel() + state) * 4,
        7 * SCAN_SEQ * state)


def recurrent_scans(device, card: str) -> dict:
    """(4) Each recurrent scan alone (``scan_case``): the median of
    SCAN_TURNS calls after a warm-up, CUDA events, against its bound: the
    larger of its bytes at 3.35 TB/s and its operations at the 67 TFLOP/s
    f32 rate."""
    out = {}
    for arch in RECURRENT_ARCHS:
        name, call, nbytes, ops = scan_case(arch, device)
        with torch.inference_mode():
            call()
            times = []
            for _ in range(SCAN_TURNS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                torch.cuda.synchronize(device)
                times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_F32) * 1e3
        out[arch] = dict(name=name, ms=ms, times=times, bound_ms=bound,
                         bytes=nbytes, ops=ops)
        log("model", f"{card}: {arch} one layer's {name} alone, S="
                     f"{SCAN_SEQ}, f32: {ms:.3f} ms (median of {SCAN_TURNS}, "
                     f"CUDA events; {[round(t, 3) for t in times]}), bound "
                     f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s, "
                     f"{ops / 1e9:.3f} GFLOP at 67 TFLOP/s f32)")
    return out


def profiled(call, device, ops: bool = True) -> dict:
    """One call of ``call`` under torch.profiler (after the caller's
    warm-up): wall and device-busy ms, kernel launches, the top kernels
    and (with ``ops``, which records the host's operators too) the top
    aten operators by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    activities = [ProfilerActivity.CUDA]
    if ops:
        activities.append(ProfilerActivity.CPU)
    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, ops = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us <= 0:
            continue
        row = (dev_us / 1e3, e.count, e.key[:90])
        if e.device_type == DeviceType.CUDA:
            kernels.append(row)
        elif e.key.startswith("aten::"):
            ops.append(row)
    kernels.sort(reverse=True)
    ops.sort(reverse=True)
    return {"wall_ms": wall_ms, "busy_ms": sum(r[0] for r in kernels),
            "launches": sum(r[1] for r in kernels),
            "top": kernels[:MODEL_TOP_OPS], "top_ops": ops[:MODEL_TOP_OPS]}


def model_profile_child(arch: str, layers: str) -> int:
    """(3) In a fresh process: ``arch`` in bf16 at its MODEL_RUNS length,
    at full depth (``layers`` "full") or cut to ``layers``, one warm-up
    forward, then one profiled forward; for a model cut in depth (its
    pattern of period 1), one profiled block too, which gives the launches
    of a full-depth forward; for a recurrent model, its scan alone
    (``scan_case``). Prints one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import transformer as T

    device = torch.device("cuda")
    seq = next(q for a, _, q in MODEL_RUNS if a == arch)
    cfg = model_cfg(arch, None if layers == "full" else int(layers))
    full = model_cfg(arch)
    gen = torch.Generator(device=device).manual_seed(MODEL_SEED)
    p, _ = T.init_params(cfg, generator=gen, device=device)
    batch = model_batch(cfg, seq, device, MODEL_SEED)
    out = {"arch": arch, "layers": cfg.num_layers, "seq": seq}
    with torch.inference_mode():
        T.forward(p, cfg, batch)
        sync(device)
        out.update(profiled(lambda: T.forward(p, cfg, batch), device))
        out["full_launches"] = out["launches"]
        if full.num_layers > cfg.num_layers:
            # every layer of a period-1 model runs the same ops: one
            # block's launches stand for each layer left out
            check(full.uniform_period == 1, f"{arch}: cut to {layers} of "
                  f"{full.num_layers} layers, its pattern is not period 1")
            _, lp = next(T._layer_params(p, cfg))
            x = torch.randn((1, seq, cfg.d_model), generator=gen,
                            device=device).to(torch.bfloat16)
            T.block_apply(lp, cfg, 0, x)
            sync(device)
            out["block_launches"] = profiled(
                lambda: T.block_apply(lp, cfg, 0, x), device,
                ops=False)["launches"]
            out["full_launches"] += ((full.num_layers - cfg.num_layers)
                                     * out["block_launches"])
        if arch in RECURRENT_ARCHS:
            name, call, _, _ = scan_case(arch, device)
            call()
            sync(device)
            scan = profiled(call, device, ops=False)
            out["scan"] = dict(name=name, launches=scan["launches"],
                               busy_ms=scan["busy_ms"],
                               wall_ms=scan["wall_ms"])
    print(json.dumps(out))
    return 0


def model_profile(card: str, arch: str, layers) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"),
         "--model-profile-child", arch,
         "full" if layers is None else str(layers)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    check(out.returncode == 0, f"model profile child ({arch}) failed: "
                               f"{out.stderr[-2000:]}")
    prof = json.loads(out.stdout.strip().splitlines()[-1])
    busy, wall = prof["busy_ms"], prof["wall_ms"]
    check(busy > 0, f"model profile ({arch}): no device time recorded")
    full = prof["full_launches"]
    log("model", f"{card}: {arch} {prof['layers']} layers, S={prof['seq']}, "
                 f"one profiled forward in a fresh process: wall {wall:.3f} "
                 f"ms, device busy {busy:.3f} ms, idle share "
                 f"{1 - busy / wall:.4f}, {prof['launches']} kernels"
                 + (f" ({prof['block_launches']} a layer: {full} at full "
                    f"depth)" if "block_launches" in prof else "")
                 + f"; the child took {time.perf_counter() - t0:.1f} s; "
                   f"top operators by the device time of their kernels:")
    for ms, count, key in prof["top_ops"]:
        log("model", f"{ms:10.4f} ms ({ms / busy:.4f}) x{count:<5d} {key}")
    log("model", f"{card}: top kernels:")
    for ms, count, key in prof["top"]:
        log("model", f"{ms:10.4f} ms ({ms / busy:.4f}) x{count:<5d} {key}")
    if "scan" in prof:
        sc = prof["scan"]
        log("model", f"{card}: {arch} {sc['name']} alone, profiled: "
                     f"{sc['launches']} kernels, device busy "
                     f"{sc['busy_ms']:.3f} ms of {sc['wall_ms']:.3f} wall")
    return prof


def model_phase(device, card: str) -> dict:
    """Phase 14: the language-model forward on the card."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    log("model", f"{card}: {tf32_state()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          f"an f32 product may run in TF32: {tf32_state()}")
    sync(device)
    torch.cuda.empty_cache()
    reset_launch_counts()
    f32 = model_card_vs_cpu(device, card)
    full = model_full_width(device, card, f32)
    scans = recurrent_scans(device, card)
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"the model forward launched {launched}")
    profs = {arch: model_profile(card, arch, layers)
             for arch, layers in MODEL_PROFILES}
    for row in full:
        if row["arch"] in RECURRENT_ARCHS:
            arch, sc = row["arch"], scans[row["arch"]]
            log("model", f"{card}: {arch} bf16 {row['layers']} layers S="
                         f"{row['seq']}: forward {row['ms']:.3f} ms, "
                         f"{row['tokens_per_s']:.1f} tokens/s, "
                         f"{row['peak_share']:.4f} of the bf16 peak, "
                         f"{profs[arch]['full_launches']} kernel launches a "
                         f"full-depth forward; one layer's {sc['name']} {sc['ms']:.3f} "
                         f"ms in {profs[arch]['scan']['launches']} launches "
                         f"(bound {sc['bound_ms']:.4f} ms)")
    log("model", f"{card}: {tf32_state()}; phase 14 took "
                 f"{time.perf_counter() - t0:.1f} s")
    return dict(f32=f32, full=full, scans=scans, profiles=profs)


# ------------------------------------------------------------- phase 15
def lm_f32_cfg(arch: str, layers: int):
    """Full width at f32, cut to ``layers`` (whisper's encoder too); a MoE
    at capacity factor 8.0, JAX's decode-test setting
    (``tests/test_models.py:21-25``), so that no token is dropped and a
    forward over other groups routes each token as the decode does."""
    import dataclasses

    cfg = model_cfg(arch, layers, f32=True)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    return cfg


def same_tree(name: str, got, want, tol: float) -> float:
    """Leaf names equal, integer leaves exact, float leaves within rtol =
    atol = ``tol`` of ``want`` (on the CPU); returns the largest float
    difference."""
    from repro_torch.common import tree as tr

    got, want = tr.tree_flatten_with_paths(got), tr.tree_flatten_with_paths(
        want)
    check([n for n, _ in got] == [n for n, _ in want],
          f"{name}: the cache trees differ")
    err = 0.0
    for (leaf, a), (_, b) in zip(got, want):
        a = a.cpu()
        if b.dtype == torch.int32:
            check(torch.equal(a, b.cpu()), f"{name}: {leaf} differs")
        else:
            err = max(err, close_f32(f"{name}: {leaf}", a, b.cpu(), tol))
    return err


@contextlib.contextmanager
def captured_grads():
    """The gradient list of every ``loss_and_grads`` call inside the train
    step, kept (the step empties its own list as AdamW consumes it)."""
    from repro_torch.models import steps as S

    seen, real = [], S.loss_and_grads

    def loss_and_grads(params, cfg, batch):
        loss, metrics, grads = real(params, cfg, batch)
        seen.append(list(grads))
        return loss, metrics, grads

    S.loss_and_grads = loss_and_grads
    try:
        yield seen
    finally:
        S.loss_and_grads = real


def lm_train_step_vs_cpu(arch: str, cfg, p, cpu_p, batch: dict) -> dict:
    """One ``make_train_step`` on the card against the CPU's loss and
    gradients from the same parameters (``loss_and_grads``, the step's
    gradient; the CPU's AdamW update is left out, its grad norm taken as
    the step takes it): loss and grad norm within 2e-3 relative, each
    gradient leaf within 2e-3 x its max |g| (the CPU's) + 1e-6."""
    from repro_torch.common import tree as tr
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig, adamw_init

    opt = AdamWConfig()
    step = S.make_train_step(cfg, opt)
    with captured_grads() as card_g:
        _, m = step(S.TrainState(p, adamw_init(p, opt)), batch)
    loss, _, grads = S.loss_and_grads(cpu_p, cfg,
                                      {k: v.cpu() for k, v in batch.items()})
    cpu_g = [grads]
    cm = {"loss": loss, "grad_norm": tr.tree_global_norm(grads)}
    out = {}
    for key in ("loss", "grad_norm"):
        a, b = float(m[key]), float(cm[key])
        out[key] = abs(a - b) / abs(b)
        check(out[key] <= 2e-3, f"{arch} train step: {key} {a!r} on the card "
                                f"against {b!r} on the CPU")
    worst, names = 0.0, [n for n, _ in tr.tree_flatten_with_paths(p)]
    for name, a, b in zip(names, card_g[0], cpu_g[0]):
        allow = 2e-3 * float(b.abs().max()) + 1e-6
        share = float((a.cpu() - b).abs().max()) / allow
        worst = max(worst, share)
        check(share <= 1.0, f"{arch} train step: gradient {name} off by "
                            f"{share:.3f} of its allowance")
    out["grad_share"] = worst
    return out


def lm_card_vs_cpu(device, card: str) -> dict:
    """(1) Full width, f32, B = 2, a prompt of LM_F32_PROMPT tokens: on the
    card the fused prefill against the replay oracle, the card's against
    the CPU's (the MoE's choices first, ``same_routes``), two decode steps
    against teacher forcing on the card; one train step against the
    CPU's on LM_F32_TRAIN."""
    import dataclasses

    from repro_torch.common import tree as tr
    from repro_torch.models import decoding as D
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    out = {}
    for arch, layers in LM_F32:
        t0 = time.perf_counter()
        cfg = lm_f32_cfg(arch, layers)
        moe = cfg.family == "moe"
        tol = 2e-2 if moe else 2e-3
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        p, _ = T.init_params(cfg, generator=gen, device=device)
        cpu_p = tr.tree_map(lambda x: x.to(cpu), p)
        n = LM_F32_PROMPT
        batch = model_batch(cfg, n + 2, device, LM_SEED, b=LM_F32_BATCH)
        prompt = {k: v[:, :n] if k in ("tokens", "labels") else v
                  for k, v in batch.items()}
        max_len = n + 16
        row = {}
        with torch.inference_mode():
            with recorded_routes() as card_routes:
                last, cache, enc_out = D.prefill(p, cfg, prompt, max_len)
            ref_last, ref_cache, _ = D.prefill_reference(p, cfg, prompt,
                                                         max_len)
            row["oracle"] = max(
                close_f32(f"{arch} fused prefill against the replay oracle",
                          last, ref_last.cpu(), tol),
                same_tree(f"{arch} fused against replayed cache", cache,
                          ref_cache, tol))
            del ref_cache
            with recorded_routes(forced=card_routes) as cpu_routes:
                c_last, c_cache, _ = D.prefill(
                    cpu_p, cfg, {k: v.cpu() for k, v in prompt.items()},
                    max_len)
            if moe:
                row["routes"] = same_routes(arch, card_routes, cpu_routes,
                                            cfg.num_experts_per_tok)
            row["cpu"] = max(
                close_f32(f"{arch} prefill, card against CPU", last, c_last,
                          tol),
                same_tree(f"{arch} prefill cache, card against CPU", cache,
                          c_cache, tol))
            del c_cache, card_routes, cpu_routes
            # teacher forcing: a MoE's forward in one group (no token is
            # dropped at capacity factor 8.0, so the groups do not matter)
            tf_cfg = (dataclasses.replace(cfg, moe_group_size=LM_F32_BATCH
                                          * (n + 2)) if moe else cfg)
            full = T.forward(p, tf_cfg, batch)
            errs = []
            for i in (n, n + 1):
                lg, cache = D.decode_step(p, cfg, batch["tokens"][:, i:i + 1],
                                          cache, enc_out=enc_out)
                errs.append(close_f32(
                    f"{arch} decode step at {i} against teacher forcing",
                    lg[:, 0], full[:, i].cpu(), tol))
            row["decode"] = max(errs)
            del full, cache
        if arch in LM_F32_TRAIN:
            train = {"tokens": batch["tokens"][:, :n],
                     "labels": batch["tokens"][:, 1:n + 1]}
            row["train"] = lm_train_step_vs_cpu(arch, cfg, p, cpu_p, train)
        del p, cpu_p
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t0
        out[arch] = row
        routed = row.get("routes")
        log("lm", f"{card}: {arch} f32, {cfg.num_layers} layers"
                  + (f" + {cfg.encoder_layers} over {cfg.encoder_seq} frames"
                     if cfg.is_encoder_decoder else "")
                  + f", B={LM_F32_BATCH}, prompt {n}: fused prefill against "
                    f"the replay oracle max |diff| {row['oracle']:.3e}, card "
                    f"against CPU {row['cpu']:.3e}, two decode steps against "
                    f"teacher forcing {row['decode']:.3e} (bar {tol})"
                  + (f"; {routed['calls']} MoE calls routed as on the card, "
                     f"{routed['flips']} token(s) otherwise on the CPU's "
                     f"inputs within 2 x the drift {routed['prob_drift']:.3e}"
                     if routed else "")
                  + (f"; train step: loss {row['train']['loss']:.3e} and "
                     f"grad norm {row['train']['grad_norm']:.3e} relative, "
                     f"worst gradient leaf {row['train']['grad_share']:.3f} of"
                     f" its allowance (bar 2e-3 x max |g| + 1e-6)"
                     if "train" in row else "")
                  + f"; {row['seconds']:.1f} s")
    return out


def ring_want(slots: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """The ring's ``pos`` after ``length`` tokens, on the device: slot s
    holds the latest position p < length with p % window == s, -1 where
    none is."""
    latest = slots + torch.div(length - 1 - slots, window,
                               rounding_mode="floor") * window
    return torch.where(slots <= length - 1, latest, -1).to(torch.int32)


def lm_serve_one(device, card: str, arch: str, layers, b: int,
                 prompt: int) -> dict:
    """(2) One architecture serving at full width and bf16 through
    ``serve_lm.greedy_generate``: SERVE_TOKENS greedy tokens under
    inference mode, each step's time from CUDA events; checked on the
    device as it runs (finite logits; every ring's ``pos`` and ``length``
    after the prefill and every step) and read once at the end."""
    from repro_torch.common import tree as tr
    from repro_torch.launch import serve_lm
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    cfg = model_cfg(arch, layers)
    gen = torch.Generator(device=device).manual_seed(LM_SEED)
    p, _ = T.init_params(cfg, generator=gen, device=device)
    batch = serve_lm.prompt_batch(cfg, b, prompt, device, seed=LM_SEED)
    patches = cfg.num_patches if cfg.family == "vlm" else 0
    max_len = prompt + SERVE_TOKENS + 8 + patches
    oks, rings = [], {}

    def on_step(i, logits, cache):
        oks.append(torch.isfinite(logits).all())
        length = prompt + patches + i
        for li, lc in enumerate(cache):
            if "kind_local" not in lc:
                continue
            ring = lc["kind_local"]
            w = ring.pos.shape[-1]
            slots = torch.arange(w, device=device)
            oks.append((ring.pos == ring_want(slots, length, w)).all())
            oks.append((ring.length == length).all())
            rings[li] = w

    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.inference_mode():
        out = serve_lm.greedy_generate(p, cfg, batch, SERVE_TOKENS, max_len,
                                       on_step=on_step)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    check(all(bool(x) for x in oks), f"{arch} serving: a logit is not "
          f"finite or a ring's positions are off")
    ids = out.ids
    check(tuple(ids.shape) == (b, SERVE_TOKENS)
          and bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          f"{arch} serving: ids {ids.dtype}{tuple(ids.shape)} outside "
          f"[0, {cfg.vocab_size})")
    if arch in ("gemma2_2b", "recurrentgemma_2b"):
        wnd = min(cfg.local_window, max_len)
        check(rings and prompt + SERVE_TOKENS - 1 > wnd,
              f"{arch} serving: the ring of {wnd} did not wrap")
    steps = out.step_ms[1:]
    ms = statistics.median(steps)
    param_bytes = tr.tree_bytes(p)
    cache_bytes = tr.tree_bytes(out.cache)
    row = dict(arch=arch, layers=cfg.num_layers, batch=b, prompt=prompt,
               patches=patches, prefill_ms=out.step_ms[0], decode_ms=ms,
               decode_ms_min=min(steps), decode_ms_max=max(steps),
               tokens_per_s=b / (ms / 1e3), peak_gib=peak / 2**30,
               param_bytes=param_bytes, cache_bytes=cache_bytes,
               floor_ms=(param_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3,
               rings=len(rings), seconds=time.perf_counter() - t0)
    del p, out, batch
    torch.cuda.empty_cache()
    log("lm", f"{card}: serve {arch} bf16 {cfg.num_layers} layers"
              f"{' (reduced)' if layers else ''}, B={b}, prompt "
              + (f"{patches} patches + " if patches else "")
              + f"{prompt} tokens"
              + (f" over {cfg.encoder_seq} frames"
                 if cfg.is_encoder_decoder else "")
              + f": prefill {row['prefill_ms']:.3f} ms; decode "
                f"{ms:.3f} ms a token (median of {len(steps)} steps, CUDA "
                f"events; {min(steps):.3f}-{max(steps):.3f}) = "
                f"{row['tokens_per_s']:.1f} tokens/s batch-wide, floor "
                f"{row['floor_ms']:.3f} ms (weights "
                f"{param_bytes / 1e9:.3f} GB + cache "
                f"{cache_bytes / 1e9:.3f} GB at 3.35 TB/s); peak "
                f"{row['peak_gib']:.3f} GiB; "
                + (f"{len(rings)} ring leaves wrapped, positions exact; "
                   if rings else "")
                + f"{row['seconds']:.1f} s")
    return row


def decode_profile_child() -> int:
    """(2) In a fresh process, for each SERVE_RUNS architecture at full
    width and bf16 (a prompt of 32 tokens: a step's launches do not depend
    on its length), the kernels one decode step launches: two profiled
    sessions, of one step and of two, launches a step = their difference
    (a session's first records, if the profiler drops them, cancel).
    Prints one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import serve_lm
    from repro_torch.models import decoding as D
    from repro_torch.models import transformer as T

    device = torch.device("cuda")
    out, t_first = {}, None
    for arch, layers, b, _ in SERVE_RUNS:
        cfg = model_cfg(arch, layers)
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        p, _ = T.init_params(cfg, generator=gen, device=device)
        batch = serve_lm.prompt_batch(cfg, b, 32, device)
        with torch.inference_mode():
            logits, cache, enc_out = D.prefill(p, cfg, batch, 32 + 16 + (
                cfg.num_patches if cfg.family == "vlm" else 0))
            tok = serve_lm.greedy(logits, cfg)

            def steps(k):
                nonlocal cache
                for _ in range(k):
                    _, cache = D.decode_step(p, cfg, tok, cache,
                                             enc_out=enc_out)

            steps(2)
            sync(device)
            t_first = t_first or time.perf_counter()
            one = profiled(lambda: steps(1), device, ops=False)["launches"]
            two = profiled(lambda: steps(2), device, ops=False)["launches"]
        out[arch] = dict(one=one, two=two, per_step=two - one,
                         since_first_s=time.perf_counter() - t_first)
        del p, cache, logits, enc_out
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def lm_decode_launches(card: str) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"),
         "--decode-profile-child"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    check(out.returncode == 0, f"decode profile child failed: "
                               f"{out.stderr[-2000:]}")
    prof = json.loads(out.stdout.strip().splitlines()[-1])
    for arch, r in prof.items():
        check(r["per_step"] > 0, f"{arch}: no decode launches recorded")
    log("lm", f"{card}: kernel launches a decode step, profiled in a fresh "
              f"process (sessions of one step and of two; "
              f"{time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{a} {r['per_step']} ({r['one']} / {r['two']}, "
                          f"{r['since_first_s']:.0f} s)"
                          for a, r in prof.items()))
    return prof


def lm_training(device, root: pathlib.Path, card: str) -> dict:
    """(3) LM_TRAIN_RUNS through ``launch/train.py``'s ``main`` at full
    width: finite losses, no checkpoint written, K6 once a batch fetched
    plus once for the marked stream, K7 once a doctor run, nothing else.
    Steps/s and tokens/s from the trainer's step durations (host clock,
    each to ``float(loss)``), the first step apart."""
    import math

    from repro_torch.configs import ALIASES
    from repro_torch.data import pipeline as pipe_mod
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import steps as S

    made, errors = [], []
    real_batch_at = pipe_mod.TokenPipeline.batch_at
    real_make = S.make_train_step

    def batch_at(self, step):
        made.append(step)
        return real_batch_at(self, step)

    def make_train_step(*args, **kw):
        # the trainer retries a step that raises and hides why: keep it
        step = real_make(*args, **kw)

        def train_step(state, batch):
            try:
                return step(state, batch)
            except Exception as e:  # noqa: BLE001 - reported, re-raised
                errors.append(f"{type(e).__name__}: {str(e)[:400]}")
                raise

        return train_step

    rows, total = [], {}
    pipe_mod.TokenPipeline.batch_at = batch_at
    S.make_train_step = make_train_step
    try:
        for arch in LM_TRAIN_RUNS:
            made.clear()
            ckpt = root / arch
            alias = {v: k for k, v in ALIASES.items()}[arch]
            sync(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            reset_launch_counts()
            errors.clear()
            with trainer_patched(device, fake_clock=False) as doctor_ms:
                t0 = time.perf_counter()
                try:
                    report = train_launcher.main(["--arch", alias,
                                                  *LM_TRAIN_ARGS,
                                                  "--ckpt-dir", str(ckpt)])
                except RuntimeError as e:
                    check(False, f"{arch} training failed: {e}; the steps "
                                 f"raised {errors[:2]}")
                wall = time.perf_counter() - t0
            check(not errors, f"{arch} training: steps raised {errors[:2]}")
            sync(device)
            peak = torch.cuda.max_memory_allocated(device)
            launches = launch_counts()
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            hist = report["history"]
            losses = [h["loss"] for h in hist]
            check(report["final_step"] == LM_TRAIN_STEPS
                  and len(hist) == LM_TRAIN_STEPS
                  and all(math.isfinite(x) for x in losses),
                  f"{arch} training: {report['final_step']} steps, losses "
                  f"{losses}")
            check(not list(ckpt.glob("step_*")),
                  f"{arch} training wrote a checkpoint")
            check(launches["powerlaw_sample"] == len(made) + 1,
                  f"{arch} training: {launches['powerlaw_sample']} K6 "
                  f"launches for {len(made)} batches and the marked stream")
            check(launches["windowed_ratio"] == len(doctor_ms),
                  f"{arch} training: {launches['windowed_ratio']} K7 "
                  f"launches for {len(doctor_ms)} doctor runs")
            others = {k: v for k, v in launches.items()
                      if k not in ("windowed_ratio", "powerlaw_sample") and v}
            check(not others, f"{arch} training: other kernels {others}")
            durs = [h["dur"] for h in hist]
            tokens = 8 * 256
            row = dict(arch=arch, wall_s=wall, first_step_s=durs[0],
                       step_s_p50=statistics.median(durs[1:]),
                       steps_per_s=(len(durs) - 1) / sum(durs[1:]),
                       tokens_per_s=tokens * (len(durs) - 1) / sum(durs[1:]),
                       peak_gib=peak / 2**30, first_loss=losses[0],
                       last_loss=losses[-1], batches=len(made),
                       doctor_runs=len(doctor_ms),
                       launches={k: v for k, v in launches.items() if v})
            rows.append(row)
            log("lm", f"{card}: train {arch} full width through "
                      f"launch/train.py, {LM_TRAIN_STEPS} steps of 8 x 256 "
                      f"malgen tokens: {row['steps_per_s']:.3f} steps/s = "
                      f"{row['tokens_per_s']:.1f} tokens/s over steps "
                      f"2-{LM_TRAIN_STEPS} "
                      f"(step p50 {row['step_s_p50']:.3f} s, the first "
                      f"{row['first_step_s']:.3f} s; host clock to "
                      f"float(loss)), main() {wall:.1f} s; peak "
                      f"{row['peak_gib']:.3f} GiB; loss {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}; launches K6 "
                      f"{launches['powerlaw_sample']} ({len(made)} batches "
                      f"+ the marked stream), K7 {launches['windowed_ratio']}"
                      f" ({len(doctor_ms)} doctor runs), no other")
            del report, hist
    finally:
        pipe_mod.TokenPipeline.batch_at = real_batch_at
        S.make_train_step = real_make
    return dict(rows=rows, launches=total)


def lm_train_child(root: str) -> int:
    """(3) in a fresh process (``--lm-train-child DIR``), started with
    PyTorch's expandable segments: qwen1.5-4b's functional step holds the
    old and the new parameters and f32 moments at once (73.6 GiB of the
    card's 79.2), which leaves no room for a fragmented cache. Prints
    one JSON line."""
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda")
    out = lm_training(device, pathlib.Path(root), card_line())
    print(json.dumps(out))
    return 0


def lm_training_in_child(root: pathlib.Path) -> dict:
    t0 = time.perf_counter()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--lm-train-child",
         str(root)], capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=env)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    check(out.returncode == 0, f"the training child failed: "
                               f"{out.stderr[-3000:]}")
    log("lm", f"the training child took {time.perf_counter() - t0:.1f} s")
    return json.loads(lines[-1])


def lm_bad_host(device, root: pathlib.Path, card: str) -> dict:
    """(4) The trainer of phase 13 with llama3-8b's smoke model step at
    its bf16 (``make_train_step``) on the JAX launcher's malgen batches:
    host 5 fails every step it serves past step 8; it ends blocklisted
    and absent from the last 16 steps, every loss finite."""
    import math

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import steps as S
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import TrainConfig, Trainer

    cfg = get_smoke_config("llama3_8b")
    sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    pipe = TokenPipeline(DataConfig(**TRAIN_DATA), device=device)
    state, _ = S.make_train_state(
        cfg, AdamWConfig(), device=device,
        generator=torch.Generator(device=device).manual_seed(LM_SEED))
    made = []

    def batch_fn(step):
        made.append(step)
        return pipe.batch_at(step)

    tr = Trainer(TrainConfig(ckpt_dir=str(root / "bad_host"), **TRAIN_RUN),
                 S.make_train_step(cfg, AdamWConfig(),
                                   total_steps=TRAIN_RUN["total_steps"]),
                 state, batch_fn, fault_hook=bad_host_hook, device=device)
    with trainer_patched(device, fake_clock=False) as doctor_ms:
        t0 = time.perf_counter()
        report = tr.run()
        wall = time.perf_counter() - t0
    sync(device)
    peak = torch.cuda.max_memory_allocated(device)
    launches = launch_counts()
    hist = report["history"]
    losses = [h["loss"] for h in hist]
    check(report["final_step"] == TRAIN_RUN["total_steps"]
          and all(math.isfinite(x) for x in losses),
          f"bad-host model run: final step {report['final_step']}")
    check(TRAIN_BAD_HOST in report["blocklist"]
          and TRAIN_BAD_HOST not in {h["host"] for h in hist[-16:]},
          f"bad-host model run: blocklist {report['blocklist']}, last hosts "
          f"{[h['host'] for h in hist[-16:]]}")
    check(launches["powerlaw_sample"] == len(made) + 1
          and launches["windowed_ratio"] == len(doctor_ms),
          f"bad-host model run: launches {dict(launches)} for {len(made)} "
          f"batches and {len(doctor_ms)} doctor runs")
    tokens = len(hist) * TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    out = dict(steps=len(hist), wall_s=wall, tokens_per_s=tokens / wall,
               peak_gib=peak / 2**30, blocklist=report["blocklist"],
               retries=report["retries"], restarts=report["restarts"],
               first_loss=losses[0], last_loss=losses[-1])
    log("lm", f"{card}: bad-host run with llama3-8b's smoke model step "
              f"(bf16): {len(hist)} steps in {wall:.3f} s = "
              f"{out['tokens_per_s']:.1f} tokens/s (host clock, retries, "
              f"restores and doctor runs included), {out['retries']} "
              f"retries, {out['restarts']} restarts, blocklist "
              f"{out['blocklist']}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; peak {out['peak_gib']:.3f} GiB; K6 "
              f"{launches['powerlaw_sample']}, K7 {launches['windowed_ratio']}")
    return out


def lm_phase(device, card: str) -> dict:
    """Phase 15: train and decode the language models on the card."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    sync(device)
    torch.cuda.empty_cache()
    f32 = lm_card_vs_cpu(device, card)
    reset_launch_counts()
    serve = [lm_serve_one(device, card, *run) for run in SERVE_RUNS]
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"serving launched {launched}")
    launches = lm_decode_launches(card)
    for row in serve:
        row["launches_per_step"] = launches[row["arch"]]["per_step"]
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_lm_"))
    sync(device)
    torch.cuda.empty_cache()
    torch._C._cuda_clearCublasWorkspaces()
    log("lm", f"{card}: this process holds "
              f"{torch.cuda.memory_allocated(device) / 2**30:.3f} GiB "
              f"allocated, {torch.cuda.memory_reserved(device) / 2**30:.3f} "
              f"reserved, as the training child starts")
    try:
        train = lm_training_in_child(root)
        bad = lm_bad_host(device, root, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("lm", f"phase 15 took {time.perf_counter() - t0:.1f} s")
    return dict(f32=f32, serve=serve, train=train, bad_host=bad)


# ------------------------------------------------------------- phase 16
def pipe_tool():
    """``tools/pipeline_gang.py``, the pipeline gang's worker, as a
    module."""
    sys.path.insert(0, str(ROOT / "tools"))
    import pipeline_gang

    return pipeline_gang


def pipe_one_process(device, card: str, smoke: bool = False) -> dict:
    """Phase 16 (a): the 32 blocks in 4 stages in this process (``smoke``:
    at the config's smoke widths and 32 blocks, for a CPU rehearsal)."""
    from repro_torch.common import tree as tr
    from repro_torch.distributed import PipelineConfig, pipeline_apply
    from repro_torch.launch import mesh

    pg = pipe_tool()
    cfg = pg.model_cfg(PIPE_ARCH, smoke=smoke,
                       layers=32 if smoke else None)
    seq = 16 if smoke else PIPE_SEQ
    s, m = PIPE_STAGES, PIPE_MICRO
    per = cfg.num_layers // s
    t0 = time.perf_counter()
    params = pg.stage_blocks(cfg, range(s), per, device)
    x = pg.hidden_states(cfg, m, seq, device)
    sync(device)
    build_s = time.perf_counter() - t0
    fn = pg.blocks_fn(cfg, per)
    pcfg = PipelineConfig(num_stages=s, num_microbatches=m)
    n_params = sum(t.numel() for t in tr.tree_leaves(params))

    def piped():
        return pipeline_apply(fn, params, x, pcfg)

    def each():
        return torch.cat([pg.sequential(fn, params, x[k:k + 1], s)
                          for k in range(m)])

    with torch.no_grad():
        out = piped()
        want = each()
        check(torch.equal(out, want),
              f"pipeline: the 4-stage output differs from the blocks "
              f"applied a microbatch at a time (max |diff| "
              f"{(out.float() - want.float()).abs().max().item():.3e})")
        whole = pg.sequential(fn, params, x, s)
        diff = (out.float() - whole.float()).abs()
        ref = whole.float().abs()
        max_diff = diff.max().item()
        mean_ref = ref.mean().item()
        check(torch.isfinite(out).all().item(), "pipeline: non-finite")
        check(max_diff <= PIPE_WHOLE_TOL * mean_ref,
              f"pipeline against the whole batch: max |diff| {max_diff:.3e}"
              f" over {PIPE_WHOLE_TOL} x the mean |value| {mean_ref:.4e}")
        del whole, diff, ref, want
        ms = {"pipeline": [], "sequential": []}
        for turn in range(PIPE_TURNS):
            order = (("pipeline", piped), ("sequential", each))
            for name, call in (order if turn % 2 == 0 else order[::-1]):
                ms[name].append(time_ms(call, device, iters=1, warmup=0))
    med = {k: statistics.median(v) for k, v in ms.items()}
    bubble = (s - 1) / (m + s - 1)
    log("pipe", f"[{card}] {PIPE_ARCH} {cfg.num_layers} blocks "
                f"({n_params:,} parameters, bf16) in {s} stages of {per}, "
                f"{m} microbatches of [1, {seq}, {cfg.d_model}]: "
                f"bit-equal to the blocks a microbatch at a time; against "
                f"the whole batch max |diff| {max_diff:.4e} (bar "
                f"{PIPE_WHOLE_TOL:.4g} x the mean |value| {mean_ref:.4e}); "
                f"built in {build_s:.1f} s")
    log("pipe", f"[{card}] one process: pipeline ms {ms['pipeline']}, "
                f"sequential ms {ms['sequential']}; medians "
                f"{med['pipeline']:.3f} / {med['sequential']:.3f} = "
                f"{med['pipeline'] / med['sequential']:.4f}; JAX's bubble "
                f"fraction (s - 1) / (m + s - 1) = {s - 1}/{m + s - 1} = "
                f"{bubble:.4f}; peak "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB")
    result = dict(digest=mesh.checksum([out]), ms=ms, median_ms=med,
                  max_diff=max_diff, mean_ref=mean_ref, bubble=bubble,
                  shape=list(out.shape))
    del params, x, out
    return result


def pipe_gangs(device, card: str, one: dict, smoke: bool = False) -> dict:
    """Phase 16 (b): the same pipeline over gloo gangs sharing the card,
    every rank's output bit-equal to the one-process run's."""
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_pipe_"))
    out = {}
    try:
        for n in PIPE_GANGS:
            dest = root / f"n{n}"
            t0 = time.perf_counter()
            rc, stdout, stderr = run_in_session(
                [str(ROOT / "tools" / "pipeline_gang.py"),
                 "--num-processes", str(n), "--arch", PIPE_ARCH,
                 "--stages", str(PIPE_STAGES),
                 "--microbatches", str(PIPE_MICRO),
                 "--batch", str(PIPE_MICRO),
                 "--seq", str(16 if smoke else PIPE_SEQ),
                 "--device", device.type, "--runs", str(PIPE_GANG_RUNS),
                 "--out", str(dest), "--timeout", str(PIPE_TIMEOUT - 30)]
                + (["--smoke", "--layers", "32"] if smoke else []),
                PIPE_TIMEOUT)
            wall = time.perf_counter() - t0
            check(rc == 0, f"pipeline gang of {n} exited {rc}: "
                           f"{stdout[-2000:]}\n{stderr[-3000:]}")
            ranks = [json.loads((dest / f"rank{r}.json").read_text())
                     for r in range(n)]
            for r, res in enumerate(ranks):
                check(res["digest"] == one["digest"]
                      and res["shape"] == one["shape"],
                      f"pipeline gang of {n}, rank {r}: output differs from "
                      f"the one-process pipeline's")
            ms = [statistics.median(res["ms"]) for res in ranks]
            shares = [res["clock"]["gloo_ms"] / sum(res["ms"])
                      for res in ranks]
            per_run = [res["clock"]["bytes"] / PIPE_GANG_RUNS
                       for res in ranks]
            out[n] = dict(ms=[res["ms"] for res in ranks],
                          median_ms=max(ms), gloo_share=shares,
                          bytes_per_run=per_run,
                          clock=[res["clock"] for res in ranks],
                          peak_gib=[(res["peak_bytes"] or 0) / 2**30
                                    for res in ranks],
                          build_s=[res["build_s"] for res in ranks])
            log("pipe", f"[{card}] gang of {n} x {PIPE_STAGES // n} "
                        f"stage(s): every rank bit-equal to the one-process "
                        f"pipeline; run ms by rank "
                        f"{[round(v, 3) for v in ms]} (median of "
                        f"{PIPE_GANG_RUNS}; one process "
                        f"{one['median_ms']['pipeline']:.3f}), "
                        f"{max(ms) / one['median_ms']['pipeline']:.4f}x; "
                        f"bytes to gloo a rank a run "
                        f"{[int(b) for b in per_run]}; gloo's share of a "
                        f"run by rank {[round(v, 4) for v in shares]}; "
                        f"clock of rank 0 {json.dumps(out[n]['clock'][0])}; "
                        f"peak GiB by rank "
                        f"{[round(v, 3) for v in out[n]['peak_gib']]}; "
                        f"{wall:.1f} s wall (started, built, run)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def pipe_toy(device, card: str) -> float:
    """Phase 16 (c): JAX's pipeline_check toy on the card against the
    port on the CPU."""
    from repro_torch.distributed import PipelineConfig, pipeline_apply

    def fn(params, x, stage):
        return torch.tanh(x @ params)

    g = torch.Generator().manual_seed(0)
    w = torch.randn((PIPE_TOY_S, PIPE_TOY_D, PIPE_TOY_D), generator=g) * 0.3
    worst = 0.0
    for m in PIPE_TOY_M:
        x = torch.randn((m * PIPE_TOY_MB, PIPE_TOY_D), generator=g)
        pcfg = PipelineConfig(PIPE_TOY_S, m)
        want = pipeline_apply(fn, w, x, pcfg)
        got = pipeline_apply(fn, w.to(device), x.to(device), pcfg).cpu()
        err = (got - want).abs().max().item()
        check(got.shape == x.shape and err <= PIPE_TOY_TOL,
              f"pipeline toy m={m}: card against CPU {err:.3e}")
        worst = max(worst, err)
    log("pipe", f"[{card}] JAX's pipeline_check toy (s = {PIPE_TOY_S}, m in "
                f"{PIPE_TOY_M}, mb = {PIPE_TOY_MB}, d = {PIPE_TOY_D}): card "
                f"against CPU max |diff| {worst:.3e} (bar {PIPE_TOY_TOL})")
    return worst


def pipe_phase(device, card: str, smoke: bool = False) -> dict:
    """Phase 16: pipeline parallelism on the card (``smoke``: the smoke
    widths, for a rehearsal on the CPU)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    sync(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    one = pipe_one_process(device, card, smoke)
    sync(device)
    torch.cuda.empty_cache()
    gangs = pipe_gangs(device, card, one, smoke)
    toy = pipe_toy(device, card)
    launches = launch_counts()
    launched = {k: v for k, v in launches.items() if v}
    check(not launched, f"the pipeline launched {launched}")
    log("pipe", f"phase 16 took {time.perf_counter() - t0:.1f} s")
    return dict(one=one, gangs=gangs, toy=toy, launches=launches)


def main() -> int:
    if sys.argv[1:] == ["--sanitizer-child"]:
        return sanitizer_child()
    if sys.argv[1:2] == ["--model-profile-child"]:
        return model_profile_child(*sys.argv[2:])
    if sys.argv[1:] == ["--decode-profile-child"]:
        return decode_profile_child()
    if sys.argv[1:2] == ["--lm-train-child"]:
        return lm_train_child(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repository's src/repro_torch is not beside "
              f"{__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    device = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log("card", card)
    log("card", f"torch {torch.__version__} cuda {torch.version.cuda} "
                f"{torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}")
    try:
        build_kernels()
        kernel_edge_cases(device)
        mp = main_path(device, NODES, RPS)
        kernels = kernels_at_main_shapes(device, mp)
        k9 = ship_buckets_row(device, mp)
        del mp["log"], mp["ordered"]
        k4, k8 = other_backends(device, NODES, RPS)
        kernels.append(k4)
        card_equals_cpu(device, NODES, EQ_RPS)
        k5_edge_cases(device)
        k5, k8["serve_launches"], k9["serve_launches"] = serving(
            device, NODES, SERVE_CHUNK, SERVE_STEPS, SERVE_SMALL_STEPS)
        kernels.append(k5)
        t8 = time.perf_counter()
        edge = k6_k7_edge_cases(device)
        kernels += bench_kernel_pairs(device, edge, mp)
        bench_smoke(device)
        log("bench", f"phase 8 took {time.perf_counter() - t8:.1f} s")
        ov = overlap(device)
        for row in kernels:
            if row["name"] in ov["launches"]:
                row["overlap_launches"] = ov["launches"][row["name"]]
        k8["overlap_launches"] = ov["k8_launches"]
        k9["overlap_launches"] = ov["k9_launches"]
        res = resumable(device)
        k9["resume_launches"] = res["k9_launches"]
        for row in kernels:
            row["resume_launches"] = (res["launches"][row["name"]]
                                      + res["streams"]["launches"][
                                          row["name"]])
        gangs = gang(device)
        for row in kernels:
            row["gang_launches"] = gangs["launches"][f"N=2 {GANG_MAIN}"][
                row["name"]]
        static = static_checks(device)
        train = trainer_phase(device, card)
        for row in kernels:
            row["trainer_launches"] = train["trainer"]["launches"][
                row["name"]]
        model_phase(device, card)
        lm = lm_phase(device, card)
        for row in kernels:
            row["lm_train_launches"] = lm["train"]["launches"].get(
                row["name"], 0)
        pipe = pipe_phase(device, card)
        for row in kernels:
            row["pipe_launches"] = pipe["launches"][row["name"]]
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    # K8's and K9's rows join last: the later phases read launch_counts(),
    # which has no entry for them
    print(json.dumps({"kernels": kernels + [k8, k9]}))
    print(json.dumps({"sanitizer": static["sanitizer"]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
