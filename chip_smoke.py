#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (``$CUDA_HOME`` or /usr/local/cuda) and the
checkout around this script; it builds every kernel library of
``src/repro_torch/kernels/csrc`` first, one nvcc per source, in parallel. It exits non-zero, printing no
result, when there is no card or no checkout, and when any phase fails
(nothing is caught).

Phases:
  (a) each kernel against its plain PyTorch version on the card, on the
      inputs that ``run_ask`` itself produces at n=2048, g=4, r=2, B=32,
      max_dwell=512, for the four escape-time workloads, plus Ex. region_fill
      must match exactly; the dwell kernels may differ in at most 1 pixel per
      million, because the plain version's FMA goes through f64 (rounded to
      odd, exact in theory; the bound is what the card's FMA may still
      disagree on).
  (b) the main path at full size: n=16384 (a 1 GiB int32 canvas), g=4, r=2,
      B=32, max_dwell=512 (the paper's parameters): ``solve(p, "ex")`` and
      ``solve(p, "ask")`` for each workload. The kernels' launch counts are
      set to 0 just before and read just after; each must be > 0, the OLT
      scan's (ASK's compactions) too.
  (t) timing at the phase-(b) shapes, for each workload: every kernel
      launch of one ASK run and one Ex run, replayed on the same inputs with
      CUDA events, beside its bound and its plain version (held against the
      kernel with the tolerance of phase a) and, for region_fill, one
      ``index_put_`` of the same writes. The escape kernels get a contract
      bound beside the flops bound: the sum of dwells the call needs x the
      issue slots of one step under the rounding contract
      (``STEP_INSTR``), over 128 lanes x the SMs x the maximum SM clock
      (``clocks.max.sm``); ``slots_per_step`` is the measured time in those
      slots per step. For A, ``lane_eff_row_per_warp`` is the lane
      efficiency of the leaves (the sum of dwells over the lane-steps
      issued) under the mapping before lane refill (one row of 32 pixels
      per warp, run to its slowest lane), computed from the Ex canvas; the
      refill's own is simulated by tools/escape_design.py. The border
      query Q gets a third bound, its exact-work bound: the fewest escape
      steps any exact query needs (``border_work``: a homogeneous border's
      every dwell; any other border's first dwell f plus its cheapest
      witness of a mismatch, min over the points q with d_q != f of
      min(d_q, f) + 1), from the Ex canvas, at the contract's slots a step;
      Q's share of its bound is read against it. One line per Q level gives
      the side, the live and homogeneous regions, the time, the contract
      and the exact-work ms; the homogeneous regions read off the canvas
      must be the ones Q answered. Q's calls (tens of microseconds) are
      timed as device time, replays of a CUDA graph (``graph_ms``), and
      beside it (``event_ms``) with CUDA events around eager calls, which
      also hold the wrapper's host work. One line per T (region_fill)
      level gives the side, the homogeneous regions it fills, its time
      (``ms``, CUDA events as for every other region call; ``graph_ms``,
      device time) and its byte bound. Every OLT-scan call of that ASK run
      and of ``ask_scan``'s warm-up (its level loop launched eagerly, at
      worst-case capacities) is replayed by the kernel, held against its
      run on the path and against the plain version (0 mismatches), and
      timed as device time; one line a call gives the path, N, µs, the
      byte bound and the floor of a graph node. The
      ``kernels`` line reports mandelbrot's times and the mismatches of all
      four workloads (the scan's row adds these calls' to phase (p)'s).
  (c) DP against ASK at n=1024 (mandelbrot): the canvases must be equal.
  (g) the golden check: run_ask on the card at n=256, g=4, r=2, B=16,
      max_dwell=128 must equal tests/golden/<workload>_256.pgm exactly.
  (e) the one-dispatch engines at the phase-(b) shapes, each one CUDA-graph
      replay a call: ``solve(p, "ask_fused")`` and ``solve(p, "ask_scan",
      safety_factor=1e9)`` for each workload. The wrappers' counts are set
      to 0 just before the engines' first calls (each runs its level loop
      as a warm-up and once under capture, through the wrappers) and read
      just after; each must be > 0. The first call and a replay must equal
      ``run_ask``'s canvas and counts, one dispatch, nothing dropped. Then
      one line a workload: each engine's first call's wall (warm-up,
      capture, replay), the walls of ``run_ask``, ``ask_fused`` and
      ``ask_scan`` (median of 5 warm calls in one process) and, for each
      engine, one replay traced by torch.profiler (``replay_trace``: its
      graph captured anew in a recording profiler session of its own, its
      outputs then poisoned, the next call traced): its kernels by name
      (Q, T, A and the scan must show), their device time, its device
      busy share against the wall, and whether its outputs equal the
      capturing call's (they must). Then a zoom sequence:
      five distinct mandelbrot windows through one ``ask_scan`` graph,
      which must capture nothing new (the graph is keyed on all but the window, which Q and A
      read from memory), each canvas equal to ``run_ask``'s, each wall
      beside ``run_ask``'s. Last, the ms of the clone that hands the
      caller a canvas out of the graph's pool; the graphs are released.
  (p) the pooled engine's path: ``solve_batch`` with
      ``EngineOptions(engine="ask_pooled")`` on 8 mandelbrot frames at
      n=16384, g=4, r=2, B=32, max_dwell=512 (a banded canvas of 2^31
      pixels), the heterogeneous batch of tests/test_pooled.py
      ``_mixed_bounds(6, 2)``, at worst-case capacities
      (safety_factor=1e9), its level loop launched kernel by kernel. Its
      four kernels (the OLT scan, the pooled
      border query, T and A on the banded canvas) are counted on that run,
      then every call is replayed by the kernel and by its plain version
      (0 mismatches, scans with N both <= 65536 and > 65536) and timed;
      one line per scan call gives N, its device time in a graph, its byte
      bound and the floor of a graph node (an empty kernel's, measured
      after the build).
      The escape kernels get the contract bound and, for A, the lane
      efficiency before refill as in phase (t), from the final canvas; the
      pooled Q its exact-work bound and one line a level, as Q in phase
      (t), from the frames' final canvases.
      Then: each frame equals the frame pooled alone; ``solve(p,
      "ask_pooled")`` equals the four goldens at n=256; the default sizing
      (safety_factor=2.0) leaves every frame it drops nothing from equal to
      its worst-case canvas; the pipeline makes no host sync
      (``torch.cuda.set_sync_debug_mode("error")``); the pipeline as one
      CUDA-graph replay (``core.graphs.replay``, the planes and the live
      mask its static inputs; the engine does not use it, being slower)
      equals it, at its capture and at a replay; and the warm median wall
      time of the batch, eager and as a graph, is printed beside the sum
      of ``run_ask`` over the same 8 frames, with one replay traced (its
      kernels by name, device busy share) and the ms of the 8 GiB clone
      out of the graph's pool. The graphs are released before phase (s). The OLT scan's and the pooled
      Q's times are device times: a CUDA graph of 20 back-to-back calls,
      replayed (host enqueue time is not device time); the pooled Q's
      ``event_ms`` times eager calls with CUDA events, as phase (t) does
      Q's.
  (f) batched frames and the planner, on phase (p)'s 8 frames at its
      shapes, after its canvases are freed: ``solve_batch(p, bounds,
      safety_factor=1e9)``, the default engine ``ask_scan`` (every frame a
      ring of its own, the frames one worklist, launched eagerly). Its
      four kernels (the same as phase (p)'s) are counted on that run (set
      to 0 just before, read just after, each > 0) and every call is
      replayed by the kernel and by its plain version (0 mismatches; added
      to the ``kernels`` line's rows with ``batched_scan_launches``). Then:
      each frame equals the pooled batch's, nothing dropped; the
      per-frame ranks at each level's inputs three ways, as device time:
      as shipped (the OLT scan, then the rank of each frame's first row
      taken off), with an atomic least rank instead, and through the
      batched-ranks kernel on an [N, F] one-hot matrix; the pipeline
      makes no host sync; the default sizing (safety_factor=2.0) leaves
      every frame it drops nothing from equal to its worst case;
      ``plan=True`` and ``plan=True, observed=`` (an
      ``OccupancyEstimator`` fed the worst-case run's stats) drop nothing
      and equal the worst case, with their dispatches, retries, ring rows
      and ``frame_p_source``; BENCH_7.json's batch (n=512) gives the
      file's ring rows (17636 planned, 17038 pooled), one pooled
      dispatch, nothing dropped, equal canvases; the warm median walls (5
      runs) of the batched scan and the pooled batch at worst case and
      default sizing, of the planned path, and of ``run_ask_scan`` frame
      by frame (graph replays), and one batched scan traced by
      torch.profiler (its kernels by name, its device busy share).
  (m) sharded frames and the split scan, on phase (f)'s 8 frames at its
      shapes, after its canvases are freed, nothing cut: ``make_frames_mesh()``
      must hold every visible card; ``solve_batch(p, bounds, mesh=mesh,
      safety_factor=1e9)`` is the main path, its four kernels (the OLT
      scan, pooled Q, T and A on the banded canvas) counted on that run
      (each > 0) and every call replayed by the kernel and by its plain
      version (0 mismatches; ``sharded_launches`` in the ``kernels``
      line); each canvas and every stats field equals the unsharded
      batched scan's, nothing dropped. Then: 7 frames with ``pad_to=8``
      equal the first 7; ``EngineOptions(engine="ask_pooled", mesh=mesh)``
      equals the pooled batch (its ``olt_caps`` printed); ``dispatch_batch``
      makes no host sync before it returns
      (``torch.cuda.set_sync_debug_mode("error")``), its enqueue ms
      printed against ``finalize()``'s; ``plan=True`` (and the pooled
      plan) with the mesh equals it without, dispatches, retries and ring
      rows printed. The split scan (``core.progressive``) of one frame of
      each workload at the phase-(b) shapes: the refined canvas equals
      ``solve(p, "ask_scan", safety_factor=1e9)``, 2 launches, no host sync
      between the coarse dispatch and ``refine()``'s return; Q, T, A and
      the scan are counted on the split's own two calls a workload (set to 0
      after the ``ask_scan`` reference, read after the second split; the
      first captures the split's graphs: ``split_launches``), and the
      previews' eager Q and T calls of the second call are held against
      their plain versions. The
      split of the 8 frames equals the batched scan. Last, the warm median
      walls (5 runs) of the unsharded batch, the sharded one and the
      unsharded one again; for each workload one ``ask_scan`` replay, the
      time from the coarse dispatch until its preview is ready, and the
      whole split render; and one split render traced by torch.profiler.
  (r) serving, after phase (m)'s canvases are freed: ``launch.
      render_service``, ``launch.frontdoor`` and ``launch.tiles`` on the
      card. (1) ``RenderService(FrameProblem(n=4096, g=4, r=2, B=32,
      max_dwell=512), chunk_frames=8)`` over ``zoom_bounds(64)`` at
      ``pipeline_depth`` 1, then 2 (after a warm render), through
      ``render(sink=)`` with a sink that writes each chunk's canvases to a
      file in a temporary directory: the pooled wrappers' launches are
      counted on the pipelined run (``serving_launches`` in the
      ``kernels`` line, each > 0); each chunk equals ``solve_batch`` of
      its bounds at the same capacities; 8 dispatches, 8 chunks, one
      program signature; before and after each ``finalize()`` of chunk k
      the event of chunk k+1 is read, and finished-after but
      pending-before (the finalize waited for it) fails the run; the
      pipelined run's ``wall_s`` must be below the synchronous run's
      ``busy_s``; both runs' times and each chunk's are printed. (2) The
      paper's size: phase (f)'s 8 frames at n=16384 through
      ``stream_chunks`` at the default chunk (4 frames a card), each chunk
      equal to the batched scan. (3) ``feedback=True`` on the boundary-
      skimming zoom (``width0=6.0``, ``zoom_per_frame=1.02``, 32 frames)
      at n=4096 with ``engine`` ``ask_scan`` and ``ask_pooled``: nothing
      dropped, canvases equal ``solve_batch(..., safety_factor=1e9)``;
      retries, ring rows and signatures printed; every call of the four
      kernels replayed by the kernel and by its plain version. (4) The
      front door: tests/test_frontdoor.py's 8 tenants over a mixed
      mandelbrot / julia service at n=1024: each tenant's frames equal
      that tenant rendered alone, in fewer dispatches in all. (5) The
      tiles: BENCH_9.json's scenario at its config (n=256, max_dwell=64,
      g=4, r=2, B=16, chunk 8, its 18 views): hit rate 0.7667, 6
      dispatches against 18 uncached, every tile equal to an exact render;
      then ``serve_progressive`` over the same views: each preview before
      its exact tiles, which equal ``serve``'s, every pooled call held
      against its plain version; the time to the first preview and to the
      last exact tile printed.
  (u) the tuned tier and k-D SSD, after phase (r)'s graphs are released.
      The launch counts of the eight wrappers are set to 0 first and read
      last; each must be > 0. (1) ``autotune.tune_problem`` at the main
      configuration (mandelbrot, ``FULL``) with ``pooled_frames=8``, into
      build/tuning/phase_u.json: for every key, each candidate schedule
      (the escape loop's steps per block U in {4, 8, 16}, Ex's thread block
      16 x 16, 8 x 32 or 4 x 32) equals the default schedule's output bit
      for bit (``tune`` raises otherwise), and its device time is printed
      beside the winner and the default; the default's output on the
      tuner's inputs is held against the plain version on a sample of up
      to 2^18 points a key. (2) ``solve(p, "ask_tuned")`` with that cache
      on the four workloads at ``FULL`` (worst-case capacities) captures a
      graph of its own and equals ``solve(p, "ask_scan")`` pixel for pixel
      and stat for stat, one dispatch; both walls, median of 5.
      (3) ``solve_batch`` with ``engine="ask_tuned"`` and the cache on
      phase (f)'s 8 frames equals the batched scan. (4) BENCH_6.json's and
      BENCH_10.json's identity, dispatch, ring-row and overflow fields
      hold on the card (``bench_invariants``). (5) ``ssd_synth`` at its
      defaults through ex, ask, ask_scan and ask_tuned equals its field;
      its Q and A take the plain path on the card, its T and scans launch
      the kernels. (6) ``core.ssd_synth.solve_ask_3d`` on a 3-D field
      (``SSD_3D``) equals the field, with the generator's level counts.
  (s) MoE serving: moonshot-v1-16b-a3b at full width and depth (48 layers,
      bf16, 28,057,995,264 random parameters from a seed, made on the card
      one tensor at a time), after phase (u)'s canvases are freed. First a
      teacher-forcing check at full width with 2 layers in f32 and a
      capacity factor at which nothing drops: prefill + decode against
      ``forward`` (rtol and atol 1e-4, f32 on both sides). Then
      ``serve.generate`` on 8 requests of 512 prompt tokens, 32 generated:
      the batched-ranks launches are counted on that run (48 + 48 x 31),
      every call is held against its plain version on the card (0
      mismatches), the run is repeated with the plain ranks substituted
      (tokens and every call's per-expert counts identical), prefill and
      decode times are the median of 3 warm runs, the prefill step (its
      logits finite) and one whole run are traced with torch.profiler (a
      failure there fails the run), and the kernel is timed at the prefill
      and decode shapes with CUDA graphs beside its bound, its plain
      version and ``torch.cumsum``, with its launches in one call (which
      must be 1).
  (l) the other decoder families, after phase (s)'s model is freed. First
      teacher forcing in f32 at full width, as in phase (s), for
      deepseek-v2-lite-16b (MLA + MoE, 2 layers), jamba-v0.1-52b (Mamba,
      attention, MLP and MoE: one group of 8 layers, experts cut to 4,
      top 2), xlstm-350m (mLSTM + sLSTM, full depth), and jamba's cut with
      the int8 KV cache (logits within 1% of the largest |logit|, the
      tolerance of tests/test_torch_models.py's int8 teacher forcing).
      Then phase (s)'s serving run in bf16, each model made on the card
      from a seed and freed before the next: deepseek-v2-lite-16b at full
      depth (16,210,324,992 parameters, 27 x 32 batched-ranks launches),
      jamba-v0.1-52b cut to one group of 8 layers (13,295,235,072; the 32
      layers take 103 GB in bf16; 4 MoE layers x 32 launches), xlstm-350m
      at full depth (429,401,184; no MoE, no launch).
  (w) the encoder-decoder and cross-attention families, after phase (l)'s
      last model is freed. First teacher forcing in f32 at full width, as
      in phase (l), with random media (normal): whisper-large-v3 at full
      depth (32 encoder + 32 decoder layers, frames [2, 12, 1280]; decode
      against ``encode``'s memory), llama-3.2-vision-90b cut to one group
      (4 self-attention layers and 1 cross layer of 100, media [2, 4096,
      8192]), and whisper with the int8 KV cache. Then ``serve.generate``
      in bf16 on 8 requests, random parameters made on the card from a
      seed, each model freed before the next: whisper-large-v3 at full
      depth (1,602,360,320 parameters; 1500 frames a request, the
      encoder's 30 s window; 224 prompt tokens, 32 generated) and
      llama-3.2-vision-90b cut to two groups (10 of 100 layers, 2 of them
      cross; 10,657,898,496 parameters; the whole model is 175 GB in bf16;
      4096 media tokens a request, 512 prompt tokens, 32 generated). Each
      run is phase (l)'s (no kernel launches on this path), and also logs
      whisper's encode ms and, from the decode trace (each cross-attention
      call and its projections in a profiler range), the device ms a token
      in the cross layers and in their K/V projections, which decode
      recomputes over the whole memory at every step.
  (x) training, after phase (w)'s last model is freed: moonshot-v1-16b-a3b
      at full width on ``data.SyntheticLMData``'s batches (seed 0; 8
      sequences of 512 tokens). First ``transformer.loss_fn`` and its
      gradients in f32 with 2 of 48 layers and the config's remat
      ("full"): the batched-ranks kernel runs under autograd, in the
      forward and again in each layer's recomputation (launches:
      ``transformer.moe_forwards``, 4), every call 0 mismatches against
      the plain version; the loss and every gradient leaf equal, within
      1e-5 of the leaf's largest |gradient| (the embedding's backward
      adds atomically), those of the same step with the plain ranks
      substituted and those with remat off. Then ``launch.train.build``'s
      state and step in bf16 with 4 of 48 layers (2,953,332,736
      parameters; AdamW's f32 master, m and v): 6 steps with
      microbatch=1, the last traced by torch.profiler with the optimizer
      update in a range, then 4 with microbatch=2 on the same state; the
      kernel's launches each step (4 forward + 4 recomputed, twice that
      with 2 microbatches), every call 0 mismatches, the losses finite,
      the parameters unchanged by step 0 (its learning rate is 0) and
      changed by step 1; the warm steps' median ms and tokens/s, peak
      memory, the traced step's busy share and the optimizer's share of
      its device time. No checkpoint of this model is written (47 GB):
      the checkpointer and resume are held on the CPU.
  (z) sharding, after phase (x)'s state is freed, on a one-rank NCCL
      process group brought up in this script (an in-process store, no
      port) and its 1 x 1 (data, model) mesh, so every collective is an
      identity: the phase proves the sharded code path on the card
      (DTensor state, NCCL, EP through the batched-ranks kernel); the
      multi-rank results are held on the CPU (the chip machine has one
      card). moonshot-v1-16b-a3b at full width, bf16, remat "full", on
      phase (x)'s batches (8 x 512): 3 steps of ``make_train_step(cfg,
      opts)`` with 2 of 48 layers (1,812,211,712 parameters), their
      parameters and master weights then kept on the host, and 3 steps of
      ``make_train_step(cfg, opts, mesh=)`` from the same seed with
      ``act_sharding=("data",)`` and ``ep_axis="model"``; the losses,
      grad_norm and every parameter and master leaf must be equal bit for
      bit, or within tests/test_torch_train_step.py's tolerances (the
      line says which); every batched-ranks call 0 mismatches, its
      launches a step ``transformer.moe_forwards``' (2 forward + 2 in
      remat's recomputation) in both; each run's median warm step ms and
      peak memory; one more sharded step traced (busy share). Then
      ``launch.serve.serve`` (the serve CLI's path) with 4 of 48 layers on
      8 requests of 512 + 32 tokens, with the mesh and without: the greedy
      tokens must be equal. Then ``pipeline_forward`` on a one-stage mesh
      with 2 layers, batch 8 x 512: with 1 microbatch equal to the plain
      stack bit for bit, with 2 to the plain stack over each half. The
      NCCL version is logged; the group is destroyed at the phase's end.
  (d) the dry-run and the sharded serving steps, after phase (z). First
      ``launch.dryrun.run_cell`` on the fake process group of one rank and
      its (1, 1) mesh (fake tensors: nothing allocated, no kernel run, the
      CPU path traced) for three cells of moonshot-v1-16b-a3b at full
      width in bf16: phase (z)'s train cell (2 of 48 layers, remat
      "full", 8 x 512), a prefill cell (8 x 512) and a decode cell (8
      rows, cache 544) at 4 of 48 layers; the fake group is destroyed.
      Then the same steps for real on a one-rank NCCL group and its (1, 1)
      mesh: one sharded train step on ``train.build``'s state and phase
      (x)'s first batch; ``make_sharded_prefill_step`` and 32
      ``make_sharded_serve_step`` calls (cache 512 + 32) on 8 random
      prompts, and ``make_prefill_step`` / ``make_serve_step`` without a
      mesh on the same weights: the logits and tokens must be equal bit
      for bit, every batched-ranks call 0 mismatches, as many launches
      sharded as unsharded. For each cell the real step (the train step,
      the sharded prefill, the first sharded decode step) runs once under
      ``launch.step_analysis``' counters and the flop counter, the card's
      peak reset just before: its argument and aliased bytes (the
      DTensor inputs' local blocks; those the step updated in place), its
      collectives a kind, its flops and its collective count must equal
      the dry-run's; the dry-run's peak over the measured one (the
      arguments plus ``max_memory_allocated`` above what was allocated
      before the step) must lie in [0.85, 1.15]. Then the sharded and
      unsharded prefill ms and decode ms a token, timed once more with
      nothing recorded. Then tensor parallelism on the card: the fake
      process group of 4 ranks (its collectives return at once and move
      nothing; it takes CUDA tensors) and its (1, 4) mesh, so the steps
      split their products over a model axis of 4 (heads, the MLP, the
      vocabulary; the experts under EP): ``run_cell`` of the same three
      cells on fake tensors, then rank 0's real steps on the card on the
      same group (the train step on ``train.build``'s sharded state, the
      sharded prefill and 32 decode steps on the same prompts): argument
      and aliased bytes, collectives a kind, flops and collective count
      equal the dry-run's, the predicted peak over the measured one in
      [0.85, 1.15], every batched-ranks call 0 mismatches; rank 0's
      train step ms and peak, prefill and decode ms are logged beside the
      one-rank run's, labelled "rank 0, collectives no-ops" (the other
      ranks' parts are never summed in: these outputs are not compared
      and the ms is not a tensor-parallel throughput). On the same group
      and mesh, the same checks for xlstm-350m at full width and depth
      (mLSTM and sLSTM split: a train step, a prefill and 8 decode steps,
      8 x 64, cache 72) and chatglm3-6b at full width, 4 of 28 layers (2
      KV heads: the cache split on the sequence, split-KV decode; a
      prefill and 32 decode steps, 8 x 512, cache 544); these make no
      batched-ranks call, and their peaks and ms are logged. Then FSDP:
      the fake process group of 16 ranks and its (4, 4) (data, model)
      mesh, FSDP on (each large weight's contraction dim split over the
      data axis too, gathered a block at a time when the block runs):
      moonshot at full width and 4 of 48 layers, ``run_cell`` of a train
      (8 x 512), a prefill (8 x 512) and a decode cell (cache 544), then
      rank 0's real steps on the card, held as above (bytes, collectives,
      flops and count equal; peak within [0.85, 1.15]; every batched-ranks
      call 0 mismatches); then moonshot's whole train state at all 48
      layers (28.06e9 parameters, 392.8 GB in all) made per shard on rank
      0 (``launch.train.build``'s ``init_state``: rank 0's blocks only, a
      leaf at a time): its ``max_memory_allocated`` must stay within the
      rank's blocks plus ``steps.init_bound_bytes`` (twice the largest
      leaf in f32), and one train step on it (8 x 512) runs, its peak and
      ms logged, every batched-ranks call 0 mismatches.

After the build, the step loop of each escape kernel is counted in its
SASS (``cuobjdump -sass`` of the built library): for each instance, the
innermost loop that multiplies in f32 and tests |z|^2, from a backward
branch's target to the branch, its instructions all and by kind; the
``kernels`` line gives the default schedule's (``default_instance``).

    python3 chip_smoke.py --sass-baseline DIR

builds the escape libraries from this checkout's and from DIR's kernel
sources (DIR: the root of another checkout, e.g. a ``git archive`` of the
parent commit unpacked under build/), prints whether each default
instance here compiles to the same SASS, instruction for instruction, as
DIR's instance of the same kind (DIR's may have no schedule arguments),
and exits non-zero if one differs; it runs nothing else.

Its last lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=2048, g=4, r=2, B=32, max_dwell=512)
FULL = dict(n=16384, g=4, r=2, B=32, max_dwell=512)
GOLDEN = dict(n=256, g=4, r=2, B=16, max_dwell=128)
DP = dict(n=1024, g=4, r=2, B=32, max_dwell=512)
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# f32 flops per escape step (an FMA counts 2), the final escape test, and
# map_coords' two FMAs; see the rounding contract in kernels/ref.py
STEP_FLOPS = {"mandelbrot": 8, "julia": 8, "burning_ship": 8, "multibrot": 14}
TEST_FLOPS, MAP_FLOPS = 3, 4
# issue slots per escape step under the rounding contract
# (csrc/escape_time.cuh): nothing fuses but the FMA the contract places, so
# 7 arithmetic instructions and one compare; multibrot 9 + 4(m - 2), at the
# registered m = 3. One slot per lane: 128 lanes per SM.
STEP_INSTR = {"mandelbrot": 8, "julia": 8, "burning_ship": 8, "multibrot": 13}
LANES_PER_SM = 128
CARD: dict = {}  # "slots_per_s", set in main from the SM count and clocks.max.sm
ESCAPE_KERNELS = {  # name -> (library, kernel function in its SASS)
    "mandelbrot_dwell": ("mandelbrot_dwell", "mandelbrot_dwell_kernel"),
    "perimeter_query": ("perimeter_query", "perimeter_query_kernel"),
    "region_dwell": ("region_dwell", "region_dwell_kernel"),
    "perimeter_query_pooled": ("perimeter_query", "perimeter_query_pooled_kernel"),
    "region_dwell_pooled": ("region_dwell_pooled", "region_dwell_pooled_kernel"),
}

KERNEL_OF = {"mandelbrot": "mandelbrot_dwell", "perimeter_query": "perimeter_query",
             "region_fill": "region_fill", "region_dwell": "region_dwell",
             "compact_ranks": "olt_compact",
             "perimeter_query_pooled": "perimeter_query_pooled",
             "region_fill_pooled": "region_fill_pooled",
             "region_dwell_pooled": "region_dwell_pooled"}
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "mandelbrot_dwell": ("src/repro_torch/kernels/csrc/mandelbrot_dwell.cu",
                         "src/repro/kernels/mandelbrot_dwell.py:44"),
    "perimeter_query": ("src/repro_torch/kernels/csrc/perimeter_query.cu",
                        "src/repro/kernels/perimeter_query.py:55"),
    "region_fill": ("src/repro_torch/kernels/csrc/region_fill.cu",
                    "src/repro/kernels/region_fill.py:42"),
    "region_dwell": ("src/repro_torch/kernels/csrc/region_dwell.cu",
                     "src/repro/kernels/region_dwell.py:51"),
}
POOLED = dict(n=16384, g=4, r=2, B=32, max_dwell=512)
POOLED_KERNELS = {  # name -> (source, what it replaces)
    # one scan for compact_ranks_kernel (:95) and compact_ranks_blocked (:62)
    "olt_compact": ("src/repro_torch/kernels/csrc/olt_compact.cu",
                    "src/repro/kernels/olt_compact.py:95"),
    # JAX computes the pooled border query with jnp, in no Pallas kernel
    "perimeter_query_pooled": ("src/repro_torch/kernels/csrc/perimeter_query.cu",
                               "src/repro/kernels/ref.py:156"),
    # the single-frame fill's kernel body on frame-tagged rows
    "region_fill_pooled": ("src/repro_torch/kernels/csrc/region_fill.cu",
                           "src/repro/kernels/region_fill_pooled.py:47"),
    "region_dwell_pooled": ("src/repro_torch/kernels/csrc/region_dwell_pooled.cu",
                            "src/repro/kernels/region_dwell_pooled.py:59"),
}
SERVE = dict(arch="moonshot-v1-16b-a3b", batch=8, prompt=512, gen=32, seed=0)
SERVE_KERNEL = {"batched_ranks": ("src/repro_torch/kernels/csrc/moe_dispatch.cu",
                                  "src/repro/kernels/moe_dispatch.py:35")}
SCAN_SPLIT = 1 << 16  # the single-block bound of JAX's compact_ranks_kernel
PLAIN_POINTS = 1 << 24  # points per chunk when a plain version is replayed


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- recording what the main path hands each kernel ---------------------------

TAPPED = ("mandelbrot", "perimeter_query", "region_fill", "region_dwell")


def single_wrappers() -> dict:
    """The single-frame entry points' kernel wrappers, which count their
    launches (``kernels.ops`` routes to them)."""
    from repro_torch.kernels import (mandelbrot_dwell, perimeter_query,
                                     region_dwell, region_fill)
    return {"mandelbrot": mandelbrot_dwell.mandelbrot_dwell,
            "perimeter_query": perimeter_query.perimeter_query,
            "region_fill": region_fill.region_fill,
            "region_dwell": region_dwell.region_dwell}


def recorded_kw(name: str, kw: dict) -> dict:
    """A recorded ``kernels.ops`` call's keywords as the kernel modules'
    wrappers and plain versions take them: without the routing and Ex's
    block (a recording phase runs the default policy and schedule, which
    it checks) and, for the pooled query, without ``n``, which only keys a
    tuned choice."""
    from repro_torch.kernels.policy import CUDA_POLICY
    if (kw.get("policy", CUDA_POLICY) != CUDA_POLICY or "backend" in kw
            or kw.get("block") is not None):
        fail(f"a recorded {name} call is routed by {kw.get('policy')}, block "
             f"{kw.get('block')}: the recording phases replay the defaults")
    drop = ("policy", "block") + (("n",) if name == "perimeter_query_pooled"
                                  else ())
    return {k: v for k, v in kw.items() if k not in drop}


@contextlib.contextmanager
def recording(ops, calls: list, keep_canvas: bool, names=TAPPED):
    """Swap the entry points ``names`` in ``kernels.ops`` for ones that
    record each call: its arguments (the canvas left out), its output (the
    scan's cloned), and with ``keep_canvas`` the canvas before and after a
    region call."""

    saved = {k: getattr(ops, k) for k in names}

    def tap(name):
        fn = saved[name]
        region = name.startswith("region")

        def keep(i, a):
            if region and i == 0:
                return None  # the canvas
            return a.clone() if isinstance(a, torch.Tensor) else a

        def wrapped(*args, **kw):
            before = args[0].clone() if region and keep_canvas else None
            out = fn(*args, **kw)
            kept = ((out.clone() if keep_canvas else None) if region else
                    tuple(x.clone() for x in out) if name == "compact_ranks"
                    else out)
            calls.append(dict(
                name=name, args=tuple(keep(i, a) for i, a in enumerate(args)),
                kw=recorded_kw(name, kw), before=before, out=kept))
            return out

        return wrapped

    try:
        for k in saved:
            setattr(ops, k, tap(k))
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def plain_of(call, canvas=None):
    """The plain version's output for one recorded call (region calls in
    place on ``canvas``)."""
    from repro_torch.kernels import (mandelbrot_dwell, perimeter_query,
                                     region_dwell, region_fill)
    name, a, kw = call["name"], call["args"], dict(call["kw"])
    if name == "mandelbrot":
        return mandelbrot_dwell.mandelbrot_dwell_plain(a[0], **kw)
    if name == "perimeter_query":
        return perimeter_query.perimeter_query_plain(*a, **kw)
    kw.pop("scheme"), kw.pop("tile")
    if name == "region_fill":
        return region_fill.region_fill_plain(canvas, *a[1:], **kw)
    return region_dwell.region_dwell_plain(canvas, *a[1:], **kw)


def kernel_of(call, canvas=None):
    """The kernel's output for one recorded call (region calls in place on
    ``canvas``)."""
    from repro_torch.kernels import ops
    a, kw = call["args"], call["kw"]
    if call["name"] == "mandelbrot":
        return ops.mandelbrot(a[0], **kw)
    if call["name"] == "perimeter_query":
        return ops.perimeter_query(*a, **kw)
    return getattr(ops, call["name"])(canvas, *a[1:], **kw)


def live_rows(call) -> int:
    """The live OLT rows of a region or border call: its device count."""
    return int(call["args"][-1].item())


def pixels_of(call) -> int:
    """Points the call computes (pixels it writes, for region_fill)."""
    kw = call["kw"]
    if call["name"] == "mandelbrot":
        return call["args"][0] ** 2
    if call["name"] == "perimeter_query":
        return live_rows(call) * 4 * kw["side"]
    return live_rows(call) * kw["side"] ** 2


def tally_add(tally: dict, call, got, want) -> None:
    """Count where a kernel's output differs from the plain version's."""
    if isinstance(got, tuple):  # perimeter_query: (homog, common)
        got, want = (torch.stack([x[0].int(), x[1]]) for x in (got, want))
    bad = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    name = KERNEL_OF[call["name"]]
    t = tally.setdefault(name, dict(mismatches=0, pixels=0, max_abs_err=0))
    t["mismatches"] += bad
    t["pixels"] += pixels_of(call)
    t["max_abs_err"] = max(t["max_abs_err"], err)


def check_tally(tally: dict, phase: str) -> None:
    for name, t in tally.items():
        allowed = 0 if name == "region_fill" else t["pixels"] // 1_000_000
        if t["mismatches"] > allowed:
            fail(f"phase {phase}: {name} differs from its plain version in "
                 f"{t['mismatches']} outputs (allowed {allowed} of "
                 f"{t['pixels']} pixels)")


# -- timing and bounds -----------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn``: a CUDA graph of ``calls``
    back-to-back calls, captured after one warm-up call on the capture
    stream (where a wrapper makes the state it keeps per stream) and
    replayed ``reps`` times between CUDA events. Unlike ``cuda_ms`` this
    leaves out the host's enqueue time, which rules calls of a few
    microseconds."""
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * calls)
    del g
    return ms


def host_ms(fn) -> float:
    """Wall time of one run of ``fn`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def escape_flops(dwell, max_dwell: int, workload: str) -> float:
    """f32 flops the escape loop needs for these dwells (data-dependent)."""
    d = dwell.double()
    tests = (dwell < max_dwell).double()
    return float((MAP_FLOPS + d * STEP_FLOPS[workload] + tests * TEST_FLOPS).sum())


def contract_ms(steps: float, workload: str) -> float:
    """The contract bound: ``steps`` escape steps at ``STEP_INSTR`` issue
    slots each, over every lane of the card at its maximum SM clock."""
    return steps * STEP_INSTR[workload] / CARD["slots_per_s"] * 1e3


def slots_per_step(ms: float, steps: float) -> float:
    """Lane issue slots the card had per escape step in ``ms``."""
    return ms * 1e-3 * CARD["slots_per_s"] / steps if steps else float("nan")


def border_dwells(call, ex_canvas):
    """The [k, 4, side] border dwells of a perimeter_query call's live
    rows, read off the Ex canvas of the same frame."""
    from repro_torch.kernels import ref
    ys, xs = ref.perimeter_coords(call["args"][0][:live_rows(call)],
                                  call["kw"]["side"])
    return ex_canvas[ys.long(), xs.long()]


def border_work(dwell) -> tuple:
    """(homogeneous regions, exact-work steps) of [k, 4, side] border
    dwells. The exact-work steps are the fewest escape steps that any exact
    query needs: a homogeneous border needs every dwell; any other needs f,
    the dwell of its point (0, 0), plus its cheapest witness of a mismatch,
    min over the points q with d_q != f of min(d_q, f) + 1."""
    d = dwell.reshape(dwell.shape[0], -1).long()
    f = d[:, :1]
    differ = d != f
    homog = ~differ.any(1)
    witness = torch.where(differ, torch.minimum(d, f) + 1,
                          torch.full_like(d, 1 << 40)).amin(1)
    steps = torch.where(homog, d.sum(1), f[:, 0] + witness)
    return int(homog.sum()), float(steps.double().sum())


def query_level(phase: str, call, dwells, ms: float, workload: str) -> float:
    """Log one border-query call (one level): side, live regions,
    homogeneous regions, its time, its contract bound (every border dwell)
    and its exact-work bound (``border_work``). ``dwells`` yields
    [k, 4, side] chunks of its live rows' border dwells; the homogeneous
    regions they give must be the ones the call answered. Returns the
    exact-work steps."""
    homog = 0
    steps = exact = 0.0
    for d in dwells:
        h, e = border_work(d)
        homog += h
        exact += e
        steps += float(d.double().sum())
    k = int(call["args"][POOLED_COUNT_ARG.get(call["name"], 1)].item())
    answered = int(call["out"][0][:k].sum())
    if answered != homog:
        fail(f"phase {phase}: {call['name']} answered {answered} homogeneous "
             f"regions, the canvas holds {homog}")
    log(f"({phase}) {workload} {call['name']} level: " + json.dumps(dict(
        side=call["kw"]["side"], live=k, homog=homog, ms=ms,
        contract_ms=contract_ms(steps, workload),
        exact_ms=contract_ms(exact, workload))))
    return exact


def bound_of(call, ex_canvas, workload: str):
    """(least ms, ms by flops, ms by bytes, escape steps) of one kernel
    call on this card's peaks: bytes moved once over HBM bandwidth vs the
    f32 flops these inputs need, with the dwells (and their sum, the escape
    steps) read off the Ex canvas of the same frame. Only the live rows of
    an OLT count: the padding is no work the call must do."""
    from repro_torch.kernels import ref
    name, a, kw = call["name"], call["args"], call["kw"]
    md = kw.get("max_dwell", 0)
    dwell = None
    if name == "mandelbrot":
        dwell = ex_canvas
        nbytes = ex_canvas.numel() * 4
    elif name == "perimeter_query":
        k = live_rows(call)
        dwell = border_dwells(call, ex_canvas)
        nbytes = k * (8 + 5) + 4
    else:
        k, side = live_rows(call), kw["side"]
        nbytes = k * side * side * 4 + k * 12
        if name == "region_dwell":
            ys, xs = ref.region_index(a[1][:k], side)
            dwell = ex_canvas[ys, xs]
    flops = 0.0 if dwell is None else escape_flops(dwell, md, workload)
    steps = 0.0 if dwell is None else float(dwell.double().sum())
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3, steps


def row_per_warp_efficiency(chunks) -> float:
    """The lane efficiency of the leaves under the mapping before lane
    refill: the sum of dwells over the lane-steps issued when each 32
    consecutive pixels of a leaf item (``chunks``: [k, ...] tensors of
    items, each flattened in row-major order) run on one warp to the
    slowest."""
    useful = issued = 0.0
    for c in chunks:
        d = c.reshape(c.shape[0], -1).to(torch.int32)
        groups = torch.nn.functional.pad(d, (0, (-d.shape[1]) % 32))
        useful += float(d.double().sum())
        issued += 32 * float(groups.view(d.shape[0], -1, 32).amax(2).double().sum())
    return useful / issued if issued else float("nan")


def library_fill(call, canvas):
    """One ``index_put_`` that writes what a region_fill call writes."""
    from repro_torch.kernels import ref
    a, side = call["args"], call["kw"]["side"]
    k = int(a[3].item())
    ys, xs = (t.reshape(-1) for t in ref.region_index(a[1][:k], side))
    vals = a[2][:k, None, None].expand(k, side, side).reshape(-1)
    return lambda: canvas.index_put_((ys, xs), vals)


# -- the compiled step loop -------------------------------------------------------

SASS_FP = ("FMUL", "FADD", "FFMA", "FSETP", "FSEL", "FMNMX")


def instance(mangled: str) -> str:
    """``name<K,U>`` of a kernel instance from its mangled symbol."""
    m = re.search(r"([a-z_]+_kernel)I((?:Li\d+E)+)E", mangled)
    if m is None:
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>"


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program: beside nvcc, else on PATH."""
    import shutil
    from repro_torch.kernels import _build
    path = Path(_build._nvcc()).parent / name
    found = str(path) if path.exists() else shutil.which(name)
    if found is None:
        fail(f"{name} not found beside nvcc or on PATH")
    return found


def sass_loops(library: str) -> dict:
    """For each kernel instance in a built library, its step loop as
    ``cuobjdump -sass`` prints it: the innermost loop (from a backward
    branch's target to the branch, both included) that holds an FMUL and
    an FSETP (the escape test).
    Returns {instance: {"instr": all instructions, "fp": f32 arithmetic and
    compares (``SASS_FP``), "other": the rest}}."""
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        lines = chunk.splitlines()
        ops, labels, pending = [], {}, []
        for line in lines[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins is None:
                continue
            addr = int(ins.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            words = ins.group(2).split()
            op = words[1] if words[0].startswith("@") else words[0]
            ops.append((addr, op.split(".")[0], ins.group(2)))
        loops = []
        for addr, op, txt in ops:
            start = None
            if op == "BRA":
                label = re.search(r"\((\.L_x_\d+)\)", txt)
                at = re.search(r"\b0x([0-9a-f]+)\b", txt)
                start = (labels.get(label.group(1)) if label else
                         int(at.group(1), 16) if at else None)
            if start is not None and start <= addr:
                body = [o for o in ops if start <= o[0] <= addr]
                if {"FMUL", "FSETP"} <= {o[1] for o in body}:
                    loops.append(body)
        if loops:
            body = min(loops, key=len)
            fp = sum(o[1] in SASS_FP for o in body)
            out[instance(lines[0].strip())] = dict(instr=len(body), fp=fp,
                                                   other=len(body) - fp)
    return out


ESCAPE_LIBS = ("mandelbrot_dwell", "perimeter_query", "region_dwell",
               "region_dwell_pooled")


def sass_text(library: str) -> dict:
    """{instance: its SASS instructions, addresses, encodings and label
    numbers left out} of a built library (``cuobjdump -sass``)."""
    text = subprocess.run([cuda_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        lines = chunk.splitlines()
        found = (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
                 for line in lines[1:])
        out[instance(lines[0].strip())] = [
            re.sub(r"\.L_x_\d+", ".L", m.group(1)) for m in found if m]
    return out


def sass_baseline(root: Path) -> int:
    """The ``--sass-baseline`` mode (module docstring): 0 when every
    default instance of the escape libraries compiles to the same SASS as
    ``root``'s instance of its kind, else 1."""
    from repro_torch.kernels import _build
    built = _build.build(ESCAPE_LIBS)
    mine = {lib: sass_text(b["path"]) for lib, b in built.items()}
    _build.CSRC = root / "src" / "repro_torch" / "kernels" / "csrc"
    built = _build.build(ESCAPE_LIBS)
    theirs = {lib: sass_text(b["path"]) for lib, b in built.items()}
    rows, differ = {}, 0
    for lib in ESCAPE_LIBS:
        for inst, ins in sorted(mine[lib].items()):
            fn, args = inst.rstrip(">").split("<")
            kind, *schedule = args.split(",")
            if schedule != default_instance(fn).rstrip(">").split(",")[1:]:
                continue  # a schedule of the tuned tier only
            base = next((theirs[lib][i] for i in (f"{fn}<{kind}>", inst)
                         if i in theirs[lib]), None)
            rows[inst] = dict(same=base == ins, instructions=[
                len(ins), None if base is None else len(base)])
            differ += base != ins
    log(f"SASS of the default instances against {root} (this tree, "
        f"{root}): {json.dumps(rows)}")
    log(f"{len(rows) - differ} of {len(rows)} default instances compile to "
        "the same SASS")
    return 1 if differ or not rows else 0


# -- the phases ----------------------------------------------------------------

def read_pgm(path: Path):
    import numpy as np
    raw = path.read_bytes()
    header, pixels = raw.split(b"\n", 1)
    _, w, h, _ = header.split()
    return np.frombuffer(pixels, dtype=np.uint8).reshape(int(h), int(w)).astype(np.int32)


def phase_a(dev) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.workloads import FrameProblem, solve
    tally: dict = {}
    for wl in WORKLOADS:
        calls: list = []
        p = FrameProblem(**SMALL, workload=wl, device=dev)
        with recording(ops, calls, keep_canvas=True):
            solve(p, "ask")
            solve(p, "ex")
        for call in calls:
            if call["name"].startswith("region"):
                tally_add(tally, call, call["out"], plain_of(call, call["before"]))
            else:
                tally_add(tally, call, call["out"], plain_of(call))
        log(f"(a) {wl}: {len(calls)} kernel calls held against plain: " +
            ", ".join(f"{k} {v['mismatches']}/{v['pixels']}"
                      for k, v in tally.items()))
    check_tally(tally, "a")
    missing = set(KERNELS) - set(tally)
    if missing:
        fail(f"phase a: no call of {sorted(missing)}")
    return tally


def phase_b(dev) -> dict:
    """The main path, counted: every launch count set to 0, then Ex and ASK
    once per workload, then the counts read. Wall times are the median of
    5 further runs (host clock, each ending in a synchronize)."""
    from repro_torch.workloads import FrameProblem, solve
    wrappers = list(single_wrappers().values())
    problems = {wl: FrameProblem(**FULL, workload=wl, device=dev)
                for wl in WORKLOADS}
    n, md = FULL["n"], FULL["max_dwell"]
    rows = {}
    scan = pooled_wrappers()["olt_compact"]
    for w in [*wrappers, scan]:
        w.launches = 0
    for wl, p in problems.items():
        ex, _ = solve(p, "ex")
        ask, st = solve(p, "ask")
        for name, c in (("ex", ex), ("ask", ask)):
            if c.shape != (n, n) or c.dtype != torch.int32:
                fail(f"phase b: {wl} {name} canvas {c.dtype} {tuple(c.shape)}")
            if int(c.min()) < 0 or int(c.max()) > md:
                fail(f"phase b: {wl} {name} dwell outside [0, {md}]")
        rows[wl] = dict(kernel_launches=st.kernel_launches,
                        region_counts=list(st.region_counts),
                        leaf_count=st.leaf_count, olt_caps=list(st.olt_caps),
                        ask_vs_ex_share=int((ex != ask).sum()) / (n * n))
        del ex, ask
    launches = {name: w.launches for name, w in zip(KERNELS, wrappers)}
    log(f"(b) launches on the main path: {json.dumps(launches)}; olt_compact "
        f"(ASK's compactions) {scan.launches}")
    for name, k in {**launches, "olt_compact": scan.launches}.items():
        if k == 0:
            fail(f"phase b: {name} was never launched on the main path")
    for wl, p in problems.items():
        for method in ("ex", "ask"):
            runs = sorted(host_ms(lambda: solve(p, method)) for _ in range(5))
            rows[wl][f"{method}_ms"] = runs[2]
            rows[wl][f"{method}_ms_range"] = [runs[0], runs[-1]]
        log(f"(b) {wl}: " + json.dumps(rows[wl]))
    return dict(rows=rows, launches=launches)


def phase_t(dev, wl: str) -> dict:
    """Per-kernel device time at the phase-(b) shapes of one workload,
    summed over the launches of one ASK run and one Ex run, beside the
    plain versions (held against the kernels), the library yardstick and,
    for the escape kernels, the contract bound and (A) the leaves' lane
    efficiency before refill."""
    from repro_torch.kernels import ops, ref
    from repro_torch.workloads import FrameProblem, solve
    from repro_torch.core import ask
    p = FrameProblem(**FULL, workload=wl, device=dev)
    calls: list = []
    with recording(ops, calls, keep_canvas=False,
                   names=TAPPED + ("compact_ranks",)):
        ex, _ = solve(p, "ex")
        solve(p, "ask")
    # the scan calls of ask_scan's warm-up: its level loop, launched eagerly
    warm: list = []
    with recording(ops, warm, keep_canvas=False, names=("compact_ranks",)):
        ask._scan_pipeline(p, ask._resolve_capacities(p, None, 0.7, 1e9))
    scans = scan_replays("t", wl, {
        "ask": [c for c in calls if c["name"] == "compact_ranks"],
        "ask_scan warm-up": warm})
    calls = [c for c in calls if c["name"] != "compact_ranks"]
    del warm
    n = FULL["n"]
    scratch = torch.zeros((n, n), dtype=torch.int32, device=dev)
    out = {k: dict(ms=0.0, plain_ms=None, bound_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, library_ms=None, steps=0.0) for k in KERNELS}
    out["perimeter_query"].update(exact_steps=0.0, event_ms=0.0)
    out["region_fill"].update(graph_ms=0.0)
    tally: dict = {}
    for call in calls:
        region = call["name"].startswith("region")
        row = out[KERNEL_OF[call["name"]]]
        reps = 3 if call["name"] == "mandelbrot" else 10
        # a border query takes tens of microseconds: device time (a graph),
        # and beside it the events around eager calls, host work included
        ms = (graph_ms if call["name"] == "perimeter_query" else
              lambda fn: cuda_ms(fn, reps))(lambda: kernel_of(call, scratch))
        row["ms"] += ms
        if call["name"] == "perimeter_query":
            row["event_ms"] += cuda_ms(lambda: kernel_of(call, scratch), reps)
            row["exact_steps"] += query_level(
                "t", call, [border_dwells(call, ex)], ms, wl)
        bound, t_ops, t_bytes, steps = bound_of(call, ex, wl)
        row["bound_ms"] += bound
        row["ops_ms"] += t_ops
        row["bytes_ms"] += t_bytes
        row["steps"] += steps
        got = kernel_of(call, scratch.clone() if region else None)
        want = []
        row["plain_ms"] = (row["plain_ms"] or 0.0) + host_ms(lambda: want.append(
            plain_of(call, scratch.clone() if region else None)))
        tally_add(tally, call, got, want[0])
        if call["name"] == "region_fill":
            row["library_ms"] = (row["library_ms"] or 0.0) + cuda_ms(
                library_fill(call, scratch), 10)
            graph = graph_ms(lambda: kernel_of(call, scratch))
            row["graph_ms"] += graph
            log(f"(t) {wl} region_fill level: " + json.dumps(dict(
                side=call["kw"]["side"], homog=live_rows(call), ms=ms,
                graph_ms=graph, bytes_ms=t_bytes)))
        del got, want
    check_tally(tally, "t")
    leaf = next(c for c in calls if c["name"] == "region_dwell")
    k, side = live_rows(leaf), leaf["kw"]["side"]
    ys, xs = ref.region_index(leaf["args"][1][:k], side)
    step = max(1, (1 << 26) // (side * side))
    out["region_dwell"]["lane_eff_row_per_warp"] = row_per_warp_efficiency(
        ex[ys[a:a + step], xs[a:a + step]] for a in range(0, k, step))
    for name, row in out.items():
        row["bound_by"] = ("operations" if row["ops_ms"] >= row["bytes_ms"]
                           else "bytes")
        row.update(tally.get(name, {}))
        if name in ESCAPE_KERNELS:
            row["contract_bound_ms"] = contract_ms(row["steps"], wl)
            row["slots_per_step"] = slots_per_step(row["ms"], row["steps"])
        if "exact_steps" in row:
            row["exact_bound_ms"] = contract_ms(row["exact_steps"], wl)
        log(f"(t) {wl} {name}: " + json.dumps(row))
    log(f"(t) {wl} olt_compact: " + json.dumps(scans))
    out["olt_compact"] = scans
    return out


def scan_replays(phase: str, wl: str, sources: dict) -> dict:
    """Every recorded OLT-scan call of ``sources`` ({path: calls}) replayed
    by the kernel, held against its run on that path and, on the same
    flags, against the plain version (0 mismatches), and timed as device
    time (``graph_ms``) beside its byte bound and the floor of a graph
    node; one line a call, and the sums."""
    floor = CARD["node_floor_ms"]
    row = dict(calls=0, mismatches=0, max_abs_err=0, ms=0.0, plain_ms=0.0,
               bytes_ms=0.0, node_floor_ms=0.0, sizes=[])
    for source, calls in sources.items():
        for call in calls:
            got = pooled_kernel(call, None)
            for g, o in zip(got, call["out"]):
                if not torch.equal(g, o.reshape(g.shape)):
                    fail(f"phase {phase}: {wl} a scan's replay differs from "
                         f"its run on the {source} path")
            want = pooled_plain(call, None)
            got_t = torch.cat([x.reshape(-1) for x in got]).long()
            want_t = torch.cat([x.reshape(-1) for x in want]).long()
            bad = int((got_t != want_t).sum())
            ms = graph_ms(lambda: pooled_kernel(call, None))
            t_bytes = pooled_bound(call, None)[2]
            row["calls"] += 1
            row["mismatches"] += bad
            row["max_abs_err"] = max(row["max_abs_err"], int(
                (got_t - want_t).abs().max()))
            row["ms"] += ms
            row["plain_ms"] += graph_ms(lambda: pooled_plain(call, None))
            row["bytes_ms"] += t_bytes
            row["node_floor_ms"] += floor
            flags = call["args"][0]
            row["sizes"].append(flags.shape[0])
            log(f"({phase}) {wl} olt_compact call ({source}): " + json.dumps(
                dict(N=flags.shape[0], dtype=str(flags.dtype), us=ms * 1e3,
                     bytes_us=t_bytes * 1e3, node_floor_us=floor * 1e3,
                     mismatches=bad)))
    if row["mismatches"]:
        fail(f"phase {phase}: {wl} olt_compact differs from its plain "
             f"version in {row['mismatches']} outputs")
    if not row["calls"]:
        fail(f"phase {phase}: {wl} no scan call was recorded")
    return row


def phase_c(dev) -> None:
    from repro_torch.workloads import FrameProblem, solve
    p = FrameProblem(**DP, workload="mandelbrot", device=dev)
    ask, ask_st = solve(p, "ask")
    t0 = time.perf_counter()
    dp, dp_st = solve(p, "dp")
    dp_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(dp, ask):
        fail(f"phase c: DP and ASK differ in {int((dp != ask).sum())} pixels")
    if dp_st.region_counts != ask_st.region_counts or \
            dp_st.leaf_count != ask_st.leaf_count:
        fail("phase c: DP and ASK count different regions")
    log(f"(c) DP == ASK at n={DP['n']}: DP {dp_st.kernel_launches} launches, "
        f"ASK {ask_st.kernel_launches}, ratio "
        f"{dp_st.kernel_launches / ask_st.kernel_launches:.1f}; "
        f"DP wall {dp_ms:.1f} ms")


def phase_g(dev) -> None:
    from repro_torch.workloads import FrameProblem, solve
    for wl in WORKLOADS:
        canvas, _ = solve(FrameProblem(**GOLDEN, workload=wl, device=dev), "ask")
        want = read_pgm(ROOT / "tests" / "golden" / f"{wl}_256.pgm")
        bad = int((canvas.cpu().numpy() != want).sum())
        if bad:
            fail(f"phase g: {wl} differs from its golden in {bad} pixels")
    log("(g) run_ask on the card equals the four goldens")


# -- the one-dispatch engines: CUDA-graph replays --------------------------------

ENGINES = (("ask_fused", {}), ("ask_scan", dict(safety_factor=1e9)))
# a kernel of the path -> a part of its name in a profiler trace
REPLAY_KERNELS = {"perimeter_query": "perimeter_query_kernel",
                  "region_fill": "fill_kernel", "region_dwell": "region_dwell",
                  "olt_compact": "scan_kernel"}
POOLED_REPLAY_KERNELS = {
    "perimeter_query_pooled": "perimeter_query_pooled_kernel",
    "region_fill_pooled": "fill_kernel",
    "region_dwell_pooled": "region_dwell_pooled_kernel",
    "olt_compact": "scan_kernel"}

EMPTY_NODE_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_node_kernel() {}
extern "C" int empty_node_launch(void* stream) {
  empty_node_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_node_build(nvcc_command):
    """Start nvcc on an empty kernel, the yardstick of a graph node's
    floor; returns (process, library path)."""
    src = ROOT / "build" / "chip_smoke" / "empty_node.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_NODE_CU)
    out = src.with_suffix(".so")
    cmd = nvcc_command("empty_node", out)
    cmd[-1] = str(src)
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def node_floor_ms(library: Path) -> float:
    """Device time of one empty kernel node in a replayed CUDA graph."""
    import ctypes
    fn = ctypes.CDLL(str(library)).empty_node_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(torch.cuda.current_stream().cuda_stream) != 0:
            fail("the empty kernel did not launch")

    return graph_ms(launch)


def fingerprints(result) -> list:
    """The f64 sum of every tensor in ``result`` (nested tuples and lists),
    in order: what tells a replay that ran from one that left its graph's
    outputs as they were."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(float(x.sum(dtype=torch.float64)))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)

    walk(result)
    return out


def device_activities(prof) -> tuple:
    """A finished torch.profiler session's device activities: (count by
    name, summed device ms, count)."""
    from torch.autograd import DeviceType
    names, device_ms, count = {}, 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        # the profiler's step annotations, which it also lays on the
        # device's timeline, span the step's device work: not an activity
        if e.device_type != DeviceType.CUDA or us <= 0 or \
                e.key.startswith("ProfilerStep"):
            continue
        names[e.key[:70]] = names.get(e.key[:70], 0) + e.count
        device_ms += us / 1e3
        count += e.count
    return names, device_ms, count


def replay_trace(fn, wall_ms: float, want: dict, phase: str) -> dict:
    """One replay of ``fn``'s CUDA graph(s) traced by torch.profiler: its
    device activities (kernels, copies, memsets) summed and counted, the
    device busy share against ``wall_ms`` (the call's untraced median
    wall), and the kernels by name.

    The graphs are released first, and ``fn``'s next call, which captures
    its graphs anew, runs inside a recording profiler session of its own,
    whose trace is dropped: CUPTI traces the kernel nodes of a graph only
    if its kernel activities were on when the graph was instantiated, and
    a recording session is the one state in which they are on for sure (a
    capture in a scheduled session's warm-up step was sometimes missed:
    PERF.md section 7). Then every graph's static
    outputs are poisoned (filled with -1) and one more call, a replay, is
    traced in a second session. Fails unless each kernel of ``want`` shows
    by name, logging first whether the traced call's outputs equal the
    first call's (a replay that ran nothing would leave the poison) and
    how many device activities the trace holds; fails too when the
    outputs differ."""
    from repro_torch.core import graphs
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    graphs.release()
    with profile(activities=activities):
        first = fingerprints(fn())  # the capture(s) and a first replay
        torch.cuda.synchronize()
    for entry in graphs._GRAPHS.values():  # the poison
        for t in entry.outputs:
            t.fill_(-1)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        result = fn()
        torch.cuda.synchronize()
    same = fingerprints(result) == first
    del result
    names, device_ms, count = device_activities(prof)
    missing = sorted(k for k, part in want.items()
                     if not any(part in name for name in names))
    if missing or not same:
        log(f"({phase}) replay trace miss: " + json.dumps(dict(
            missing=missing, replay_output_equal=same, activities=count,
            kernels=names)))
        fail(f"phase {phase}: the replay's trace shows no kernel of "
             f"{missing}: {sorted(names)}" if missing else
             f"phase {phase}: the traced replay's outputs differ from the "
             "first call's")
    return dict(device_ms=device_ms, activities=count,
                busy=device_ms / wall_ms, replay_output_equal=same,
                kernels=names)


def phase_e(dev) -> dict:
    """The one-dispatch engines; see the module docstring, phase (e)."""
    from repro_torch.core import graphs
    from repro_torch.workloads import FrameProblem, solve
    single = single_wrappers()
    wrappers = {"perimeter_query": single["perimeter_query"],
                "region_fill": single["region_fill"],
                "region_dwell": single["region_dwell"],
                "olt_compact": pooled_wrappers()["olt_compact"]}
    problems = {wl: FrameProblem(**FULL, workload=wl, device=dev)
                for wl in WORKLOADS}
    asks = {wl: solve(p, "ask") for wl, p in problems.items()}
    graphs.release()

    # the paths, counted: an engine's first call runs its level loop once
    # on a side stream (the warm-up) and once under capture, through the
    # wrappers; its replays run no Python wrapper. The first call's wall
    # (warm-up, capture, replay, clone, read-back) is kept.
    for w in wrappers.values():
        w.launches = 0
    firsts, first_ms = {}, {}
    for wl, p in problems.items():
        for m, kw in ENGINES:
            box: list = []
            first_ms[(wl, m)] = host_ms(lambda: box.append(solve(p, m, **kw)))
            firsts[(wl, m)] = box[0]
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"(e) launches in the engines' warm-ups and captures: "
        f"{json.dumps(launches)}; graphs held {graphs.held()}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase e: {k} was never launched on the one-dispatch path")

    rows = {}
    for wl, p in problems.items():
        ask, ask_st = asks[wl]
        row = rows[wl] = dict(levels=ask_st.levels, first_call_ms={
            m: first_ms[(wl, m)] for m, _ in ENGINES})
        for method, kw in ENGINES:
            for call, (got, st) in (("capture", firsts[(wl, method)]),
                                    ("replay", solve(p, method, **kw))):
                if not torch.equal(got, ask):
                    fail(f"phase e: {wl} {method} ({call}) differs from run_ask "
                         f"in {int((got != ask).sum())} pixels")
                if st.kernel_launches != 1 or st.overflow_dropped or \
                        st.leaf_count != ask_st.leaf_count or (
                            method == "ask_scan" and
                            st.region_counts != ask_st.region_counts):
                    fail(f"phase e: {wl} {method} ({call}) stats {st}")
                del got
        del firsts[(wl, "ask_fused")], firsts[(wl, "ask_scan")]
        for method, kw in (("ask", {}), *ENGINES):
            runs = sorted(host_ms(lambda: solve(p, method, **kw))
                          for _ in range(5))
            row[f"{method}_ms"] = runs[2]
            row[f"{method}_ms_range"] = [runs[0], runs[-1]]
    # the traces last: each releases the graphs and captures its own
    for wl, p in problems.items():
        row = rows[wl]
        for method, kw in ENGINES:
            t = replay_trace(lambda: solve(p, method, **kw), row[f"{method}_ms"],
                             REPLAY_KERNELS, "e")
            row[f"{method}_replay"] = t
        log(f"(e) {wl}: " + json.dumps(row))
    zoom = zoom_sequence(dev)
    clone = cuda_ms(lambda: asks["mandelbrot"][0].clone(), 10)
    log(f"(e) the returned canvas's clone out of the graph's pool "
        f"([{FULL['n']}, {FULL['n']}] int32, 1 GiB): {clone:.4f} ms")
    del asks
    graphs.release()
    return dict(rows=rows, launches=launches, clone_ms=clone, zoom=zoom)


ZOOM_CENTRE = (-0.7453, 0.1127)  # the seahorse valley
ZOOM_WIDTHS = (3.0, 0.75, 0.1875, 0.046875, 0.01171875)


def zoom_sequence(dev) -> list:
    """A zoom of five distinct windows at the phase-(b) shapes (mandelbrot)
    through one ``ask_scan`` graph, captured by a call on the default
    window: no zoom frame captures (the graph is keyed on all but the
    window), each canvas equals ``run_ask``'s on its window, and each
    frame's wall (one call, as a zoom service makes it) stands beside
    ``run_ask``'s."""
    from repro_torch.core import graphs
    from repro_torch.workloads import FrameProblem, solve
    solve(FrameProblem(**FULL, device=dev), "ask_scan", safety_factor=1e9)
    held = graphs.held()[0]
    out = []
    for w in ZOOM_WIDTHS:
        cx, cy = ZOOM_CENTRE
        q = FrameProblem(**FULL, bounds=(cx - w / 2, cy - w / 2, cx + w / 2,
                                         cy + w / 2), device=dev)
        box: list = []
        scan_ms = host_ms(lambda: box.append(
            solve(q, "ask_scan", safety_factor=1e9)))
        (got, st), = box
        want, want_st = solve(q, "ask")
        if not torch.equal(got, want) or st.leaf_count != want_st.leaf_count \
                or st.overflow_dropped:
            fail(f"phase e: the zoom frame of width {w} differs from run_ask "
                 f"in {int((got != want).sum())} pixels")
        del got, want
        out.append(dict(width=w, ask_scan_ms=scan_ms,
                        ask_ms=host_ms(lambda: solve(q, "ask")),
                        levels=want_st.levels, leaves=want_st.leaf_count))
    if graphs.held()[0] != held:
        fail(f"phase e: the zoom sequence captured "
             f"{graphs.held()[0] - held} graphs")
    log("(e) zoom sequence through one graph: " + json.dumps(out))
    return out


# -- the pooled engine's path ----------------------------------------------------

def mixed_bounds(n_sparse: int = 6, n_dense: int = 2):
    """The heterogeneous batch of tests/test_pooled.py ``_mixed_bounds``: a
    zoomed-out sparse majority and a deep seahorse tail, as [F, 4] f32."""
    import numpy as np

    def window(cx, cy, w):
        return (cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2)

    sparse = [window(-0.5, 0.0, float(w))
              for w in np.geomspace(16.0, 4.0, n_sparse)]
    dense = [window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k)
             for k in np.linspace(4, 10, n_dense)]
    return np.asarray(sparse + dense, np.float32)


POOLED_OPS = ("compact_ranks", "perimeter_query_pooled", "region_fill_pooled",
              "region_dwell_pooled")


@contextlib.contextmanager
def recording_pooled(ops, calls: list):
    """Swap the pooled entry points in ``kernels.ops`` for ones that record
    each call: its arguments (cloned; the canvas left out), keywords and
    output (the scan's and the query's; the region calls write the canvas)."""
    saved = {k: getattr(ops, k) for k in POOLED_OPS}

    def tap(name):
        fn = saved[name]
        region = name.startswith("region")

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            calls.append(dict(
                name=name, kw=recorded_kw(name, kw), out=None if region else out,
                args=tuple(None if region and i == 0 else
                           (a.clone() if isinstance(a, torch.Tensor) else a)
                           for i, a in enumerate(args))))
            return out

        return wrapped

    try:
        for k in saved:
            setattr(ops, k, tap(k))
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def pooled_wrappers():
    from repro_torch.kernels import (olt_compact, perimeter_query,
                                     region_dwell_pooled, region_fill_pooled)
    return {"olt_compact": olt_compact.compact_ranks,
            "perimeter_query_pooled": perimeter_query.perimeter_query_pooled,
            "region_fill_pooled": region_fill_pooled.region_fill_pooled,
            "region_dwell_pooled": region_dwell_pooled.region_dwell_pooled}


def pooled_kernel(call, canvas):
    """The kernel's output for one recorded pooled call (region calls in
    place on ``canvas``)."""
    from repro_torch.kernels import olt_compact
    w = pooled_wrappers()
    a, kw = call["args"], call["kw"]
    if call["name"] == "compact_ranks":
        return olt_compact.compact_ranks(*a)
    if call["name"] == "perimeter_query_pooled":
        return w["perimeter_query_pooled"](*a, **kw)
    return w[call["name"]](canvas, *a[1:], **kw)


def row_chunks(k: int, points_per_row: int):
    """[a, b) slices of k live rows, about PLAIN_POINTS points each."""
    step = max(1, PLAIN_POINTS // max(1, points_per_row))
    return [(a, min(k, a + step)) for a in range(0, k, step)]


def pooled_plain(call, canvas):
    """The plain version's output for one recorded pooled call, replayed in
    chunks of live rows (rows are independent, so this is the same
    function; it bounds the plain versions' temporaries). Region calls
    write ``canvas`` in place."""
    from repro_torch.kernels import (olt_compact, perimeter_query,
                                     region_dwell_pooled, region_fill_pooled)
    name, a, kw = call["name"], call["args"], call["kw"]
    if name == "compact_ranks":
        return olt_compact.compact_ranks_plain(*a)
    rows, k = a[1] if name.startswith("region") else a[0], pooled_live(call)
    side = kw["side"]
    if name == "perimeter_query_pooled":
        planes = a[2]
        N = rows.shape[0]
        homog = torch.zeros((N,), dtype=torch.bool, device=rows.device)
        common = torch.zeros((N,), dtype=torch.int32, device=rows.device)
        for lo, hi in row_chunks(k, 4 * side):
            cnt = torch.tensor([hi - lo], dtype=torch.int32, device=rows.device)
            homog[lo:hi], common[lo:hi] = perimeter_query.perimeter_query_pooled_plain(
                rows[lo:hi], cnt, planes, **kw)
        return homog, common
    for lo, hi in row_chunks(k, side * side):
        cnt = torch.tensor([hi - lo], dtype=torch.int32, device=rows.device)
        if name == "region_fill_pooled":
            region_fill_pooled.region_fill_pooled_plain(
                canvas, rows[lo:hi], a[2][lo:hi], cnt, **kw)
        else:
            region_dwell_pooled.region_dwell_pooled_plain(
                canvas, rows[lo:hi], cnt, a[3], **kw)
    return canvas


# where the live row count sits among a pooled call's arguments
POOLED_COUNT_ARG = {"perimeter_query_pooled": 1, "region_fill_pooled": 3,
                    "region_dwell_pooled": 2}


def pooled_live(call) -> int:
    """The live rows of a pooled region or border call: its device count."""
    return int(call["args"][POOLED_COUNT_ARG[call["name"]]].item())


def region_values(canvas, rows, side: int, n: int):
    """The [k, side, side] blocks of frame-tagged rows on the banded canvas,
    in chunks: yields one tensor per chunk."""
    F = canvas.shape[0] // n
    v = canvas.view(F, n // side, side, n // side, side)
    for lo, hi in row_chunks(rows.shape[0], side * side):
        r = rows[lo:hi].long()
        yield v[r[:, 0], r[:, 1], :, r[:, 2], :]


def border_values(canvas, rows, side: int, n: int):
    """The 4 x side border values of frame-tagged rows read off the final
    banded canvas, in chunks. Every border pixel of a queried region lies on
    the border of the filled or leaf region that finally holds it, so the
    canvas holds its exact dwell there (no drops at worst-case capacity)."""
    from repro_torch.kernels import ref
    flat = canvas.view(-1)
    for lo, hi in row_chunks(rows.shape[0], 4 * side):
        r = rows[lo:hi]
        ys, xs = ref.perimeter_coords(r[:, 1:], side)
        yield flat[(r[:, 0, None, None].long() * n + ys.long()) * n + xs.long()]


def pooled_bound(call, canvas):
    """(least ms, ms by operations, ms by bytes, escape steps) of one pooled
    call: each input read once and each output written once over HBM
    bandwidth, and the escape flops that this run's dwells need over the
    f32 peak (the steps: the sum of those dwells)."""
    name, a, kw = call["name"], call["args"], call["kw"]
    n, md = POOLED["n"], POOLED["max_dwell"]
    flops = steps = 0.0
    if name == "compact_ranks":
        N = a[0].shape[0]
        nbytes = N * a[0].element_size() + 4 * N + 4
    else:
        k, side = pooled_live(call), kw["side"]
        rows = (a[1] if name.startswith("region") else a[0])[:k]
        values = None
        if name == "perimeter_query_pooled":
            nbytes = k * (12 + 5) + 4
            values = border_values
        else:
            nbytes = k * side * side * 4 + k * 16 + 4
            if name == "region_dwell_pooled":
                values = region_values
        if values is not None:
            for v in values(canvas, rows, side, n):
                flops += escape_flops(v, md, "mandelbrot")
                steps += float(v.double().sum())
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3, steps


def pooled_library(call, canvas):
    """One PyTorch call computing the same function, where there is one:
    ``torch.cumsum`` for the scan, ``index_put_`` for the pooled fill."""
    from repro_torch.kernels import ref
    a = call["args"]
    if call["name"] == "compact_ranks":
        return lambda: torch.cumsum(a[0], 0, dtype=torch.int32)
    if call["name"] == "region_fill_pooled":
        k, side = pooled_live(call), call["kw"]["side"]
        ys, xs = ref.pooled_region_index(a[1][:k], side, POOLED["n"])
        vals = a[2][:k, None, None].expand(k, side, side)
        return lambda: canvas.index_put_((ys, xs), vals)
    return None


def leaf_efficiency_pooled(calls, banded) -> float:
    """The lane efficiency before refill of phase (t) for the pooled A's
    items, from the final canvas."""
    from repro_torch.kernels import _build
    n = POOLED["n"]
    chunks = []
    for call in (c for c in calls if c["name"] == "region_dwell_pooled"):
        k, side = pooled_live(call), call["kw"]["side"]
        rpi = _build.rows_per_item(side)
        chunks += [v.reshape(-1, rpi * side) for v in
                   region_values(banded, call["args"][1][:k], side, n)]
    return row_per_warp_efficiency(chunks)


def phase_p(dev) -> dict:
    """The pooled engine's path; see the module docstring, phase (p)."""
    from repro_torch.core import graphs, pooled, run_ask
    from repro_torch.kernels import ops
    from repro_torch.workloads import (EngineOptions, FrameProblem, solve,
                                       solve_batch)
    n, md = POOLED["n"], POOLED["max_dwell"]
    bounds = mixed_bounds()
    F = len(bounds)
    p = FrameProblem(**POOLED, device=dev)
    worst = EngineOptions(engine="ask_pooled", safety_factor=1e9)
    wrappers = pooled_wrappers()
    others = list(single_wrappers().values())

    # the main path, counted (and recorded for the replays below)
    calls: list = []
    for w in [*wrappers.values(), *others]:
        w.launches = 0
    with recording_pooled(ops, calls):
        canvas, st = solve_batch(p, bounds, options=worst)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"(p) launches on the pooled path: {json.dumps(launches)}; "
        f"single-frame kernels {[w.launches for w in others]}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase p: {k} was never launched on the pooled path")
    if canvas.shape != (F, n, n) or canvas.dtype != torch.int32:
        fail(f"phase p: canvas {canvas.dtype} {tuple(canvas.shape)}")
    if int(canvas.min()) < 0 or int(canvas.max()) > md:
        fail(f"phase p: dwell outside [0, {md}]")
    if st.overflow_dropped or st.kernel_launches != 1:
        fail(f"phase p: worst case dropped {st.overflow_dropped}, "
             f"dispatches {st.kernel_launches}")
    log(f"(p) worst case: region_counts {list(st.region_counts)}, leaves "
        f"{list(st.frame_leaf_counts)}, olt_caps {list(st.olt_caps)}, "
        f"ring_rows {st.ring_rows}")
    banded = canvas.view(F * n, n)

    # every call by the kernel and by its plain version, timed
    out = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, library_ms=None, mismatches=0,
                   max_abs_err=0, calls=0, steps=0.0) for k in POOLED_KERNELS}
    out["perimeter_query_pooled"].update(exact_steps=0.0, event_ms=0.0)
    scan_sizes = []
    k_canvas = torch.zeros((F * n, n), dtype=torch.int32, device=dev)
    p_canvas = torch.zeros_like(k_canvas)
    for name in POOLED_OPS:  # region kernels: one pair of canvases each
        k_canvas.zero_()
        p_canvas.zero_()
        for call in (c for c in calls if c["name"] == name):
            row = out[KERNEL_OF[name]]
            row["calls"] += 1
            region = name.startswith("region")
            got = pooled_kernel(call, k_canvas)
            want = []
            plain_t = host_ms(lambda: want.append(pooled_plain(call, p_canvas)))
            scan = name == "compact_ranks"
            reps = 3 if name == "region_dwell_pooled" else 10
            # the scan's calls take microseconds and the query's tens of
            # them: time them as device time
            timer = (graph_ms if scan or name == "perimeter_query_pooled" else
                     (lambda fn: cuda_ms(fn, reps)))
            if scan:
                plain_t = graph_ms(lambda: pooled_plain(call, p_canvas))
                floor = CARD["node_floor_ms"]
                row["node_floor_ms"] = row.get("node_floor_ms", 0.0) + floor
            row["plain_ms"] += plain_t
            if not region:
                if name == "compact_ranks":
                    scan_sizes.append(call["args"][0].shape[0])
                    for g, o in zip(got, call["out"]):
                        if not torch.equal(g, o.reshape(g.shape)):
                            fail("phase p: the scan's replay differs from "
                                 "its run on the main path")
                got_t = torch.cat([x.reshape(-1).int() for x in got])
                want_t = torch.cat([x.reshape(-1).int() for x in want[0]])
                row["mismatches"] += int((got_t != want_t).sum())
                row["max_abs_err"] = max(row["max_abs_err"], int(
                    (got_t.long() - want_t.long()).abs().max()))
            ms = timer(lambda: pooled_kernel(call, k_canvas))
            row["ms"] += ms
            if name == "perimeter_query_pooled":
                row["event_ms"] += cuda_ms(
                    lambda: pooled_kernel(call, k_canvas), reps)
                k = pooled_live(call)
                row["exact_steps"] += query_level(
                    "p", call, border_values(banded, call["args"][0][:k],
                                             call["kw"]["side"], n),
                    ms, "mandelbrot")
            bound, t_ops, t_bytes, steps = pooled_bound(call, banded)
            if scan:
                flags = call["args"][0]
                log("(p) olt_compact call: " + json.dumps(dict(
                    N=flags.shape[0], dtype=str(flags.dtype), us=ms * 1e3,
                    bytes_us=t_bytes * 1e3, node_floor_us=floor * 1e3)))
            row["bound_ms"] += bound
            row["ops_ms"] += t_ops
            row["bytes_ms"] += t_bytes
            row["steps"] += steps
            lib = pooled_library(call, p_canvas)
            if lib is not None:
                row["library_ms"] = (row["library_ms"] or 0.0) + (
                    graph_ms(lib) if scan else cuda_ms(lib, 10))
            del got, want
        if name.startswith("region"):
            row = out[KERNEL_OF[name]]
            for f in range(F):
                kb, pb = k_canvas[f * n:(f + 1) * n], p_canvas[f * n:(f + 1) * n]
                row["mismatches"] += int((kb != pb).sum())
                row["max_abs_err"] = max(row["max_abs_err"],
                                         int((kb - pb).abs().max()))
    del k_canvas, p_canvas
    out["region_dwell_pooled"]["lane_eff_row_per_warp"] = \
        leaf_efficiency_pooled(calls, banded)
    if not any(s <= SCAN_SPLIT for s in scan_sizes) or \
            not any(s > SCAN_SPLIT for s in scan_sizes):
        fail(f"phase p: scan sizes {sorted(set(scan_sizes))} do not cover "
             f"both sides of {SCAN_SPLIT}")
    for k, row in out.items():
        row["bound_by"] = ("operations" if row["ops_ms"] >= row["bytes_ms"]
                           else "bytes")
        row["launches"] = launches[k]
        if k in ESCAPE_KERNELS:
            row["contract_bound_ms"] = contract_ms(row["steps"], "mandelbrot")
            row["slots_per_step"] = slots_per_step(row["ms"], row["steps"])
        if "exact_steps" in row:
            row["exact_bound_ms"] = contract_ms(row["exact_steps"], "mandelbrot")
        log(f"(p) {k}: " + json.dumps(row))
        if row["mismatches"]:
            fail(f"phase p: {k} differs from its plain version in "
                 f"{row['mismatches']} outputs")
    log(f"(p) scan sizes: {sorted(set(scan_sizes))}")

    # each frame equals the same frame pooled alone
    for f in range(F):
        alone, st1 = solve_batch(p, bounds[f:f + 1], options=worst)
        if not torch.equal(alone[0], canvas[f]):
            fail(f"phase p: frame {f} pooled alone differs in "
                 f"{int((alone[0] != canvas[f]).sum())} pixels")
        if st1.region_counts[0] != st.region_counts[f]:
            fail(f"phase p: frame {f} alone counts other regions")
        del alone
    log("(p) each of the 8 frames equals the frame pooled alone (F=1)")

    # the goldens through solve(p, "ask_pooled")
    for wl in WORKLOADS:
        got, _ = solve(FrameProblem(**GOLDEN, workload=wl, device=dev),
                       "ask_pooled", safety_factor=1e9)
        want = read_pgm(ROOT / "tests" / "golden" / f"{wl}_256.pgm")
        bad = int((got.cpu().numpy() != want).sum())
        if bad:
            fail(f"phase p: ask_pooled {wl} differs from its golden in {bad} px")
    log("(p) solve(p, 'ask_pooled') on the card equals the four goldens")

    # the default sizing: frames with no drop equal their worst-case canvas
    default = EngineOptions(engine="ask_pooled")
    dflt, st_d = solve_batch(p, bounds, options=default)
    for f in range(F):
        if st_d.frame_overflow[f] == 0 and not torch.equal(dflt[f], canvas[f]):
            fail(f"phase p: frame {f} dropped nothing at the default sizing "
                 "but differs from its worst-case canvas")
    log(f"(p) default sizing: frame_overflow {list(st_d.frame_overflow)}, "
        f"olt_caps {list(st_d.olt_caps)}, ring_rows {st_d.ring_rows} (worst "
        f"case {st.ring_rows}); the {st_d.frame_overflow.count(0)} frames "
        "with no drop equal their worst-case canvas")
    del dflt

    # no host sync inside the pipeline
    caps = pooled._resolve_pooled_capacities(p, F, None, None, 0.7, 1e9)
    planes = ops.pooled_planes(n, bounds, dev)
    live = torch.ones((F,), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, entering, leaf_f, dropped = pooled.pooled_pipeline(
            p, caps, planes, live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(states, canvas) or int(dropped.sum()) != 0:
        fail("phase p: the pipeline under the sync check gives another canvas")
    del states
    log("(p) the pooled pipeline made no host sync "
        "(torch.cuda.set_sync_debug_mode('error'))")

    # the batch as one CUDA-graph replay (the engine launches it eagerly,
    # which measured faster): the capture, then a replay, equal to the
    # eager batch; the replay traced
    def graph_batch():
        """The pooled pipeline as ``core.graphs`` replays it, with the
        engine's uploads, the clone of the canvases out of the graph's pool
        and the one read-back of the stats."""
        states, entering, leaf_f, dropped = graphs.replay(
            ("pooled", p, caps, F),
            lambda pl, lv: pooled.pooled_pipeline(p, caps, pl, lv),
            ops.pooled_planes(n, bounds, dev),
            torch.ones((F,), dtype=torch.bool, device=dev), device=dev)
        host = torch.cat([entering.reshape(-1), leaf_f, dropped]).tolist()
        return states.clone(), host

    for call in ("capture", "replay"):
        got, host = graph_batch()
        levels = len(host) // F - 2
        if not torch.equal(got, canvas) or \
                tuple(host[levels * F:levels * F + F]) != st.frame_leaf_counts:
            fail(f"phase p: the graph's {call} differs from the eager batch")
        del got
    log(f"(p) the pooled graph's capture and replay equal the eager batch; "
        f"graphs held {graphs.held()}")

    # warm wall time of the batch, eager (the engine) and as a graph
    # replay, beside run_ask over the same frames
    runs = sorted(host_ms(lambda: solve_batch(p, bounds, options=worst))
                  for _ in range(5))
    runs_g = sorted(host_ms(graph_batch) for _ in range(5))
    replay = replay_trace(graph_batch, runs_g[2], POOLED_REPLAY_KERNELS, "p")
    clone = cuda_ms(lambda: canvas.clone(), 3)
    runs_d = sorted(host_ms(lambda: solve_batch(p, bounds, options=default))
                    for _ in range(5))
    singles = []
    for b in bounds:
        q = FrameProblem(**POOLED, bounds=tuple(float(x) for x in b), device=dev)
        singles.append(sorted(host_ms(lambda: run_ask(q)) for _ in range(5))[2])
    wall = dict(pooled_worst_ms=runs[2], pooled_worst_range=[runs[0], runs[-1]],
                pooled_worst_graph_ms=runs_g[2],
                pooled_worst_graph_range=[runs_g[0], runs_g[-1]],
                pooled_default_ms=runs_d[2],
                pooled_default_range=[runs_d[0], runs_d[-1]],
                run_ask_sum_ms=sum(singles), run_ask_ms=singles,
                clone_ms=clone)
    log(f"(p) wall: {json.dumps(wall)}")
    log(f"(p) replay: {json.dumps(replay)}")
    del canvas, banded
    graphs.release()  # the pooled graphs' pools, before phase (s)
    return dict(kernels=out, wall=wall, replay=replay)

# -- batched frames and the planner -----------------------------------------------

def hold_pooled_calls(calls, F: int, n: int, dev, phase: str = "f") -> dict:
    """Every recorded pooled call replayed by its kernel and by its plain
    version, as phase (p) does, untimed: per kernel the calls, the outputs
    that differ and the largest difference (the region kernels' on the
    final canvases, band by band)."""
    out = {KERNEL_OF[name]: dict(calls=0, mismatches=0, max_abs_err=0)
           for name in POOLED_OPS}
    k_canvas = torch.zeros((F * n, n), dtype=torch.int32, device=dev)
    p_canvas = torch.zeros_like(k_canvas)
    for name in POOLED_OPS:
        k_canvas.zero_()
        p_canvas.zero_()
        row = out[KERNEL_OF[name]]
        for call in (c for c in calls if c["name"] == name):
            row["calls"] += 1
            got = pooled_kernel(call, k_canvas)
            want = pooled_plain(call, p_canvas)
            if name.startswith("region"):
                continue
            if name == "compact_ranks":
                for g, o in zip(got, call["out"]):
                    if not torch.equal(g, o.reshape(g.shape)):
                        fail(f"phase {phase}: a scan's replay differs from "
                             "its run on the main path")
            got_t = torch.cat([x.reshape(-1).int() for x in got])
            want_t = torch.cat([x.reshape(-1).int() for x in want])
            row["mismatches"] += int((got_t != want_t).sum())
            row["max_abs_err"] = max(row["max_abs_err"], int(
                (got_t.long() - want_t.long()).abs().max()))
        if name.startswith("region"):
            for f in range(F):
                kb, pb = k_canvas[f * n:(f + 1) * n], p_canvas[f * n:(f + 1) * n]
                row["mismatches"] += int((kb != pb).sum())
                row["max_abs_err"] = max(row["max_abs_err"],
                                         int((kb - pb).abs().max()))
    del k_canvas, p_canvas
    return out


def frame_rank_variants(calls, F: int) -> list:
    """The per-frame ranks of the batched scan three ways, at the inputs
    of each level of the main path's run (its rows and, from its border
    query's answer, its flags): as shipped (``pooled._frame_ranks`` on the
    OLT scan's ranks: each frame's first row found by a binary search of
    the frame tags), with the least rank of each frame's flagged rows
    taken off instead (an atomic min over the rows), and through the
    batched-ranks kernel on the [N, F] one-hot flag matrix. Each timed as
    device time; the three must agree on every flagged row."""
    from repro_torch.core import pooled
    from repro_torch.kernels import ops

    def shipped(rows, flags, valid):
        return pooled._frame_ranks(rows, valid, ops.compact_ranks(flags)[0], F)

    def least_rank(rows, flags, valid):
        ranks = ops.compact_ranks(flags)[0]
        frame = rows[:, 0].long()
        top = torch.iinfo(torch.int32).max
        first = torch.full((F,), top, dtype=torch.int32, device=rows.device)
        first.scatter_reduce_(0, frame, torch.where(flags, ranks, top), "amin")
        return ranks - first[frame]

    def one_hot(rows, flags, valid):
        frame = rows[:, 0].long()
        hot = flags[:, None] & (frame[:, None] == torch.arange(
            F, device=flags.device))
        return ops.batched_ranks(hot)[0].gather(1, frame[:, None])[:, 0]

    out = []
    for call in (c for c in calls if c["name"] == "perimeter_query_pooled"):
        rows, count = call["args"][0], call["args"][1]
        valid = torch.arange(rows.shape[0], device=rows.device) < count
        flags = valid & ~call["out"][0]
        row = dict(N=rows.shape[0], flagged=int(flags.sum()))
        want = None
        for name, fn in (("shipped", shipped), ("least_rank", least_rank),
                         ("batched_ranks", one_hot)):
            got = fn(rows, flags, valid)[flags]
            if want is not None and not torch.equal(got, want):
                fail(f"phase f: the per-frame ranks {name} disagree")
            want = got
            row[f"{name}_us"] = graph_ms(lambda: fn(rows, flags, valid)) * 1e3
        out.append(row)
    return out


def bench7_rings(dev) -> dict:
    """BENCH_7.json's batch on the card: the per-frame plan (plan=4)
    against the pooled plan; both converge with nothing dropped, the same
    canvases, and the file's ring rows."""
    import numpy as np

    from repro_torch.workloads import EngineOptions, FrameProblem, solve_batch
    bench = json.loads((ROOT / "BENCH_7.json").read_text())
    c, want = bench["config"], bench["workloads"]["mixed_mandelbrot"]
    p = FrameProblem(n=c["n"], g=c["g"], r=c["r"], B=c["B"],
                     max_dwell=c["max_dwell"], device=dev)

    def window(cx, cy, w):
        return (cx - w / 2, cy - w / 2, cx + w / 2, cy + w / 2)

    bounds = ([window(-0.5, 0.0, float(w))
               for w in np.geomspace(16.0, 4.0, c["n_sparse"])]
              + [window(-0.7436447860, 0.1318252536, 3.0 / 2 ** k)
                 for k in np.linspace(4, 12, c["n_dense"])])
    planned, rep = solve_batch(p, bounds, plan=4)
    pooled, prep = solve_batch(p, bounds, options=EngineOptions(
        engine="ask_pooled", plan=True))
    got = dict(planned_ring_rows=rep.ring_rows, ring_rows=prep.ring_rows,
               planned_dispatches=rep.dispatches, dispatches=prep.dispatches,
               overflow=rep.overflow_dropped + prep.overflow_dropped,
               identical=int(torch.equal(planned, pooled)))
    log(f"(f) BENCH_7 config on the card: {json.dumps(got)}; the file: "
        f"planned_ring_rows {want['planned_ring_rows']}, ring_rows "
        f"{want['ring_rows']}")
    if (got["planned_ring_rows"], got["ring_rows"], got["dispatches"],
            got["overflow"], got["identical"]) != (
            want["planned_ring_rows"], want["ring_rows"], want["dispatches"],
            want["overflow"], want["identical"]):
        fail(f"phase f: BENCH_7 config gives {got}, the file {want}")
    return got


def phase_f(dev) -> dict:
    """Batched frames and the planner; see the module docstring, phase (f)."""
    from repro_torch.core import ask, graphs, planner, pooled, run_ask_scan
    from repro_torch.core.feedback import OccupancyEstimator
    from repro_torch.kernels import ops
    from repro_torch.workloads import EngineOptions, FrameProblem, solve_batch
    n, md = POOLED["n"], POOLED["max_dwell"]
    bounds = mixed_bounds()
    F = len(bounds)
    p = FrameProblem(**POOLED, device=dev)
    wrappers = pooled_wrappers()
    others = list(single_wrappers().values())

    # the main path: solve_batch's default engine at worst-case capacities,
    # counted and recorded
    calls: list = []
    for w in [*wrappers.values(), *others]:
        w.launches = 0
    with recording_pooled(ops, calls):
        canvas, st = solve_batch(p, bounds, safety_factor=1e9)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"(f) launches on the batched scan's path: {json.dumps(launches)}; "
        f"single-frame kernels {[w.launches for w in others]}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase f: {k} was never launched on the batched scan's path")
    if canvas.shape != (F, n, n) or canvas.dtype != torch.int32 or \
            int(canvas.min()) < 0 or int(canvas.max()) > md:
        fail(f"phase f: canvas {canvas.dtype} {tuple(canvas.shape)}")
    if st.overflow_dropped or st.kernel_launches != 1:
        fail(f"phase f: worst case dropped {st.overflow_dropped}, "
             f"dispatches {st.kernel_launches}")
    log(f"(f) worst case: region_counts {list(st.region_counts)}, leaves "
        f"{list(st.frame_leaf_counts)}, olt_caps {list(st.olt_caps)}")

    # each frame equals the same frame of the pooled batch
    pool, pst = solve_batch(p, bounds, options=EngineOptions(
        engine="ask_pooled", safety_factor=1e9))
    for f in range(F):
        if not torch.equal(pool[f], canvas[f]):
            fail(f"phase f: frame {f} differs from the pooled batch's in "
                 f"{int((pool[f] != canvas[f]).sum())} pixels")
    if pst.region_counts != st.region_counts or \
            pst.frame_leaf_counts != st.frame_leaf_counts:
        fail("phase f: the batched scan counts other regions than the pool")
    del pool
    log("(f) each of the 8 frames equals the pooled batch's frame")

    # every call of the main path against its plain version
    held = hold_pooled_calls(calls, F, n, dev)
    for k, row in held.items():
        row["launches"] = launches[k]
        log(f"(f) {k}: " + json.dumps(row))
        if row["mismatches"]:
            fail(f"phase f: {k} differs from its plain version in "
                 f"{row['mismatches']} outputs")
    ranks = frame_rank_variants(calls, F)
    for r in ranks:
        log("(f) per-frame ranks: " + json.dumps(r))
    del calls

    # no host sync inside the pipeline
    caps = ask._resolve_capacities(p, None, 0.7, 1e9)
    planes = ops.pooled_planes(n, bounds, dev)
    live = torch.ones((F,), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        states, _, _, dropped = pooled.pooled_pipeline(p, caps, planes, live,
                                                       per_frame=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not torch.equal(states, canvas) or int(dropped.sum()) != 0:
        fail("phase f: the pipeline under the sync check gives another canvas")
    del states
    log("(f) the batched scan's pipeline made no host sync "
        "(torch.cuda.set_sync_debug_mode('error'))")

    # the default sizing: frames with no drop equal their worst case
    dflt, st_d = solve_batch(p, bounds)
    for f in range(F):
        if st_d.frame_overflow[f] == 0 and not torch.equal(dflt[f], canvas[f]):
            fail(f"phase f: frame {f} dropped nothing at the default sizing "
                 "but differs from its worst-case canvas")
    log(f"(f) default sizing: frame_overflow {list(st_d.frame_overflow)}, "
        f"olt_caps {list(st_d.olt_caps)}, ring_rows {st_d.ring_rows} a frame "
        f"(worst case {st.ring_rows}); the {st_d.frame_overflow.count(0)} "
        "frames with no drop equal their worst-case canvas")
    del dflt

    # the planner, then the planner fed the first run's occupancy
    def planned_ok(what, **kw):
        got, rep = solve_batch(p, bounds, **kw)
        if rep.overflow_dropped or not torch.equal(got, canvas):
            fail(f"phase f: {what} dropped {rep.overflow_dropped} or differs "
                 "from the worst case")
        return dict(dispatches=rep.dispatches, retries=rep.retries,
                    retried_frames=list(rep.retried_frames),
                    ring_rows=rep.ring_rows, buckets=len(rep.plan.buckets),
                    frame_p_source=list(rep.frame_p_source),
                    frame_p_subdiv=list(rep.frame_p_subdiv))

    plan = planned_ok("plan=True", plan=True)
    log(f"(f) plan=True: {json.dumps(plan)}")
    widths, ref_w = planner._frame_widths(p, bounds, None)
    est = OccupancyEstimator()
    est.observe_stats([planner.zoom_depth(w, ref_width=ref_w, r=p.r)
                       for w in widths], st, g=p.g, r=p.r, workload=p.workload)
    observed = planned_ok("plan=True, observed=", plan=True, observed=est)
    log(f"(f) plan=True, observed= (fed the worst-case run): "
        f"{json.dumps(observed)}")
    bench7 = bench7_rings(dev)

    # warm walls, beside the pooled batch and run_ask_scan frame by frame
    def median(fn):
        runs = sorted(host_ms(fn) for _ in range(5))
        return runs[2], [runs[0], runs[-1]]

    wall = {}
    for key, kw in (("scan_worst", dict(safety_factor=1e9)),
                    ("scan_default", {}),
                    ("pooled_worst", dict(options=EngineOptions(
                        engine="ask_pooled", safety_factor=1e9))),
                    ("pooled_default", dict(options="ask_pooled")),
                    ("planned", dict(plan=True))):
        wall[f"{key}_ms"], wall[f"{key}_range"] = median(
            lambda: solve_batch(p, bounds, **kw))
    singles = []
    for b in bounds:
        q = FrameProblem(**POOLED, bounds=tuple(float(x) for x in b), device=dev)
        run_ask_scan(q, safety_factor=1e9)  # the graph's capture
        singles.append(median(lambda: run_ask_scan(q, safety_factor=1e9))[0])
    wall["run_ask_scan_sum_ms"], wall["run_ask_scan_ms"] = sum(singles), singles
    graphs.release()
    trace = replay_trace(lambda: solve_batch(p, bounds, safety_factor=1e9),
                         wall["scan_worst_ms"], POOLED_REPLAY_KERNELS, "f")
    log(f"(f) wall: {json.dumps(wall)}")
    log(f"(f) trace of one batched scan (worst case): {json.dumps(trace)}")
    del canvas
    return dict(kernels=held, wall=wall, trace=trace, plan=plan,
                observed=observed, bench7=bench7, ranks=ranks)


# -- sharded frames and the split scan ---------------------------------------------

SHARD_STATS = ("levels", "region_counts", "leaf_count", "overflow_dropped",
               "frame_overflow", "frame_leaf_counts", "olt_caps", "ring_rows")


def same_stats(phase: str, what: str, got, want, fields=SHARD_STATS) -> None:
    for f in fields:
        if getattr(got, f) != getattr(want, f):
            fail(f"phase {phase}: {what} {f} {getattr(got, f)} against "
                 f"{getattr(want, f)}")


def same_frames(phase: str, what: str, got, want) -> None:
    if got.shape != want.shape:
        fail(f"phase {phase}: {what} {tuple(got.shape)} against "
             f"{tuple(want.shape)}")
    for f in range(got.shape[0]):
        if not torch.equal(got[f], want[f]):
            fail(f"phase {phase}: {what} frame {f} differs in "
                 f"{int((got[f] != want[f]).sum())} pixels")


def phase_m(dev) -> dict:
    """Sharded frames and the split scan; see the module docstring, phase
    (m)."""
    from repro_torch.core import progressive
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_frames_mesh
    from repro_torch.workloads import (EngineOptions, FrameProblem,
                                       dispatch_batch, solve, solve_batch)
    n = POOLED["n"]
    bounds = mixed_bounds()
    F = len(bounds)
    p = FrameProblem(**POOLED, device=dev)
    worst = dict(safety_factor=1e9)

    mesh = make_frames_mesh()
    if mesh.size != torch.cuda.device_count() or \
            any(d.type != "cuda" for d in mesh.devices):
        fail(f"phase m: make_frames_mesh() gives {mesh}, "
             f"{torch.cuda.device_count()} cards visible")
    log(f"(m) make_frames_mesh(): {mesh.size} device(s) "
        f"{[str(d) for d in mesh.devices]}, axes {mesh.axis_names}")

    # the unsharded batched scan, then the main path: the same batch under
    # the mesh, counted and recorded
    ref, ref_st = solve_batch(p, bounds, **worst)
    wrappers = pooled_wrappers()
    for w in wrappers.values():
        w.launches = 0
    calls: list = []
    with recording_pooled(ops, calls):
        got, st = solve_batch(p, bounds, mesh=mesh, **worst)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"(m) launches on the sharded scan's path: {json.dumps(launches)}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase m: {k} was never launched on the sharded path")
    same_frames("m", "the sharded scan", got, ref)
    same_stats("m", "the sharded scan", st, ref_st)
    if st.kernel_launches != 1 or st.overflow_dropped:
        fail(f"phase m: the sharded scan: {st}")
    del got
    log("(m) solve_batch(mesh=) equals the unsharded batched scan: each of "
        f"the {F} frames, every stats field, nothing dropped")
    held = hold_pooled_calls(calls, F, n, dev, "m")
    for k, row in held.items():
        row["launches"] = launches[k]
        log(f"(m) {k}: " + json.dumps(row))
        if row["mismatches"]:
            fail(f"phase m: {k} differs from its plain version in "
                 f"{row['mismatches']} outputs")
    del calls

    # a ragged batch: 7 frames padded to 8 equal the unsharded 7
    got, st = solve_batch(p, bounds[:7], mesh=mesh, pad_to=8, **worst)
    same_frames("m", "the ragged batch", got, ref[:7])
    want_st = solve_batch(p, bounds[:7], **worst)[1]
    same_stats("m", "the ragged batch", st, want_st)
    del got
    log("(m) 7 frames with pad_to=8 equal the first 7 frames, stats too")

    # the pooled engine under the mesh, at its default sizing
    pooled_opts = dict(engine="ask_pooled")
    want, want_st = solve_batch(p, bounds, options=EngineOptions(**pooled_opts))
    got, st = solve_batch(p, bounds, options=EngineOptions(**pooled_opts,
                                                           mesh=mesh))
    same_frames("m", "the sharded pool", got, want)
    # on several cards each shard sizes its own ring (and drops alone)
    same_stats("m", "the sharded pool", st, want_st,
               SHARD_STATS if mesh.size == 1 else ("overflow_dropped",))
    del got, want
    log(f"(m) the sharded pool equals the pooled batch: olt_caps "
        f"{list(st.olt_caps)}, ring_rows {st.ring_rows} a shard, dropped "
        f"{st.overflow_dropped}")

    # the dispatch: no host sync before it returns
    dispatch_batch(p, bounds, mesh=mesh, **worst).finalize()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = dispatch_batch(p, bounds, mesh=mesh, **worst)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    t1 = time.perf_counter()
    got, st = d.finalize()
    t2 = time.perf_counter()
    same_frames("m", "dispatch_batch", got, ref)
    same_stats("m", "dispatch_batch", st, ref_st)
    dispatch = dict(enqueue_ms=(t1 - t0) * 1e3, finalize_ms=(t2 - t1) * 1e3)
    del got, d
    log(f"(m) dispatch_batch made no host sync before it returned "
        f"(set_sync_debug_mode('error')): {json.dumps(dispatch)}")

    # the planner under the mesh
    plans = {}
    for name, kw in (("plan", dict(plan=True)),
                     ("pooled_plan", dict(options=EngineOptions(
                         engine="ask_pooled", plan=True)))):
        a, ra = solve_batch(p, bounds, **kw)
        if "options" in kw:
            kw = dict(options=EngineOptions(engine="ask_pooled", plan=True,
                                            mesh=mesh))
        else:
            kw = dict(kw, mesh=mesh)
        b, rb = solve_batch(p, bounds, **kw)
        same_frames("m", f"{name} under the mesh", b, a)
        same_stats("m", f"{name} under the mesh", rb, ra,
                   ("region_counts", "frame_leaf_counts", "overflow_dropped")
                   + (("dispatches", "retries", "retried_frames", "ring_rows")
                      if mesh.size == 1 else ()))
        plans[name] = dict(dispatches=rb.dispatches, retries=rb.retries,
                           ring_rows=rb.ring_rows)
        del a, b
    log(f"(m) plan=True with the mesh equals plan=True without it: "
        f"{json.dumps(plans)}")

    # the split scan, one frame of each workload at the phase-(b) shapes
    single = [*list(single_wrappers().values())[1:], wrappers["olt_compact"]]
    split, tally = {}, {}
    split_launches = {KERNEL_OF.get(w.__name__, w.__name__): 0
                      for w in single}
    for wl in WORKLOADS:
        q = FrameProblem(**FULL, workload=wl, device=dev)
        want, want_st = solve(q, "ask_scan", **worst)
        # the counts see the split's own calls only, not the reference's
        torch.cuda.synchronize()
        for w in single:
            w.launches = 0
        pre, state, st = progressive.run_ask_scan_progressive(q, **worst)
        if not torch.equal(state, want):
            fail(f"phase m: {wl} split scan differs from ask_scan in "
                 f"{int((state != want).sum())} pixels")
        same_stats("m", f"{wl} split scan", st, want_st,
                   ("levels", "region_counts", "leaf_count",
                    "overflow_dropped", "olt_caps"))
        if st.kernel_launches != 2 or pre.shape != (FULL["n"],) * 2 or \
                int(pre.min()) < 0 or int(pre.max()) > FULL["max_dwell"]:
            fail(f"phase m: {wl} split scan {st}, preview {pre.dtype} "
                 f"{tuple(pre.shape)}")
        painted = int((pre != state).sum())
        del pre, state
        # no host sync between the coarse dispatch and refine()'s return;
        # the preview's eager Q and T recorded and held against plain
        calls = []
        torch.cuda.synchronize()
        with recording(ops, calls, keep_canvas=True,
                       names=("perimeter_query", "region_fill")):
            torch.cuda.set_sync_debug_mode("error")
            try:
                c = progressive.dispatch_progressive(q, **worst)
                r = c.refine()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        state, st = r.finalize()
        for w in single:
            split_launches[KERNEL_OF.get(w.__name__, w.__name__)] += \
                w.launches
        if not torch.equal(state, want) or st.kernel_launches != 2:
            fail(f"phase m: {wl} split scan under the sync check differs")
        for call in calls:
            if call["name"] == "region_fill":
                tally_add(tally, call, call["out"],
                          plain_of(call, call["before"]))
            else:
                tally_add(tally, call, call["out"], plain_of(call))
        del c, r, state, want, calls
        split[wl] = dict(checkpoint=progressive.checkpoint_for(q, None),
                         preview_painted_px=painted)
    check_tally(tally, "m")
    log(f"(m) the split scan of each workload equals ask_scan, 2 launches, "
        f"no host sync between the coarse dispatch and refine(): "
        f"{json.dumps(split)}; launches on the split calls alone (warm-ups, "
        f"captures, previews) {json.dumps(split_launches)}; the previews' Q "
        f"and T against plain: {json.dumps(tally)}")
    for k, c in split_launches.items():
        if c == 0:
            fail(f"phase m: {k} was never launched on the split path")

    # the split batch
    c = progressive.dispatch_progressive_batch(p, bounds, **worst)
    r = c.refine()
    pre = c.preview()
    if pre.shape != (F, n, n):
        fail(f"phase m: batch preview {tuple(pre.shape)}")
    del pre, c
    got, st = r.finalize()
    same_frames("m", "the split batch", got, ref)
    same_stats("m", "the split batch", st, ref_st)
    del got, r
    log("(m) dispatch_progressive_batch on the 8 frames equals the batched "
        "scan, every stats field")

    # warm walls, medians of 5
    def median(fn):
        runs = sorted(host_ms(fn) for _ in range(5))
        return runs[2], [runs[0], runs[-1]]

    wall = {}
    for key, fn in (
            ("batch_ms", lambda: solve_batch(p, bounds, **worst)),
            ("sharded_batch_ms",
             lambda: solve_batch(p, bounds, mesh=mesh, **worst)),
            ("batch_again_ms", lambda: solve_batch(p, bounds, **worst))):
        wall[key], wall[key.replace("_ms", "_range")] = median(fn)
    for wl in WORKLOADS:
        q = FrameProblem(**FULL, workload=wl, device=dev)
        row = wall[wl] = {}
        for key, fn in (
                ("ask_scan_ms", lambda: solve(q, "ask_scan", **worst)),
                ("preview_ready_ms", lambda: progressive.dispatch_progressive(
                    q, **worst).preview()),
                ("split_ms", lambda: progressive.run_ask_scan_progressive(
                    q, **worst))):
            row[key], row[key.replace("_ms", "_range")] = median(fn)
    log(f"(m) wall: {json.dumps(wall)}")
    q = FrameProblem(**FULL, device=dev)
    trace = replay_trace(
        lambda: progressive.run_ask_scan_progressive(q, **worst),
        wall["mandelbrot"]["split_ms"], REPLAY_KERNELS, "m")
    log(f"(m) trace of one split render (mandelbrot, its graphs replayed): "
        f"{json.dumps(trace)}")
    del ref
    return dict(kernels=held, split_launches=split_launches, wall=wall,
                dispatch=dispatch, plans=plans, trace=trace, tally=tally)


# -- serving: the render service, the front door, the tile service --------------

SERVE_ZOOM = dict(n=4096, g=4, r=2, B=32, max_dwell=512)
# the boundary-skimming zoom of tests/test_render_pipeline.py
SKIM = dict(center=(-0.7436447860, 0.1318252536), width0=6.0,
            zoom_per_frame=1.02)
# BENCH_9.json's tile scenario at its own config (benchmarks/
# bench_ask_scan.py): a half-overlap pan, a half-overlap zoom one depth
# down, then the whole stream again
TILES = dict(n=256, g=4, r=2, B=16, max_dwell=64)
TILE_VIEWS = ([(-1.0 + 0.25 * i, -0.25, -0.5 + 0.25 * i, 0.25)
               for i in range(6)]
              + [(-0.85 + 0.125 * i, -0.125, -0.6 + 0.125 * i, 0.125)
                 for i in range(3)]) * 2


def watch_handles(svc) -> list:
    """Wrap ``svc._dispatch`` so that each chunk's ``finalize()`` records
    whether the chunk enqueued after it had finished just before the call
    and just after it: (index, before, after), None without a next chunk.
    Pending before and finished after would mean that the finalize waited
    for it."""
    handles, states = [], []
    dispatch = svc._dispatch

    def recorded(chunk, caps=None, key=""):
        d, secs = dispatch(chunk, caps, key)
        i = len(handles)
        handles.append(d)
        finalize = d.finalize

        def watched(**kw):
            nxt = handles[i + 1] if i + 1 < len(handles) else None
            before = None if nxt is None else nxt.ready.query()
            out = finalize(**kw)
            after = None if nxt is None else nxt.ready.query()
            states.append((i, before, after))
            return out

        d.finalize = watched
        return d, secs

    svc._dispatch = recorded
    return states


def chunk_times(rs) -> list:
    return [dict(dispatch_ms=c.dispatch_s * 1e3, fetch_ms=c.fetch_s * 1e3,
                 in_flight=c.in_flight) for c in rs.chunk_stats]


def render_times(rs) -> dict:
    return dict(wall_s=rs.wall_s, busy_s=rs.busy_s, dispatch_s=rs.dispatch_s,
                fetch_s=rs.fetch_s, host_copy_s=rs.host_copy_s)


def tenant_plan() -> dict:
    """tests/test_frontdoor.py's 8 tenants x 3 frames: mixed workloads,
    distinct trajectories."""
    from repro_torch.launch.render_service import zoom_bounds
    plan = {}
    for i in range(8):
        wl = ("mandelbrot", "julia")[i % 2]
        center = ((-0.74364 + 0.01 * i, 0.13182) if wl == "mandelbrot"
                  else (0.02 * i - 0.05, 0.01 * i))
        plan[f"tenant{i}"] = (wl, list(zoom_bounds(
            3, center=center, width0=3.0 - 0.1 * i)))
    return plan


def merge_held(*rows: dict) -> dict:
    out = {}
    for held in rows:
        for k, row in held.items():
            o = out.setdefault(k, dict(calls=0, mismatches=0, max_abs_err=0))
            o["calls"] += row["calls"]
            o["mismatches"] += row["mismatches"]
            o["max_abs_err"] = max(o["max_abs_err"], row["max_abs_err"])
    return out


def phase_r(dev) -> dict:
    """Serving; see the module docstring, phase (r)."""
    import tempfile

    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.frontdoor import FrontDoor, FrontDoorStats
    from repro_torch.launch.render_service import RenderService, zoom_bounds
    from repro_torch.launch.tiles import TileService
    from repro_torch.workloads import (FrameProblem, FrontDoorOptions,
                                       TileOptions, solve_batch)
    out = {}

    # 1. the zoom stream at n=4096, chunk 8, depth 1 then 2, through
    # render(sink=): each chunk's canvases written to one file
    p = FrameProblem(**SERVE_ZOOM, device=dev)
    zoom = list(zoom_bounds(64))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "chunk.bin"
        sink_ms: list = []  # the sink's own time, a chunk

        def sink(canvases, stats):
            t = time.perf_counter()
            with open(path, "wb") as f:
                canvases.tofile(f)
            sink_ms.append((time.perf_counter() - t) * 1e3)

        RenderService(p, chunk_frames=8).render(zoom[:24], sink=sink)  # warm
        runs = {}
        wrappers = pooled_wrappers()
        for depth in (1, 2):
            svc = RenderService(p, chunk_frames=8, pipeline_depth=depth)
            states = watch_handles(svc)
            sink_ms.clear()
            torch.cuda.synchronize()
            if depth == 2:  # the main path of this phase, counted
                for w in wrappers.values():
                    w.launches = 0
            canv, rs = svc.render(zoom, sink=sink)
            torch.cuda.synchronize()
            if depth == 2:
                launches = {k: w.launches for k, w in wrappers.items()}
            runs[depth] = (svc, canv, rs, states)
            log(f"(r) zoom stream, depth {depth}: " + json.dumps(dict(
                **render_times(rs), chunks=rs.chunks,
                dispatches=rs.dispatches, program_traces=rs.program_traces,
                overflow_dropped=rs.overflow_dropped,
                chunk_times=chunk_times(rs), sink_ms=list(sink_ms),
                next_chunk_before_after_finalize=states)))
        # the pipelined stream once more, traced: the card's busy share
        # against the untraced run's wall
        svc = RenderService(p, chunk_frames=8)
        trace = traced(lambda: svc.render(zoom, sink=sink))
        trace["busy"] = trace["device_ms"] / (runs[2][2].wall_s * 1e3)
        log("(r) the pipelined zoom stream traced: " + json.dumps(trace))
    log(f"(r) launches on the pipelined zoom stream: {json.dumps(launches)}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase r: {k} was never launched on the serving path")
    sync_rs, pipe_rs = runs[1][2], runs[2][2]
    for depth, (svc, canv, rs, states) in runs.items():
        if not rs.dispatches == rs.chunks == 8 or \
                svc.program_traces() != 1 or canv.shape != (64, 4096, 4096):
            fail(f"phase r: depth {depth}: {rs.chunks} chunks, "
                 f"{rs.dispatches} dispatches, {svc.program_traces()} "
                 f"signatures, canvases {canv.shape}")
        waited = [s for s in states if s[1] is False and s[2] is True]
        if waited:
            fail(f"phase r: depth {depth}: finalize() of chunk k waited for "
                 f"chunk k+1: {waited}")
    if not np.array_equal(runs[1][1], runs[2][1]):
        fail("phase r: the pipelined stream differs from the synchronous one")
    for k in range(8):
        want, _ = solve_batch(p, np.asarray(zoom[8 * k:8 * k + 8], np.float32))
        if not np.array_equal(runs[2][1][8 * k:8 * k + 8], want.cpu().numpy()):
            fail(f"phase r: zoom chunk {k} differs from solve_batch")
        del want
    out["zoom"] = dict(sync=render_times(sync_rs), pipelined=render_times(
        pipe_rs), saved_s=sync_rs.busy_s - pipe_rs.wall_s,
        busy=trace["busy"])
    del runs
    log(f"(r) the zoom stream (64 frames at n=4096, chunk 8) equals "
        f"solve_batch chunk by chunk at depth 1 and 2, 8 dispatches, one "
        f"signature; pipelined wall {pipe_rs.wall_s:.4f} s against the "
        f"synchronous busy {sync_rs.busy_s:.4f} s")
    if not pipe_rs.wall_s < sync_rs.busy_s:
        fail(f"phase r: the pipelined wall {pipe_rs.wall_s} s is not below "
             f"the synchronous busy {sync_rs.busy_s} s")

    # 2. the paper's size: 8 frames at n=16384, the default chunk
    p = FrameProblem(**FULL, device=dev)
    bounds = mixed_bounds()
    ref, _ = solve_batch(p, bounds, safety_factor=1e9)
    svc = RenderService(p, safety_factor=1e9)
    t0, at, chunks = time.perf_counter(), 0, []
    for r in svc.stream_chunks(bounds):
        f = r.chunk.frames
        if not torch.equal(r.canvases, ref[at:at + f]) or \
                r.stats.overflow_dropped:
            fail(f"phase r: paper-size chunk {r.chunk.index} differs from "
                 "the batched scan")
        chunks.append(dict(frames=f, dispatch_ms=r.chunk.dispatch_s * 1e3,
                           fetch_ms=r.chunk.fetch_s * 1e3))
        at += f
    wall = time.perf_counter() - t0
    if at != 8 or len(chunks) != 2:
        fail(f"phase r: paper size streamed {at} frames in {len(chunks)} "
             "chunks")
    del ref, svc
    out["paper"] = dict(chunks=chunks, wall_s=wall)
    log("(r) 8 frames at n=16384 through stream_chunks (chunk "
        f"{chunks[0]['frames']}) equal the batched scan: " + json.dumps(
            out["paper"]))

    # 3. feedback, both engines, on the boundary-skimming zoom at n=4096;
    # every kernel call held against its plain version
    p = FrameProblem(**SERVE_ZOOM, device=dev)
    skim = list(zoom_bounds(32, **SKIM))
    want = solve_batch(p, np.asarray(skim, np.float32),
                       safety_factor=1e9)[0].cpu().numpy()
    calls: list = []
    out["feedback"] = {}
    with recording_pooled(ops, calls):
        for engine in ("ask_scan", "ask_pooled"):
            svc = RenderService(p, chunk_frames=8, feedback=True,
                                engine=engine)
            canv, rs = svc.render(skim)
            if rs.overflow_dropped or not np.array_equal(canv, want):
                fail(f"phase r: feedback {engine} dropped "
                     f"{rs.overflow_dropped} or differs from the worst case")
            out["feedback"][engine] = dict(
                retries=rs.retries, ring_rows=rs.ring_rows,
                plan_signatures=rs.plan_signatures, chunks=rs.chunks,
                dispatches=rs.dispatches, wall_s=rs.wall_s,
                sources=[c.p_source for c in rs.chunk_stats])
    del want
    held = hold_pooled_calls(calls, 8, SERVE_ZOOM["n"], dev, "r")
    del calls
    log("(r) feedback on the skimming zoom (32 frames at n=4096) drops "
        "nothing and equals the worst case: " + json.dumps(out["feedback"]))

    # 4. the front door: 8 tenants over a mixed service at n=1024
    def mixed_service():
        probs = {wl: FrameProblem(**dict(FULL, n=1024), workload=wl,
                                  device=dev)
                 for wl in ("mandelbrot", "julia")}
        return RenderService(probs, chunk_frames=8, feedback=True,
                             safety_factor=1.1)

    svc = mixed_service()
    door = FrontDoor(svc, options=FrontDoorOptions(
        quantum=2, max_in_flight=2, tenant_feedback=True))
    plan = tenant_plan()
    now = door.now()
    t0 = time.perf_counter()
    for i, (tenant, (wl, bs)) in enumerate(plan.items()):
        for j, b in enumerate(bs):
            door.session(tenant).submit(wl, b,
                                        deadline=now + 300.0 + 10.0 * i + j)
    door.drain()
    door_s = time.perf_counter() - t0
    st = door.stats
    solo = 0
    for tenant, (wl, bs) in plan.items():
        frames = list(door.session(tenant).results())
        canv, rs = mixed_service().render([(wl, b) for b in bs])
        solo += rs.dispatches
        if [f.tseq for f in frames] != [0, 1, 2] or not np.array_equal(
                np.stack([f.canvas for f in frames]), canv):
            fail(f"phase r: {tenant}'s frames differ from its solo render")
    if not (st.served == 24 and st.overflow_dropped == 0
            and st.dispatches < solo):
        fail(f"phase r: the front door served {st.served}, dropped "
             f"{st.overflow_dropped}, dispatched {st.dispatches} against "
             f"{solo} alone")
    out["frontdoor"] = dict(batches=st.batches, dispatches=st.dispatches,
                            solo_dispatches=solo, retries=st.retries,
                            deadline_misses=st.deadline_misses,
                            wall_s=door_s)
    log("(r) front door, 8 tenants at n=1024: each tenant's frames equal "
        "its solo render: " + json.dumps(out["frontdoor"]))

    # 5. the tiles: BENCH_9.json's scenario, then progressively
    prob = FrameProblem(**TILES, device=dev)
    svc = RenderService(prob, chunk_frames=8, feedback=True)

    def stream(tiles):
        hits = misses = dispatches = 0
        served = {}
        for v in TILE_VIEWS:
            r = tiles.serve(v)
            hits, misses = hits + r.hits, misses + r.misses
            dispatches += r.dispatches
            served.update(r.tiles)
        return hits, misses, dispatches, served

    fd = FrontDoorStats()
    hits, misses, dispatches, served = stream(TileService(svc, stats_sink=fd))
    base = stream(TileService(svc, options=TileOptions(max_bytes=0)))[2]
    ref = tuple(float(x) for x in prob.bounds)
    addrs = list(served)
    exact = solve_batch(prob, np.asarray([a.bounds(ref) for a in addrs]),
                        p_subdiv=1.0)[0].cpu().numpy()
    identical = int(all(np.array_equal(served[a], exact[j])
                        for j, a in enumerate(addrs)))
    hit_rate = round(hits / (hits + misses), 4)
    if (hit_rate, dispatches, base, identical) != (0.7667, 6, 18, 1) or \
            (fd.tile_hits, fd.tile_misses) != (hits, misses):
        fail(f"phase r: tiles hit_rate {hit_rate}, {dispatches} dispatches "
             f"against {base}, identical {identical}")
    tile_calls: list = []
    ts = TileService(svc, options=TileOptions(progressive=True))
    previewed, exact_tiles = set(), {}
    t0 = time.perf_counter()
    first_preview = last_tile = None
    with recording_pooled(ops, tile_calls):
        for v in TILE_VIEWS:
            for kind, a, c in ts.serve_progressive(v):
                if kind == "preview":
                    first_preview = first_preview or time.perf_counter() - t0
                    previewed.update(a)
                elif kind == "tile":
                    if a not in previewed:
                        fail(f"phase r: tile {a} came before its preview")
                    exact_tiles[a] = c
                    last_tile = time.perf_counter() - t0
    if set(exact_tiles) != set(served) or not all(
            np.array_equal(c, served[a]) for a, c in exact_tiles.items()):
        fail("phase r: the progressive tiles differ from serve()'s")
    held = merge_held(held, hold_pooled_calls(tile_calls, 8, TILES["n"], dev,
                                              "r"))
    out["tiles"] = dict(hit_rate=hit_rate, dispatches=dispatches,
                        baseline_dispatches=base, identical=identical,
                        tiles_unique=len(addrs), progressive_tiles=len(
                            exact_tiles), first_preview_s=first_preview,
                        last_exact_tile_s=last_tile)
    log("(r) tiles (BENCH_9.json's scenario): " + json.dumps(out["tiles"]))
    for k, row in held.items():
        row["launches"] = launches[k]
        log(f"(r) {k}: " + json.dumps(row))
        if row["mismatches"]:
            fail(f"phase r: {k} differs from its plain version in "
                 f"{row['mismatches']} outputs")
    return dict(launches=launches, kernels=held, **out)


# -- phase (u): the tuned tier and k-D SSD ----------------------------------

TUNED_FRAMES = 8  # pooled_frames of the tuning sweep: phase (p)'s batch
BENCH6 = dict(n=256, g=4, r=2, B=16, max_dwell=64)  # BENCH_6/10.json's config
SSD_3D = dict(seed=0, n=64, g=2, r=2, B=4, P=0.6, k=3)
PLAIN_SAMPLE = 1 << 18  # points of a tuned call's output held against plain
# the tuned tier's kernel names (autotune) -> the kernels line's names
TUNED_NAME = {"dwell": "mandelbrot_dwell", "perimeter_query": "perimeter_query",
              "region_dwell": "region_dwell", "olt_compact": "olt_compact",
              "region_fill_pooled": "region_fill_pooled",
              "region_dwell_pooled": "region_dwell_pooled"}


def default_instance(fn: str) -> str:
    """The SASS instance name of an escape kernel's default schedule
    (``autotune.DEFAULT_SCHEDULES``): <kind 0 (mandelbrot), U[, rows,
    columns]>."""
    from repro_torch.kernels.autotune import DEFAULT_SCHEDULES
    kernel = {"mandelbrot_dwell_kernel": "dwell",
              "perimeter_query_kernel": "perimeter_query",
              "perimeter_query_pooled_kernel": "perimeter_query",
              "region_dwell_kernel": "region_dwell",
              "region_dwell_items_kernel": "region_dwell",
              "region_dwell_pooled_kernel": "region_dwell_pooled"}[fn]
    sched = DEFAULT_SCHEDULES[kernel]
    args = [0, sched["unroll"], *sched.get("block", ())]
    return f"{fn}<{','.join(str(a) for a in args)}>"


def parse_key(key: str):
    """(kernel, signature) of a tuning-cache key."""
    kernel, *parts = key.split("|")
    sig = dict(p.split("=", 1) for p in parts)
    return kernel, {k: int(v) for k, v in sig.items()
                    if k not in ("wl", "dtype", "plat")}


def tuned_plain_check(kernel: str, sig: dict, dev, tally: dict) -> None:
    """Hold the default schedule's output on the tuner's inputs
    (``autotune._inputs``) against the plain version on a sample of at most
    ``PLAIN_SAMPLE`` points: Ex's first rows, Q's first rows, A's first
    region's first rows, the pooled A's rows, the scan whole, the pooled
    fill's rows that no other row repeats (a repeated region may get
    either row's value)."""
    from repro_torch.kernels import autotune, ops, ref
    from repro_torch.kernels.perimeter_query import perimeter_query_plain
    from repro_torch.workloads import get_workload
    wl = get_workload("mandelbrot")
    x = autotune._inputs(kernel, workload=wl, device=dev, **sig)
    b, md = wl.default_bounds, sig.get("max_dwell", 0)
    n = sig.get("n")

    def plain_points(xs, ys):
        cr, ci = ref.map_coords(xs.float(), ys.float(), n, b)
        return ref.dwell_compute(cr, ci, md, workload=wl)

    if kernel == "dwell":
        h = max(1, min(n, PLAIN_SAMPLE // n))
        got = ops.mandelbrot(n, bounds=b, max_dwell=md, workload=wl,
                             device=dev)[:h]
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(n, device=dev), indexing="ij")
        want = plain_points(xs, ys)
    elif kernel == "olt_compact":
        got = torch.cat([t.reshape(-1) for t in ops.compact_ranks(x["flags"])])
        ranks, count = ref.compact_ranks_ref(x["flags"])
        want = torch.cat([ranks, count.reshape(1)])
    elif kernel == "perimeter_query":
        side = sig["side"]
        k = max(1, min(x["coords"].shape[0], PLAIN_SAMPLE // (4 * side)))
        homog, common = ops.perimeter_query(
            x["coords"], x["count"], side=side, n=n, bounds=b, max_dwell=md,
            workload=wl)
        got = torch.stack([homog[:k].int(), common[:k]])
        ph, pc = perimeter_query_plain(
            x["coords"][:k].contiguous(),
            torch.tensor([k], dtype=torch.int32, device=dev), side=side, n=n,
            bounds=b, max_dwell=md, workload=wl)
        want = torch.stack([ph.int(), pc])
    elif kernel == "region_dwell":
        side = sig["side"]
        canvas = ops.region_dwell(x["canvas"], x["coords"], x["count"],
                                  side=side, n=n, bounds=b, max_dwell=md,
                                  workload=wl)
        h = max(1, min(side, PLAIN_SAMPLE // side))
        cy, cx = (int(v) for v in x["coords"][0].tolist())
        ys, xs = torch.meshgrid(cy * side + torch.arange(h, device=dev),
                                cx * side + torch.arange(side, device=dev),
                                indexing="ij")
        got, want = canvas[ys, xs], plain_points(xs, ys)
    elif kernel == "region_dwell_pooled":
        side = sig["side"]
        rows = x["rows"]
        canvas = ops.region_dwell_pooled(x["canvas"], rows, x["count"],
                                         x["planes"], side=side, n=n,
                                         max_dwell=md, workload=wl)
        got = canvas[ref.pooled_region_index(rows, side, n)]
        want = ref.region_interior_pooled_ref(rows, x["planes"], side=side,
                                              max_dwell=md, workload=wl)
    else:  # region_fill_pooled
        side, rows = sig["side"], x["rows"]
        canvas = ops.region_fill_pooled(x["canvas"], rows, x["values"],
                                        x["count"], side=side, n=n)
        _, inverse, counts = torch.unique(rows, dim=0, return_inverse=True,
                                          return_counts=True)
        once = counts[inverse] == 1
        k = max(1, PLAIN_SAMPLE // (side * side))
        rows_once = rows[once][:k]
        got = canvas[ref.pooled_region_index(rows_once, side, n)]
        want = x["values"][once][:k, None, None].expand_as(got)
    name = TUNED_NAME[kernel]
    t = tally.setdefault(name, dict(mismatches=0, pixels=0, max_abs_err=0))
    t["mismatches"] += int((got != want).sum())
    t["pixels"] += got.numel()
    if got.numel():
        t["max_abs_err"] = max(t["max_abs_err"],
                               int((got.long() - want.long()).abs().max()))


def bench_invariants(dev) -> dict:
    """BENCH_6.json's and BENCH_10.json's identity, dispatch, ring-row and
    overflow fields, on the card: ``ask_tuned`` against ``ask_scan`` on
    every registry workload at BENCH_6's config; the pooled engine planned
    with the tuned policy against the default one on BENCH_10's zoom
    ladders (``benchmarks/bench_ask_scan.py``, ``tuned_tier`` and
    ``pooled_tuned_tier``). Their walls are not a target."""
    import numpy as np
    from repro_torch.workloads import (EngineOptions, FrameProblem, available,
                                       solve, solve_batch)
    b6 = json.loads((ROOT / "BENCH_6.json").read_text())
    b10 = json.loads((ROOT / "BENCH_10.json").read_text())
    for f in (b6, b10):
        if {k: f["config"][k] for k in BENCH6} != BENCH6:
            fail(f"phase u: BENCH config {f['config']} is not {BENCH6}")
    out = {"bench6": {}, "bench10": {}}
    for wl in available():
        p = FrameProblem(**BENCH6, workload=wl, device=dev)
        base, _ = solve(p, "ask_scan", safety_factor=1e9)
        tuned, st = solve(p, "ask_tuned", safety_factor=1e9)
        got = dict(dispatches=st.kernel_launches, ring_rows=st.ring_rows,
                   identical=int(torch.equal(base, tuned)))
        want = {k: b6["workloads"][wl][k] for k in got}
        if got != want:
            fail(f"phase u: BENCH_6 {wl}: {got} on the card, the file {want}")
        out["bench6"][wl] = got
    F = b10["config"]["frames"]
    for wl, row in b10["workloads"].items():
        p = FrameProblem(**BENCH6, workload=wl, device=dev)
        c = (np.asarray(p.bounds[:2]) + np.asarray(p.bounds[2:])) / 2.0
        w0 = p.bounds[2] - p.bounds[0]
        bounds = [(c[0] - w / 2, c[1] - w / 2, c[0] + w / 2, c[1] + w / 2)
                  for w in (w0 / 1.35 ** k for k in range(F))]
        base, _ = solve_batch(p, bounds, options=EngineOptions(
            engine="ask_pooled", plan=True))
        tuned, rep = solve_batch(p, bounds, options=EngineOptions(
            engine="ask_pooled", plan=True, policy="tuned"))
        got = dict(dispatches=rep.dispatches, ring_rows=rep.ring_rows,
                   overflow=rep.overflow_dropped,
                   identical=int(torch.equal(torch.as_tensor(base),
                                             torch.as_tensor(tuned))))
        want = {k: row[k] for k in got}
        if got != want:
            fail(f"phase u: BENCH_10 {wl}: {got} on the card, the file {want}")
        out["bench10"][wl] = got
    return out


def phase_u(dev) -> dict:
    """The tuned tier and k-D SSD; see the module docstring, phase (u)."""
    import numpy as np
    from repro_torch.core import graphs
    from repro_torch.core import ssd_synth as ssd
    from repro_torch.kernels import autotune
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.workloads import (EngineOptions, FrameProblem, solve,
                                       solve_batch)
    wrappers = {**single_wrappers(), **pooled_wrappers()}
    names = {k: KERNEL_OF.get(k, k) for k in wrappers}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0

    # (1) the sweep at the main configuration, into a cache under build/
    path = ROOT / "build" / "tuning" / "phase_u.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    autotune.clear_memo()
    report: dict = {}
    t0 = time.perf_counter()
    cache = autotune.tune_problem(FrameProblem(**FULL, device=dev),
                                  pooled_frames=TUNED_FRAMES, report=report)
    cache.save(str(path))
    sweep_s = time.perf_counter() - t0
    tally: dict = {}
    winners = {}
    for key, r in report.items():
        kernel, sig = parse_key(key)
        default = next(c for c in r["candidates"] if c["default"])
        differs = r["winner"] != {k: v for k, v in default["params"].items()}
        winners.setdefault(TUNED_NAME[kernel], []).append(dict(
            sig=sig, winner=r["winner"], us=r["us"], default_us=default["us"],
            differs=differs))
        log(f"(u) tune {key}: " + json.dumps(dict(
            candidates=[[c["params"], round(c["us"], 3)] for c in r["candidates"]],
            winner=r["winner"], default=default["params"],
            winner_us=r["us"], default_us=default["us"], differs=differs)))
        tuned_plain_check(kernel, sig, dev, tally)
    check_tally(tally, "u")
    candidates = sum(len(r["candidates"]) for r in report.values())
    log(f"(u) the sweep: {len(report)} keys, {candidates} candidates, each "
        f"equal to its default schedule (tune raises otherwise), in "
        f"{sweep_s:.1f} s; the defaults against the plain version: "
        f"{json.dumps(tally)}; winners other than the default: "
        f"{sum(w['differs'] for ws in winners.values() for w in ws)}")

    # (2) ask_tuned with that cache against ask_scan, one replay each
    pol = KernelPolicy(tuning_cache=str(path))
    worst = dict(safety_factor=1e9)
    walls = {}
    for wl in WORKLOADS:
        scan_p = FrameProblem(**FULL, workload=wl, device=dev)
        tuned_p = FrameProblem(**FULL, workload=wl, device=dev, policy=pol)
        want, want_st = solve(scan_p, "ask_scan", **worst)
        held = graphs.held()[0]
        got, st = solve(tuned_p, "ask_tuned", **worst)
        if graphs.held()[0] != held + 1:
            fail(f"phase u: {wl} ask_tuned captured no graph of its own")
        if not torch.equal(got, want) or st.kernel_launches != 1:
            fail(f"phase u: {wl} ask_tuned differs from ask_scan in "
                 f"{int((got != want).sum())} pixels, {st.kernel_launches} "
                 "dispatches")
        same_stats("u", f"{wl} ask_tuned", st, want_st,
                   ("levels", "region_counts", "leaf_count",
                    "overflow_dropped", "olt_caps"))
        del got, want
        row = {}
        for m, q in (("ask_scan", scan_p), ("ask_tuned", tuned_p)):
            runs = sorted(host_ms(lambda: solve(q, m, **worst))
                          for _ in range(5))
            row[f"{m}_ms"], row[f"{m}_ms_range"] = runs[2], [runs[0], runs[-1]]
        walls[wl] = row
        log(f"(u) {wl}: ask_tuned equals ask_scan, one replay each: "
            + json.dumps(row))
        graphs.release()

    # (3) the batched scan through the tuned tier, phase (f)'s 8 frames
    bounds = mixed_bounds()
    p = FrameProblem(**POOLED, device=dev)
    want, want_st = solve_batch(p, bounds, **worst)
    got, st = solve_batch(p, bounds, options=EngineOptions(
        engine="ask_tuned", policy=pol, **worst))
    if not torch.equal(got, want):
        fail(f"phase u: the tuned batch differs from the batched scan in "
             f"{int((got != want).sum())} pixels")
    same_stats("u", "tuned batch", st, want_st,
               ("region_counts", "frame_leaf_counts", "frame_overflow",
                "overflow_dropped", "olt_caps"))
    del got, want
    torch.cuda.empty_cache()
    log(f"(u) solve_batch(engine='ask_tuned') on {len(bounds)} frames at "
        f"n={POOLED['n']} equals the batched scan")

    # (4) BENCH_6.json's and BENCH_10.json's invariants on the card
    bench = bench_invariants(dev)
    log(f"(u) BENCH_6/10 invariants on the card: {json.dumps(bench)}")

    # (5) ssd_synth through every engine JAX runs it through, and ask_tuned
    sp = FrameProblem(**BENCH6, workload="ssd_synth", device=dev)
    truth = torch.from_numpy(ssd.generate_field(
        0, n=256, g=4, r=2, B=16, P=0.7, k=2).field).to(dev)  # its defaults
    ssd_rows = {}
    for m in ("ex", "ask", "ask_scan", "ask_tuned"):
        kw = worst if m in ("ask_scan", "ask_tuned") else {}
        canvas, st = solve(sp, m, **kw)
        if not torch.equal(canvas, truth):
            fail(f"phase u: ssd_synth {m} differs from its field in "
                 f"{int((canvas != truth).sum())} pixels")
        ssd_rows[m] = st.kernel_launches
    graphs.release()

    # (6) the 3-D field through solve_ask_3d
    fld = ssd.generate_field(SSD_3D["seed"], **{k: v for k, v in SSD_3D.items()
                                                  if k != "seed"})
    canvas, counts = ssd.solve_ask_3d(fld, device=dev)
    if not np.array_equal(canvas.cpu().numpy(), fld.field) or \
            counts != fld.level_counts:
        fail(f"phase u: solve_ask_3d differs from its field: counts {counts} "
             f"against {fld.level_counts}")
    torch.cuda.synchronize()
    launches = {names[k]: w.launches for k, w in wrappers.items()}
    log(f"(u) ssd_synth on the card equals its field through "
        f"{json.dumps(ssd_rows)}; solve_ask_3d at {json.dumps(SSD_3D)} equals "
        f"its field, counts {counts}; launches in phase (u): "
        f"{json.dumps(launches)}")
    for k, c in launches.items():
        if c == 0:
            fail(f"phase u: {k} was never launched in the tuned phase")
    return dict(launches=launches, tally=tally, winners=winners, walls=walls,
                bench=bench, sweep_s=sweep_s)


# -- MoE serving ---------------------------------------------------------------

@contextlib.contextmanager
def recording_ranks(ops, calls: list, fn=None, to_host: bool = False):
    """Swap ``ops.batched_ranks`` (what the MoE calls) for one that records
    each call's flags and outputs (on the card, or with ``to_host`` on the
    host: no card memory); ``fn`` replaces the function called."""
    saved = ops.batched_ranks
    inner = fn or saved
    keep = (lambda t: t.cpu()) if to_host else (lambda t: t.clone())

    def wrapped(flags):
        ranks, counts = inner(flags)
        calls.append(dict(flags=keep(flags), ranks=keep(ranks),
                          counts=keep(counts)))
        return ranks, counts

    ops.batched_ranks = wrapped
    try:
        yield calls
    finally:
        ops.batched_ranks = saved


def held_ranks(calls: list) -> tuple:
    """(mismatches, max abs err) of recorded batched-ranks calls against
    the plain version."""
    from repro_torch.kernels import ref
    mismatches = max_err = 0
    for c in calls:
        pr, pc = ref.batched_ranks(c["flags"])
        got = torch.cat([c["ranks"].reshape(-1), c["counts"].reshape(-1)])
        want = torch.cat([pr.reshape(-1), pc.reshape(-1)])
        mismatches += int((got != want).sum())
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
    return mismatches, max_err


def ranks_bound(flags) -> tuple:
    """(least ms, ms by operations, ms by bytes) of one batched-ranks call:
    flags read once, ranks and counts written once, over HBM bandwidth; one
    add per flag at the f32 non-tensor rate (the data sheet gives no int32
    rate; it is far from binding either way)."""
    G, N, E = flags.shape
    nbytes = flags.numel() * flags.element_size() + 4 * G * N * E + 4 * G * E
    t_ops, t_bytes = G * N * E / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


# phase (l): teacher forcing at full width in f32 (arch, cuts, KV cache
# dtype), then serving in bf16 (arch, layers: None is the full depth)
FAMILY_PARITY = (("deepseek-v2-lite-16b", dict(num_layers=2), "bfloat16"),
                 ("jamba-v0.1-52b", dict(num_layers=8, num_experts=4), "bfloat16"),
                 ("xlstm-350m", {}, "bfloat16"),
                 ("jamba-v0.1-52b", dict(num_layers=8, num_experts=4), "int8"))
FAMILY_SERVE = (("deepseek-v2-lite-16b", None), ("jamba-v0.1-52b", 8),
                ("xlstm-350m", None))
INT8_TF_TOL = 1e-2  # tests/test_torch_models.py: of the largest |logit|


def cut_config(arch: str, num_layers=None, num_experts=None, **change):
    """``arch``'s config with its depth (and its routed experts, top-k
    kept) cut, and any other field changed."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if num_layers:
        change["num_layers"] = num_layers
    if num_experts:
        change["moe"] = dataclasses.replace(cfg.moe, num_experts=num_experts)
    return dataclasses.replace(cfg, **change)


def moe_layers(cfg) -> int:
    return cfg.num_groups * sum(s.ffn == "moe" for s in cfg.pattern)


def serve_parity(dev, phase: str, cfg, cuts: str) -> float:
    """Teacher forcing at full width, f32, nothing dropped: prefill(prompt)
    + decode_step(token t) against forward() (rtol and atol 1e-4; with the
    int8 KV cache, within INT8_TF_TOL of the largest |logit|). A vision or
    audio config takes normal media ([B, num_media_tokens, D], or S frames),
    and decodes against the media or the encoder's memory."""
    import dataclasses

    from repro_torch.models import transformer as T
    note = ""
    if cfg.moe:  # C = int(cf * Sg * K / E) >= Sg for every group: no drops
        cf = float(cfg.moe.num_experts // cfg.moe.top_k + 1)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        note = f", cf {cf}"
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    int8 = cfg.kv_cache_dtype == "int8"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=1, device=dev)
    n = T.count_params(model)
    g = torch.Generator(device=dev).manual_seed(1)
    B, S, P = 2, 12, 6
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    media = None
    if cfg.frontend != "none":
        media = torch.randn((B, cfg.num_media_tokens or S, cfg.d_model),
                            generator=g, device=dev)
        note += f", media {list(media.shape)}"
    worst = 0.0
    with torch.no_grad():
        full, _ = T.forward(cfg, model, toks, media)
        lp, cache = T.prefill(cfg, model, toks[:, :P], media, cache_len=S)
        memory = T.make_memory(cfg, model, media)
        steps = [(P - 1, lp)]
        for t in range(P, S):
            ld, cache = T.decode_step(cfg, model, cache, toks[:, t:t + 1], t,
                                      memory=memory)
            steps.append((t, ld))
    for t, got in steps:
        want = full[:, t]
        if not torch.isfinite(got).all():
            fail(f"phase {phase}: {cfg.name} parity logits at {t} not finite")
        err = float((got - want).abs().max())
        if int8:
            if err > INT8_TF_TOL * float(want.abs().max()):
                fail(f"phase {phase}: {cfg.name} with the int8 cache: logits "
                     f"at {t} differ by {err:.3g}, above {INT8_TF_TOL} of "
                     f"{float(want.abs().max()):.3g}")
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        worst = max(worst, err)
    tol = (f"within {INT8_TF_TOL} of the largest |logit|, "
           f"{float(full.abs().max()):.3g}" if int8 else "rtol 1e-4, atol 1e-4")
    log(f"({phase}) teacher forcing, {cfg.name} at full width ({cuts}), f32"
        f"{', int8 KV cache' if int8 else ''}{note}: {n:,} parameters; prefill "
        f"+ {S - P} decode steps equal forward (max abs diff {worst:.3g}; {tol}), "
        f"in {time.perf_counter() - t0:.1f} s")
    del model, cache, full, media, memory
    torch.cuda.empty_cache()
    return worst


def traced(fn, spans=()) -> dict:
    """Device time of one run of ``fn`` by torch.profiler: the kernels'
    summed durations and launches, the top kernels by name, and the top
    PyTorch operations by the device time of the kernels they launch (a
    kernel counts for the operation that launched it, as ``key_averages``'
    self device time counts it). Summed from the profiler's raw events:
    ``key_averages`` takes about 0.3 ms an event, minutes on a serving
    trace of 10^5 launches. ``spans``: names of ``record_function`` ranges;
    a kernel counts for each range its launch lies in (``ranges``: ms,
    launches and the top operations' ms by name)."""
    import bisect
    from collections import Counter, defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.profiler.kineto_results.events()
              if not getattr(e, "is_hidden_event", lambda: False)()]
    op_of, calls = {}, Counter()  # the operations, by correlation id
    for e in events:
        if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0 \
                and not e.is_async() and e.start_thread_id() == e.end_thread_id():
            op_of[e.correlation_id()] = e.name()
            calls[e.name()] += 1
    launched, ranges = {}, {}  # correlation id -> launch time; name -> spans
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        if e.name() in spans:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
        elif e.correlation_id():
            t = launched.get(e.correlation_id())
            launched[e.correlation_id()] = min(t or e.start_ns(), e.start_ns())
    for r in ranges.values():
        r.sort()
    in_range = defaultdict(lambda: [0.0, 0])
    range_ops = defaultdict(lambda: defaultdict(float))
    kernels, ops_ = defaultdict(lambda: [0.0, 0]), defaultdict(float)
    for e in events:  # a range also shows on the device's timeline: skip it
        if e.device_type() != DeviceType.CUDA or e.name() in spans:
            continue
        us = e.duration_ns() / 1e3
        k = kernels[e.name()]
        k[0] += us
        k[1] += 1
        op = op_of.get(e.linked_correlation_id())
        if op is not None:
            ops_[op] += us
        t = launched.get(e.linked_correlation_id())
        for name, r in ranges.items():
            i = bisect.bisect_right(r, (t, float("inf"))) - 1 if t else -1
            if i >= 0 and r[i][0] <= t <= r[i][1]:
                in_range[name][0] += us
                in_range[name][1] += 1
                range_ops[name][op or e.name()[:60]] += us
    krows = sorted(((us / 1e3, n, name[:80]) for name, (us, n) in kernels.items()),
                   reverse=True)
    orows = sorted(((us / 1e3, calls[name], name[:80]) for name, us in ops_.items()),
                   reverse=True)
    return dict(device_ms=sum(r[0] for r in krows),
                launches=sum(r[1] for r in krows),
                top_kernels=[dict(ms=a, calls=b, name=c) for a, b, c in krows[:8]],
                top_ops=[dict(ms=a, calls=b, name=c) for a, b, c in orows[:10]],
                ranges={name: dict(ms=in_range[name][0] / 1e3,
                                   launches=in_range[name][1],
                                   spans=len(ranges.get(name, ())),
                                   ops=sorted(((us / 1e3, op) for op, us
                                               in range_ops[name].items()),
                                              reverse=True)[:5])
                        for name in spans})


@contextlib.contextmanager
def annotated_cross():
    """Run each cross-attention call (``attn_train`` with ``kv_x``) in a
    profiler range ``cross_attn`` and its projections in ``cross_kv``: the
    K and V over the memory, and the Q of one row a request."""
    from torch.profiler import record_function

    from repro_torch.models import attention as A
    train, project = A.attn_train, A._project_qkv

    def attn_train(p, x, *, kv_x=None, **kw):
        if kv_x is None:
            return train(p, x, **kw)
        with record_function("cross_attn"):
            return train(p, x, kv_x=kv_x, **kw)

    def project_qkv(p, x, kv_x=None, **kw):
        if kv_x is None:
            return project(p, x, **kw)
        with record_function("cross_kv"):
            return project(p, x, kv_x, **kw)

    A.attn_train, A._project_qkv = attn_train, project_qkv
    try:
        yield
    finally:
        A.attn_train, A._project_qkv = train, project


def serve_profile(phase: str, cfg, model, tokens, gen, wall: dict,
                  media=None) -> dict:
    """One request's run traced in two parts, the prefill step and then
    its gen - 1 serve steps; the device busy share of each against the
    untraced wall times. The prefill step's logits must be finite. With
    ``media``, the decode trace also sums the device time of the cross
    layers' attention calls and of their projections over the memory
    (``annotated_cross``), and their shares of decode's."""
    from repro_torch.launch.steps import greedy, make_prefill_step, make_serve_step
    from repro_torch.models.transformer import CROSS, make_memory
    P = tokens.shape[1]
    prefill, serve = make_prefill_step(cfg, cache_len=P + gen), make_serve_step(cfg)
    batch = {"tokens": tokens, "media": media}
    with torch.no_grad():
        memory = make_memory(cfg, model, media)
    state = {}

    def prefill_step():
        state["logits"], state["cache"] = prefill(model, batch)

    def decode_steps():
        tok, cache = greedy(cfg, state.pop("logits")), state.pop("cache")
        for i in range(gen - 1):
            tok, cache = serve(model, cache, {"tokens": tok, "pos": P + i,
                                              "memory": memory})

    pre = traced(prefill_step)
    if not torch.isfinite(state["logits"]).all():
        fail(f"phase {phase}: {cfg.name} prefill logits not finite")
    spans = ("cross_attn", "cross_kv") if memory is not None else ()
    with annotated_cross() if spans else contextlib.nullcontext():
        dec = traced(decode_steps, spans)
    out = dict(
        prefill=pre, decode=dec,
        prefill_busy=pre["device_ms"] / wall["prefill_ms"],
        decode_device_ms_per_token=dec["device_ms"] / (gen - 1),
        decode_busy=dec["device_ms"] / (wall["decode_ms_per_token"] * (gen - 1)),
        decode_launches_per_token=dec["launches"] / (gen - 1))
    log(f"({phase}) {cfg.name} profile: prefill {pre['device_ms']:.2f} ms of "
        f"kernels in {pre['launches']} launches ({out['prefill_busy']:.0%} of its "
        f"wall); decode {out['decode_device_ms_per_token']:.2f} ms of kernels "
        f"per token in {out['decode_launches_per_token']:.0f} launches "
        f"({out['decode_busy']:.0%} of its wall)")
    cross_layers = cfg.num_groups * sum(sp.mixer in CROSS for sp in cfg.pattern)
    for name in spans:
        r = dec["ranges"][name]
        if r["spans"] != cross_layers * (gen - 1) or not r["launches"]:
            fail(f"phase {phase}: {cfg.name} decode trace: {r['spans']} "
                 f"{name} ranges (expected {cross_layers} x {gen - 1}) holding "
                 f"{r['launches']} launches")
        out[name] = dict(device_ms_per_token=r["ms"] / (gen - 1),
                         launches_per_token=r["launches"] / (gen - 1),
                         share_of_decode=r["ms"] / dec["device_ms"],
                         ops_ms_per_token={op: ms / (gen - 1)
                                           for ms, op in r["ops"]})
    if spans:
        a, kv = out["cross_attn"], out["cross_kv"]
        log(f"({phase}) {cfg.name} decode over the memory {list(memory.shape)}: "
            f"the {cross_layers} cross layers' attention calls "
            f"{a['device_ms_per_token']:.3f} ms of kernels a token "
            f"({a['share_of_decode']:.1%} of decode's; "
            f"{a['launches_per_token']:.0f} launches), of which their "
            f"projections (K and V over the memory, Q of one row) "
            f"{kv['device_ms_per_token']:.3f} ms ({kv['share_of_decode']:.1%}; "
            f"{kv['launches_per_token']:.0f} launches)")
        for name in spans:
            log(f"({phase}) {cfg.name}   {name} by operation, ms a token: "
                + ", ".join(f"{op} {ms:.3f}" for op, ms
                            in out[name]["ops_ms_per_token"].items()))
    for name, t in (("prefill", pre), ("decode", dec)):
        for kind in ("top_kernels", "top_ops"):
            for r in t[kind]:
                log(f"({phase})   {name} {kind[4:-1]} {r['ms']:9.3f} ms "
                    f"{r['calls']:7d}x {r['name']}")
    return out


def serve_run(dev, phase: str, cfg, cuts: str, prompt=None, frames=None) -> dict:
    """``serve.generate`` on SERVE's requests (``prompt`` tokens each, if
    given) with random parameters made on the card from a seed: the
    batched-ranks launches counted on that run (one per MoE layer per
    step), every call held against its plain version, the run repeated
    with the plain ranks (tokens and every call's counts identical), 3
    warm runs, a traced one, and the kernel timed at each of the run's
    shapes. A vision or audio config gets the serve CLI's media
    (``serve.make_media``; ``frames`` frames a request for audio). The
    model is freed at the end."""
    from repro_torch.kernels import moe_dispatch, ops, ref
    from repro_torch.launch.serve import generate, make_media
    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import count_params, init_params

    B, P, gen = SERVE["batch"], prompt or SERVE["prompt"], SERVE["gen"]
    torch.cuda.reset_peak_memory_stats(dev)
    t_run = t0 = time.perf_counter()
    model = init_params(cfg, seed=SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    n_params = count_params(model)
    init_s = time.perf_counter() - t0
    init_mem = torch.cuda.max_memory_allocated(dev)
    log(f"({phase}) {cfg.name}: {n_params:,} parameters ({cfg.num_layers} "
        f"layers, {cuts}, {cfg.param_dtype}), made on the card in {init_s:.1f} "
        f"s; max_memory_allocated {init_mem / 2**30:.2f} GiB")
    if n_params != cfg.param_count():
        fail(f"phase {phase}: {n_params} parameters, config says "
             f"{cfg.param_count()}")
    g = torch.Generator(device=dev).manual_seed(SERVE["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev)
    media = make_media(cfg, B, frames or P, g, dev)
    if media is not None:
        log(f"({phase}) {cfg.name} media {list(media.shape)} {media.dtype}, "
            f"prompt {P} tokens, {gen} generated")

    # the main path, counted and recorded
    others = [*pooled_wrappers().values(), *single_wrappers().values()]
    for w in [moe_dispatch.batched_ranks, *others]:
        w.launches = 0
    calls: list = []
    with recording_ranks(ops, calls):
        res = generate(cfg, model, tokens, gen, media)
    torch.cuda.synchronize()
    launches = moe_dispatch.batched_ranks.launches
    others = {w.__name__: w.launches for w in others}
    layers = moe_layers(cfg)
    want_launches = layers * gen  # one per MoE layer per step
    log(f"({phase}) {cfg.name} batched_ranks launches on the serving path: "
        f"{launches} (expected {layers} + {layers} x {gen - 1} = "
        f"{want_launches}); other kernels {others}")
    if launches != want_launches or len(calls) != want_launches or any(
            others.values()):
        fail(f"phase {phase}: {cfg.name} {launches} batched_ranks launches, "
             f"{len(calls)} calls, other kernels {others}")
    toks = res.tokens
    if toks.shape != (B, gen) or toks.dtype != torch.int32 or \
            int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"phase {phase}: tokens {toks.dtype} {tuple(toks.shape)} out of range")
    serve_mem = torch.cuda.max_memory_allocated(dev)
    shapes = sorted({tuple(c["flags"].shape) for c in calls})
    log(f"({phase}) {cfg.name} flag shapes [G, N, E]: {shapes}; "
        f"max_memory_allocated {serve_mem / 2**30:.2f} GiB; first request's "
        f"tokens {toks[0, :12].tolist()}")

    # every call against the plain version on the card
    mismatches, max_err = held_ranks(calls)
    log(f"({phase}) {cfg.name}: {len(calls)} batched_ranks calls held against "
        f"the plain version: {mismatches} mismatches, max_abs_err {max_err}")
    if mismatches:
        fail(f"phase {phase}: batched_ranks differs from plain in "
             f"{mismatches} outputs")

    # the plain ranks substituted: tokens and per-call counts identical
    plain_calls: list = []
    with recording_ranks(ops, plain_calls, fn=lambda f: ref.batched_ranks(f)):
        alt = generate(cfg, model, tokens, gen, media)
    if not torch.equal(alt.tokens, toks):
        fail(f"phase {phase}: serving with the plain ranks gives other tokens "
             f"({int((alt.tokens != toks).sum())} differ)")
    if len(plain_calls) != len(calls) or not all(
            torch.equal(a["counts"], b["counts"]) for a, b in zip(plain_calls, calls)):
        fail(f"phase {phase}: per-layer expert counts differ with the plain ranks")
    if cfg.moe:
        mo = cfg.moe
        decode = [c for c in calls if c["flags"].shape[0] == 1]
        C = capacity(mo.capacity_factor, B, mo.top_k, mo.num_experts)
        dropped = sum(int((c["counts"] - C).clamp(min=0).sum()) for c in decode)
        log(f"({phase}) plain-ranks replay: tokens and all {len(calls)} calls' "
            f"counts identical; decode drops {dropped} of "
            f"{B * mo.top_k * len(decode)} token-expert pairs (capacity {C} "
            "per expert per step)")
    else:
        log(f"({phase}) plain-ranks replay: tokens identical (no MoE layer)")
    del alt, plain_calls

    # warm wall times
    runs = [generate(cfg, model, tokens, gen, media) for _ in range(3)]
    for r in runs:
        if not torch.equal(r.tokens, toks):
            fail(f"phase {phase}: a warm run gave other tokens")
    pre = sorted(r.prefill_ms for r in runs)
    dec = sorted(r.decode_ms_per_token for r in runs)
    total = sorted(r.prefill_ms + r.decode_ms for r in runs)
    wall = dict(prefill_ms=pre[1], prefill_range=[pre[0], pre[2]],
                decode_ms_per_token=dec[1], decode_range=[dec[0], dec[2]],
                request_ms=total[1],
                tokens_per_s=B * gen / (total[1] / 1e3),
                decode_tokens_per_s=B / (dec[1] / 1e3),
                max_memory_allocated_gib=serve_mem / 2**30,
                init_s=init_s)
    if cfg.encoder_layers:
        enc = sorted(r.encode_ms for r in runs)
        wall.update(encode_ms=enc[1], encode_range=[enc[0], enc[2]])
    log(f"({phase}) {cfg.name} wall: {json.dumps(wall)}")
    t0 = time.perf_counter()
    prof = serve_profile(phase, cfg, model, tokens, gen, wall, media)
    prof_s = time.perf_counter() - t0

    # the kernel at the main path's shapes, as device time
    per_shape = {}
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  ops_ms=0.0, bytes_ms=0.0)
    for shape in shapes:
        f = next(c["flags"] for c in calls if tuple(c["flags"].shape) == shape)
        n = sum(1 for c in calls if tuple(c["flags"].shape) == shape)
        start = moe_dispatch.batched_ranks.launches
        moe_dispatch.batched_ranks(f)
        row = dict(calls=n,
                   launches_per_call=moe_dispatch.batched_ranks.launches - start,
                   ms=graph_ms(lambda: moe_dispatch.batched_ranks(f)),
                   plain_ms=graph_ms(lambda: ref.batched_ranks(f)),
                   library_ms=graph_ms(
                       lambda: torch.cumsum(f, 1, dtype=torch.int32) - f))
        row["bound_ms"], row["ops_ms"], row["bytes_ms"] = ranks_bound(f)
        per_shape[str(list(shape))] = row
        for k in totals:
            totals[k] += n * row[k]
        log(f"({phase}) batched_ranks at {list(shape)}: per call " + json.dumps(row))
        if row["launches_per_call"] != 1:
            fail(f"phase {phase}: batched_ranks at {list(shape)} made "
                 f"{row['launches_per_call']} launches in one call")
    totals["bound_by"] = ("operations" if totals["ops_ms"] >= totals["bytes_ms"]
                          else "bytes")
    log(f"({phase}) {cfg.name} batched_ranks over one generate: " + json.dumps(totals))
    log(f"({phase}) {cfg.name} served and measured in "
        f"{time.perf_counter() - t_run:.1f} s, of which the traces {prof_s:.1f} s")
    del model, calls, runs, media
    torch.cuda.empty_cache()
    return dict(launches=launches, mismatches=mismatches, max_abs_err=max_err,
                wall=wall, per_shape=per_shape, kernel=totals, profile=prof)


def phase_s(dev) -> dict:
    """MoE serving; see the module docstring, phase (s)."""
    serve_parity(dev, "s", cut_config(SERVE["arch"], num_layers=2), "2 layers")
    return serve_run(dev, "s", cut_config(SERVE["arch"]), "full depth")


def phase_l(dev) -> dict:
    """The other decoder families; see the module docstring, phase (l)."""
    for arch, cuts, kv in FAMILY_PARITY:
        note = ", ".join(f"{k} {v}" for k, v in cuts.items()) or "full depth"
        serve_parity(dev, "l", cut_config(arch, kv_cache_dtype=kv, **cuts), note)
    out = {}
    for arch, layers in FAMILY_SERVE:
        cuts = f"cut to {layers} layers" if layers else "full depth"
        out[arch] = serve_run(dev, "l", cut_config(arch, num_layers=layers), cuts)
    return out


# phase (w): teacher forcing at full width in f32 (arch, cuts, KV cache
# dtype, what the cut keeps), then serving in bf16 (arch, layers: None is
# the full depth, prompt tokens, frames)
CROSS_PARITY = (
    ("whisper-large-v3", {}, "bfloat16", "full depth, 32 + 32 layers"),
    ("llama-3.2-vision-90b", dict(num_layers=5), "bfloat16",
     "one group of 100 layers: 4 self-attention, 1 cross"),
    ("whisper-large-v3", {}, "int8", "full depth, 32 + 32 layers"))
CROSS_SERVE = (("whisper-large-v3", None, 224, 1500),
               ("llama-3.2-vision-90b", 10, 512, None))


def phase_w(dev) -> dict:
    """The encoder-decoder and cross-attention families; see the module
    docstring, phase (w)."""
    for arch, cuts, kv, note in CROSS_PARITY:
        serve_parity(dev, "w", cut_config(arch, kv_cache_dtype=kv, **cuts), note)
    out = {}
    for arch, layers, prompt, frames in CROSS_SERVE:
        cuts = (f"cut to {layers} of 100 layers (175 GB in bf16 whole)"
                if layers else "full depth")
        out[arch] = serve_run(dev, "w", cut_config(arch, num_layers=layers),
                              cuts, prompt=prompt, frames=frames)
    return out


# -- training --------------------------------------------------------------------

# phase (x): moonshot at full width on SyntheticLMData's batches (seed 0),
# 8 sequences of 512 tokens; the gradients in f32 at 2 layers, the steps in
# bf16 at 4 (6 with microbatch=1, then 4 with microbatch=2)
TRAIN = dict(arch="moonshot-v1-16b-a3b", batch=8, seq=512, seed=0,
             grad_layers=2, layers=4, steps=6, micro_steps=4)
GRAD_TOL = 1e-5  # of a gradient leaf's largest |value|: the embedding's
# backward adds atomically, so two runs are not bit for bit


def train_batch(cfg, step: int, dev, case=None) -> dict:
    """Phase (x)'s synthetic batch ``step`` (8 x 512), or ``case``'s size."""
    from repro_torch.configs.shapes import ShapeCase
    from repro_torch.data import SyntheticLMData
    case = case or ShapeCase("x", "train", TRAIN["seq"], TRAIN["batch"])
    data = SyntheticLMData(cfg, case, seed=TRAIN["seed"])
    return {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(step).items()}


def train_grads(dev) -> dict:
    """loss_fn and its gradients in f32 at full width, 2 layers: with the
    kernel (remat on, the config's), with the plain ranks substituted, and
    with the kernel and remat off; every leaf within GRAD_TOL of its
    largest |gradient|, every kernel call 0 mismatches."""
    import dataclasses

    from repro_torch.kernels import moe_dispatch, ops, ref
    from repro_torch.models import transformer as T
    cfg = cut_config(TRAIN["arch"], num_layers=TRAIN["grad_layers"],
                     param_dtype="float32", compute_dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=TRAIN["seed"], device=dev, requires_grad=True)
    batch = train_batch(cfg, 0, dev)
    params = dict(model.named_parameters())

    def loss_grads(cfg, fn=None):
        calls: list = []
        start = moe_dispatch.batched_ranks.launches
        with recording_ranks(ops, calls, fn=fn):
            loss, _ = T.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        return (float(loss.detach()), dict(zip(params, grads)), calls,
                moe_dispatch.batched_ranks.launches - start)

    loss, grads, calls, launches = loss_grads(cfg)
    want = T.moe_forwards(cfg)
    if launches != want or len(calls) != want:
        fail(f"phase x: {launches} batched_ranks launches, {len(calls)} calls in "
             f"one loss and gradient with remat (expected {want})")
    mismatches, max_err = held_ranks(calls)
    out = dict(params=sum(p.numel() for p in params.values()), loss=loss,
               launches=launches, mismatches=mismatches, max_abs_err=max_err)
    if mismatches or not torch.isfinite(torch.tensor(loss)):
        fail(f"phase x: gradients: {mismatches} mismatches, loss {loss}")
    for what, alt_cfg, fn in (
            ("the plain ranks", cfg, lambda f: ref.batched_ranks(f)),
            ("remat off", dataclasses.replace(cfg, remat=False), None)):
        alt_loss, alt, alt_calls, alt_launches = loss_grads(alt_cfg, fn)
        worst = 0.0
        for n, g in grads.items():
            err = float((alt[n] - g).abs().max())
            scale = float(g.abs().max())
            if err > GRAD_TOL * scale:
                fail(f"phase x: {n}'s gradient with {what} differs by {err:.3g} "
                     f"(largest |gradient| {scale:.3g})")
            worst = max(worst, err / scale if scale else 0.0)
        if abs(alt_loss - loss) > GRAD_TOL * abs(loss):
            fail(f"phase x: the loss with {what} is {alt_loss}, not {loss}")
        if fn is None:
            m, e = held_ranks(alt_calls)
            out["mismatches"] += m
            out["max_abs_err"] = max(out["max_abs_err"], e)
            out["launches_remat_off"] = alt_launches
            if m or alt_launches != T.moe_forwards(alt_cfg):
                fail(f"phase x: remat off: {alt_launches} launches, {m} mismatches")
        out[what.replace(" ", "_")] = dict(loss_diff=abs(alt_loss - loss),
                                            worst_leaf_rel=worst)
        del alt
    log(f"(x) gradients: {cfg.name} at full width, {cfg.num_layers} layers, f32, "
        f"{out['params']:,} parameters, batch {TRAIN['batch']} x {TRAIN['seq']}: "
        f"loss {loss:.6f}; {launches} batched_ranks launches with remat "
        f"({out['launches_remat_off']} without), {out['mismatches']} mismatches; "
        f"against the plain ranks: loss diff {out['the_plain_ranks']['loss_diff']:.3g}, "
        f"worst leaf {out['the_plain_ranks']['worst_leaf_rel']:.3g} of its largest "
        f"|gradient|; remat off: {out['remat_off']['loss_diff']:.3g}, "
        f"{out['remat_off']['worst_leaf_rel']:.3g} (tolerance {GRAD_TOL}), in "
        f"{time.perf_counter() - t0:.1f} s")
    del model, params, grads, batch
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def annotated_optimizer():
    """Run the train step's ``adamw_update`` in a profiler range
    ``optimizer``."""
    from torch.profiler import record_function

    from repro_torch.launch import steps
    update = steps.adamw_update

    def adamw_update(*args, **kw):
        with record_function("optimizer"):
            return update(*args, **kw)

    steps.adamw_update = adamw_update
    try:
        yield
    finally:
        steps.adamw_update = update


def train_run(dev) -> dict:
    """``launch.train.build``'s state and steps in bf16 at full width, 4
    layers, the config's remat: 6 steps with microbatch=1 (the last one
    traced) and 4 with microbatch=2 on the same state; every batched-ranks
    call held against the plain version, its launches per step those
    ``transformer.moe_forwards`` implies; losses finite; the parameters
    unchanged by step 0 (its learning rate is 0) and changed by step 1."""
    import statistics

    from repro_torch.kernels import moe_dispatch, ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepOptions
    from repro_torch.models.transformer import moe_forwards
    cfg = cut_config(TRAIN["arch"], num_layers=TRAIN["layers"])
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step1, init_state = train.build(cfg, StepOptions(microbatch=1), device=dev)
    step2, _ = train.build(cfg, StepOptions(microbatch=2), device=dev)
    state = init_state(TRAIN["seed"])
    torch.cuda.synchronize()
    model = state["params"]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"(x) {cfg.name}: {n_params:,} parameters ({cfg.num_layers} of 48 layers, "
        f"bf16, remat {cfg.remat_policy}), AdamW state (f32 master, m, v) made on "
        f"the card in {time.perf_counter() - t0:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if n_params != cfg.param_count():
        fail(f"phase x: {n_params} parameters, config says {cfg.param_count()}")
    before = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    per_step = moe_forwards(cfg)
    rows, calls, traced_step = [], [], TRAIN["steps"] - 1
    total = TRAIN["steps"] + TRAIN["micro_steps"]
    for s in range(total):
        M = 1 if s < TRAIN["steps"] else 2
        fn = step1 if M == 1 else step2
        batch = train_batch(cfg, s, dev)
        torch.cuda.synchronize()
        start, n_calls = moe_dispatch.batched_ranks.launches, len(calls)
        t = time.perf_counter()
        with recording_ranks(ops, calls):
            if s == traced_step:
                with annotated_optimizer():
                    box = {}
                    prof = traced(lambda: box.update(out=fn(state, batch)),
                                  spans=("optimizer",))
                _, metrics = box["out"]
            else:
                _, metrics = fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        ms = (time.perf_counter() - t) * 1e3
        launches = moe_dispatch.batched_ranks.launches - start
        rows.append(dict(step=s, microbatch=M, ms=ms, launches=launches, **metrics))
        log(f"(x) step {s} (microbatch {M}): " + json.dumps(rows[-1]))
        if launches != M * per_step or len(calls) - n_calls != M * per_step:
            fail(f"phase x: step {s}: {launches} batched_ranks launches, expected "
                 f"{M} x {per_step}")
        if not all(map(math.isfinite, metrics.values())):
            fail(f"phase x: step {s}: metrics not finite: {metrics}")
        if s <= 1:
            same = all(torch.equal(p.detach().cpu(), before[n])
                       for n, p in model.named_parameters())
            if same != (s == 0):
                fail(f"phase x: after step {s} the parameters "
                     f"{'are unchanged' if same else 'changed'} "
                     f"(lr {metrics['lr']})")
            if s == 1:
                del before
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    mismatches, max_err = held_ranks(calls)
    if mismatches:
        fail(f"phase x: batched_ranks differs from plain in {mismatches} outputs")
    warm1 = [r["ms"] for r in rows[1:traced_step]]
    warm2 = [r["ms"] for r in rows[TRAIN["steps"] + 1:]]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    step_ms = statistics.median(warm1)
    opt = prof["ranges"]["optimizer"]
    out = dict(params=n_params, step_ms=step_ms, step_range=[min(warm1), max(warm1)],
               tokens_per_s=tokens / (step_ms / 1e3),
               micro2_step_ms=statistics.median(warm2),
               micro2_tokens_per_s=tokens / (statistics.median(warm2) / 1e3),
               peak_gib=peak, traced_device_ms=prof["device_ms"],
               traced_launches=prof["launches"], busy=prof["device_ms"] / step_ms,
               optimizer_device_ms=opt["ms"], optimizer_launches=opt["launches"],
               optimizer_share=opt["ms"] / prof["device_ms"],
               ranks_launches_per_step=per_step, launches=sum(r["launches"] for r in rows),
               calls=len(calls), mismatches=mismatches, max_abs_err=max_err,
               losses=[r["loss"] for r in rows], first_step_ms=rows[0]["ms"])
    log("(x) training: " + json.dumps({k: v for k, v in out.items() if k != "losses"}))
    for kind in ("top_kernels", "top_ops"):
        for r in prof[kind]:
            log(f"(x)   step {kind[4:-1]} {r['ms']:9.3f} ms {r['calls']:7d}x {r['name']}")
    log("(x)   optimizer by operation, ms: " + ", ".join(
        f"{op} {ms:.3f}" for ms, op in opt["ops"]))
    del state, model, calls, step1, step2
    torch.cuda.empty_cache()
    return out


def phase_x(dev) -> dict:
    """Training; see the module docstring, phase (x)."""
    return dict(grads=train_grads(dev), **train_run(dev))


# -- sharding ---------------------------------------------------------------------

# phase (z): the sharded code path on the card, a 1 x 1 mesh on a one-rank
# NCCL group (every collective an identity): moonshot at full width on
# phase (x)'s batches, the train steps at 2 layers, serving at 4, the
# pipeline at 2
SHARD = dict(arch="moonshot-v1-16b-a3b", layers=2, steps=3, serve_layers=4,
             prompt=512, gen=32, seed=0)
SHARD_TOL = dict(metric=1e-5, state=1e-5, atol={"params": 1e-10, "master": 1e-10})
# tests/test_torch_train_step.py's tolerances (METRIC_RTOL, STATE_TOL,
# STATE_ATOL), the fallback where a value is not equal bit for bit


@contextlib.contextmanager
def one_rank_nccl(dev):
    """A one-rank NCCL process group on ``dev`` (an in-process store: no
    port), destroyed on exit."""
    import torch.distributed as dist
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


def shard_steps(dev, cfg, mesh) -> dict:
    """``launch.train.build``'s state (sharded with a ``mesh``) and
    SHARD["steps"] bf16 steps on phase (x)'s batches: each step's metrics,
    wall ms and batched-ranks launches, every ranks call recorded, the
    peak memory; the state stays on the card."""
    from repro_torch.kernels import moe_dispatch, ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepOptions
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    step, init_state = train.build(cfg, StepOptions(), device=dev, mesh=mesh)
    state = init_state(SHARD["seed"])
    rows, calls = [], []
    for s in range(SHARD["steps"]):
        batch = train_batch(cfg, s, dev)
        torch.cuda.synchronize()
        start = moe_dispatch.batched_ranks.launches
        t = time.perf_counter()
        with recording_ranks(ops, calls):
            _, metrics = step(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the step
        rows.append(dict(step=s, ms=(time.perf_counter() - t) * 1e3,
                         launches=moe_dispatch.batched_ranks.launches - start,
                         **metrics))
    return dict(step=step, state=state, rows=rows, calls=calls,
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)


def same_or_close(what: str, got: torch.Tensor, want: torch.Tensor, atol: float):
    """(equal bit for bit, max abs diff); fails unless within SHARD_TOL's
    state tolerance of ``want``'s largest |value|."""
    if torch.equal(got, want):
        return True, 0.0
    err = float((got.float() - want.float()).abs().max())
    lim = SHARD_TOL["state"] * float(want.float().abs().max()) + atol
    if err > lim:
        fail(f"phase z: {what} differs by {err:.3g} from the unsharded step's "
             f"(tolerance {lim:.3g})")
    return False, err


def shard_train(dev, mesh) -> dict:
    """3 steps of ``make_train_step(cfg, opts)`` and 3 of ``make_train_step(
    cfg, opts, mesh=)`` from the same seed (moonshot, 2 layers, bf16,
    remat "full"); the unsharded state's parameters and master weights
    kept on the host while the sharded run has the card. Losses,
    grad_norm and every parameter and master leaf: equal bit for bit, or
    within SHARD_TOL; every batched-ranks call 0 mismatches; the launches
    a step ``transformer.moe_forwards``' for both; then one more sharded
    step traced by torch.profiler (its busy share)."""
    import dataclasses
    import statistics

    from repro_torch.models.transformer import moe_forwards
    cfg = cut_config(SHARD["arch"], num_layers=SHARD["layers"])
    scfg = dataclasses.replace(cfg, act_sharding=("data",), ep_axis="model")
    per_step = moe_forwards(cfg)
    t0 = time.perf_counter()
    plain = shard_steps(dev, cfg, None)
    model = plain["state"]["params"]
    want = {"params": {n: p.detach().cpu() for n, p in model.named_parameters()},
            "master": {n: t.cpu() for n, t in plain["state"]["opt"]["master"].items()}}
    n_params = sum(t.numel() for t in want["params"].values())
    del plain["state"], plain["step"], model
    sharded = shard_steps(dev, scfg, mesh)
    out = dict(params=n_params, launches=0, mismatches=0, max_abs_err=0)
    for name, run in (("unsharded", plain), ("sharded", sharded)):
        m, e = held_ranks(run["calls"])
        out["launches"] += sum(r["launches"] for r in run["rows"])
        out["mismatches"] += m
        out["max_abs_err"] = max(out["max_abs_err"], e)
        bad = [r["launches"] for r in run["rows"] if r["launches"] != per_step]
        if m or bad or len(run["calls"]) != per_step * SHARD["steps"]:
            fail(f"phase z: {name}: {m} batched_ranks mismatches, launches a step "
                 f"{[r['launches'] for r in run['rows']]} (expected {per_step})")
        out[f"{name}_step_ms"] = statistics.median(r["ms"] for r in run["rows"][1:])
        out[f"{name}_peak_gib"] = run["peak_gib"]
        out[f"{name}_losses"] = [r["loss"] for r in run["rows"]]
    metrics_equal = True
    for a, b in zip(plain["rows"], sharded["rows"]):
        for k in ("loss", "grad_norm", "ce", "z_loss", "load_balance", "router_z",
                  "lr"):
            if a[k] != b[k]:
                metrics_equal = False
                if abs(a[k] - b[k]) > SHARD_TOL["metric"] * abs(a[k]):
                    fail(f"phase z: step {a['step']} {k}: sharded {b[k]}, "
                         f"unsharded {a[k]}")
    state = sharded["state"]
    got = {"params": state["params"], "master": state["opt"]["master"]}
    identical, worst = 0, 0.0
    for part, leaves in want.items():
        for n, w in leaves.items():
            same, err = same_or_close(f"{part} {n}", got[part][n].to_local().cpu(),
                                      w, SHARD_TOL["atol"][part])
            identical += same
            worst = max(worst, err)
    out.update(metrics_equal=metrics_equal, leaves=sum(map(len, want.values())),
               leaves_identical=identical, worst_leaf_abs_diff=worst)
    del want
    batch = train_batch(scfg, SHARD["steps"], dev)
    torch.cuda.synchronize()
    box = {}
    t = time.perf_counter()
    prof = traced(lambda: box.update(out=sharded["step"](state, batch)))
    float(box["out"][1]["loss"])
    traced_ms = (time.perf_counter() - t) * 1e3
    out.update(traced_device_ms=prof["device_ms"], traced_launches=prof["launches"],
               busy=prof["device_ms"] / out["sharded_step_ms"],
               traced_wall_ms=traced_ms, seconds=time.perf_counter() - t0)
    log("(z) train: " + json.dumps(out))
    for kind in ("top_kernels", "top_ops"):
        for r in prof[kind]:
            log(f"(z)   sharded step {kind[4:-1]} {r['ms']:9.3f} ms {r['calls']:7d}x "
                f"{r['name']}")
    del sharded, state, got, box
    torch.cuda.empty_cache()
    return out


def shard_serve(dev, mesh) -> dict:
    """``launch.serve.serve`` (the CLI's path) on 8 requests of 512 + 32
    tokens, moonshot at 4 layers in bf16: with the mesh (``ep_axis=
    "model"``) and without; the greedy tokens equal, every batched-ranks
    call 0 mismatches."""
    from repro_torch.kernels import moe_dispatch, ops
    from repro_torch.launch import serve
    cfg = cut_config(SHARD["arch"], num_layers=SHARD["serve_layers"])
    kw = dict(batch=TRAIN["batch"], prompt_len=SHARD["prompt"], gen=SHARD["gen"],
              seed=SHARD["seed"], device=dev)
    out, tokens = dict(launches=0, mismatches=0, max_abs_err=0), {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        calls = []
        start = moe_dispatch.batched_ranks.launches
        with recording_ranks(ops, calls):
            res = serve.serve(cfg, mesh=m, **kw)
        torch.cuda.synchronize()
        launches = moe_dispatch.batched_ranks.launches - start
        mism, err = held_ranks(calls)
        if mism or launches != len(calls) or not launches:
            fail(f"phase z: serve {name}: {launches} launches, {len(calls)} calls, "
                 f"{mism} mismatches")
        out["launches"] += launches
        out["mismatches"] += mism
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out[f"{name}_decode_ms_per_token"] = res.decode_ms_per_token
        out[f"{name}_prefill_ms"] = res.prefill_ms
        tokens[name] = res.tokens.cpu()
        del res, calls
        torch.cuda.empty_cache()
    if not torch.equal(tokens["sharded"], tokens["unsharded"]):
        fail(f"phase z: serve --mesh 1x1 tokens differ in "
             f"{int((tokens['sharded'] != tokens['unsharded']).sum())} of "
             f"{tokens['sharded'].numel()}")
    out["tokens"] = list(tokens["sharded"].shape)
    log("(z) serve: " + json.dumps(out))
    return out


def shard_pipeline(dev) -> dict:
    """``pipeline_forward`` on a one-stage mesh, moonshot at 2 layers in
    bf16, batch 8 x 512: with 1 microbatch it equals the plain stack over
    the batch bit for bit, with 2 the plain stack over each half; no
    transfer on one stage."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import pipeline_forward
    from repro_torch.models import transformer as T
    cfg = cut_config(SHARD["arch"], num_layers=SHARD["layers"])
    stage = make_mesh((1,), ("stage",), device="cuda")
    model = T.init_params(cfg, seed=SHARD["seed"], device=dev)
    g = torch.Generator(device=dev).manual_seed(SHARD["seed"])
    B = TRAIN["batch"]
    tokens = torch.randint(0, cfg.vocab_size, (B, SHARD["prompt"]), generator=g,
                           device=dev)
    sent = pipeline_forward.transfers
    with torch.no_grad():
        h = T._embed(cfg, model, tokens)
        plain = T._run_stack(cfg, model.groups, h, mode="train")[0]
        halves = torch.cat([T._run_stack(cfg, model.groups, x, mode="train")[0]
                            for x in h.split(B // 2)])
        one = pipeline_forward(cfg, model.groups, h, stage, microbatches=1)
        two = pipeline_forward(cfg, model.groups, h, stage, microbatches=2)
    torch.cuda.synchronize()
    if not (torch.equal(one, plain) and torch.equal(two, halves)):
        fail("phase z: the one-stage pipeline differs from the plain stack")
    if pipeline_forward.transfers != sent:
        fail("phase z: a one-stage pipeline sent something")
    out = dict(shape=list(one.shape), finite=bool(torch.isfinite(one).all()),
               two_microbatches_vs_whole_batch=float((two.float() - plain.float())
                                                     .abs().max()))
    if not out["finite"]:
        fail("phase z: the pipeline's output is not finite")
    log("(z) pipeline: " + json.dumps(out))
    del model, h, plain, halves, one, two
    torch.cuda.empty_cache()
    return out


def phase_z(dev) -> dict:
    """Sharding; see the module docstring, phase (z)."""
    from repro_torch.launch.mesh import make_mesh
    with one_rank_nccl(dev):
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        log(f"(z) NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, one rank, "
            f"mesh {tuple(mesh.mesh.shape)} {tuple(mesh.mesh_dim_names)}")
        train_out = shard_train(dev, mesh)
        serve_out = shard_serve(dev, mesh)
        pipe_out = shard_pipeline(dev)
    runs = (train_out, serve_out)
    return dict(train=train_out, serve=serve_out, pipeline=pipe_out,
                launches=sum(r["launches"] for r in runs),
                mismatches=sum(r["mismatches"] for r in runs),
                max_abs_err=max(r["max_abs_err"] for r in runs))


# phase (d): the dry-run of three cells on a fake group of one rank, then the
# same three steps for real on a one-rank NCCL group
DRY = dict(arch="moonshot-v1-16b-a3b", train_layers=2, serve_layers=4, batch=8,
           prompt=512, gen=32, seed=0)
PEAK_RATIO = (0.85, 1.15)  # the dry-run's peak over the measured one, a cell


def dry_cells() -> dict:
    """kind -> (config, ShapeCase) of phase (d)'s cells: phase (z)'s train
    cell (2 layers, 8 x 512), a prefill (8 x 512) and a decode cell (8
    rows, cache 512 + 32) at 4 layers."""
    from repro_torch.configs.shapes import ShapeCase
    B, S, G = DRY["batch"], DRY["prompt"], DRY["gen"]
    train = cut_config(DRY["arch"], num_layers=DRY["train_layers"])
    serve = cut_config(DRY["arch"], num_layers=DRY["serve_layers"])
    return {"train": (train, ShapeCase(f"train_{B}x{S}", "train", S, B)),
            "prefill": (serve, ShapeCase(f"prefill_{B}x{S}", "prefill", S, B)),
            "decode": (serve, ShapeCase(f"decode_{B}x{S + G}", "decode", S + G, B))}


def traced_cells(cells: dict, mesh, tag: str = "", fsdp=None) -> dict:
    """``run_cell`` of each cell on ``mesh`` (a CPU mesh of the fake group
    that is up: nothing allocated); ``fsdp`` as ``run_cell``'s."""
    from repro_torch.launch.dryrun import run_cell
    recs = {}
    for kind, (cfg, case) in cells.items():
        recs[kind] = rec = run_cell(cfg, case, mesh, fsdp=fsdp)
        if rec["status"] != "ok":
            fail(f"phase d{tag}: the dry-run's {kind} cell {rec['status']}: "
                 f"{rec.get('error')}\n{rec.get('traceback')}")
        log(f"(d){tag} dry-run {kind}: trace {rec['trace_s']} s, "
            + json.dumps(dict(memory=rec["memory"], cost=rec["cost"],
                              comm_ops=rec["comm_ops"],
                              auto_overrides=rec["auto_overrides"])))
    return recs


def dry_run(cells: dict) -> dict:
    """``run_cell`` of each cell on the fake process group of one rank and
    its (1, 1) mesh (nothing allocated); the group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_mesh
    init_fake_group(1)
    try:
        return traced_cells(cells, make_mesh((1, 1), ("data", "model"), device="cpu"))
    finally:
        dist.destroy_process_group()


def counted(fn, args: tuple, reads_pos: bool = False, arg_bytes=None):
    """``fn(*args)`` once under the dry-run's counters (step_analysis'
    collectives, the flop counter) with the card's peak reset just before:
    (its result, what the dry-run records of it). The measured peak is the
    arguments' bytes (``arg_bytes`` when given, else the arguments' local
    tensors') plus the most allocated above what was allocated before the
    step; the aliased bytes are the arguments' storages that the result
    holds (updated in place)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import alias_bytes
    from repro_torch.launch.step_analysis import StepTrace, tensor_bytes
    if arg_bytes is None:
        arg_bytes = tensor_bytes(args)
    arg_bytes += 4 if reads_pos else 0  # pos: int32
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fc = FlopCounterMode(display=False)
    t = time.perf_counter()
    with fc, StepTrace() as trace:
        out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return out, dict(argument_bytes=arg_bytes, alias_bytes=alias_bytes(args, out),
                     comm_ops=trace.comm_ops, flops=float(fc.get_total_flops()),
                     op_count=trace.report.op_count,
                     peak_bytes=arg_bytes + torch.cuda.max_memory_allocated() - before,
                     counted_ms=ms)


def held_cell(kind: str, rec: dict, real: dict, tag: str = "") -> dict:
    """Phase (d)'s checks of one cell: the dry-run's argument and aliased
    bytes, collectives and flops equal the real step's; its peak within
    PEAK_RATIO of the measured one. ``tag`` names the run in the log."""
    mem = rec["memory"]
    want = dict(argument_bytes=mem["argument_bytes"], alias_bytes=mem["alias_bytes"],
                comm_ops=rec["comm_ops"], flops=rec["cost"]["flops"],
                op_count=rec["collectives"]["op_count"])
    for k, v in want.items():
        if real[k] != v:
            fail(f"phase d{tag}: {kind}: the dry-run's {k} is {v}, the real step's "
                 f"{real[k]}: the fake trace took another path")
    ratio = mem["peak_per_device_bytes"] / real["peak_bytes"]
    out = dict(kind=kind, **want, predicted_peak_gib=mem["peak_per_device_bytes"] / 2**30,
               measured_peak_gib=real["peak_bytes"] / 2**30, peak_ratio=ratio,
               trace_s=rec["trace_s"], counted_ms=real["counted_ms"])
    log(f"(d){tag} {kind}: " + json.dumps(out))
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        fail(f"phase d{tag}: {kind}: predicted peak / measured = {ratio:.4f}, "
             f"outside {PEAK_RATIO}")
    return out


def with_overrides(cfg, rec):
    """``cfg`` with the dry-run's ``auto_overrides`` of its cell."""
    import dataclasses
    return dataclasses.replace(cfg, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in rec.get("auto_overrides", {}).items()})


def dry_train(dev, mesh, cfg, rec, tag: str = "", case=None, fsdp=None) -> dict:
    """The train cell for real: ``train.build``'s sharded state (``fsdp``
    as ``build``'s) and one step of phase (x)'s first batch (``case``'s
    size when given), counted, every batched-ranks call recorded (to the
    host) and held against the plain version (a config with no MoE makes
    none)."""
    from repro_torch.kernels import moe_dispatch, ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import train
    from repro_torch.launch.step_analysis import tensor_bytes
    from repro_torch.launch.steps import StepOptions
    cfg = with_overrides(cfg, rec)
    torch.cuda.empty_cache()
    step, init_state = train.build(cfg, StepOptions(), device=dev, mesh=mesh,
                                   fsdp=fsdp)
    state = init_state(DRY["seed"])
    batch = train_batch(cfg, 0, dev, case)
    # the arguments as the dry-run counts them: the state's blocks and the
    # rank's rows of the batch (every rank is passed the global batch)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh, fsdp)
    bsh = sh.batch_shardings(cfg, mesh, pol, batch)
    rows = sum(math.prod(sh.shard_shape(mesh, bsh[k].spec, v.shape)) * v.element_size()
               for k, v in batch.items())
    start = moe_dispatch.batched_ranks.launches
    calls = []
    with recording_ranks(ops, calls, to_host=True):
        (state, metrics), real = counted(step, (state, batch),
                                         arg_bytes=tensor_bytes(state) + rows)
    loss = float(metrics["loss"])
    if not tag and not math.isfinite(loss):  # the fake group sums nothing
        fail(f"phase d: the train step's loss is {loss}")
    out = held_cell("train", rec, real, tag)
    out["launches"] = moe_dispatch.batched_ranks.launches - start
    out["mismatches"], out["max_abs_err"] = held_ranks(calls)
    if out["mismatches"] or out["launches"] != len(calls) or \
            bool(calls) != bool(cfg.moe):
        fail(f"phase d{tag}: train: {out['launches']} batched_ranks launches, "
             f"{len(calls)} calls, {out['mismatches']} mismatches")
    batch = train_batch(cfg, 1, dev, case)  # one more step, warm, nothing counted
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, metrics = step(state, batch)
    float(metrics["loss"])
    out["step_ms"] = (time.perf_counter() - t) * 1e3
    out["launches"] = moe_dispatch.batched_ranks.launches - start
    del state, batch, metrics, step, init_state, calls
    torch.cuda.empty_cache()
    return out


def generate_steps(cfg, prefill, serve, params, batch, gen: int, calls=None):
    """Prefill then ``gen`` serve steps: (prefill logits, tokens [B, gen],
    ms of the prefill, ms a decoded token), a DTensor's rows as this
    rank's, the first decode step at the prompt's length; ``calls``
    records every batched-ranks call to the host."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import greedy
    recording = contextlib.nullcontext() if calls is None else \
        recording_ranks(ops, calls, to_host=True)
    with recording:
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = prefill(params, batch)
        local = logits.to_local() if isinstance(logits, DTensor) else logits
        tok = greedy(cfg, local)
        if isinstance(logits, DTensor):
            tok = DTensor.from_local(tok, logits.device_mesh, logits.placements,
                                     shape=(logits.shape[0], 1), stride=(1, 1))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        out = []
        t = time.perf_counter()
        prompt = batch["tokens"].shape[1]
        for i in range(gen):
            tok, cache = serve(params, cache, {"tokens": tok, "pos": prompt + i})
            out.append(tok.to_local() if isinstance(tok, DTensor) else tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / gen
    return local, torch.cat(out, dim=1), prefill_ms, decode_ms


def counted_first(fn, key: str, box: dict, reads_pos: bool = False):
    """``fn``, its first call ``counted`` into ``box[key]``."""
    def wrapped(*args):
        if key in box:
            return fn(*args)
        res, box[key] = counted(fn, args, reads_pos)
        return res
    return wrapped


def dry_serve(dev, mesh, cfg, recs) -> dict:
    """The prefill and decode cells for real: the unsharded steps
    (``make_prefill_step`` / ``make_serve_step``, no mesh) and the sharded
    ones on the same weights, prefill then DRY["gen"] decode steps, every
    batched-ranks call recorded; the sharded prefill and its first decode
    step counted against the dry-run's cells; logits and tokens equal bit
    for bit; every call 0 mismatches, as many launches sharded as
    unsharded; then one more pass of each, nothing recorded, timed."""
    import dataclasses

    from repro_torch.kernels import moe_dispatch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (init_sharded_params, make_prefill_step,
                                          make_serve_step,
                                          make_sharded_prefill_step,
                                          make_sharded_serve_step)
    from repro_torch.models.transformer import init_params, reads_pos
    scfg = dataclasses.replace(cfg, **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in recs["decode"]["auto_overrides"].items()})
    B, P, G = DRY["batch"], DRY["prompt"], DRY["gen"]
    model = init_params(cfg, seed=DRY["seed"], device=dev)
    g = torch.Generator(device=dev).manual_seed(DRY["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev,
                           dtype=torch.int32)  # the dry-run's batch spec
    pol = sh.ShardingPolicy.for_arch(scfg, mesh)
    psh = sh.params_shardings(scfg, mesh, pol, model)
    params = init_sharded_params(scfg, psh, DRY["seed"], dev)  # per shard
    bsh = sh.batch_shardings(scfg, mesh, pol, {"tokens": tokens})
    sbatch = {"tokens": sh.distribute(tokens, bsh["tokens"])}

    def steps(name: str, box=None) -> tuple:
        """(config, prefill, serve, params, batch) of a run."""
        if name == "unsharded":
            return (cfg, make_prefill_step(cfg, cache_len=P + G), make_serve_step(cfg),
                    model, {"tokens": tokens})
        prefill = make_sharded_prefill_step(scfg, mesh, cache_len=P + G)
        serve = make_sharded_serve_step(scfg, mesh)
        if box is not None:
            prefill = counted_first(prefill, "prefill", box)
            serve = counted_first(serve, "decode", box, reads_pos(scfg))
        return scfg, prefill, serve, params, sbatch

    runs, out, box = {}, {"max_abs_err": 0}, {}
    for name in ("unsharded", "sharded"):
        calls = []
        start = moe_dispatch.batched_ranks.launches
        runs[name] = generate_steps(*steps(name, box), G, calls)
        torch.cuda.synchronize()
        launches = moe_dispatch.batched_ranks.launches - start
        mism, err = held_ranks(calls)
        if mism or launches != len(calls) or not launches:
            fail(f"phase d: {name}: {launches} batched_ranks launches, "
                 f"{len(calls)} calls, {mism} mismatches")
        out[f"{name}_launches"], out[f"{name}_mismatches"] = launches, mism
        out["max_abs_err"] = max(out["max_abs_err"], err)
    if out["sharded_launches"] != out["unsharded_launches"]:
        fail(f"phase d: {out['sharded_launches']} batched_ranks launches sharded, "
             f"{out['unsharded_launches']} unsharded")
    (lu, tu, *_), (ls, ts, *_) = runs["unsharded"], runs["sharded"]
    if not (torch.equal(ls, lu) and torch.equal(ts, tu)):
        fail(f"phase d: the sharded steps differ from the unsharded ones: logits "
             f"by {float((ls.float() - lu.float()).abs().max())}, tokens in "
             f"{int((ts != tu).sum())} of {tu.numel()}")
    cells = [held_cell("prefill", recs["prefill"], box["prefill"]),
             held_cell("decode", recs["decode"], box["decode"])]
    for name in ("unsharded", "sharded"):  # timed, nothing recorded
        _, _, pm, dm = generate_steps(*steps(name), G)
        out[f"{name}_prefill_ms"], out[f"{name}_decode_ms_per_token"] = pm, dm
    out.update(tokens=list(tu.shape), logits_equal=True, tokens_equal=True,
               launches=out["unsharded_launches"] + out["sharded_launches"],
               mismatches=out["unsharded_mismatches"] + out["sharded_mismatches"])
    log("(d) serve: " + json.dumps(out))
    del model, params, runs
    torch.cuda.empty_cache()
    return dict(out, cells=cells)


TP_RANKS = 4  # phase (d)'s tensor-parallel section: a (1, 4) mesh
TP_TAG = " tp"


def tp_serve(dev, mesh, cfg, recs, size=DRY, tag: str = TP_TAG, fsdp=None) -> dict:
    """The prefill and decode cells for real on the tensor-parallel mesh
    (rank 0 of the fake group): the sharded prefill and ``size["gen"]``
    decode steps on ``size``'s weights (made per shard, ``fsdp`` as
    ``ShardingPolicy.for_arch``'s) and prompts (``dry_serve``'s by
    default), the prefill and the first decode step counted, every
    batched-ranks call held (a config with no MoE makes none); then one
    more pass, nothing recorded, timed."""
    from repro_torch.kernels import moe_dispatch
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (init_sharded_params,
                                          make_sharded_prefill_step,
                                          make_sharded_serve_step)
    from repro_torch.models.transformer import init_params, reads_pos
    scfg = with_overrides(cfg, recs["decode"])
    B, P, G = size["batch"], size["prompt"], size["gen"]
    g = torch.Generator(device=dev).manual_seed(DRY["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=dev,
                           dtype=torch.int32)
    pol = sh.ShardingPolicy.for_arch(scfg, mesh, fsdp)
    psh = sh.params_shardings(scfg, mesh, pol, init_params(cfg, device="meta"))
    params = init_sharded_params(scfg, psh, DRY["seed"], dev)
    bsh = sh.batch_shardings(scfg, mesh, pol, {"tokens": tokens})
    batch = {"tokens": sh.distribute(tokens, bsh["tokens"])}
    box, calls = {}, []
    start = moe_dispatch.batched_ranks.launches
    generate_steps(scfg,
                   counted_first(make_sharded_prefill_step(scfg, mesh, cache_len=P + G),
                                 "prefill", box),
                   counted_first(make_sharded_serve_step(scfg, mesh), "decode", box,
                                 reads_pos(scfg)),
                   params, batch, G, calls)
    torch.cuda.synchronize()
    launches = moe_dispatch.batched_ranks.launches - start
    mism, err = held_ranks(calls)
    if mism or launches != len(calls) or bool(launches) != bool(cfg.moe):
        fail(f"phase d{tag}: serve: {launches} batched_ranks launches, "
             f"{len(calls)} calls, {mism} mismatches")
    cells = [held_cell(k, recs[k], box[k], tag) for k in ("prefill", "decode")]
    _, _, pm, dm = generate_steps(scfg, make_sharded_prefill_step(scfg, mesh,
                                                                  cache_len=P + G),
                                  make_sharded_serve_step(scfg, mesh), params, batch, G)
    del params, calls
    torch.cuda.empty_cache()
    return dict(cells=cells, launches=launches, mismatches=mism, max_abs_err=err,
                prefill_ms=pm, decode_ms_per_token=dm)


# phase (d)'s tensor-parallel cells beside moonshot's: xlstm-350m at full
# width and depth (mLSTM and sLSTM split; a prompt of 64 keeps the sLSTM
# loop's trace short) and chatglm3-6b at full width, 4 of 28 layers (2 KV
# heads: its cache split on the sequence, split-KV decode)
TP_MORE = {"xlstm": dict(arch="xlstm-350m", layers=None, batch=8, prompt=64,
                         gen=8, train=True),
           "chatglm3": dict(arch="chatglm3-6b", layers=4, batch=8, prompt=512,
                            gen=32, train=False)}


def tp_more_cells(name: str) -> dict:
    """kind -> (config, ShapeCase) of a TP_MORE entry's cells: train (B x
    prompt), prefill (B x prompt), decode (B rows, cache prompt + gen)."""
    from repro_torch.configs.shapes import ShapeCase
    size = TP_MORE[name]
    cfg = cut_config(size["arch"], num_layers=size["layers"])
    B, P, G = size["batch"], size["prompt"], size["gen"]
    out = {"prefill": (cfg, ShapeCase(f"prefill_{B}x{P}", "prefill", P, B)),
           "decode": (cfg, ShapeCase(f"decode_{B}x{P + G}", "decode", P + G, B))}
    if size["train"]:
        out["train"] = (cfg, ShapeCase(f"train_{B}x{P}", "train", P, B))
    return out


def phase_d_tp(dev, cells: dict) -> dict:
    """Phase (d)'s tensor-parallel section (see the module docstring): the
    fake group of TP_RANKS ranks, its (1, TP_RANKS) mesh on the CPU for
    the dry-run and on the card for rank 0's real steps; moonshot's cells,
    then TP_MORE's."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_mesh
    shape, axes = (1, TP_RANKS), ("data", "model")
    more = {name: tp_more_cells(name) for name in TP_MORE}
    init_fake_group(TP_RANKS)
    try:
        t0 = time.perf_counter()
        cpu = make_mesh(shape, axes, device="cpu")
        recs = traced_cells(cells, cpu, TP_TAG)
        more_recs = {name: traced_cells(c, cpu, f"{TP_TAG} {name}")
                     for name, c in more.items()}
        dry_s = time.perf_counter() - t0
        torch.cuda.set_device(dev)
        mesh = make_mesh(shape, axes, device="cuda")
        train_out = dry_train(dev, mesh, cells["train"][0], recs["train"], TP_TAG)
        serve_out = tp_serve(dev, mesh, cells["prefill"][0], recs)
        runs = [train_out, serve_out]
        extra = {}
        for name, c in more.items():
            tag, r = f"{TP_TAG} {name}", more_recs[name]
            out = tp_serve(dev, mesh, c["prefill"][0], r, TP_MORE[name], tag)
            if "train" in c:
                t = dry_train(dev, mesh, c["train"][0], r["train"], tag,
                              case=c["train"][1])
                out["cells"].insert(0, t)
                out["train_step_ms"] = t["step_ms"]
                runs.append(t)
            runs.append(out)
            extra[name] = out
    finally:
        dist.destroy_process_group()
    return dict(dry_run_s=dry_s, cells=[train_out, *serve_out.pop("cells")],
                serve=serve_out, train_step_ms=train_out["step_ms"], more=extra,
                launches=sum(r["launches"] for r in runs),
                mismatches=sum(r["mismatches"] for r in runs),
                max_abs_err=max(r["max_abs_err"] for r in runs))


FSDP_RANKS, FSDP_MESH = 16, (4, 4)  # phase (d)'s FSDP section
FSDP_TAG = " fsdp"
FSDP = dict(arch="moonshot-v1-16b-a3b", layers=4, batch=8, prompt=512, gen=32)


def fsdp_cells() -> dict:
    """kind -> (config, ShapeCase) of the FSDP section's cells: moonshot at
    4 layers, train and prefill 8 x 512, decode with a cache of 544."""
    from repro_torch.configs.shapes import ShapeCase
    B, S, G = FSDP["batch"], FSDP["prompt"], FSDP["gen"]
    cfg = cut_config(FSDP["arch"], num_layers=FSDP["layers"])
    return {"train": (cfg, ShapeCase(f"train_{B}x{S}", "train", S, B)),
            "prefill": (cfg, ShapeCase(f"prefill_{B}x{S}", "prefill", S, B)),
            "decode": (cfg, ShapeCase(f"decode_{B}x{S + G}", "decode", S + G, B))}


def fsdp_full_state(dev, mesh) -> dict:
    """Moonshot's whole train state at all 48 layers made per shard on
    rank 0 of the FSDP mesh, its ``max_memory_allocated`` held within the
    rank's blocks plus ``steps.init_bound_bytes``; then one train step of
    phase (x)'s first batch on it (the config as the dry-run sets it on
    this mesh: the rows on the data axis, the experts on the model axis),
    every batched-ranks call held, its peak and ms."""
    import dataclasses

    from repro_torch.kernels import moe_dispatch, ops
    from repro_torch.launch import train
    from repro_torch.launch.step_analysis import tensor_bytes
    from repro_torch.launch.steps import StepOptions, init_bound_bytes
    from repro_torch.models.transformer import leaves
    cfg = dataclasses.replace(cut_config(FSDP["arch"]), act_sharding=("data",),
                              ep_axis="model")
    gib = 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step, init_state = train.build(cfg, StepOptions(), device=dev, mesh=mesh, fsdp=True)
    t = time.perf_counter()
    state = init_state(DRY["seed"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated(dev) - before
    blocks = tensor_bytes(state)
    bound = blocks + init_bound_bytes(cfg)
    whole = sum(leaf.numel for leaf in leaves(cfg).values())
    out = dict(layers=cfg.num_layers, params=whole, whole_state_gb=whole * 14 / 1e9,
               blocks_gib=blocks / gib, init_peak_gib=init_peak / gib,
               init_bound_gib=bound / gib, init_s=init_s)
    if init_peak > bound:
        fail(f"phase d{FSDP_TAG}: per-shard init peaked at {init_peak / gib:.3f} "
             f"GiB, over its bound {bound / gib:.3f} GiB")
    batch = train_batch(cfg, 0, dev)
    calls = []
    start = moe_dispatch.batched_ranks.launches
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with recording_ranks(ops, calls, to_host=True):
        state, metrics = step(state, batch)
        float(metrics["loss"])
    out["step_ms"] = (time.perf_counter() - t) * 1e3
    out["step_peak_gib"] = (blocks + torch.cuda.max_memory_allocated(dev) - before) / gib
    out["launches"] = moe_dispatch.batched_ranks.launches - start
    out["mismatches"], out["max_abs_err"] = held_ranks(calls)
    if out["mismatches"] or out["launches"] != len(calls) or not calls:
        fail(f"phase d{FSDP_TAG}: 48 layers: {out['launches']} batched_ranks "
             f"launches, {len(calls)} calls, {out['mismatches']} mismatches")
    log(f"(d){FSDP_TAG} moonshot 48 layers, rank 0 of {FSDP_RANKS}, collectives "
        "no-ops: " + json.dumps(out))
    del state, batch, metrics, step, init_state, calls
    torch.cuda.empty_cache()
    return out


def phase_d_fsdp(dev) -> dict:
    """Phase (d)'s FSDP section (see the module docstring): the fake group
    of FSDP_RANKS ranks and its FSDP_MESH (data, model) mesh, on the CPU
    for the dry-run and on the card for rank 0's real steps, FSDP on."""
    import torch.distributed as dist

    from repro_torch.launch.dryrun import init_fake_group
    from repro_torch.launch.mesh import make_mesh
    axes = ("data", "model")
    cells = fsdp_cells()
    init_fake_group(FSDP_RANKS)
    try:
        t0 = time.perf_counter()
        recs = traced_cells(cells, make_mesh(FSDP_MESH, axes, device="cpu"),
                            FSDP_TAG, fsdp=True)
        dry_s = time.perf_counter() - t0
        torch.cuda.set_device(dev)
        mesh = make_mesh(FSDP_MESH, axes, device="cuda")
        train_out = dry_train(dev, mesh, cells["train"][0], recs["train"], FSDP_TAG,
                              fsdp=True)
        serve_out = tp_serve(dev, mesh, cells["prefill"][0], recs, FSDP, FSDP_TAG,
                             fsdp=True)
        full = fsdp_full_state(dev, mesh)
    finally:
        dist.destroy_process_group()
    runs = [train_out, serve_out, full]
    return dict(dry_run_s=dry_s, cells=[train_out, *serve_out.pop("cells")],
                serve=serve_out, full=full, train_step_ms=train_out["step_ms"],
                gathered_gib={k: r["collectives"]["gathered_weights_peak_bytes"]
                              / 2 ** 30 for k, r in recs.items()},
                launches=sum(r["launches"] for r in runs),
                mismatches=sum(r["mismatches"] for r in runs),
                max_abs_err=max(r["max_abs_err"] for r in runs))


def phase_d(dev) -> dict:
    """The dry-run and the sharded serving steps, on one rank, then
    tensor-parallel over 4, then FSDP on (4, 4); see the module docstring,
    phase (d)."""
    from repro_torch.launch.mesh import make_mesh
    cells = dry_cells()
    t0 = time.perf_counter()
    recs = dry_run(cells)
    dry_s = time.perf_counter() - t0
    with one_rank_nccl(dev):
        mesh = make_mesh((1, 1), ("data", "model"), device="cuda")
        train_out = dry_train(dev, mesh, cells["train"][0], recs["train"])
        serve_out = dry_serve(dev, mesh, cells["prefill"][0], recs)
    torch.cuda.empty_cache()
    tp = phase_d_tp(dev, cells)
    torch.cuda.empty_cache()
    fsdp = phase_d_fsdp(dev)
    one = {c["kind"]: c for c in (train_out, *serve_out["cells"])}
    many = {c["kind"]: c for c in tp["cells"]}
    log(f"(d) rank 0 of {TP_RANKS}, collectives no-ops (not a tensor-parallel "
        "throughput), beside one rank: " + json.dumps(dict(
            train_step_ms=[tp["train_step_ms"], train_out["step_ms"]],
            train_peak_gib=[many["train"]["measured_peak_gib"],
                            one["train"]["measured_peak_gib"]],
            prefill_peak_gib=[many["prefill"]["measured_peak_gib"],
                              one["prefill"]["measured_peak_gib"]],
            decode_peak_gib=[many["decode"]["measured_peak_gib"],
                             one["decode"]["measured_peak_gib"]],
            prefill_ms=[tp["serve"]["prefill_ms"], serve_out["sharded_prefill_ms"]],
            decode_ms_per_token=[tp["serve"]["decode_ms_per_token"],
                                 serve_out["sharded_decode_ms_per_token"]])))
    for name, out in tp["more"].items():
        log(f"(d) rank 0 of {TP_RANKS}, {TP_MORE[name]['arch']}, collectives "
            "no-ops: " + json.dumps({
                **{f"{c['kind']}_peak_gib": [c["predicted_peak_gib"],
                                             c["measured_peak_gib"]]
                   for c in out["cells"]},
                **{k: out[k] for k in ("train_step_ms", "prefill_ms",
                                       "decode_ms_per_token") if k in out}}))
    log(f"(d){FSDP_TAG} rank 0 of {FSDP_RANKS}, {FSDP_MESH}, collectives no-ops: "
        + json.dumps(dict(
            peak_gib={c["kind"]: [c["predicted_peak_gib"], c["measured_peak_gib"]]
                      for c in fsdp["cells"]},
            gathered_weights_alive_gib=fsdp["gathered_gib"],
            train_step_ms=fsdp["train_step_ms"],
            prefill_ms=fsdp["serve"]["prefill_ms"],
            decode_ms_per_token=fsdp["serve"]["decode_ms_per_token"],
            launches=fsdp["launches"], dry_run_s=fsdp["dry_run_s"])))
    parts = (train_out, serve_out, tp, fsdp)
    return dict(dry_run_s=dry_s, cells=[train_out, *serve_out.pop("cells")],
                serve=serve_out, tp=tp, fsdp=fsdp,
                launches=sum(r["launches"] for r in parts),
                mismatches=sum(r["mismatches"] for r in parts),
                max_abs_err=max(r["max_abs_err"] for r in parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass-baseline", type=Path, default=None,
                        help="compare the escape kernels' default instances "
                             "with this checkout's, and run nothing else")
    args = parser.parse_args()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0])
    log(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"capability {torch.cuda.get_device_capability(0)}; "
        f"count {torch.cuda.device_count()}")

    if args.sass_baseline is not None:
        return sass_baseline(args.sass_baseline.resolve())
    t0 = time.perf_counter()
    empty, empty_lib = empty_node_build(_build.nvcc_command)
    built = _build.build()
    empty_log, _ = empty.communicate()
    if empty.returncode != 0:
        fail(f"nvcc failed for the empty kernel:\n{empty_log}")
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} libraries "
        "and the empty kernel (nvcc in parallel)")
    for name, b in built.items():  # one line per library: ptxas -v summary
        regs = re.findall(r"Used (\d+) registers", b["log"])
        insts = [instance(x) for x in
                 re.findall(r"Compiling entry function '(\w+)'", b["log"])]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", b["log"]))
        log(f"  {name}: registers "
            f"{' '.join(f'{i}:{r}' for i, r in zip(insts, regs)) or regs}, "
            f"spill bytes {spills}, built in {b['seconds']:.1f} s")
    sass = {}
    for name in sorted({lib for lib, _ in ESCAPE_KERNELS.values()}):
        sass[name] = sass_loops(built[name]["path"])
        log(f"  SASS step loop of {name} (cuobjdump -sass; innermost loop "
            "with an FMUL and an FSETP, instructions all/f32/other): " +
            " ".join(f"{i}:{c['instr']}/{c['fp']}/{c['other']}"
                     for i, c in sorted(sass[name].items())))
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    CARD["slots_per_s"] = sms * LANES_PER_SM * float(clock) * 1e6
    log(f"clocks.max.sm {clock} MHz: {sms} SMs x {LANES_PER_SM} lanes x "
        f"{clock} MHz = {CARD['slots_per_s']:.4g} issue slots/s (contract bound)")
    CARD["node_floor_ms"] = node_floor_ms(empty_lib)
    log(f"an empty kernel node in a replayed CUDA graph: "
        f"{CARD['node_floor_ms'] * 1e3:.3f} us (the floor of a graph node)")

    t0 = time.perf_counter()
    small = phase_a(dev)
    log(f"(a) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path = phase_b(dev)
    log(f"(b) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timing = {wl: phase_t(dev, wl) for wl in WORKLOADS}
    log(f"(t) done in {time.perf_counter() - t0:.1f} s")
    phase_c(dev)
    phase_g(dev)
    t0 = time.perf_counter()
    phase_e(dev)
    log(f"(e) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pooled = phase_p(dev)
    log(f"(p) done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()  # phase (p)'s 8 GiB canvases, graphs and ring
    t0 = time.perf_counter()
    batched = phase_f(dev)
    log(f"(f) done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()  # phase (f)'s canvases
    t0 = time.perf_counter()
    sharded = phase_m(dev)
    log(f"(m) done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()  # phase (m)'s canvases
    t0 = time.perf_counter()
    rendering = phase_r(dev)
    log(f"(r) done in {time.perf_counter() - t0:.1f} s")
    from repro_torch.core import graphs
    graphs.release()  # phase (m)'s split graphs and canvases, before (u)
    t0 = time.perf_counter()
    tuned = phase_u(dev)
    log(f"(u) done in {time.perf_counter() - t0:.1f} s")
    graphs.release()
    torch.cuda.empty_cache()  # phase (u)'s canvases, before (s)
    t0 = time.perf_counter()
    serving = phase_s(dev)
    log(f"(s) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families = phase_l(dev)
    log(f"(l) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_w(dev)
    log(f"(w) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    training = phase_x(dev)
    log(f"(x) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sharding = phase_z(dev)
    log(f"(z) done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = phase_d(dev)
    log(f"(d) done in {time.perf_counter() - t0:.1f} s")

    def escape_keys(name: str, t: dict) -> dict:
        """The escape kernels' extra keys: the contract bound and the SASS
        step loop's instructions of the mandelbrot instance; for the border
        queries also the exact-work bound and ``event_ms``, the CUDA events
        around eager calls (``ms`` is their device time)."""
        if name not in ESCAPE_KERNELS:
            return dict(contract_bound_ms=None)
        library, fn = ESCAPE_KERNELS[name]
        query = {k: t[k] for k in ("exact_bound_ms", "event_ms") if k in t}
        return dict(contract_bound_ms=t["contract_bound_ms"], **query,
                    sass_step_loop=sass[library].get(
                        default_instance(fn), {}).get("instr"))

    def tuned_keys(name: str, held: list) -> dict:
        """Phase (u)'s keys of a kernel: its launches there and, over the
        signatures the sweep tuned, how many winners are not the default
        and the winners' and the defaults' summed us (each signature's
        line is in the log); its calls held against the plain version join
        ``held``."""
        if name in tuned["tally"]:
            held.append(tuned["tally"][name])
        out = dict(tuned_launches=tuned["launches"].get(name))
        rows = tuned["winners"].get(name)
        if rows:
            out["tuned"] = dict(
                signatures=len(rows),
                winners_not_default=sum(r["differs"] for r in rows),
                winner_us=sum(r["us"] for r in rows),
                default_us=sum(r["default_us"] for r in rows))
        return out

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timing["mandelbrot"][name]
        held = [small[name]] + [timing[wl][name] for wl in WORKLOADS]
        if name in sharded["tally"]:  # the split scan's previews (phase m)
            held.append(sharded["tally"][name])
        extra = tuned_keys(name, held)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path["launches"][name],
            max_abs_err=max(h["max_abs_err"] for h in held),
            mismatches=sum(h["mismatches"] for h in held),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            split_launches=sharded["split_launches"].get(name),
            **extra, **escape_keys(name, t)))
    for name, (source, replaces) in POOLED_KERNELS.items():
        t = pooled["kernels"][name]
        floor = ({"node_floor_ms": t["node_floor_ms"]}
                 if "node_floor_ms" in t else {})
        # the scan: also every call of phase (t), the single-frame paths'
        held = [t] + [timing[wl][name] for wl in WORKLOADS
                      if name in timing[wl]]
        if len(held) > 1:
            floor["single_frame_calls"] = sum(h["calls"] for h in held[1:])
        # the batched scan's path (phase f) and the sharded one (phase m):
        # their launches and their calls
        f = batched["kernels"][name]
        floor["batched_scan_launches"] = f["launches"]
        held.append(f)
        m = sharded["kernels"][name]
        floor["sharded_launches"] = m["launches"]
        held.append(m)
        if name in sharded["split_launches"]:
            floor["split_launches"] = sharded["split_launches"][name]
        # serving (phase r): the pipelined zoom stream's launches; the
        # calls of its feedback renders and progressive tiles
        floor["serving_launches"] = rendering["launches"][name]
        held.append(rendering["kernels"][name])
        floor.update(tuned_keys(name, held))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=t["launches"],
            max_abs_err=max(h["max_abs_err"] for h in held),
            mismatches=sum(h["mismatches"] for h in held), ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], **floor, **escape_keys(name, t)))
    for name, (source, replaces) in SERVE_KERNEL.items():
        # the times: phase (s)'s generate; the launches and the calls held:
        # phase (s)'s, each family's of phase (l), training's (x), the
        # sharded path's (z) and the sharded serving steps' (d)
        t = serving["kernel"]
        runs = [serving, *families.values(), training, training["grads"], sharding,
                dry]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r["launches"] for r in runs),
            max_abs_err=max(r["max_abs_err"] for r in runs),
            mismatches=sum(r["mismatches"] for r in runs), ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            contract_bound_ms=None, serving_launches=serving["launches"],
            family_launches={a: r["launches"] for a, r in families.items()},
            family_ms={a: r["kernel"]["ms"] for a, r in families.items()},
            train_launches=training["launches"],
            train_grad_launches=training["grads"]["launches"]
            + training["grads"]["launches_remat_off"],
            shard_launches=sharding["launches"], dryrun_phase_launches=dry["launches"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
