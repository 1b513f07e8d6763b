#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvo_slam_tpu_torch``) on one card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.
Every solve runs the IRLS loop in chunks of K steps (``dense_tracker
.CHUNK_STEPS``).  A tracker level is one launch of a CUDA graph that holds
the whole ``while ~done`` loop (``csrc/while_graph.cu``: the head chunk,
then a WHILE node around the tail chunk, its condition set on the card by
``set_while``), with no host read; so are the pixel-sharded level
(``sharded_alignment.CHUNK_STEPS``, its NCCL all-reduces in the WHILE
body) and block-CG (``while active``), where the NCCL group's probe
admitted that form (else they replay one graph per chunk and read the
host after each).  A step
past a level's ``done`` is inert but still launches, so wherever a phase
below holds a kernel's launches (or the modular evaluations) to solver
iterations, it holds them to the executed steps: per level K *
ceil(iterations / K), the slowest stream's iterations in lockstep; the
iterations themselves are printed beside them.  The while graphs count
their chunks on the card (``set_while``), and the counts are folded into
the launch counters when a phase reads them.

1. Device: a CUDA card is required (there is no CPU fallback).  Prints
   its name and ``nvidia-smi``'s name and power limit.
2. Build: ``nvcc`` builds ``dvo_slam_tpu_torch/csrc/fused_stats.cu`` (the
   folded, sampled-input, batched and partials entry points, the step
   kernels and the glue kernels),
   ``csrc/table_copy.cu``, ``csrc/while_graph.cu`` and ``csrc/ingest.cu``
   from the checkout, the four at once, and ``g++`` the
   native ingest (``native/ingest.cpp``, no libpng) beside them, so that no
   timed phase pays a build; prints the build seconds and the compiler's
   report.
3. Kernels vs plain versions on the card, on a rendered 640x480 sequence
   at levels 3, 2 and 1.  The folded kernel (``dvo_warp_fused_stats``, the
   tracker's evaluation) against ``warp_fused_stats_plain`` on the first
   pair warped by a small twist, with ``first`` 0/1 and depth-buffered
   sampling on/off: the stash (r_I, r_Z, mask) bit-equal to the plain
   version's (the count of differing entries printed, held to the mask
   equal and atol 1e-6); the Gram element-wise within rtol 1e-6 of the
   float64 Gram of the plain float32 rows; n equal, the precision, ll, A
   and b as ``fused_check.compare_warp_fused_stats`` holds them (rtol 1e-5
   of each quantity's rounding scale, A's entries within 1e-4 of
   sqrt(A_aa A_bb)); two runs bit-identical.  Then B = 8 pairs in one call,
   depth-buffered sampling on and off, bit-equal per stream to one-stream
   calls and held to the plain version the same way.  Times (CUDA events, median of 30 after 5 warm-ups, in
   turns with the plain version) and device times (the same events with
   the card spinning first, so they bracket the kernels and not the
   host's enqueue) at first = 0, depth-buffered (the batched call also
   without depth buffering), beside the unfolded pair
   ``warp_and_sample_cm`` + ``fused_stats_cuda``.  The sampled-input
   kernels on the same pair's sampled packs: ``num_valid`` equal; the Gram
   blocks within rtol 1e-6 of the float64 Gram and within 1e-4 of
   sqrt(G_aa G_bb) of the float32 twin's; two runs bit-identical.
   ``fused_stats``: ``log_sum`` within rtol 1e-5.  ``fused_partials``: the
   mask row equal, r_I and r_Z within atol 1e-6, w within rtol 1e-5 of the
   twin's rows, and the count of rw entries that are not bit-equal.
   The pixel-sharded evaluation's three launches
   (``dvo_warp_fused_partials``, ``dvo_sharded_loglik``,
   ``dvo_sharded_tail``) against their plain versions, on the whole frame
   and on every rank's block of 4 and of 7 ranks (7 pads the last block),
   with the blocks' sums added on the card in rank order where the ranks
   all-reduce, ``first`` 0/1:
   each block's stash (r_I, r_Z, gate) against the plain version's (the
   gate equal, atol 1e-6, the count of entries that differ printed), its
   136 sums within rtol 1e-6 of the float64 Gram, the tail as
   ``compare_warp_fused_stats`` holds it, every rank's result the same
   bits, two runs bit-identical.  At L1 for N, N/2 and N/4 pixels: wrapper
   ms and device ms of the three launches beside the plain version and the
   unfolded trio (``warp_and_sample_cm`` + ``dvo_fused_partials`` + the
   PyTorch tail), each launch's device ms alone, and the bound.
   Ingest's two kernels (``csrc/ingest.cu``: kernel A the pyramid, kernel
   B sel, refpack and quad) on phase 4's first frames at 640x480, 4
   levels, solve range 3..1: ``ingest_cuda`` on the raw frame on the card
   with u16 and with int32 depth, and ``Frame.from_raw`` from the host
   arrays, every one of the 41 tensors of a frame bit-equal to the plain
   chain's (``convert_raw_depth`` -> ``build_pyramid`` ->
   ``prepare_frame``) on the card.  Times of both kernels and of the plain
   chain from the raw frame on the card (``ms``, ``plain_ms``; device
   times with the card spinning first), kernel A's alone, the bound from
   the bytes the two kernels must move, and the host's time of one
   ``Frame.from_raw`` from host arrays against the plain chain's issue
   from the same arrays (median of 100).  Then the rig's form: phase 4's
   first 8 frames as one rig frame of 8 streams (``frames.ingest_raw``
   from the host arrays, levels below the solve range not stored, as
   ``LockstepTracker`` ingests), one launch of each kernel on a grid over
   the streams, every [8, ...] tensor bit-equal to the plain chain over
   the stacked frames (the streams that differ named); the device times of
   both kernels and of the plain chain at B = 8 and their bound.
4. Odometry: 100 frames at 640x480 (``TUM_FR1``), frame to frame with a
   constant-velocity warm start at ``benchmark_config().tracker``, from
   u8/u16 frames through ``convert_raw_depth`` -> ``build_pyramid`` ->
   ``match_pyramids``.  The folded kernel's launch count must equal the
   number of solver iterations; the sampled-input kernels and
   ``warp_and_sample_cm`` run 0 times; every level one while-graph launch,
   ``set_while`` once per executed chunk and no host read of ``done``
   (``irls_reads_per_frame`` 0).  Prints ATE-RMSE and tracked frames/s.
5. Hard scene: the occluded scene under a 30 cm loop; ATE-RMSE < 10 mm;
   the same counts as phase 4.
6. Sharded paths: a one-rank NCCL process group (``file://`` rendezvous
   in a temporary directory) and its mesh.  The form ``initialize``'s
   probe chose for the group (``irls_graph.group_forms``: a while graph
   whose body holds the group's all-reduces and kernel 2's clustered
   launch) is printed with the probe's node census; it must be the while
   form unless the probe's refusal was recorded (then the loops stay
   host-polled and the refusal is printed).  The pixel-sharded matcher on
   the first 20 easy pairs from the identity in that form, each level one
   while-graph launch with the two all-reduces in its WHILE body: each
   pair within 5e-3 of the ground truth (max |log(T_gt^-1 T)|), each of
   the sharded evaluation's three kernels and the two step kernels
   launched once per executed step (folded in from the card), one launch per level, ``set_while`` once
   per executed chunk and no read of ``done``, and ``dvo_fused_partials``,
   the statistics kernels and ``warp_and_sample_cm`` not at all; the
   group's graph keys built.  The same pairs as host-polled graph replays
   and with ``irls_graph.CUDA_GRAPHS`` off: every level's carry and
   iterations and every result bit-equal; each form and
   ``match_pyramids`` timed twice, in turns; ``done`` reads per pair of
   each form; the node census of the L1 sharded level's and the
   distributed CG's captures.  ``distributed_gauss_newton_cg`` on the
   one-rank mesh (513 vertices of ``tools/cg_iteration_stats``, 2 GN
   steps) in the three forms: poses, chi2 and every solve's k bit-equal,
   in the while form one launch per solve and ``set_while`` once per
   chunk; ms per CG iteration of each.  After the checks below,
   ``shutdown()`` drops the group's keys and no other, and a new group
   (``initialize()``, a new key generation) solves the first pair to the
   same bits.  With
   mu = 0, where the sharded and single paths coincide, one pair against
   ``match_pyramids``: per-level iterations and terminations equal,
   estimate within 1e-4, information within rtol 2e-3 / atol 1e-3.  The
   pair-parallel matcher on 8 pairs (each rank's pairs in one lockstep
   call) against ``match_pyramids`` pair by pair: level statistics equal,
   estimates within 1e-5 and information within 1e-5 of its largest entry
   (the batched 6x6 solve's tolerance); the pairs that are not bit-equal
   are counted.  Prints ms per iteration and pairs/s of the sharded path
   under graphs and eagerly and of ``match_pyramids`` on the same 20
   pairs; after phase 10 (so that no
   profiler is attached to the timed phases) the device kernels per
   iteration of both under ``torch.profiler``
   (``tools/sharded_bench.kernels_per_iteration``).
7. Lockstep multi-stream odometry: 8 streams x 30 frames at 640x480
   (the reference's 50 cut to 30 to pay for phase 14)
   (``tools/multistream_bench.render_streams``) through
   ``make_multistream_tracker``.  The batched sampled-input kernel
   (``dvo_fused_stats_batched``) first, against the single-stream one on
   each stream's packs at levels 3, 2, 1 with ``first_iter`` 0, 1 and
   per-stream flags: every output bit-equal per stream; against the plain
   twin per stream as phase 3 holds it; times of kernel and twin at L1.
   Then the run: batched folded launches equal to the lockstep loop
   iterations, no one-stream or sampled-input launch and no
   ``warp_and_sample_cm`` call, one launch of each ingest kernel a rig
   frame (``LockstepTracker``), the levels as while graphs with no read of
   ``done`` (as phase 4), every stream's ATE-RMSE < 10 mm.  Prints
   aggregate frames/s, ms per lockstep iteration, the max-over-streams
   iterations per level and the device's busy share (``torch.profiler``
   over 6 frames; null where the profiler records no device event).
8. Schedules: streams 0 and 1, 20 frames, lockstep against sequential:
   per stream, frame and level the iterations and terminations equal (a
   difference is counted as a near-tie flip; more than 5 % fail), every
   pose within 1e-3 (max |log(T_a^-1 T_b)|, tests/test_parallel.py).  On
   a one-rank NCCL mesh the tracker's result bit-equal to the local run.
9. Temporal: the 100-frame sequence of phase 4 in 8 chunks
   (``make_temporal_tracker``): every pose within 1e-3 of phase 4's.
   Prints the ATE-RMSE.
10. Copy kernel and gather probe: ``dvo_table_copy`` bit-equal to
   ``clone()`` on [32, 76800], on ragged shapes (one straddles the bulk
   copy's 8 KB chunks), on a table of more than the 50 MB L2 cache and on
   a table that is not 16-byte aligned; kernel and ``clone()`` times on
   [32, 76800], in turns: on the device cold (a 256 MB buffer written
   before each call) and warm (the table in L2 from the call before), at
   the wrapper, and under ``torch.profiler`` (null where the profiler
   records no device event), beside the HBM bound.  Then the gather probe
   (``tools/gather_probe.py``) at L1, B = 8: every variant bit-equal to
   ``batched``, ms and device ms per iteration each; its ``pcopy`` tables
   are the copy kernel's main path.

Phases 11-15 and 18-19 run after phase 5, before any profiler session, so
that their frames/s compare with phase 4's:

11. ``CameraTracker``: phase 4's 100 frames as u8/u16 through
   ``Frame.from_raw(prepare_for=(cfg, K))`` and ``CameraTracker.update``:
   per frame the relative transform within 1e-6 of phase 4's (the frames
   that are not bit-equal counted) and the per-level iterations equal; the
   folded kernel's launches equal the solver iterations, no other kernel;
   ingest's two kernels run once each per frame and ``prepare_frame``
   never (phase 4's inline path runs it twice per pair).  Prints the ATE-RMSE and tracked frames/s beside phase 4's.
12. ``LocalTracker`` with ``LocalMap``: the same frames through
   ``init_new_local_map`` and ``update``, the map completed every 10 frames
   (``force_complete_current_local_map``), a map-complete callback running
   ``local_map.optimize(50)`` as ``KeyframeGraph.add`` does.  The batched
   folded kernel's launches equal the dual match's lockstep iterations, the
   one-stream kernel's those of the initial match; 9 maps complete, each
   optimize returns a finite, non-increasing chi2 history; on 5 frames the
   dual match's stream 1 (last frame -> frame) against a one-stream
   ``match_pyramids`` of the pair: per-level iterations and terminations
   equal (flips counted), transformation within 1e-4; ATE-RMSE < 10 mm.
   Prints tracked frames/s and the split per frame: ingest
   (``Frame.from_raw``), dual match, host decision, LM solve.  Then the
   batched folded kernel at the dual match's shape (B = 2, two refpacks
   against one frame's stacked table) at L1: wrapper, device and plain
   times and the bound.
13. ``KeyframeTracker`` (``benchmark_config()``, the graph's worker thread
   on) on phase 5's 100 hard-scene frames, u8/u16 through
   ``make_frame_raw``, then ``finish()`` and ``trajectory()``: 100 poses,
   the optimized trajectory's ATE-RMSE < 5 mm and the online poses' < 10 mm
   (``bench.py:44-45``), every graph solve's chi2 history finite, no solve
   falling back; kernel 1's launches equal the initial match's iterations,
   kernel 1b's the dual matches' plus the validation waves' lockstep
   iterations, no other kernel and no ``warp_and_sample_cm``.  The final
   pass's starting graph solved again by the dense, sparse, Schur and CG
   routes: each within ``ROUTE_GATES`` of dense.  Prints keyframes, loop
   edges, the waves' sizes, per-frame latency (``bench.py:379-386``'s
   keys, all frames and split by keyframe events), the back end's phase
   ms per frame (``bench.py:323-333``), frames/s and the routes; then kernel
   1b at the largest wave's shape, coarse (level 3) and fine (L1), against
   its plain version, as phase 12 holds B = 2.

14. ``StreamingSLAM(TUM_FR1, benchmark_config())`` (run right after phase
   13) on phase 5's 100 hard-scene frames as u8/u16, host-reduced to the
   ingest level (the native C++ reduction where it built, else NumPy; the
   path and the reason printed): ``track_sequence(..., pipeline_chunk=50)``
   (``bench.py:304``) with the graph's worker thread, then
   ``track_frontend`` of the same frames.  The two forms' records and
   poses bit-equal; the online poses within 2e-3 of phase 13's and the
   keyframes as many as phase 13's (phase 13 forces the last keyframe as
   ``force_last`` does) and as the switches + 1; graph ATE < 5 mm, online
   ATE < 10 mm, every graph solve's chi2 finite; in each run kernel 1's
   launches equal the bootstrap match's iterations and kernel 1b's the dual
   matches' plus the validation waves' lockstep iterations, no other
   kernel; every level of every run (the worker's waves too) a while graph
   with no read of ``done``, so the record copy per chunk is the front
   end's only read.  Prints keyframes, loop edges, e2e frames/s
   (``slam_e2e_fps``'s definition, ``bench.py:313-331``) and the front
   end's frames/s, the back end's phase ms per frame, the pipelined run's
   split (front-end runs, record feed, final pass) and the host read-backs
   per frame.  Then
   the slice's main path, ``cli.benchmark.main(["--synthetic", "20",
   "--engine", "streaming", "--timing", "--interactive-html", "graph.html",
   ...])`` at 480x640 on the card: exit 0, the report's ATE and RPE keys
   finite, kernel 1's launches equal its bootstrap's iterations and kernel
   1b's its dual matches' and waves' lockstep iterations, as for the runs
   above; the viewer written atomically (no temporary file left), its
   embedded payload parsing, one keyframe entry per keyframe of the graph
   it exported and an error grid for each of the worst 5 ranked loop edges
   whose keyframes hold pyramid levels (the count printed, with the
   export's seconds).  Prints the records' sha256 (to compare trees).
15. ``DataParallelSLAM(TUM_FR1, benchmark_config())`` (run right after
   phase 14) on a one-rank NCCL process group: 2 hard-scene streams of 40
   frames rendered as ``bench.py:228-239`` renders them (seeds 3000 +
   97 b), the two in lockstep through the streaming front end (one dual
   match at B = 4 per frame), then each stream's back end and final pass.
   Each stream's online poses bit-equal to its one-stream
   ``StreamingSLAM.track_frontend`` (run after the counted window), graph
   ATE < 5 mm, online ATE < 10 mm; kernel 1's launches equal the
   stream-by-stream bootstraps' iterations and kernel 1b's the dual
   matches' plus the validation waves' lockstep iterations, no other
   kernel.  Prints the aggregate e2e frames/s.  Then every section of
   the port's driver (``dvo_slam_tpu_torch/bench.py``) once at a cut size
   (phase 4's first 12 frames, e2e on 12 hard-scene frames in chunks of
   6 and one timed run, 8 streams x 3 frames, a bsweep of 16 x 2): no
   section fails, the record's keys are ``bench.py``'s; in each section
   kernel 1's launches equal its one-stream solves' iterations and kernel
   1b's its lockstep solves' (``tools/driver_launches.py``), no other
   kernel runs, and the lockstep_nobuf runs launch kernel 1b's
   non-depth-buffered template as often as their loop iterations; prints
   the record and the counts per section (its accuracy gates are not held
   at this cut: the loops are 12 frames long).
16. The modular tracker backend and the warps (run after phases 8-9,
   since it reads phase 7's streams, and before phase 10's profiler
   sessions).  (a) Kernel 1's folded call against the modular evaluation
   (``tools/fused_check.compare_modular_to_kernel``) on phase 3's pair at
   levels 3, 2, 1, ``first`` 0 and 1, depth-buffered: n and the mask
   equal, the stashed residuals within atol 2e-5 of the modular ones, A
   and b within rtol 2e-3 (b also atol 1e-2), the scale numerator within
   rtol 2e-3 (the reference's tolerances, ``tests/test_pallas.py``).
   (b) ``odometry.track_sequence`` on phase 4's first 20 frames: kernel 1
   (``benchmark_config().tracker``) for the timing, then
   ``kernel_backend="xla"`` with the t-distribution, (Huber, normal),
   (Tukey, MAD), (Huber, MAD), (unit, unit) and ``use_weighting=False``:
   no evaluation kernel launch and no ``warp_and_sample_cm`` call, one
   modular evaluation and one pass of the step kernels per solver
   iteration, every tensor it reads on the card,
   finite poses; the t-distribution's ATE within 1 mm of phase 4's on the
   same frames.  Prints ATE, tracked frames/s and ms per iteration of each
   beside kernel 1's.  Then 4 streams of phase 7 (10 frames) in lockstep
   under (Huber, MAD) against the sequential schedule (no evaluation
   kernel, one launch of each ingest kernel a rig frame): iterations and
   terminations per stream, frame and level (flips counted; more than 5 %
   fail); the same run again on the eager loop with each batched
   evaluation repeated stream by stream (``fused_check.solo_evaluations``):
   the counts equal the graph run's, and per flip b's largest difference
   at that level solve is printed (ROADMAP C (g)).  (c) ``intensity_error_image`` on phase 4's first pair at L1 on
   the card: mean error at the true transform below the identity's; against
   the same call on CPU copies, at most 0.1 % of the valid pixels differ
   and the values agree within 1e-4 where both are valid;
   ``warp_depth_forward_advanced`` and ``compute_normals`` once each, finite
   where valid.  Prints the phase's seconds.
17. The IRLS loop's forms on the card (``models/irls_graph``; run after
   phase 16), on phase 4's first 20 frames and 4 of phase 7's streams x 10
   frames in lockstep: (a) the modular path (t-distribution and (Huber,
   MAD)) as while graphs and as host-polled graphs at the card's K against
   the eager loop at K = 1, (b) kernels 1 and 1b (``tools/chunk_sweep
   .sweep``): the eager loop, the host-polled graphs at K = 1, 2, 3 and 4
   and the while graph, each twice, in turns; every level's carry, level
   statistics and counts bit-equal to the eager loop's, and the while
   graph reading nothing.  Prints each mode's frames/s, ms per iteration,
   executed steps and host reads per frame, the node types of the head and
   tail chunks (the while body's child graph), the graph cache (keys,
   graphs, while graphs, capture ms, the captures' pool bytes, the static
   buffers' bytes); then (c) ``set_while`` against its plain loop
   (``tools/graph_check.set_while_check``: a loop of known length at 1, 2,
   8 and 136 streams, the even streams done at the head, at both senses
   of the condition (while a ``done`` flag is false, as the IRLS levels
   loop; while an ``active`` flag is true, as CG does); the tail chunks
   counted and the final state equal; ms per step of a 1,000-step while
   graph against the plain loop's host-read steps) and the phase's
   seconds.
18. A recorded sequence (run right after phase 14): phase 5's 100
   hard-scene frames written as a TUM RGB-D directory by the port's PNG
   writer (``tools/recorded_sequence.py``: R = G = B, 16-bit depth, every
   row cycling the five scanline filters, assoc.txt, groundtruth.txt, FR1
   intrinsics), after printing whether cv2 imports, zlib's version,
   ``native.build_error()`` (must be None) and ``native.library_path()``.
   Every frame decoded bit-equal to what was written, serially and through
   ``RgbdFramePrefetcher`` (ms per frame of each); the native reduction
   bit-equal to ``reduce_ingest_numpy`` (ms per frame of each, the native
   path taken).  Then ``cli.benchmark.main(["--dataset", DIR, ...])`` in
   the three engines (``--mode odometry``, ``--mode slam --engine loop``,
   ``--engine streaming``): exit 0, every frame decoded natively (no cv2),
   odometry ATE < 10 mm, the SLAM engines' graph ATE < 5 mm and online ATE
   < 10 mm, kernels 1 and 1b launched as often as the solves' executed
   steps and no other kernel, no graph solve falling back, the streaming
   engine's ingest reduced natively; the streaming engine's online poses and
   optimized trajectory bit-equal to ``StreamingSLAM.track_sequence`` run
   here on the same u8 frames and the CLI's u16 round trip of the loader's
   float depth (the reference's truncation, ``cli/benchmark.py:137``, on
   purpose).  Prints the phase's seconds.
19. The back end at scale (run after phase 18): ``tools/backend_scale_probe``
   at 40 keyframes x 7 frames (60x80) on the card: 241 vertices (past the
   auto policy's 128) and 481 edges, as the reference's probe gives at this
   cut, the ATE within 1 mm of its 49.06 mm, the routes of the feed's and
   the final pass's solves printed, none falling back, kernel 1b launched
   as often as the validation waves' executed steps and no other kernel;
   then ``tools/final_pass_profile`` and ``tools/cg_iteration_stats
   --sizes 512 --gn-steps 4`` (CG on the card): finite rounds and chi2;
   the CG loop in chunks of ``pose_graph.CG_CHUNK_STEPS`` steps as one
   while-graph launch per solve (``while active``), as host-polled graph
   replays and eagerly: equal iterations and x bit-equal at every GN step
   in the three forms, the while form's host reads per GN step the live
   edges' one, one launch per solve and ``set_while`` once per chunk; ms
   per CG iteration and host reads per GN step of each printed.  Prints
   the phase's seconds.
20. The IRLS step kernels (``ops/irls_step``: ``csrc/fused_stats.cu``'s
   step head and tail, which run every tracker step on the card around
   kernel 1's evaluation; run after phase 17, before phase 10's profiler
   sessions) at B = 1 and B = 8 on phase 3's pairs at L1: four steps
   from the level's start, each from the plain step's carry and trace
   through the kernels (the first also from the level's start values)
   and through the plain ``_step`` on the card, the integers and flags
   equal and every float field and trace row within 32 ulps of its scale
   (each one's largest gap printed); device times (CUDA events behind a
   spinning stream) of the head and tail on a fixed evaluation, of each
   alone, and of the plain step's ops around the same evaluation, beside
   the bound; their launches in every phase whose launches are held to
   its steps (every tracker step on the card takes them, the modular
   path's too), and phase 14's records sha256.
21. The glue kernels (``ops/match_glue``: ``csrc/fused_stats.cu``'s match
   setup, link and result, which run a match's glue on the card; run
   after phase 20) at B = 1 and B = 8 on phase 3's pairs, warm-started:
   each against the plain glue on one match's real carries, level by
   level, the counts equal and every float field within 32 ulps of its
   scale (each one's largest gap printed); device times of each kernel
   alone, of a match's glue behind a spinning stream and with the host's
   enqueueing, beside the plain glue's and the bound; the match graph's
   nodes outside its levels' loops and its heads' copies (at most 8 nodes
   and no copy), beside the nodes of the same plain glue captured alone;
   and their launches in every phase whose step launches are held (each of
   the card's matches one setup and one result, and a link between each
   two of its levels).

The last three lines of standard output are one JSON object describing
the kernels (per kernel: launches on its main path, errors against the
plain version, kernel and plain ms at L1, the bound from this run's
tensor sizes at the card's 3.35 TB/s and 67 TFLOP/s, and the one PyTorch
call that computes the same function where there is one; ``set_while``
with its runs in phases 4, 6, 7, 14 and 19 and its ms per loop step at
both senses of its condition; ``ingest`` with its launches in phases 11-14
and 18, its bits against the plain chain, its times and the plain chain's
device kernels under ``torch.profiler`` after phase 10; ``irls_step``
with its launches by phase, its gap to the plain step and its times;
``match_glue`` the same for the glue kernels),
``nvidia-smi``'s name and power limit, then ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SHAPE = (480, 640)
NUM_FRAMES = 100
HARD_ATE_GATE_M = 0.01  # the reference's hard-scene gate (bench.py)
RENDER_WORKERS = min(8, os.cpu_count() or 1)  # host threads rendering the sequences' frames
TIMING_REPS = 30
TIMING_WARMUP = 5
KERNEL_SOURCE = "dvo_slam_tpu_torch/csrc/fused_stats.cu"
STATS_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:413"
PARTIALS_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:252"
SHARDED_PAIRS = 20
# phase 6: the forms of the multi-rank loops (graph_check.loop_mode arguments)
SHARDED_FORMS = {"while": dict(graphs=True, polled=False), "polled": dict(graphs=True, polled=True),
                 "eager": dict(graphs=False)}
SHARDED_CG_VERTICES = 512  # phase 6: the distributed CG on tools/cg_iteration_stats' 513 vertices
SHARDED_CG_GN_STEPS = 2
SHARD_WORLDS = (1, 4, 7)  # phase 3: the whole frame, and every block of 4 and of 7 ranks
SHARD_TIMED = (1, 2, 4)  # phase 3: N, N/2 and N/4 pixels of L1, block 0 of as many ranks
PROFILED_PAIRS = 3
WAVE_PAIRS = 8
WAVE_ATOL = 1e-5  # the batched 6x6 solve's tolerance against the one-system solve
POSE_GATE = 5e-3  # tests/test_parallel.py: max |log(T_gt^-1 T)| against the ground truth
MU0_POSE_GATE = 1e-4  # tests/test_parallel.py: sharded vs single at mu = 0
CAMERA_TRACKER_ATOL = 1e-6  # phase 11 against phase 4, per transform entry
LOCAL_MAP_FRAMES = 10  # phase 12 completes the local map every 10 frames
LOCAL_MAP_ITERATIONS = 50  # KeyframeGraph.add's local_map.optimize(50)
STREAM_CHECK_FRAMES = 5  # phase 12: frames whose stream 1 is held to a one-stream match
STREAM_ATOL = 1e-4
E2E_ATE_GATE_M = 0.005  # bench.py:45, the optimized SLAM trajectory
ONLINE_ATE_GATE_M = 0.01  # bench.py:44, the online poses
# phase 13's host cross-check: each route's poses against the dense route's
# from the same state (tests/test_pose_graph.py: Schur within 1e-4, CG and
# sparse within 1e-3 of dense, max |log(T_a^-1 T_b)|)
ROUTE_GATES = {"sparse": 1e-3, "schur": 1e-4, "cg": 1e-3}
STREAM_PIPELINE_CHUNK = 50  # bench.py:304's pipeline_chunk
STREAMING_VS_TRACKER_ATOL = 2e-3  # tests/test_streaming.py: streaming against the per-frame loop
CLI_FRAMES = 20  # phase 14's run of the benchmark CLI
VIEWER_FILE = "graph.html"  # phase 14: the CLI's --interactive-html
DP_STREAMS = 2  # phase 15: DataParallelSLAM on bench.py's --mesh streams (B = 2)
DP_FRAMES = 40  # bench.py:226
DRIVER_FRAMES = 12  # phase 15: the driver's sections on phase 4's first 12 frames
DRIVER_STREAM_FRAMES = 3  # phase 15: multistream's 8 streams x 3 frames
DRIVER_SWEEP = ((16, 2),)  # phase 15: bsweep cut to one (B, T)
MODULAR_FRAMES = 20  # phase 16(b): phase 4's first 20 frames
MODULAR_ATE_GAP_M = 1e-3  # phase 16(b): the xla route's ATE against phase 4's on them
MODULAR_STREAMS = 4  # phase 16(b): streams of phase 7 in lockstep under (Huber, MAD)
MODULAR_STREAM_FRAMES = 10
GRAPH_FRAMES = 20  # phase 17: phase 4's first 20 frames
GRAPH_STREAMS = 4  # phase 17: 4 of phase 7's streams x 10 frames in lockstep
GRAPH_STREAM_FRAMES = 10
CHUNK_SWEEP = (1, 2, 3, 4)  # phase 17: the chunk sizes K measured
WARP_MASK_SHARE = 1e-3  # phase 16(c): valid pixels that may differ from the CPU's
WARP_VALUE_ATOL = 1e-4
PROBE_KEYFRAMES = 40  # phase 19: backend_scale_probe cut from 300, past 128 vertices
PROBE_FRAMES_PER_MAP = 7
# the reference's tools/backend_scale_probe.py at 40 x 7 on the CPU: 241
# vertices, 481 edges after the final pass, ATE 0.04906 m (one loop edge is
# accepted at this cut, keyframes 5.5 cm apart; the port's CPU run gives
# 0.049060 m)
PROBE_GRAPH = (241, 481)
PROBE_ATE_M = 0.04906
PROBE_ATE_ATOL_M = 1e-3
PROBE_GN_STEPS = 4  # phase 19: cg_iteration_stats at its smallest size (512), 4 of its 8 GN steps
STREAMS = 8  # the reference's stream count (tests/test_parallel.py, tools/gather_probe.py)
STREAM_FRAMES = 30  # the reference benchmark's 50, cut to pay for phase 14
STREAM_ATE_GATE_M = 0.01
SCHEDULE_STREAMS = 2
SCHEDULE_FRAMES = 20
SCHEDULE_POSE_GATE = 1e-3  # tests/test_parallel.py: lockstep vs sequential
SCHEDULE_FLIP_SHARE = 0.05  # near-tie flips tolerated, as a share of stream-frame-levels
TEMPORAL_CHUNKS = 8
TEMPORAL_POSE_GATE = 1e-3  # tests/test_parallel.py: chunked vs sequential
BUSY_FRAMES = 6
BATCHED_REPLACES = "dvo_slam_tpu/ops/pallas_kernels.py:413"  # vmapped (multistream.py:217-227)
COPY_SOURCE = "dvo_slam_tpu_torch/csrc/table_copy.cu"
INGEST_SOURCE = "dvo_slam_tpu_torch/csrc/ingest.cu"
# no Pallas kernel: the reference's ingest is XLA's ops (upload, pyramid, prepare)
INGEST_REPLACES = "dvo_slam_tpu/models/frames.py:103"
INGEST_FRAMES = 4  # phase 3: phase 4's first frames through the three routes
INGEST_HOST_REPS = 100  # phase 3: host time of one ingest, median of as many
INGEST_RIG_STREAMS = 8  # phase 3: the rig's form, phase 4's first frames as its streams
INGEST_COUNTS = ("ingest_pyramid", "ingest_pack")  # kernel A's and kernel B's launches
STEP_COUNTS = ("step_head", "step_tail")  # the step kernels' launches
GLUE_COUNTS = ("glue_setup", "glue_link", "glue_result")  # the glue kernels' launches
# the card's matches and their level solves (``irls_graph.match_counts``)
MATCH_COUNTS = ("matches", "match_levels")
# no Pallas kernel: the loop body's glue around the evaluation is XLA's ops
STEP_REPLACES = "dvo_slam_tpu/models/dense_tracker.py:343"
GLUE_REPLACES = "dvo_slam_tpu/models/dense_tracker.py:546"  # match_prepared's glue, XLA's
WHILE_SOURCE = "dvo_slam_tpu_torch/csrc/while_graph.cu"
WHILE_REPLACES = "dvo_slam_tpu/models/dense_tracker.py:445"  # the level's lax.while_loop
CG_WHILE_REPLACES = "dvo_slam_tpu/models/pose_graph.py:310"  # block-CG's lax.while_loop
COPY_REPLACES = "tools/gather_probe.py:382"
COPY_SHAPES = {"l1_table": (32, 76800), "ragged": (7, 1001), "chunk_straddle": (3, 2731),
               "beyond_l2": (32, 460800)}
# about 10 ms of the card's clock ahead of a device-timed call: longer than
# the host takes to enqueue the slowest timed call (the plain version's
# ~120 ops), so the events bracket device work only
SPIN_CYCLES = 20_000_000
COLD_FLUSH_BYTES = 256 * 2**20  # written between cold copy runs: more than the 50 MB L2
CHECK_P_PREV = ((4000.0, 10.0), (10.0, 1.5e5))  # fused_check.CHECK_PRECISION as a matrix
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# and float32 (outside the tensor cores) and FP64 tensor-core FLOP/s, both 67 T
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 67e12
# operations per pixel: about 200 float32 operations of the warp, sample and
# residual chain (about 130 from a sampled pack), and the Gram's three
# distinct 8x8 tiles of 16 rows, 192 float64 multiply-adds
CHAIN_FLOPS, SAMPLED_CHAIN_FLOPS, GRAM_FLOPS = 200, 130, 384


def median_ms(fn, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms, without the profiler: the card
    first spins for about 10 ms (``torch.cuda._sleep``), longer than the
    host takes to enqueue the call, so the CUDA events around it bracket
    its kernels and the gaps between them, not the host's work.  (A
    profiler session early in the script would stay attached to every later
    launch.)"""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cold_ms(fn, flush, reps=TIMING_REPS, warmup=TIMING_WARMUP):
    """Median device time of ``fn`` in ms with a cold L2 cache: ``flush``
    (more bytes than the L2 holds) is written before each run, outside the
    CUDA events around the run."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for i in range(reps):
        flush.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _timed(row, kernel_fn, plain_fn, timer=None, prefix=""):
    """Kernel and twin times into ``row`` (keys ``prefix + "ms"``,
    ``prefix + "plain_ms"``): one card, in turns (twin, kernel, kernel,
    twin), the better of each pair; ``timer`` is ``median_ms`` unless
    given."""
    timer = timer or median_ms
    t_plain = [timer(plain_fn)]
    t_kernel = [timer(kernel_fn), timer(kernel_fn)]
    t_plain.append(timer(plain_fn))
    row[prefix + "ms"] = min(t_kernel)
    row[prefix + "plain_ms"] = min(t_plain)


def _bytes(*tensors):
    """Bytes of the tensors, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def _rows_bytes(pack, rows):
    """Bytes of the first ``rows`` channels of a [..., C, N] pack: what a
    kernel that reads only those channels moves."""
    return pack.numel() // pack.shape[-2] * rows * pack.element_size()


def _quad_bytes(refpack, quad, shape, intrinsics, T):
    """Bytes of the quad table [..., 32, N] that the folded warp reads on
    this run's data: channels 0-6 of the four neighbours (28 of 32 rows) in
    each distinct column, per stream, that a pixel's sample lands on."""
    import torch

    from dvo_slam_tpu_torch.ops.interp import quad_index

    x, y, z = refpack[..., 4, :], refpack[..., 5, :], refpack[..., 1, :]
    R, t = T[..., :3, :3].unsqueeze(-1), T[..., :3, 3].unsqueeze(-1)
    p = [R[..., r, 0, :] * x + R[..., r, 1, :] * y + R[..., r, 2, :] * z + t[..., r, :]
         for r in range(3)]
    z_safe = torch.where(p[2] > 1e-12, p[2], torch.full_like(p[2], 1e-12))
    u = p[0] / z_safe * intrinsics.fx + intrinsics.ox
    v = p[1] / z_safe * intrinsics.fy + intrinsics.oy
    idx = quad_index(shape, u, v).idx.reshape(-1, u.shape[-1])
    idx = idx + quad.shape[-1] * torch.arange(idx.shape[0], device=idx.device)[:, None]
    return int(torch.unique(idx).numel()) * 28 * quad.element_size()


def _bound(moved_bytes, flops=0.0):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    card's memory rate and the operations over its peak rate."""
    by_bytes = 1e3 * moved_bytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_FLOPS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_kernels(cfg, intrinsics, ref_levels, cur_levels):
    """Phase 3b: the sampled-input kernels vs their plain twins at every
    solved level, first_iter 0 and 1.  Returns {kernel name: (rows, worst errors)}: the
    worst absolute error, the worst error scaled by sqrt(G_aa G_bb)
    (``compare_gram``), the worst relative error against the float64 Gram
    (``compare_exact_gram``) and, for the partials, the most rw entries
    that were not bit-equal to the twin's."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check

    out = {"fused_stats": ([], {}), "fused_partials": ([], {})}

    def worst(name, **errors):
        table = out[name][1]
        for key, value in errors.items():
            table[key] = max(table.get(key, 0), value)

    for level, (sampled, refpack, k) in fused_check.level_inputs(
        cfg, intrinsics, ref_levels, cur_levels
    ).items():
        device = sampled.device
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
        for first in (0, 1):
            flag = torch.tensor(first, dtype=torch.int32, device=device)
            args = (sampled, refpack, p3, flag, k, cfg.influence_function_param)
            exact = fused_check.exact_gram(*args)
            base = {"level": level, "pixels": sampled.shape[1], "first_iter": first}

            kernel = fused_kernels.fused_stats_cuda(*args)
            again = fused_kernels.fused_stats_cuda(*args)
            twin = fused_kernels.fused_stats_plain(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical(kernel, again)
            abs_err, scaled_err = fused_check.compare_fused_stats(kernel, twin)
            exact_err = fused_check.compare_exact_gram(kernel, exact)
            worst("fused_stats", max_abs_err=abs_err, max_scaled_err=scaled_err,
                  max_rel_err_f64=exact_err)
            row = dict(base, kernel="fused_stats", num_valid=int(float(kernel.num_valid)),
                       max_abs_err=abs_err, max_scaled_err=scaled_err, max_rel_err_f64=exact_err)
            if first == 0:
                _timed(row, lambda: fused_kernels.fused_stats_cuda(*args),
                       lambda: fused_kernels.fused_stats_plain(*args))
                n = sampled.shape[1]
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flag) + _rows_bytes(refpack, 7) + 4 * (256 + 1),
                    n * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
            out["fused_stats"][0].append(row)
            print("phase 3:", json.dumps(row), flush=True)

            gram, rw = fused_kernels.fused_partials_rows_cuda(*args)
            gram2, rw2 = fused_kernels.fused_partials_rows_cuda(*args)
            kernel = fused_kernels.partials_from_rows(gram, rw)
            twin = fused_kernels.fused_partials_plain(*args)
            twin_rw = fused_check.twin_rows(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical((gram, rw), (gram2, rw2))
            abs_err, scaled_err, not_bit_equal = fused_check.compare_fused_partials(
                kernel, rw, twin, twin_rw
            )
            exact_err = fused_check.compare_exact_gram(kernel, exact)
            worst("fused_partials", max_abs_err=abs_err, max_scaled_err=scaled_err,
                  max_rel_err_f64=exact_err, rw_not_bit_equal=not_bit_equal)
            row = dict(base, kernel="fused_partials", num_valid=int(float(kernel.num_valid)),
                       max_abs_err=abs_err, max_scaled_err=scaled_err,
                       max_rel_err_f64=exact_err, rw_not_bit_equal=not_bit_equal)
            if first == 0:
                _timed(row, lambda: fused_kernels.fused_partials_cuda(*args),
                       lambda: fused_kernels.fused_partials_plain(*args))
                n = sampled.shape[1]
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flag, rw) + _rows_bytes(refpack, 7) + 4 * 256,
                    n * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
            out["fused_partials"][0].append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return out


def _stream(stats, b):
    """Stream b of a batched named tuple of tensors."""
    return type(stats)(*(f[b] for f in stats))


def _bits_differ(a, b):
    """Entries whose bits differ between two tuples of equal-shape tensors."""
    import torch

    return sum(int((x.reshape(-1).view(torch.int32) != y.reshape(-1).view(torch.int32)).sum())
               for x, y in zip(a, b))


def check_folded(cfg, intrinsics, frames):
    """Phase 3a: the folded kernel against its plain version at every solved
    level, first 0 and 1, depth-buffered on and off (pair 0 of ``frames``),
    then B = STREAMS pairs in one call against one-stream calls (pairs b,
    b + 1), depth-buffered on and off.  Returns (one-stream rows, their
    worst errors, batched rows, their worst errors by ``depth_buffered``)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.ops.residuals import warp_and_sample_cm
    from dvo_slam_tpu_torch.tools import fused_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    dof = cfg.influence_function_param
    per_pair = [fused_check.warp_level_inputs(cfg, intrinsics, frames[b], frames[b + 1])
                for b in range(STREAMS)]
    rows, worst, batched_rows, batched_worst = [], {}, [], {True: {}, False: {}}

    def note(table, **errors):
        for key, value in errors.items():
            table[key] = max(table.get(key, 0), value)

    def held(kernel, stats, stash, plain, args, exact_args):
        """The checks shared by one stream and B streams -> the row's errors."""
        r_err, not_bit_equal = fused_check.compare_stash(stash, fused_check.twin_stash(*args))
        exact_err = max(
            fused_check.compare_exact_gram(
                _stream(stats, b) if stats.m00.dim() == 3 else stats,
                fused_check.warp_exact_gram(*one_args))
            for b, one_args in enumerate(exact_args))
        scaled = fused_check.compare_warp_fused_stats(kernel, plain)
        abs_err = max(float((x.double() - y.double()).abs().max()) for x, y in zip(kernel, plain))
        return {"n": kernel.n.reshape(-1).tolist(), "stash_not_bit_equal": not_bit_equal,
                "stash_max_abs_err": r_err, "max_rel_err_f64": exact_err,
                "max_abs_err": max(abs_err, r_err),
                **{"max_scaled_err_" + k: v for k, v in scaled.items()}}

    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        inputs = per_pair[0][level]
        device = inputs.refpack.device
        P = torch.tensor(CHECK_P_PREV, dtype=torch.float32, device=device)
        for first in (0, 1):
            for buffered in (True, False):
                args = (*inputs, P, bool(first), dof, buffered)
                kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*args)
                again = fused_kernels.warp_fused_stats_rows_cuda(*args)
                plain = fused_kernels.warp_fused_stats_plain(*args)
                torch.cuda.synchronize(device)
                fused_check.assert_bit_identical((*kernel, *stats, stash),
                                                 (*again[0], *again[1], again[2]))
                errors = held(kernel, stats, stash, plain, args, [args])
                note(worst, **{k: v for k, v in errors.items() if k != "n"})
                row = {"level": level, "pixels": inputs.refpack.shape[1], "first": first,
                       "depth_buffered": buffered, "kernel": "warp_fused_stats", **errors}
                if first == 0 and buffered:
                    p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
                    flag = torch.zeros((), dtype=torch.int32, device=device)

                    def unfolded():
                        sampled = warp_and_sample_cm(inputs.refpack, inputs.quad, inputs.shape,
                                                     inputs.intrinsics, inputs.T)
                        return fused_kernels.fused_stats_cuda(sampled, inputs.refpack, p3, flag,
                                                              inputs.intrinsics, dof)

                    def folded():
                        return fused_kernels.warp_fused_stats_cuda(*args)

                    def folded_plain():
                        return fused_kernels.warp_fused_stats_plain(*args)

                    _timed(row, folded, folded_plain)
                    row["unfolded_pair_ms"] = median_ms(unfolded)
                    row["device_ms"] = device_ms(folded)
                    row["plain_device_ms"] = device_ms(folded_plain)
                    row["unfolded_pair_device_ms"] = device_ms(unfolded)
                    row["bound_ms"], row["bound_by"] = _bound(
                        _rows_bytes(inputs.refpack, 7) + _quad_bytes(*inputs) + _bytes(inputs.T, P, *kernel),
                        inputs.refpack.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
                rows.append(row)
                print("phase 3:", json.dumps(row), flush=True)

        # B pairs in one call, depth-buffered (the benchmark's sampling) and
        # not (the driver's lockstep_nobuf section)
        Ps = torch.stack([P * (1.0 + 0.1 * b) for b in range(STREAMS)])
        stack = lambda field: torch.stack(  # noqa: E731
            [getattr(pp[level], field) for pp in per_pair]).contiguous()  # noqa: B023
        for first in (0, 1):
            for buffered in (True, False):
                bargs = (stack("refpack"), stack("quad"), inputs.shape, inputs.intrinsics,
                         stack("T"), Ps, bool(first), dof, buffered)
                one_args = [(*per_pair[b][level], Ps[b], bool(first), dof, buffered)
                            for b in range(STREAMS)]
                kernel, stats, stash = fused_kernels.warp_fused_stats_rows_cuda(*bargs)
                again = fused_kernels.warp_fused_stats_rows_cuda(*bargs)
                plain = fused_kernels.warp_fused_stats_plain(*bargs)
                torch.cuda.synchronize(device)
                fused_check.assert_bit_identical((*kernel, *stats, stash),
                                                 (*again[0], *again[1], again[2]))
                not_bit_equal = 0
                for b in range(STREAMS):
                    one, one_stats, one_stash = fused_kernels.warp_fused_stats_rows_cuda(
                        *one_args[b])
                    not_bit_equal += _bits_differ((*_stream(kernel, b), *_stream(stats, b), stash[b]),
                                                  (*one, *one_stats, one_stash))
                require(not_bit_equal == 0,
                        f"batched folded kernel: {not_bit_equal} outputs differ from one-stream "
                        f"calls (level {level}, first {first}, depth_buffered {buffered})")
                errors = held(kernel, stats, stash, plain, bargs, one_args)
                note(batched_worst[buffered], not_bit_equal_to_single=not_bit_equal,
                     **{k: v for k, v in errors.items() if k != "n"})
                row = {"level": level, "streams": STREAMS, "pixels": inputs.refpack.shape[1],
                       "first": first, "depth_buffered": buffered,
                       "kernel": "warp_fused_stats_batched",
                       "not_bit_equal_to_single": not_bit_equal, **errors}
                if level == cfg.last_level and first == 0:
                    def batched():
                        return fused_kernels.warp_fused_stats_batched_cuda(*bargs)  # noqa: B023

                    def batched_plain():
                        return fused_kernels.warp_fused_stats_plain(*bargs)  # noqa: B023

                    _timed(row, batched, batched_plain)
                    row["single_kernel_x_streams_ms"] = median_ms(lambda: [
                        fused_kernels.warp_fused_stats_cuda(*a) for a in one_args])  # noqa: B023
                    row["device_ms"] = device_ms(batched)
                    row["plain_device_ms"] = device_ms(batched_plain)
                    row["bound_ms"], row["bound_by"] = _bound(
                        _rows_bytes(bargs[0], 7) + _quad_bytes(*bargs[:5])
                        + _bytes(bargs[4], Ps, *kernel),
                        STREAMS * inputs.refpack.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
                batched_rows.append(row)
                print("phase 3:", json.dumps(row), flush=True)
    return rows, worst, batched_rows, batched_worst


def check_sharded_kernels(cfg, intrinsics, frames):
    """Phase 3c: the pixel-sharded evaluation's three launches against their
    plain versions at every solved level, first 0 and 1, on the blocks of
    ``SHARD_WORLDS`` ranks (pair 0 of ``frames``); timings at the last
    level.  Returns (rows, worst errors, the timing rows by pixel count)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.ops.residuals import warp_and_sample_cm
    from dvo_slam_tpu_torch.tools import fused_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    dof = cfg.influence_function_param
    cuda_steps = (fused_kernels.warp_fused_partials_cuda, fused_kernels.sharded_loglik_cuda,
                  fused_kernels.sharded_tail_cuda)
    plain_steps = (fused_kernels.warp_fused_partials_plain, fused_kernels.sharded_loglik_plain,
                   fused_kernels.sharded_tail_plain)
    levels = fused_check.warp_level_inputs(cfg, intrinsics, frames[0], frames[1])
    rows, worst, timed = [], {}, []
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        inputs = levels[level]
        device = inputs.refpack.device
        P = torch.tensor(CHECK_P_PREV, dtype=torch.float32, device=device)
        common = (inputs.quad, inputs.shape, inputs.intrinsics, inputs.T, P)
        for first in (0, 1):
            for world in SHARD_WORLDS:
                blocks = fused_check.shard_blocks(inputs.refpack, world)
                plain, _, plain_own, _ = fused_check.sharded_on_one_device(
                    plain_steps, blocks, *common, bool(first), dof)
                twins = [fused_check.twin_sharded_stash(b, *common, bool(first), dof) for b in blocks]
                exact = [fused_check.warp_exact_gram(b, *common, bool(first), dof) for b in blocks]
                runs = [fused_check.sharded_on_one_device(cuda_steps, blocks, *common, bool(first), dof)
                        for _ in range(2)]
                torch.cuda.synchronize(device)
                (results, evaluations, own, total), again = runs
                stashes = [fused_kernels.sharded_stash(e) for e in evaluations]
                fused_check.assert_bit_identical(
                    (*results[0], own, total, *stashes),
                    (*again[0][0], again[2], again[3],
                     *(fused_kernels.sharded_stash(e) for e in again[1])))
                r_err, not_bit_equal, exact_err = 0.0, 0, 0.0
                for rank in range(world):
                    err, differ = fused_check.compare_stash(stashes[rank], twins[rank], gate="gate")
                    r_err, not_bit_equal = max(r_err, err), not_bit_equal + differ
                    if float(plain_own[rank][135]) > 0:
                        exact_err = max(exact_err, fused_check.compare_packed_sums(
                            own[rank], exact[rank], plain_own[rank][135]))
                    require(_bits_differ(results[rank], results[0]) == 0,
                            f"sharded evaluation: rank {rank} of {world} differs from rank 0")
                scaled = fused_check.compare_warp_fused_stats(results[0], plain[0])
                abs_err = max(float((x.double() - y.double()).abs().max())
                              for x, y in zip(results[0], plain[0]))
                errors = {"stash_not_bit_equal": not_bit_equal, "stash_max_abs_err": r_err,
                          "max_rel_err_f64": exact_err, "max_abs_err": max(abs_err, r_err),
                          **{"max_scaled_err_" + k: v for k, v in scaled.items()}}
                for key, value in errors.items():
                    worst[key] = max(worst.get(key, 0), value)
                row = {"level": level, "pixels": inputs.refpack.shape[1], "first": first,
                       "ranks": world, "pixels_per_rank": blocks[0].shape[1],
                       "kernel": "warp_fused_partials", "n": int(plain[0].n), **errors}
                rows.append(row)
                print("phase 3:", json.dumps(row), flush=True)

        if level != cfg.last_level:
            continue
        # times at the last level, first = 0: block 0 of 1, 2 and 4 ranks
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device)
        flag = torch.zeros((), dtype=torch.int32, device=device)
        for world in SHARD_TIMED:
            block = fused_check.shard_blocks(inputs.refpack, world)[0]

            def folded():
                return fused_check.sharded_on_one_device(cuda_steps, [block], *common, False, dof)[0]  # noqa: B023

            def folded_plain():
                return fused_check.sharded_on_one_device(plain_steps, [block], *common, False, dof)[0]  # noqa: B023

            def unfolded():
                sampled = warp_and_sample_cm(block, inputs.quad, inputs.shape, inputs.intrinsics,  # noqa: B023
                                             inputs.T)
                parts = fused_kernels.fused_partials_cuda(sampled, block, p3, flag,  # noqa: B023
                                                          inputs.intrinsics, dof)
                evaluation = fused_kernels.ShardedEvaluation(
                    fused_kernels.pack_sums(parts), None, (parts, dof))
                return fused_kernels.sharded_tail_plain(fused_kernels.sharded_loglik_plain(evaluation))

            row = {"level": level, "ranks": world, "pixels_per_rank": block.shape[1],
                   "kernel": "warp_fused_partials", "first": 0}
            _timed(row, folded, folded_plain)
            row["unfolded_trio_ms"] = median_ms(unfolded)
            row["device_ms"] = device_ms(folded)
            row["plain_device_ms"] = device_ms(folded_plain)
            row["unfolded_trio_device_ms"] = device_ms(unfolded)
            row["launch1_device_ms"] = device_ms(
                lambda: fused_kernels.warp_fused_partials_cuda(block, *common, False, dof))  # noqa: B023
            evaluation = fused_kernels.warp_fused_partials_cuda(block, *common, False, dof)
            row["launch2_device_ms"] = device_ms(lambda: fused_kernels.sharded_loglik_cuda(evaluation))  # noqa: B023
            row["launch3_device_ms"] = device_ms(lambda: fused_kernels.sharded_tail_cuda(evaluation))  # noqa: B023
            result = folded()[0]
            row["bound_ms"], row["bound_by"] = _bound(
                _rows_bytes(block, 7) + _quad_bytes(block, *common[:4]) + 12 * block.shape[1]
                + _bytes(inputs.T, P, *result),
                block.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
            timed.append(row)
            print("phase 3:", json.dumps(row), flush=True)
    return rows, worst, timed


def _ingest_outputs(levels, prepared, solve):
    """{(name, level): tensor} of a frame's ingest tensors (41 at 4 levels,
    all stored), a stored level's fields and the solve range's tables."""
    out = {(name, k): t for k, lv in enumerate(levels) if lv is not None
           for name, t in zip(lv._fields, lv)}
    for name in ("sel", "refpack", "quad"):
        for k in range(solve[0], solve[1] + 1):
            out[(name, k)] = getattr(prepared, name)[k]
    return out


def _ingest_bytes(layout):
    """Bytes ingest's two kernels must move: kernel A reads the raw frames
    (u8 and u16, one a stream) and writes every stored level field; kernel
    B reads the seven fields it uses of the solve range's levels and writes
    sel, refpack and quad."""
    from dvo_slam_tpu_torch.ops import ingest

    h, w = layout.shape
    views = layout.views
    fields = [k for k in views if k[0] in ingest.KERNEL_FIELDS]
    a = 3 * h * w * (layout.batch or 1) + sum(views[k].nbytes for k in fields)
    last, first = layout.solve
    b_in = sum(views[k].nbytes for k in fields if last <= k[1] <= first and k[0] != "valid")
    b_out = sum(views[k].nbytes for k in views if k[0] in ("sel", "refpack", "quad"))
    return a + b_in + b_out


def check_ingest(cfg, intrinsics, iu, du):
    """Phase 3d: ingest's two kernels against the plain chain on the card,
    bit for bit, on the first ``INGEST_FRAMES`` host frames ``iu`` / ``du``
    (u8 / u16), through ``ingest_cuda`` on card tensors (u16 and int32
    depth) and ``Frame.from_raw`` from the host arrays; then the times; then
    the rig's form (:func:`check_ingest_rig`).  Returns the row of the
    kernels line (without its launches)."""
    import time as _time

    import torch

    from dvo_slam_tpu_torch.models.dense_tracker import PreparedFrame, prepare_frame
    from dvo_slam_tpu_torch.models.frames import Frame
    from dvo_slam_tpu_torch.ops import ingest
    from dvo_slam_tpu_torch.ops.pyramid import build_pyramid, convert_raw_depth
    from dvo_slam_tpu_torch.tools.fused_check import require

    dev = torch.device("cuda", 0)
    solve = (cfg.last_level, cfg.first_level)
    key = (cfg, intrinsics)
    layout = ingest.arena_layout(tuple(iu.shape[1:]), cfg.num_levels, solve, True)
    pack = ingest.pack_args(layout, intrinsics, cfg.intensity_derivative_threshold,
                            cfg.depth_derivative_threshold)

    def plain(raw_i, raw_d):
        depth, valid = convert_raw_depth(raw_d)
        levels = build_pyramid(raw_i.to(torch.float32), depth, valid, cfg.num_levels)
        return levels, prepare_frame(cfg, intrinsics, levels)

    def kernels(raw_i, raw_d, pack=pack):
        ref, cur = ingest.new_arenas(layout, dev)
        ingest.ingest_cuda(raw_i, raw_d, layout, ref, cur, pack)
        levels, sel, refpack, quad = ingest.arena_views(layout, ref, cur)
        return levels, PreparedFrame(sel=sel, refpack=refpack, quad=quad, accel=None)

    def from_host(k):
        frame = Frame.from_raw(iu[k], du[k], 0.0, cfg.num_levels, prepare_for=key, device=dev)
        return frame.levels, frame.__dict__["_prepared"][key]

    differ, worst, tensors = {}, 0.0, 0
    for k in range(INGEST_FRAMES):
        raw_i = torch.from_numpy(iu[k]).to(dev)
        raw_d = torch.from_numpy(du[k]).to(dev)
        want = _ingest_outputs(*plain(raw_i, raw_d), solve)
        for route, got in (("card_u16", kernels(raw_i, raw_d)),
                           ("card_int32", kernels(raw_i, raw_d.to(torch.int32))),
                           ("from_host", from_host(k))):
            got = _ingest_outputs(*got, solve)
            require(got.keys() == want.keys(), f"phase 3 ingest {route}: tensors {got.keys()}")
            for name, x in got.items():
                y = want[name]
                require(x.shape == y.shape and x.dtype == y.dtype,
                        f"phase 3 ingest {route} {name}: {x.shape} {x.dtype} against "
                        f"{y.shape} {y.dtype}")
                tensors += 1
                if not torch.equal(_bits_of(x), _bits_of(y)):
                    differ.setdefault(route, []).append(f"{name[0]}{name[1]}")
                    if x.dtype == torch.float32:
                        worst = max(worst, float((x - y).abs().nan_to_num(float("inf")).max()))
    require(not differ, f"phase 3 ingest: tensors not bit-equal to the plain chain: {differ}")

    raw_i = torch.from_numpy(iu[0]).to(dev)
    raw_d = torch.from_numpy(du[0]).to(dev)
    ref, cur = ingest.new_arenas(layout, dev)
    row = {"shape": list(layout.shape), "levels": cfg.num_levels, "solve": list(solve),
           "frames": INGEST_FRAMES, "tensors_compared": tensors, "not_bit_equal": 0,
           "max_abs_err": worst}
    both = lambda: ingest.ingest_cuda(raw_i, raw_d, layout, ref, cur, pack)  # noqa: E731
    chain = lambda: plain(raw_i, raw_d)  # noqa: E731
    _timed(row, both, chain)
    _timed(row, both, chain, timer=device_ms, prefix="device_")
    row["device_ms"], row["plain_device_ms"] = row.pop("device_ms"), row.pop("device_plain_ms")
    row["kernel_a_device_ms"] = device_ms(lambda: ingest.ingest_cuda(raw_i, raw_d, layout, ref))
    row["bytes"] = _ingest_bytes(layout)
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"])

    def host_ms(fn):
        times = []
        for k in range(INGEST_HOST_REPS):
            t0 = _time.perf_counter()
            fn(k % INGEST_FRAMES)
            times.append(1e3 * (_time.perf_counter() - t0))
            torch.cuda.synchronize()
        return float(np.median(times))

    row["host_ms"] = host_ms(from_host)
    row["plain_host_ms"] = host_ms(lambda k: plain(torch.from_numpy(iu[k]).to(dev),
                                                   torch.from_numpy(du[k]).to(dev)))
    row["rig"] = check_ingest_rig(cfg, intrinsics, iu, du)
    print("phase 3:", json.dumps({"ingest": row}), flush=True)
    return row


def check_ingest_rig(cfg, intrinsics, iu, du):
    """Phase 3d, the rig's form: the first ``INGEST_RIG_STREAMS`` host frames
    as one rig frame of as many streams through ``frames.ingest_raw``, levels
    below the solve range not stored (``LockstepTracker``'s call): one launch
    of each kernel, every [B, ...] tensor bit-equal to the plain chain over
    the stacked frames on the card.  Returns the rig's part of the kernels
    line: device ms of both kernels and of the plain chain at B, the bound."""
    import torch

    from dvo_slam_tpu_torch.models.dense_tracker import prepare_frame
    from dvo_slam_tpu_torch.models.frames import ingest_raw
    from dvo_slam_tpu_torch.ops import ingest
    from dvo_slam_tpu_torch.ops.pyramid import build_pyramid, convert_raw_depth
    from dvo_slam_tpu_torch.tools.fused_check import require

    dev = torch.device("cuda", 0)
    streams, skip = INGEST_RIG_STREAMS, cfg.last_level
    solve = (cfg.last_level, cfg.first_level)
    rig_i, rig_d = iu[:streams], du[:streams]
    require(len(rig_i) == streams, f"phase 3 ingest rig: {len(rig_i)} frames for {streams}")
    raw_i = torch.from_numpy(np.ascontiguousarray(rig_i)).to(dev)
    raw_d = torch.from_numpy(np.ascontiguousarray(rig_d)).to(dev)

    def plain():
        depth, valid = convert_raw_depth(raw_d)
        levels = build_pyramid(raw_i.to(torch.float32), depth, valid, cfg.num_levels,
                               skip_below=skip)
        return levels, prepare_frame(cfg, intrinsics, levels)

    launches = (ingest.ingest_cuda.pyramid_launches, ingest.ingest_cuda.pack_launches)
    got = ingest_raw(list(rig_i), list(rig_d), cfg.num_levels, (cfg, intrinsics), dev, streams,
                     skip)
    launched = (ingest.ingest_cuda.pyramid_launches - launches[0],
                ingest.ingest_cuda.pack_launches - launches[1])
    require(launched == (1, 1), f"phase 3 ingest rig: launches (A, B) {launched}, not (1, 1)")
    got, want = _ingest_outputs(*got, solve), _ingest_outputs(*plain(), solve)
    require(got.keys() == want.keys(), f"phase 3 ingest rig: tensors {sorted(got)} against "
                                       f"{sorted(want)}")
    differ = {}
    for name, x in got.items():
        y = want[name]
        require(x.shape == y.shape and x.dtype == y.dtype and x.shape[0] == streams,
                f"phase 3 ingest rig {name}: {x.shape} {x.dtype} against {y.shape} {y.dtype}")
        bad = [s for s in range(streams) if not torch.equal(_bits_of(x[s]), _bits_of(y[s]))]
        if bad:
            differ[f"{name[0]}{name[1]}"] = bad
    require(not differ, f"phase 3 ingest rig: tensors not bit-equal to the plain chain, "
                        f"streams by tensor: {differ}")

    layout = ingest.arena_layout(tuple(iu.shape[1:]), cfg.num_levels, solve, True, streams, skip)
    pack = ingest.pack_args(layout, intrinsics, cfg.intensity_derivative_threshold,
                            cfg.depth_derivative_threshold)
    ref, cur = ingest.new_arenas(layout, dev)
    row = {"streams": streams, "skip_below": skip, "tensors_compared": len(got),
           "not_bit_equal": 0}
    _timed(row, lambda: ingest.ingest_cuda(raw_i, raw_d, layout, ref, cur, pack), plain,
           timer=device_ms, prefix="device_")
    row["device_ms"], row["plain_device_ms"] = row.pop("device_ms"), row.pop("device_plain_ms")
    row["bytes"] = _ingest_bytes(layout)
    row["bound_ms"], row["bound_by"] = _bound(row["bytes"])
    return row


def count_ingest_kernels(cfg, intrinsics, iu, du):
    """After the timed phases: the device kernels and copies ``torch.profiler``
    records in one ingest of a host frame, on the kernel route
    (``Frame.from_raw``) and on the plain chain (None where it records
    none)."""
    import torch
    from torch.autograd import DeviceType

    from dvo_slam_tpu_torch.models.dense_tracker import prepare_frame
    from dvo_slam_tpu_torch.models.frames import Frame
    from dvo_slam_tpu_torch.ops.pyramid import build_pyramid, convert_raw_depth

    dev = torch.device("cuda", 0)

    def plain():
        depth, valid = convert_raw_depth(torch.from_numpy(du[0]).to(dev))
        levels = build_pyramid(torch.from_numpy(iu[0]).to(dev).to(torch.float32), depth, valid,
                               cfg.num_levels)
        prepare_frame(cfg, intrinsics, levels)

    def kernels():
        Frame.from_raw(iu[0], du[0], 0.0, cfg.num_levels, prepare_for=(cfg, intrinsics),
                       device=dev)

    counts = {}
    for name, fn in (("kernel_route", kernels), ("plain_chain", plain)):
        for _ in range(2):  # the second session's count is kept
            fn()
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            with prof:
                fn()
                torch.cuda.synchronize()
            counts[name] = sum(e.device_type == DeviceType.CUDA for e in prof.events()) or None
    print("phase 3:", json.dumps({"ingest_device_events": counts}), flush=True)
    return counts


def _bits_of(t):
    """A tensor's bits: float32 as int32, others as they are."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _pose_errors(a, b):
    """max |log(a^-1 b)| per pose, for [..., 4, 4] poses (float64 on the host)."""
    import torch

    from dvo_slam_tpu_torch.ops import se3

    a = np.asarray(a, np.float64).reshape(-1, 4, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4, 4)
    rel = torch.from_numpy(np.linalg.inv(a) @ b)
    return se3.log_se3(rel).abs().amax(dim=-1).numpy()


def _pose_error(T_gt, T):
    """max |log(T_gt^-1 T)| of one pose ``T`` (a tensor)."""
    return float(_pose_errors(T_gt, T.detach().cpu().numpy()).max())


def _synchronized_seconds(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _result_bits(results):
    """Per result the bytes of its transformation, information and
    negative log-likelihood, and its level statistics."""
    return [(tuple(t.cpu().numpy().tobytes()
                   for t in (r.transformation, r.information, r.neg_log_likelihood)),
             [(int(s.valid_constraints), int(s.iterations), int(s.termination))
              for s in r.level_stats])
            for r in results]


def _same_results(a, b) -> bool:
    return _result_bits(a) == _result_bits(b)


def check_sharded(cfg, intrinsics, frames, poses):
    """Phase 6: the pixel-sharded and pair-parallel matchers on a one-rank
    NCCL process group; the group's probe and form; the sharded level in
    that form (while graphs) against the host-polled graphs and its eager
    loop, the distributed CG likewise, then the sharded level again after
    ``shutdown()`` and ``initialize()``.  Returns the main run's launches
    of the folded partials kernel, ``set_while``'s runs in the phase
    ({"6_sharded": n, "6_cg": n}) and the phase's summary."""
    import dataclasses
    import tempfile

    import torch

    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.models import pose_graph as pg
    from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
    from dvo_slam_tpu_torch.ops.pyramid import PyramidLevel
    from dvo_slam_tpu_torch.parallel import distributed, distributed_ba, mesh as mesh_lib
    from dvo_slam_tpu_torch.parallel import sharded_alignment
    from dvo_slam_tpu_torch.tools import cg_iteration_stats, graph_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    device = frames[0][cfg.first_level].intensity.device
    eye = torch.eye(4, dtype=torch.float32, device=device)
    pairs = [(frames[k], frames[k + 1]) for k in range(SHARDED_PAIRS)]
    chunk = sharded_alignment.CHUNK_STEPS
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            mesh = mesh_lib.make_mesh(1)
            require(mesh.device.type == "cuda", f"the mesh's rank runs on {mesh.device}")
            group = irls_graph.group_key()
            # the group's form, chosen by its probe at initialize: the while
            # form, or host-polled with CUDA's refusal recorded
            form = irls_graph.group_forms().get(group)
            require(form is not None, "initialize probed no form for the NCCL group")
            require(form.form == "while" or form.refusal,
                    f"the group's loops are host-polled with no refusal recorded: {form}")
            admitted = form.form == "while"
            print("phase 6:", json.dumps({
                "group_form": form.form, "probe_refusal": form.refusal,
                "probe_census": form.census}), flush=True)
            run = sharded_alignment.make_pixel_sharded_matcher(cfg, intrinsics, mesh)
            sharded = lambda: [run(r, c, eye) for r, c in pairs]  # noqa: E731
            for mode in SHARDED_FORMS.values():  # warm-up (the communicator, the captures)
                with graph_check.loop_mode(sharded=chunk, **mode):
                    run(*pairs[0], eye)

            # the sharded path in the group's form, with every kernel count at 0
            _reset_counts()
            with graph_check.sharded_recording() as levels:
                results, sharded_s = _synchronized_seconds(sharded)
            stats_launches = _launches()
            partials_launches = stats_launches["warp_fused_partials"]
            sharded_launches = {name: stats_launches.pop(name)
                                for name in SHARDED_KERNELS + STEP_COUNTS}
            del stats_launches["table_copy"]
            iterations = sum(int(s.iterations) for r in results for s in r.level_stats)
            steps = sum(graph_check.counts([s], chunk)[1] for _, s, _ in levels)
            require(all(count == steps > 0 for count in sharded_launches.values()),
                    f"sharded launches {sharded_launches} != executed steps {steps}")
            require(not any(stats_launches.values()),
                    "the sampled-input partials kernel, a statistics kernel or "
                    f"warp_and_sample_cm ran on the sharded path: {stats_launches}")
            level_iterations = [s.iterations for _, s, _ in levels]
            if admitted:
                while_6 = _require_while(level_iterations, "phase 6", chunk)
            else:
                while_6 = {"set_while_runs": 0, "irls_done_reads": _done_reads()}
            keys = [k for k in irls_graph._cache if k[1] == "sharded"]
            require(keys and all(group in k for k in keys),
                    f"the sharded level built no graph key of the group: {keys}")
            errors = [
                _pose_error(np.linalg.inv(poses[k]) @ poses[k + 1], r.transformation)
                for k, r in enumerate(results)
            ]
            require(max(errors) < POSE_GATE, f"sharded pose errors {errors} (gate {POSE_GATE})")

            # the other forms on the same pairs: the same bits; then every
            # form and match_pyramids timed in turns (while, polled, eager,
            # single, then back)
            seconds = {name: [] for name in list(SHARDED_FORMS) + ["single"]}
            reads = {}
            for name, mode in SHARDED_FORMS.items():
                if name == "while":
                    continue
                before = _done_reads()
                with graph_check.loop_mode(sharded=chunk, **mode), \
                        graph_check.sharded_recording() as other_levels:
                    other, other_s = _synchronized_seconds(sharded)
                reads[name] = _done_reads() - before
                parted = graph_check.differences(other_levels, levels)
                require(not parted, f"sharded {name} vs the group's form: {parted[:5]}")
                require(_same_results(results, other), f"sharded results {name} != while")
                seconds[name].append(other_s)
            seconds["while"].append(sharded_s)
            single = lambda: [match_pyramids(cfg, intrinsics, r, c, eye) for r, c in pairs]  # noqa: E731
            singles, single_s = _synchronized_seconds(single)
            seconds["single"].append(single_s)
            for name in ["single"] + list(SHARDED_FORMS)[::-1]:
                if name == "single":
                    seconds[name].append(_synchronized_seconds(single)[1])
                    continue
                with graph_check.loop_mode(sharded=chunk, **SHARDED_FORMS[name]):
                    seconds[name].append(_synchronized_seconds(sharded)[1])
            single_iterations = sum(int(s.iterations) for r in singles for s in r.level_stats)

            # the distributed CG (its all-reduce in the WHILE body) in the
            # three forms: the same bits, ms per CG iteration
            graph, _ = cg_iteration_stats.loopy_graph(SHARDED_CG_VERTICES, 7)
            arrays = pg.GraphArrays(*(t.to(device) for t in graph.to_arrays()))
            cg_runs, cg_k = {}, []
            solve = pg.solve_blocks_cg

            def counted_solve(*args, **kwargs):
                x, k = solve(*args, **kwargs, return_iterations=True)
                cg_k.append(k)
                return x

            pg.solve_blocks_cg = counted_solve
            try:
                for name, mode in SHARDED_FORMS.items():
                    with graph_check.loop_mode(**mode):  # the captures, then the timed run
                        distributed_ba.distributed_gauss_newton_cg(arrays, mesh, iterations=1)
                        _reset_counts()
                        cg_k.clear()
                        (out, hist), cg_s = _synchronized_seconds(
                            lambda: distributed_ba.distributed_gauss_newton_cg(
                                arrays, mesh, iterations=SHARDED_CG_GN_STEPS))
                        _launches()
                    cg_runs[name] = {"poses": out.poses, "chi2": hist, "k": list(cg_k),
                                     "seconds": cg_s,
                                     "set_while_runs": irls_graph.while_counts.set_while,
                                     "while_launches": irls_graph.while_counts.launches}
            finally:
                pg.solve_blocks_cg = solve
            for name, r in cg_runs.items():
                require(r["k"] == cg_runs["eager"]["k"]
                        and torch.equal(r["poses"], cg_runs["eager"]["poses"])
                        and torch.equal(r["chi2"], cg_runs["eager"]["chi2"]),
                        f"phase 6: distributed GN-CG {name} != eager")
            cg_chunks = sum(-(-k // pg.CG_CHUNK_STEPS) for k in cg_runs["while"]["k"])
            if admitted:
                require(cg_runs["while"]["while_launches"] == SHARDED_CG_GN_STEPS
                        and cg_runs["while"]["set_while_runs"] == cg_chunks,
                        f"phase 6: the distributed CG's while graphs: {cg_runs['while']}")
            cg_keys = [k for k in irls_graph._cache if k[1] == "cg" and group in k]
            require(cg_keys, "the distributed CG built no graph key of the group")
            census = {"sharded_L1": irls_graph._cache[max(
                keys, key=lambda k: k[3][0] * k[3][1])].census(),
                "cg": irls_graph._cache[cg_keys[0]].census()}

            # mu = 0: the sharded and single paths coincide by construction
            cfg0 = dataclasses.replace(cfg, mu=0.0)
            sharded0 = sharded_alignment.make_pixel_sharded_matcher(cfg0, intrinsics, mesh)(
                *pairs[0], eye)
            single0 = match_pyramids(cfg0, intrinsics, *pairs[0], eye)
            counts = lambda r: [(int(s.iterations), int(s.termination)) for s in r.level_stats]  # noqa: E731
            require(counts(sharded0) == counts(single0),
                    f"mu=0 levels: sharded {counts(sharded0)} vs single {counts(single0)}")
            mu0_err = _pose_error(single0.transformation.cpu().numpy(), sharded0.transformation)
            require(mu0_err < MU0_POSE_GATE, f"mu=0 sharded vs single: {mu0_err}")
            torch.testing.assert_close(sharded0.information, single0.information,
                                       rtol=2e-3, atol=1e-3)

            # the pair-parallel wave against match_pyramids pair by pair
            def stack(levels_list):
                return tuple(
                    None if levels_list[0][lv] is None else PyramidLevel(*(
                        torch.stack([levels[lv][f] for levels in levels_list]) for f in range(8)
                    ))
                    for lv in range(len(levels_list[0]))
                )

            wave = sharded_alignment.make_pair_parallel_matcher(cfg, intrinsics, mesh)(
                stack(frames[:WAVE_PAIRS]), stack(frames[1:WAVE_PAIRS + 1]),
                eye.expand(WAVE_PAIRS, 4, 4).contiguous(),
            )
            wave_not_bit_equal, wave_err = 0, 0.0
            for b in range(WAVE_PAIRS):
                one = singles[b]
                wave_not_bit_equal += not (
                    torch.equal(wave.transformation[b], one.transformation)
                    and torch.equal(wave.information[b], one.information)
                    and torch.equal(wave.neg_log_likelihood[b], one.neg_log_likelihood))
                wave_err = max(wave_err, float(
                    (wave.transformation[b] - one.transformation).abs().max()))
                torch.testing.assert_close(wave.information[b], one.information, rtol=0,
                                           atol=WAVE_ATOL * float(one.information.abs().max()))
                for s_wave, s_one in zip(wave.level_stats, one.level_stats):
                    require([int(s_wave.valid_pixels[b]), int(s_wave.valid_constraints[b]),
                             int(s_wave.iterations[b]), int(s_wave.termination[b])]
                            == [int(s_one.valid_pixels), int(s_one.valid_constraints),
                                int(s_one.iterations), int(s_one.termination)],
                            f"pair-parallel pair {b} level stats differ")
            require(wave_err <= WAVE_ATOL,
                    f"pair-parallel estimates {wave_err} from match_pyramids (tolerance {WAVE_ATOL})")
            others = [k for k in irls_graph._cache if group not in k]
        finally:
            distributed.shutdown()
        left = list(irls_graph._cache)
        require(left == others, f"shutdown left {[k for k in left if k not in others]} or "
                f"dropped {[k for k in others if k not in left]}")

        # a new group: a new generation of keys, the same bits
        distributed.initialize(init_method=f"file://{store}/again", world_size=1, rank=0,
                               backend="nccl")
        try:
            require(irls_graph.group_key() != group, "initialize did not start a new generation")
            again = sharded_alignment.make_pixel_sharded_matcher(
                cfg, intrinsics, mesh_lib.make_mesh(1))(*pairs[0], eye)
            require(_same_results([again], results[:1]),
                    "the sharded pair after shutdown and initialize != the first run's")
        finally:
            distributed.shutdown()
    ms = lambda name, n: [1000.0 * t / n for t in seconds[name]]  # noqa: E731
    summary = {
        "pairs": SHARDED_PAIRS, "max_pose_err": max(errors), "chunk": chunk,
        "group_form": form.form, "probe_refusal": form.refusal,
        "solver_iterations": iterations, "executed_steps": steps,
        "sharded_launches": sharded_launches, "other_launches": stats_launches,
        "set_while_runs": while_6["set_while_runs"],
        "done_reads_per_pair": {"while": while_6["irls_done_reads"] / SHARDED_PAIRS,
                                **{name: n / SHARDED_PAIRS for name, n in reads.items()}},
        "graph_keys": len(keys), "forms_bit_equal": True, "after_restart_bit_equal": True,
        "census": census,
        "ms_per_iteration": {**{name: ms(name, iterations) for name in SHARDED_FORMS},
                             "match_pyramids": ms("single", single_iterations)},
        "sharded_ms_per_iteration": 1000.0 * sharded_s / iterations,
        "sharded_pairs_per_s": SHARDED_PAIRS / sharded_s,
        "single_pairs_per_s": SHARDED_PAIRS / single_s,
        "single_iterations": single_iterations,
        "distributed_cg": {
            "vertices": SHARDED_CG_VERTICES + 1, "gn_steps": SHARDED_CG_GN_STEPS,
            "cg_iterations": cg_runs["eager"]["k"], "chunk": pg.CG_CHUNK_STEPS,
            "set_while_runs": cg_runs["while"]["set_while_runs"], "forms_bit_equal": True,
            "ms_per_cg_iteration": {name: 1000.0 * r["seconds"] / sum(r["k"])
                                    for name, r in cg_runs.items()}},
        "mu0_levels": counts(sharded0), "mu0_pose_err": mu0_err,
        "wave_pairs": WAVE_PAIRS, "wave_pairs_not_bit_equal": wave_not_bit_equal,
        "wave_max_transform_err": wave_err,
    }
    print("phase 6:", json.dumps(summary), flush=True)
    return partials_launches, {"6_sharded": while_6["set_while_runs"],
                               "6_cg": cg_runs["while"]["set_while_runs"]}, summary


def count_sharded_kernels(cfg, intrinsics, frames):
    """Phase 6, after the timed phases: device kernels per solver iteration
    of the pixel-sharded matcher and of ``match_pyramids`` on the first
    pairs, under ``torch.profiler`` (None where it records no device
    event)."""
    import tempfile

    import torch

    from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
    from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib, sharded_alignment
    from dvo_slam_tpu_torch.tools import sharded_bench

    eye = torch.eye(4, dtype=torch.float32, device=frames[0][cfg.first_level].intensity.device)
    pairs = [(frames[k], frames[k + 1]) for k in range(PROFILED_PAIRS)]
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            run = sharded_alignment.make_pixel_sharded_matcher(cfg, intrinsics, mesh_lib.make_mesh(1))
            run(*pairs[0], eye)
            summary = {
                "pairs": PROFILED_PAIRS,
                "sharded": sharded_bench.kernels_per_iteration(
                    lambda: [run(r, c, eye) for r, c in pairs]),
                "single": sharded_bench.kernels_per_iteration(
                    lambda: [match_pyramids(cfg, intrinsics, r, c, eye) for r, c in pairs]),
            }
        finally:
            distributed.shutdown()
    print("phase 6:", json.dumps(summary), flush=True)
    return summary


def _per(numerator, ms):
    """numerator / ms, or None where the time was not measured."""
    return None if ms is None else numerator / ms


def _device_busy(fn):
    """(device busy share, wall seconds) of one call of ``fn`` under
    ``torch.profiler``, after one untimed call; the share is None (not
    measured) where the profiler recorded no device event."""
    from dvo_slam_tpu_torch.tools.gather_probe import device_time

    busy_ms, wall_ms = device_time(fn, calls=1)
    return _per(busy_ms, wall_ms), wall_ms / 1000.0


def check_batched_kernel(cfg, intrinsics, pairs):
    """Phase 7a: the batched sampled-input kernel on B streams' packs (each
    stream's first pair, at every solved level) against the single-stream
    kernel on each stream's packs (bit-equal) and against the plain twin
    (as phase 3 holds it).  Returns (rows, worst errors)."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    per_stream = [fused_check.level_inputs(cfg, intrinsics, r, c) for r, c in pairs]
    batch = len(pairs)
    dof = cfg.influence_function_param
    rows, worst = [], {}
    for level in range(cfg.first_level, cfg.last_level - 1, -1):
        k = per_stream[0][level][2]
        sampled = torch.stack([s[level][0] for s in per_stream]).contiguous()
        refpack = torch.stack([s[level][1] for s in per_stream]).contiguous()
        device = sampled.device
        scale = 1.0 + 0.1 * torch.arange(batch, dtype=torch.float32, device=device)
        p3 = torch.tensor(fused_check.CHECK_PRECISION, dtype=torch.float32, device=device) * scale[:, None]
        for first in ("0", "1", "per-stream"):
            if first == "per-stream":
                flags = (torch.arange(batch, device=device) % 2).to(torch.int32)
            else:
                flags = torch.tensor(int(first), dtype=torch.int32, device=device)
            args = (sampled, refpack, p3, flags, k, dof)
            kernel = fused_kernels.fused_stats_batched_cuda(*args)
            again = fused_kernels.fused_stats_batched_cuda(*args)
            twin = fused_kernels.fused_stats_plain(*args)
            torch.cuda.synchronize(device)
            fused_check.assert_bit_identical(kernel, again)
            not_bit_equal, abs_err, scaled_err, exact_err = 0, 0.0, 0.0, 0.0
            for b in range(batch):
                flag = flags[b] if flags.dim() else flags
                single_args = (sampled[b], refpack[b], p3[b], flag, k, dof)
                single = fused_kernels.fused_stats_cuda(*single_args)
                mine = _stream(kernel, b)
                not_bit_equal += _bits_differ(mine, single)
                a, s = fused_check.compare_fused_stats(mine, _stream(twin, b))
                e = fused_check.compare_exact_gram(mine, fused_check.exact_gram(*single_args))
                abs_err, scaled_err, exact_err = max(abs_err, a), max(scaled_err, s), max(exact_err, e)
            require(not_bit_equal == 0,
                    f"batched kernel: {not_bit_equal} outputs differ from the single-stream kernel "
                    f"(level {level}, first_iter {first})")
            for key, value in (("max_abs_err", abs_err), ("max_scaled_err", scaled_err),
                               ("max_rel_err_f64", exact_err), ("not_bit_equal_to_single", 0)):
                worst[key] = max(worst.get(key, 0), value)
            row = {"level": level, "streams": batch, "pixels": sampled.shape[2], "first_iter": first,
                   "kernel": "fused_stats_batched", "not_bit_equal_to_single": not_bit_equal,
                   "max_abs_err": abs_err, "max_scaled_err": scaled_err, "max_rel_err_f64": exact_err}
            if first == "0":
                _timed(row, lambda: fused_kernels.fused_stats_batched_cuda(*args),
                       lambda: fused_kernels.fused_stats_plain(*args))
                row["bound_ms"], row["bound_by"] = _bound(
                    _bytes(sampled, p3, flags) + _rows_bytes(refpack, 7) + batch * 4 * (256 + 1),
                    batch * sampled.shape[2] * (SAMPLED_CHAIN_FLOPS + GRAM_FLOPS))
                row["single_kernel_x_streams_ms"] = median_ms(lambda: [
                    fused_kernels.fused_stats_cuda(sampled[b], refpack[b], p3[b], flags, k, dof)
                    for b in range(batch)
                ])
            rows.append(row)
            print("phase 7:", json.dumps(row), flush=True)
    return rows, worst


SHARDED_KERNELS = ("warp_fused_partials", "sharded_loglik", "sharded_tail")


def _glue_wrappers():
    from dvo_slam_tpu_torch.ops import match_glue

    return match_glue.setup_cuda, match_glue.link_cuda, match_glue.result_cuda


def _reset_counts():
    """Every kernel's launch count (ingest's two kernels, the step and the
    glue kernels too), warp_and_sample_cm's and compute_residuals' calls,
    the IRLS loop's ``done`` reads, the while form's and the matches'
    counts to 0 (the while graphs' launches folded in first)."""
    from dvo_slam_tpu_torch.ops import ingest, irls_step
    from dvo_slam_tpu_torch.tools import driver_launches

    driver_launches.reset_counts()
    ingest.ingest_cuda.pyramid_launches = ingest.ingest_cuda.pack_launches = 0
    irls_step.step_head_cuda.launches = irls_step.step_tail_cuda.launches = 0
    for wrapper in _glue_wrappers():
        wrapper.launches = 0


def _launches():
    """{name: launches} since the last reset, with warp_and_sample_cm's calls,
    ingest's two kernels (``INGEST_COUNTS``), the step kernels
    (``STEP_COUNTS``), the glue kernels (``GLUE_COUNTS``) and the card's
    matches with their level solves (``MATCH_COUNTS``)."""
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.ops import ingest, irls_step
    from dvo_slam_tpu_torch.tools import driver_launches

    matches = irls_graph.match_counts
    return {**driver_launches.launches(),
            **dict(zip(INGEST_COUNTS, (ingest.ingest_cuda.pyramid_launches,
                                       ingest.ingest_cuda.pack_launches))),
            **dict(zip(STEP_COUNTS, (irls_step.step_head_cuda.launches,
                                     irls_step.step_tail_cuda.launches))),
            **dict(zip(GLUE_COUNTS, (w.launches for w in _glue_wrappers()))),
            **dict(zip(MATCH_COUNTS, (matches.launches + matches.per_level, matches.levels)))}


STEP_BY_PHASE = {}  # phase -> the step tail's launches of its main-path run
GLUE_BY_PHASE = {}  # phase -> the glue kernels' launches of its main-path run


def _note_steps(what, counts, evaluations=None):
    """Keep a run's step-kernel launches for the kernels line (a head with
    every tail and, where ``evaluations`` is given, one step with each),
    and its glue kernels' (``_note_glue``)."""
    from dvo_slam_tpu_torch.tools.fused_check import require

    head, tail = (counts[k] for k in STEP_COUNTS)
    require(head == tail, f"{what}: step head launches {head} != tail launches {tail}")
    require(evaluations is None or tail == evaluations,
            f"{what}: step tail launches {tail} != the evaluations {evaluations}")
    STEP_BY_PHASE[what] = STEP_BY_PHASE.get(what, 0) + tail
    _note_glue(what, counts)


def _note_glue(what, counts):
    """Keep a run's glue-kernel launches for the kernels line: each of the
    card's matches one setup and one result, and a link between each two
    of its levels (its level solves less one)."""
    from dvo_slam_tpu_torch.tools.fused_check import require

    setup, link, result = (counts[k] for k in GLUE_COUNTS)
    matches, levels = (counts[k] for k in MATCH_COUNTS)
    require(setup == result == matches and link == levels - matches,
            f"{what}: glue kernels launched {setup} setups, {link} links and {result} results "
            f"for {matches} matches of {levels} level solves")
    GLUE_BY_PHASE[what] = GLUE_BY_PHASE.get(what, 0) + setup + link + result


INGEST_BY_PHASE = {}  # phase -> (kernel A's, kernel B's launches) of its main-path run


def _note_ingest(phase, counts, frames=None):
    """Keep a phase's ingest launches for the kernels line; with ``frames``,
    require one launch of each kernel per frame."""
    from dvo_slam_tpu_torch.tools.fused_check import require

    pair = tuple(counts[k] for k in INGEST_COUNTS)
    require(frames is None or pair == (frames, frames),
            f"phase {phase}: ingest's kernels launched {pair} times for {frames} frames")
    INGEST_BY_PHASE[phase] = pair


def _chunk():
    """K: the card's IRLS loop steps per chunk (one host read per chunk)."""
    from dvo_slam_tpu_torch.models import dense_tracker

    return dense_tracker.CHUNK_STEPS


def _steps(level_stats):
    """Executed steps of the IRLS loop, which are its kernel's launches,
    for an iterable of match calls' level statistics: per level K *
    ceil(iterations / K), the slowest stream's iterations in lockstep."""
    from dvo_slam_tpu_torch.tools.driver_launches import executed_steps

    return sum(executed_steps(ls) for ls in level_stats)


def _done_reads():
    """The IRLS loop's host reads of ``done`` since the last reset, in any
    thread: the eager and host-polled forms read once per chunk, the while
    graphs never."""
    from dvo_slam_tpu_torch.models import dense_tracker

    return dense_tracker.read_done.calls


def _require_while(iterations, what, chunk=None):
    """The levels of a run ran as while graphs: ``iterations`` holds each
    level solve's iteration counts (a tensor per solve, its slowest
    stream's taken).  Since the last reset (the counts folded by
    ``_launches()``): one launch per level solve, ``set_while`` once per
    executed chunk of K = ``chunk`` steps (its head's and each tail's; by
    default the tracker's K), no read of ``done``.  Returns
    ``{"set_while_runs": n, "irls_done_reads": reads}``."""
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.tools.fused_check import require

    slowest = [int(it.max()) for it in iterations]
    chunks = sum(-(-it // (chunk or _chunk())) for it in slowest)
    counts = irls_graph.while_counts
    require(counts.launches == len(slowest) and counts.set_while == chunks > 0,
            f"{what}: {counts.launches} while-graph launches for {len(slowest)} level solves, "
            f"set_while ran {counts.set_while} times for {chunks} chunks")
    reads = _done_reads()
    require(reads == 0, f"{what}: {reads} host reads of the IRLS loop's done")
    return {"set_while_runs": counts.set_while, "irls_done_reads": reads}


def _row_stats(rows):
    """The ``LevelStats`` of a ``match_prepared_flat`` result (rows on the
    host or the card)."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker

    return dense_tracker.result_from_row(torch.as_tensor(rows)).level_stats


def _iterations(level_stats):
    """The per-level iteration tensors of an iterable of calls' level statistics."""
    return [s.iterations for ls in level_stats for s in ls]


def _require_only(counts, name, expected, what):
    """The tracker path went through kernel ``name`` ``expected`` times (its
    executed steps) and through no other statistics kernel, nor
    ``warp_and_sample_cm``."""
    from dvo_slam_tpu_torch.tools.fused_check import require

    require(counts[name] == expected > 0,
            f"{what}: {name} launches {counts[name]} != executed steps {expected}")
    kernels = ("warp_fused_stats", "warp_fused_stats_batched")
    _note_steps(what, counts, sum(counts[k] for k in kernels)
                if all(k in counts for k in kernels) else None)
    others = {k: v for k, v in counts.items()
              if k not in (name, "table_copy", *INGEST_COUNTS, *STEP_COUNTS, *GLUE_COUNTS,
                           *MATCH_COUNTS) and v}
    require(not others, f"{what}: other statistics kernels or warp_and_sample_cm ran: {others}")


def check_lockstep(cfg, intrinsics, d_i, d_d, gt, single_fps):
    """Phase 7b: B streams in lockstep.  Returns the batched folded
    kernel's launches, ``set_while``'s runs and the phase's summary."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.tools.multistream_bench import stream_ates

    run = make_multistream_tracker(cfg, intrinsics)
    run.tracks(d_i[:, :3], d_d[:, :3])  # warm-up, not counted

    _reset_counts()
    tracks, seconds = _synchronized_seconds(lambda: run.tracks(d_i, d_d))
    counts = _launches()
    _note_ingest("7", counts, d_i.shape[1])  # one launch of each a rig frame
    batched = counts["warp_fused_stats_batched"]
    slowest = tracks.iterations.amax(dim=0)  # [T-1, levels]
    steps = dense_tracker.executed_steps(slowest, _chunk())
    _require_only(counts, "warp_fused_stats_batched", steps, "lockstep")
    while_7 = _require_while(list(slowest.flatten()), "phase 7")
    ates = stream_ates(tracks.poses.cpu().numpy(), gt)
    require(np.isfinite(ates).all() and max(ates) < STREAM_ATE_GATE_M,
            f"stream ATE-RMSE {ates} (gate {STREAM_ATE_GATE_M} m)")
    iterations = tracks.iterations.cpu().numpy()  # [B, T-1, levels]
    busy, busy_wall = _device_busy(lambda: run.tracks(d_i[:, :BUSY_FRAMES], d_d[:, :BUSY_FRAMES]))
    streams, frames = d_i.shape[:2]
    fps = streams * (frames - 1) / seconds
    summary = {
        "streams": streams, "frames": frames, "seconds": seconds,
        "aggregate_frames_per_s": fps, "single_stream_frames_per_s_phase4": single_fps,
        "lockstep_iterations": tracks.loop_iterations, "executed_steps": steps,
        "chunk_steps": _chunk(), "launches": counts, "set_while_runs": while_7["set_while_runs"],
        "irls_reads_per_frame": while_7["irls_done_reads"] / (frames - 1),
        "ms_per_lockstep_iteration": 1000.0 * seconds / tracks.loop_iterations,
        "levels": list(range(cfg.first_level, cfg.last_level - 1, -1)),
        "max_over_streams_iterations_per_level": iterations.max(axis=0).sum(axis=0).tolist(),
        "sum_over_streams_iterations_per_level": iterations.sum(axis=(0, 1)).tolist(),
        "ate_rmse_m": ates, "device_busy_share": busy, "busy_window_frames": BUSY_FRAMES,
        "busy_window_s": busy_wall,
    }
    print("phase 7:", json.dumps(summary), flush=True)
    return batched, while_7["set_while_runs"], summary


def check_schedules(cfg, intrinsics, d_i, d_d):
    """Phase 8: lockstep against sequential, and the tracker on a one-rank
    NCCL mesh against the local run."""
    import tempfile

    import torch

    from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require

    sub_i = d_i[:SCHEDULE_STREAMS, :SCHEDULE_FRAMES]
    sub_d = d_d[:SCHEDULE_STREAMS, :SCHEDULE_FRAMES]
    lock = make_multistream_tracker(cfg, intrinsics).tracks(sub_i, sub_d)
    seq = make_multistream_tracker(cfg, intrinsics, schedule="sequential").tracks(sub_i, sub_d)
    differ = (lock.iterations != seq.iterations) | (lock.termination != seq.termination)
    flips = [tuple(int(i) for i in at) for at in torch.nonzero(differ).tolist()]
    require(len(flips) <= SCHEDULE_FLIP_SHARE * differ.numel(),
            f"lockstep vs sequential: {len(flips)} of {differ.numel()} stream-frame-levels differ")
    errors = _pose_errors(lock.poses.cpu().numpy(), seq.poses.cpu().numpy())
    require(errors.max() < SCHEDULE_POSE_GATE,
            f"lockstep vs sequential pose error {errors.max()} (gate {SCHEDULE_POSE_GATE})")
    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            dp = make_multistream_tracker(cfg, intrinsics, mesh_lib.make_mesh(1)).tracks(sub_i, sub_d)
        finally:
            distributed.shutdown()
    for field in ("poses", "iterations", "termination"):
        require(torch.equal(getattr(dp, field), getattr(lock, field)),
                f"one-rank mesh tracker: {field} differ from the local run")
    summary = {
        "streams": SCHEDULE_STREAMS, "frames": SCHEDULE_FRAMES,
        "stream_frame_levels": differ.numel(), "near_tie_flips": len(flips),
        "flips_at_stream_frame_level": flips, "max_pose_err": float(errors.max()),
        "lockstep_loop_iterations": lock.loop_iterations,
        "sequential_iterations": seq.loop_iterations, "mesh_equal_to_local": True,
    }
    print("phase 8:", json.dumps(summary), flush=True)
    return summary


def check_temporal(cfg, intrinsics, d_i, d_d, est, gt):
    """Phase 9: the phase-4 sequence in chunks against phase 4's trajectory."""
    from dvo_slam_tpu_torch.parallel.temporal import make_temporal_tracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    run = make_temporal_tracker(cfg, intrinsics, num_chunks=TEMPORAL_CHUNKS)
    par, seconds = _synchronized_seconds(lambda: run(d_i, d_d))
    errors = _pose_errors(est[1:], par)
    require(errors.max() < TEMPORAL_POSE_GATE,
            f"temporal vs sequential pose error {errors.max()} (gate {TEMPORAL_POSE_GATE})")
    stamps = np.arange(len(gt)) / 30.0
    ate = trajectory.ate_rmse(stamps, np.concatenate([np.eye(4)[None], par]), stamps, gt)
    summary = {"frames": len(gt), "chunks": TEMPORAL_CHUNKS, "max_pose_err": float(errors.max()),
               "ate_rmse_m": ate, "seconds": seconds}
    print("phase 9:", json.dumps(summary), flush=True)
    return summary


def _host(frame_results):
    """Per-level (iterations, termination) of results with host or device fields."""
    return [[(int(s.iterations), int(s.termination)) for s in r.level_stats] for r in frame_results]


def _raw_frames(cfg, intrinsics, d_i, d_d, count):
    """Frames 0..count-1 of a device sequence through ``Frame.from_raw``,
    prepared for ``cfg`` (the live ingest)."""
    from dvo_slam_tpu_torch.models.frames import Frame

    for k in range(count):
        yield Frame.from_raw(d_i[k], d_d[k], k / 30.0, cfg.num_levels,
                             prepare_for=(cfg, intrinsics), device=d_i.device)


def check_camera_tracker(cfg, intrinsics, d_i, d_d, odometry_results, gt, odometry_fps):
    """Phase 11: ``CameraTracker`` on phase 4's frames against phase 4.
    Returns the folded kernel's launches and the phase's summary."""
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    def run(count):
        tracker = CameraTracker(intrinsics, cfg, device=d_i.device)
        poses, results = [], []
        for frame in _raw_frames(cfg, intrinsics, d_i, d_d, count):
            poses.append(tracker.update(frame).copy())
            results.append(tracker.last_result)
        return np.asarray(poses), results[1:]

    run(3)  # warm-up, not counted
    _reset_counts()
    dense_tracker.prepare_frame.calls = 0
    (poses, results), seconds = _synchronized_seconds(lambda: run(NUM_FRAMES))
    counts, prepares = _launches(), dense_tracker.prepare_frame.calls
    iterations = sum(s.iterations for r in results for s in r.level_stats)
    steps = _steps(r.level_stats for r in results)
    _require_only(counts, "warp_fused_stats", steps, "phase 11")
    _note_ingest("11", counts, NUM_FRAMES)
    require(prepares == 0, f"phase 11: prepare_frame ran {prepares} times on the kernel route")
    expected = [r.transformation.cpu().numpy() for r in odometry_results]
    got = [r.transformation.astype(np.float32) for r in results]
    not_bit_equal = sum(not np.array_equal(a, b) for a, b in zip(got, expected))
    err = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(got, expected))
    require(err <= CAMERA_TRACKER_ATOL, f"phase 11: transforms {err} from phase 4's")
    require(_host(results) == _host(odometry_results),
            "phase 11: per-level iterations or terminations differ from phase 4's")
    stamps = np.arange(NUM_FRAMES) / 30.0
    ate = trajectory.ate_rmse(stamps, poses, stamps, gt)
    require(np.isfinite(ate), "phase 11: non-finite ATE")
    summary = {
        "frames": NUM_FRAMES, "ate_rmse_m": ate, "tracked_frames_per_s": (NUM_FRAMES - 1) / seconds,
        "phase4_tracked_frames_per_s": odometry_fps, "seconds": seconds,
        "solver_iterations": iterations, "executed_steps": steps, "launches": counts,
        "prepare_frame_calls": prepares,
        "phase4_prepare_frame_calls": 2 * (NUM_FRAMES - 1), "max_transform_err": err,
        "frames_not_bit_equal": not_bit_equal,
    }
    print("phase 11:", json.dumps(summary), flush=True)
    return counts["warp_fused_stats"], summary


def check_local_tracker(cfg, intrinsics, d_i, d_d, gt, odometry_fps):
    """Phase 12: ``LocalTracker`` and ``LocalMap`` on phase 4's frames.
    Returns (one-stream launches, batched launches, the phase's summary)."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.models.dense_tracker import match_pyramids
    from dvo_slam_tpu_torch.models.local_tracker import LocalTracker
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    checked = set(np.linspace(2, NUM_FRAMES - 1, STREAM_CHECK_FRAMES).astype(int).tolist())

    def run(count):
        tracker = LocalTracker(intrinsics, cfg, device=d_i.device)
        log = {"dual": [], "init": [], "histories": [], "lm_s": [], "dual_s": [], "ingest_s": [],
               "update_s": [], "pairs": {}}
        match_many = tracker.matcher.match_many

        def timed_match_many(requests):
            t0 = time.perf_counter()
            out = match_many(requests)  # ends in one copy to the host
            if len(requests) == 2:  # the dual match, not the initial one
                log["dual_s"].append(time.perf_counter() - t0)
            return out

        def complete(_, local_map):
            t0 = time.perf_counter()
            log["histories"].append(local_map.optimize(LOCAL_MAP_ITERATIONS))
            log["lm_s"].append(time.perf_counter() - t0)

        tracker.matcher.match_many = timed_match_many
        tracker.add_map_initialized_callback(lambda _, __, r: log["init"].append(r))
        tracker.add_map_complete_callback(complete)
        tracker.add_accept_criterion(
            lambda _, r_odo, r_kf: (log["dual"].append((r_kf, r_odo)) or True, r_odo, r_kf))
        frames = _raw_frames(cfg, intrinsics, d_i, d_d, count)
        first, second = next(frames), next(frames)
        tracker.init_new_local_map(first, second, np.eye(4))
        poses = [np.eye(4), tracker.local_map.current_frame_pose()]
        for k in range(2, count):
            t0 = time.perf_counter()
            frame = next(frames)
            t1 = time.perf_counter()
            log["ingest_s"].append(t1 - t0)
            if k % LOCAL_MAP_FRAMES == 0:
                tracker.force_complete_current_local_map()
            if k in checked:
                log["pairs"][k] = (tracker._last_frame, frame)
            poses.append(tracker.update(frame))
            log["update_s"].append(time.perf_counter() - t1)
        return np.asarray(poses), log

    run(4)  # warm-up, not counted
    _reset_counts()
    (poses, log), seconds = _synchronized_seconds(lambda: run(NUM_FRAMES))
    counts = _launches()
    _note_ingest("12", counts, NUM_FRAMES)
    init_iterations = sum(s.iterations for s in log["init"][0].level_stats)
    slowest = [max(a.iterations, b.iterations) for r_kf, r_odo in log["dual"]
               for a, b in zip(r_kf.level_stats, r_odo.level_stats)]
    lockstep = sum(slowest)
    init_steps = _steps([log["init"][0].level_stats])
    dual_steps = dense_tracker.executed_steps(slowest, _chunk())
    require(counts["warp_fused_stats"] == init_steps > 0,
            f"phase 12: one-stream launches {counts['warp_fused_stats']} != the initial "
            f"match's executed steps {init_steps}")
    _require_only({k: v for k, v in counts.items() if k != "warp_fused_stats"},
                  "warp_fused_stats_batched", dual_steps, "phase 12")
    completed = len(log["histories"])
    require(completed == (NUM_FRAMES - 1) // LOCAL_MAP_FRAMES, f"phase 12: {completed} maps completed")
    for h in log["histories"]:
        require(np.isfinite(h).all() and (np.diff(h) <= 1e-9 * np.maximum(h[:-1], 1.0)).all(),
                f"phase 12: chi2 history not finite and non-increasing: {h.tolist()}")

    # stream 1 of the dual match against a one-stream match of the pair
    flips, stream_err = 0, 0.0
    for k, (last, frame) in sorted(log["pairs"].items()):
        one = match_pyramids(cfg, intrinsics, last.levels, frame.levels,
                             torch.eye(4, device=d_i.device))
        r_odo = log["dual"][k - 2][1]
        flips += _host([r_odo]) != _host([one])
        stream_err = max(stream_err, float(np.abs(
            r_odo.transformation - one.transformation.cpu().numpy()).max()))
    require(stream_err <= STREAM_ATOL, f"phase 12: stream 1 {stream_err} from one-stream matches")
    require(flips <= 1, f"phase 12: {flips} of {len(log['pairs'])} checked frames flip")

    stamps = np.arange(NUM_FRAMES) / 30.0
    ate = trajectory.ate_rmse(stamps, poses, stamps, gt)
    require(ate < HARD_ATE_GATE_M, f"phase 12: ATE-RMSE {ate} m >= {HARD_ATE_GATE_M} m")
    updates = NUM_FRAMES - 2
    dual_ms = 1000.0 * float(np.sum(log["dual_s"])) / updates
    lm_total_ms = 1000.0 * float(np.sum(log["lm_s"]))
    update_ms = 1000.0 * float(np.sum(log["update_s"])) / updates
    summary = {
        "frames": NUM_FRAMES, "ate_rmse_m": ate, "tracked_frames_per_s": (NUM_FRAMES - 1) / seconds,
        "phase4_tracked_frames_per_s": odometry_fps, "seconds": seconds,
        "maps_completed": completed, "launches": counts,
        "initial_match_iterations": init_iterations, "dual_lockstep_iterations": lockstep,
        "initial_match_steps": init_steps, "dual_steps": dual_steps,
        "dual_stream_iterations": sum(s.iterations for pair in log["dual"] for r in pair
                                      for s in r.level_stats),
        "ms_per_frame": {
            "ingest": 1000.0 * float(np.sum(log["ingest_s"])) / updates,
            "dual_match": dual_ms,
            "host_decision": update_ms - dual_ms - lm_total_ms / updates,
            "lm_solve_amortized": lm_total_ms / updates,
        },
        "ms_per_lm_solve": lm_total_ms / max(completed, 1),
        "chi2_first_last": [[float(h[0]), float(h[-1])] for h in log["histories"]],
        "stream1_checked_frames": sorted(log["pairs"]), "stream1_flips": flips,
        "stream1_max_transform_err": stream_err,
    }
    print("phase 12:", json.dumps(summary), flush=True)
    return counts["warp_fused_stats"], counts["warp_fused_stats_batched"], summary


def time_batched_kernel(cfg, intrinsics, pairs, level, shape_name):
    """The batched folded kernel on B = len(pairs) streams (reference
    pyramid, current pyramid) at ``level``, each warped by the check twist,
    against its plain version: the largest error on each quantity's rounding
    scale, wrapper, device and plain times, and the bound.  Returns the row."""
    import torch

    from dvo_slam_tpu_torch.ops import fused_kernels
    from dvo_slam_tpu_torch.tools import fused_check

    inputs = [fused_check.warp_level_inputs(cfg, intrinsics, ref, cur)[level]
              for ref, cur in pairs]
    device = inputs[0].refpack.device
    P = torch.tensor(CHECK_P_PREV, dtype=torch.float32, device=device)
    stack = lambda field: torch.stack([getattr(i, field) for i in inputs]).contiguous()  # noqa: E731
    args = (stack("refpack"), stack("quad"), inputs[0].shape, inputs[0].intrinsics, stack("T"),
            torch.stack([P] * len(pairs)), False, cfg.influence_function_param, True)
    row = {"level": level, "streams": len(pairs), "pixels": inputs[0].refpack.shape[1],
           "kernel": "warp_fused_stats_batched", "shape": shape_name}
    kernel = fused_kernels.warp_fused_stats_batched_cuda(*args)
    plain = fused_kernels.warp_fused_stats_plain(*args)
    row["max_scaled_err"] = fused_check.compare_warp_fused_stats(kernel, plain)
    _timed(row, lambda: fused_kernels.warp_fused_stats_batched_cuda(*args),
           lambda: fused_kernels.warp_fused_stats_plain(*args))
    row["device_ms"] = device_ms(lambda: fused_kernels.warp_fused_stats_batched_cuda(*args))
    row["plain_device_ms"] = device_ms(lambda: fused_kernels.warp_fused_stats_plain(*args))
    row["bound_ms"], row["bound_by"] = _bound(
        _rows_bytes(args[0], 7) + _quad_bytes(*args[:5]) + _bytes(args[4], args[5], *kernel),
        len(pairs) * inputs[0].refpack.shape[1] * (CHAIN_FLOPS + GRAM_FLOPS))
    return row


def time_dual_kernel(cfg, intrinsics, frames):
    """Phase 12b: the batched folded kernel at the dual match's shape, L1:
    frames 0 and 1 as references against frame 2 (its table stacked twice)."""
    row = time_batched_kernel(cfg, intrinsics, [(frames[0], frames[2]), (frames[1], frames[2])],
                              cfg.last_level, "dual match")
    print("phase 12:", json.dumps(row), flush=True)
    return row


def _percentiles(ms):
    """bench.py:379-386's latency keys."""
    ms = np.asarray(ms, np.float64)
    if ms.size == 0:
        return None
    return {"p50": float(np.percentile(ms, 50)), "p90": float(np.percentile(ms, 90)),
            "p99": float(np.percentile(ms, 99)), "mean": float(ms.mean()), "max": float(ms.max()),
            "frames": int(ms.size)}


def check_keyframe_tracker(slam_cfg, intrinsics, d_i, d_d, gt):
    """Phase 13: ``KeyframeTracker`` (the SLAM system: front end, keyframe
    graph on its worker thread, loop-closure waves, final optimization) on
    phase 5's frames.  Returns (kernel 1 launches, kernel 1b launches, the
    wave-shape rows of kernel 1b, the phase's summary)."""
    import copy
    import threading
    import warnings

    import torch

    from dvo_slam_tpu_torch.models import frames as frames_mod
    from dvo_slam_tpu_torch.models import pose_graph
    from dvo_slam_tpu_torch.models.keyframe_tracker import KeyframeTracker
    from dvo_slam_tpu_torch.ops import se3
    from dvo_slam_tpu_torch.tools.driver_launches import lockstep_iterations, streams
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    calls, waves, optimizes, snapshots = [], [], [], []
    in_wave = threading.local()
    match_flat = frames_mod.match_prepared_flat
    match_pairs = frames_mod.TwoStageMatcher.match_pairs
    optimize = pose_graph.PoseGraph.optimize
    set_levels = pose_graph.PoseGraph.set_all_edge_levels

    def counted_match(cfg, k, ref, cur, initial=None, *args, **kwargs):
        rows = match_flat(cfg, k, ref, cur, initial, *args, **kwargs)
        calls.append((getattr(in_wave, "on", False), _row_stats(rows)))
        return rows

    def counted_pairs(self, requests):
        outer = not getattr(in_wave, "on", False)
        if outer:
            waves.append([(r[0], r[1]) for r in requests])
        in_wave.on = True
        try:
            return match_pairs(self, requests)
        finally:
            in_wave.on = not outer

    def recorded_optimize(self, *args, **kwargs):
        t0 = time.perf_counter()
        history = optimize(self, *args, **kwargs)
        optimizes.append((history, self.last_solver, time.perf_counter() - t0,
                          self.num_vertices))
        return history

    def snapshot_levels(self, level):
        set_levels(self, level)
        snapshots.append(copy.deepcopy(self))  # the final pass's starting state

    tracker = KeyframeTracker(intrinsics, slam_cfg, device=d_i.device)
    require(tracker.graph._thread is not None, "phase 13: the graph worker thread is off")
    keyframe_frames = []
    tracker.lt.add_map_complete_callback(lambda _, m: keyframe_frames.append(True))
    latency, events = [], []
    online = []
    mp_attrs = ((frames_mod, "match_prepared_flat", counted_match),
                (frames_mod.TwoStageMatcher, "match_pairs", counted_pairs),
                (pose_graph.PoseGraph, "optimize", recorded_optimize),
                (pose_graph.PoseGraph, "set_all_edge_levels", snapshot_levels))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in mp_attrs]
    for obj, name, fn in mp_attrs:
        setattr(obj, name, fn)
    _reset_counts()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tracker.init()
            for k in range(NUM_FRAMES):
                before = len(keyframe_frames)
                t1 = time.perf_counter()
                if k == NUM_FRAMES - 1:
                    tracker.force_keyframe()  # benchmark_slam.cpp:477-481 (phase 14's force_last)
                online.append(tracker.update(tracker.make_frame_raw(d_i[k], d_d[k], k / 30.0)))
                latency.append(1000.0 * (time.perf_counter() - t1))
                events.append(len(keyframe_frames) > before)
            t_track = time.perf_counter() - t0
            tracker.finish()
            stamps, poses = tracker.trajectory()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            tracker.graph.shutdown()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    counts = _launches()
    _note_ingest("13", counts, NUM_FRAMES)
    fallbacks = [str(w.message) for w in caught if "falling back" in str(w.message)]
    require(not fallbacks, f"phase 13: a graph solve fell back: {fallbacks}")

    # the kernels' launches against the solves' executed steps
    one_stream = sum(lockstep_iterations(ls) for wave, ls in calls if streams(ls) == 1)
    dual = sum(lockstep_iterations(ls) for wave, ls in calls if not wave and streams(ls) > 1)
    wave_iterations = sum(lockstep_iterations(ls) for wave, ls in calls if wave)
    one_steps = _steps(ls for wave, ls in calls if streams(ls) == 1)
    batched_steps = _steps(ls for wave, ls in calls if streams(ls) > 1)
    require(counts["warp_fused_stats"] == one_steps > 0,
            f"phase 13: kernel 1 launches {counts['warp_fused_stats']} != the initial match's "
            f"executed steps {one_steps}")
    _require_only({k: v for k, v in counts.items() if k != "warp_fused_stats"},
                  "warp_fused_stats_batched", batched_steps, "phase 13")
    require(wave_iterations > 0 and waves, "phase 13: no validation wave ran")

    # accuracy and the back end's results
    stamps_gt = np.arange(NUM_FRAMES) / 30.0
    online = np.asarray(online, np.float64)
    online_ate = trajectory.ate_rmse(stamps_gt, online, stamps_gt, gt)
    graph_ate = trajectory.ate_rmse(stamps, poses, stamps_gt, gt)
    require(len(stamps) == NUM_FRAMES and np.isfinite(poses).all(),
            f"phase 13: trajectory of {len(stamps)} frames")
    require(online_ate < ONLINE_ATE_GATE_M, f"phase 13: online ATE {online_ate} m")
    require(graph_ate < E2E_ATE_GATE_M, f"phase 13: graph ATE {graph_ate} m")
    for history, route, _, _ in optimizes:
        require(np.isfinite(history).all(), f"phase 13: non-finite chi2 ({route}): {history}")
    graph = tracker.graph.graph
    loops = int(graph.robust[: graph.num_edges].sum())
    final_routes = sorted({route for _, route, _, n in optimizes[-10:]})

    # the host routes from the final pass's starting state
    require(len(snapshots) == 1, f"phase 13: {len(snapshots)} final-pass snapshots")
    cross = {}
    iterations = max(slam_cfg.graph.final_optimization_iterations // 10, 1)
    solved = {}
    for route in ("dense", "sparse", "schur", "cg"):
        g = copy.deepcopy(snapshots[0])
        t1 = time.perf_counter()
        h = optimize(g, iterations, solver=route, tol=slam_cfg.graph.optimization_tol)
        solved[route] = g
        cross[route] = {"took": g.last_solver, "ms": 1000.0 * (time.perf_counter() - t1),
                        "chi2_first_last": [float(h[0]), float(h[-1])] if len(h) else None}
    n = snapshots[0].num_vertices
    for route, gate in ROUTE_GATES.items():
        rel = np.linalg.inv(solved["dense"].poses[:n].astype(np.float64)) @ solved[
            route].poses[:n].astype(np.float64)
        err = float(torch.abs(se3.log_se3(torch.from_numpy(rel))).max())
        cross[route]["max_log_err_vs_dense"] = err
        require(err <= gate, f"phase 13: the {route} route {err} from dense (gate {gate})")

    # kernel 1b at the largest wave's shape, coarse (level 3) and fine (L1)
    biggest = max(waves, key=len)[:frames_mod.TwoStageMatcher.MAX_PAIRS]
    pairs = [(r.levels, c.levels) for r, c in biggest] + [(c.levels, r.levels) for r, c in biggest]
    tcfg = slam_cfg.tracker
    wave_rows = [time_batched_kernel(tcfg, intrinsics, pairs, level, name)
                 for level, name in ((tcfg.first_level, "validation wave, coarse"),
                                     (tcfg.last_level, "validation wave, fine"))]
    for row in wave_rows:
        print("phase 13:", json.dumps(row), flush=True)

    keyframe_ms = [ms for ms, e in zip(latency[2:], events[2:]) if e]
    other_ms = [ms for ms, e in zip(latency[2:], events[2:]) if not e]
    timers = tracker.graph.timers.summary()
    summary = {
        "frames": NUM_FRAMES, "seconds": seconds, "tracking_seconds": t_track,
        "tracked_frames_per_s": NUM_FRAMES / t_track, "e2e_frames_per_s": NUM_FRAMES / seconds,
        "online_ate_rmse_m": online_ate, "graph_ate_rmse_m": graph_ate,
        "keyframes": len(tracker.graph.keyframes), "loop_edges": loops,
        "waves_pairs": [len(w) for w in waves],
        "wave_batch_sizes": [streams(ls) for wave, ls in calls if wave][::2],
        "launches": counts,
        "initial_match_iterations": one_stream, "dual_lockstep_iterations": dual,
        "wave_lockstep_iterations": wave_iterations,
        "executed_steps": {"kernel_1": one_steps, "kernel_1b": batched_steps},
        "online_latency_ms": _percentiles(latency[2:]),
        "online_latency_ms_keyframe_event": _percentiles(keyframe_ms),
        "online_latency_ms_no_event": _percentiles(other_ms),
        "backend_phase_ms_per_frame": {
            name: 1000.0 * t["total_s"] / NUM_FRAMES for name, t in timers.items()},
        "graph_solves": len(optimizes), "final_pass_routes": final_routes,
        "final_pass_vertices": n, "host_routes": cross,
    }
    print("phase 13:", json.dumps(summary), flush=True)
    return (counts["warp_fused_stats"], counts["warp_fused_stats_batched"], wave_rows, summary,
            online)


def check_streaming(slam_cfg, intrinsics, hard_i, hard_d, gt, online13, keyframes13):
    """Phase 14: ``StreamingSLAM`` (the scanned front end, its host-reduced
    ingest and the replayed back end) on phase 5's frames, pipelined and
    monolithic, against phase 13; then the benchmark CLI's streaming engine.
    Returns ({run: (kernel 1 launches, kernel 1b launches, set_while's
    runs)}, the summary)."""
    import contextlib
    import io
    import tempfile
    import threading
    import warnings

    from dvo_slam_tpu_torch import native
    from dvo_slam_tpu_torch.cli import benchmark as cli
    from dvo_slam_tpu_torch.models import frames as frames_mod
    from dvo_slam_tpu_torch.models import pose_graph, streaming
    from dvo_slam_tpu_torch.tools.driver_launches import lockstep_iterations, streams
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import interactive_viz, trajectory

    calls, optimizes, viewer = [], [], {}
    in_wave = threading.local()
    frontend_match = streaming.match_prepared
    wave_match = frames_mod.match_prepared_flat
    match_pairs = frames_mod.TwoStageMatcher.match_pairs
    optimize = pose_graph.PoseGraph.optimize

    def counted_frontend(cfg, k, ref, cur, initial=None, *args, **kwargs):
        result = frontend_match(cfg, k, ref, cur, initial, *args, **kwargs)
        calls.append(("frontend", result.level_stats))
        return result

    def counted_wave(cfg, k, ref, cur, initial=None, *args, **kwargs):
        rows = wave_match(cfg, k, ref, cur, initial, *args, **kwargs)
        calls.append(("wave" if getattr(in_wave, "on", False) else "other", _row_stats(rows)))
        return rows

    def counted_pairs(self, requests):
        outer = not getattr(in_wave, "on", False)
        in_wave.on = True
        try:
            return match_pairs(self, requests)
        finally:
            in_wave.on = not outer

    def recorded_optimize(self, *args, **kwargs):
        history = optimize(self, *args, **kwargs)
        optimizes.append((history, self.last_solver))
        return history

    export = interactive_viz.export_interactive_graph

    def watched_export(path, keyframe_graph, *args, **kwargs):
        """The CLI's viewer export, timed, with the graph it exported."""
        t0 = time.perf_counter()
        out = export(path, keyframe_graph, *args, **kwargs)
        viewer.update(seconds=time.perf_counter() - t0, graph=keyframe_graph)
        return out

    def expected_launches(what):
        """(kernel 1, kernel 1b) launches the recorded solves imply: their
        executed steps."""
        one = _steps(ls for _, ls in calls if streams(ls) == 1)
        batched = _steps(ls for _, ls in calls if streams(ls) > 1)
        others = [kind for kind, ls in calls if kind == "other"]
        require(not others, f"{what}: {len(others)} matches outside the front end and the waves")
        return one, batched

    mp_attrs = ((streaming, "match_prepared", counted_frontend),
                (frames_mod, "match_prepared_flat", counted_wave),
                (frames_mod.TwoStageMatcher, "match_pairs", counted_pairs),
                (pose_graph.PoseGraph, "optimize", recorded_optimize),
                (interactive_viz, "export_interactive_graph", watched_export))
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in mp_attrs]
    for obj, name, fn in mp_attrs:
        setattr(obj, name, fn)
    stamps_gt = np.arange(NUM_FRAMES) / 30.0
    runs, seconds, times = {}, {}, {"frontend_s": 0.0, "feed_s": 0.0}
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            # the pipelined form (bench.py's e2e section): chunk k's records
            # feed the back end once chunk k+1 has run
            slam = streaming.StreamingSLAM(intrinsics, slam_cfg)
            run_first, run_cont = slam._chunked_runs()

            def timed(fn):
                def run(*args):
                    t0 = time.perf_counter()
                    out = fn(*args)
                    times["frontend_s"] += time.perf_counter() - t0
                    return out
                return run

            feed = streaming._ReplayFeeder.feed

            def timed_feed(self, rec):
                t0 = time.perf_counter()
                feed(self, rec)
                times["feed_s"] += time.perf_counter() - t0

            slam._chunked = (timed(run_first), timed(run_cont))
            streaming._ReplayFeeder.feed = timed_feed
            calls.clear()
            _reset_counts()
            try:
                online, seconds["pipelined"] = _synchronized_seconds(lambda: slam.track_sequence(
                    hard_i, hard_d, stamps_gt, pipeline_chunk=STREAM_PIPELINE_CHUNK))
            finally:
                streaming._ReplayFeeder.feed = feed
            runs["pipelined"] = (_launches(), expected_launches("phase 14 pipelined"), list(calls),
                                 _require_while(_iterations(ls for _, ls in calls), "phase 14 pipelined"))
            ingest = {"level": slam.ingest_level, "path": streaming.host_reduce_ingest.last_path,
                      "why_not_native": streaming.host_reduce_ingest.last_reason,
                      "native_build_error": native.build_error()}
            stamps, poses = slam.trajectory()
            timers = slam.graph.timers.summary()
            keyframes = len(slam.graph.keyframes)
            graph = slam.graph.graph
            loops = int(graph.robust[: graph.num_edges].sum())
            slam.graph.shutdown()

            # the monolithic form: one front-end run, one copy of the records
            mono = streaming.StreamingSLAM(intrinsics, slam_cfg)
            calls.clear()
            _reset_counts()
            (records, mono_online), seconds["monolithic_frontend"] = _synchronized_seconds(
                lambda: mono.track_frontend(hard_i, hard_d))
            runs["monolithic"] = (_launches(), expected_launches("phase 14 monolithic"), list(calls),
                                 _require_while(_iterations(ls for _, ls in calls), "phase 14 monolithic"))
            mono.graph.shutdown()

            # the CLI's streaming engine on the card, at the default 480x640,
            # with the interactive viewer: the slice's main path
            with tempfile.TemporaryDirectory() as out_dir:
                out = io.StringIO()
                calls.clear()
                _reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc = cli.main(["--synthetic", str(CLI_FRAMES), "--engine", "streaming",
                                   "--timing", "--interactive-html", VIEWER_FILE,
                                   "--output-dir", out_dir])
                cli_seconds = time.perf_counter() - t0
                runs["cli"] = (_launches(), expected_launches("phase 14 CLI"), list(calls),
                                 _require_while(_iterations(ls for _, ls in calls), "phase 14 CLI"))
                report = json.loads(out.getvalue())
                written = sorted(os.listdir(out_dir))
                with open(os.path.join(out_dir, VIEWER_FILE)) as f:
                    html = f.read()
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)
    fallbacks = [str(w.message) for w in caught if "falling back" in str(w.message)]
    require(not fallbacks, f"phase 14: a graph solve fell back: {fallbacks}")

    launches = {}
    for name, (counts, (one, batched), _, _) in runs.items():
        require(counts["warp_fused_stats"] == one > 0,
                f"phase 14 {name}: kernel 1 launches {counts['warp_fused_stats']} != the "
                f"bootstrap's executed steps {one}")
        _require_only({k: v for k, v in counts.items() if k != "warp_fused_stats"},
                      "warp_fused_stats_batched", batched, f"phase 14 {name}")
        _note_ingest(f"14_{name}", counts)
        launches[name] = (counts["warp_fused_stats"], counts["warp_fused_stats_batched"],
                          runs[name][3]["set_while_runs"])
    pipelined_calls = runs["pipelined"][2]
    wave_iterations = sum(lockstep_iterations(ls) for kind, ls in pipelined_calls if kind == "wave")
    require(wave_iterations > 0, "phase 14: no validation wave ran")

    # the two forms' records bit-equal; the decisions and poses of phase 13
    require(len(records) == len(slam.records) == NUM_FRAMES, "phase 14: record count")
    differ = [k for k, (a, b) in enumerate(zip(slam.records, records))
              if not all(np.array_equal(x, y) for x, y in zip(a, b))]
    require(not differ, f"phase 14: pipelined records differ from monolithic at frames {differ}")
    require(np.array_equal(online, mono_online), "phase 14: pipelined poses differ from monolithic")
    pose_err = float(np.abs(online - np.asarray(online13, np.float64)).max())
    require(pose_err <= STREAMING_VS_TRACKER_ATOL,
            f"phase 14: online poses {pose_err} from phase 13's (gate {STREAMING_VS_TRACKER_ATOL})")
    switches = sum(not r.accept for r in records[2:])
    require(keyframes == keyframes13 == switches + 1,
            f"phase 14: {keyframes} keyframes, phase 13 {keyframes13}, switches + 1 = {switches + 1}")
    online_ate = trajectory.ate_rmse(stamps_gt, online, stamps_gt, gt)
    graph_ate = trajectory.ate_rmse(stamps, poses, stamps_gt, gt)
    require(len(stamps) == NUM_FRAMES and np.isfinite(poses).all(),
            f"phase 14: trajectory of {len(stamps)} frames")
    require(online_ate < ONLINE_ATE_GATE_M, f"phase 14: online ATE {online_ate} m")
    require(graph_ate < E2E_ATE_GATE_M, f"phase 14: graph ATE {graph_ate} m")
    for history, route in optimizes:
        require(np.isfinite(history).all(), f"phase 14: non-finite chi2 ({route}): {history}")

    frontend_iterations = {
        name: sum(lockstep_iterations(ls) for kind, ls in run[2] if kind == "frontend")
        for name, run in runs.items()}
    chunks = -(-NUM_FRAMES // STREAM_PIPELINE_CHUNK)

    require(rc == 0, f"phase 14: the CLI exited {rc}")
    ate_keys = ("ate_rmse_m", "ate_rmse_optimized_m", "rpe_translational_m", "rpe_rotational_rad")
    require(all(np.isfinite(report.get(k, np.nan)) for k in ate_keys) and
            report["frames"] == CLI_FRAMES, f"phase 14: CLI report {report}")
    viewer_summary = check_viewer(html, written, viewer)

    summary = {
        "frames": NUM_FRAMES, "pipeline_chunk": STREAM_PIPELINE_CHUNK, "ingest": ingest,
        "keyframes": keyframes, "phase13_keyframes": keyframes13, "loop_edges": loops,
        "online_ate_rmse_m": online_ate, "graph_ate_rmse_m": graph_ate,
        "max_pose_err_vs_phase13": pose_err,
        "e2e_frames_per_s": NUM_FRAMES / seconds["pipelined"],
        "e2e_seconds": seconds["pipelined"],
        "tracked_frames_per_s": NUM_FRAMES / seconds["monolithic_frontend"],
        "monolithic_frontend_seconds": seconds["monolithic_frontend"],
        "pipelined_split_s": {"frontend_runs": times["frontend_s"],
                              "record_feed": times["feed_s"],
                              "final_optimization": timers.get("final_optimization", {}).get(
                                  "total_s")},
        "backend_phase_ms_per_frame": {
            name: 1000.0 * t["total_s"] / NUM_FRAMES for name, t in timers.items()},
        "launches": {name: run[0] for name, run in runs.items()},
        "frontend_lockstep_iterations": frontend_iterations,
        "wave_lockstep_iterations": wave_iterations, "chunk_steps": _chunk(),
        "set_while_runs": {name: run[3]["set_while_runs"] for name, run in runs.items()},
        "host_readbacks_per_frame": {
            "irls_done_reads": runs["pipelined"][3]["irls_done_reads"] / NUM_FRAMES,
            "record_copies": chunks / NUM_FRAMES},
        "graph_solves": len(optimizes),
        "records_sha256": _records_digest(records),
        "cli": {"frames": CLI_FRAMES, "seconds": cli_seconds, "written": written,
                **{k: report[k] for k in ate_keys}, "viewer": viewer_summary},
    }
    print("phase 14:", json.dumps(summary), flush=True)
    return launches, summary


def check_viewer(html, written, viewer):
    """Phase 14's interactive viewer: written atomically (no temporary file
    left), its embedded payload parses, one keyframe entry per keyframe of
    the graph the CLI exported, and an error grid for each of the worst-k
    ranked loop edges whose keyframes hold pyramid levels.  Returns the
    summary."""
    import re

    from dvo_slam_tpu_torch.tools.fused_check import require

    require(VIEWER_FILE in written and VIEWER_FILE + ".tmp" not in written and "graph" in viewer,
            f"phase 14: viewer files {written}")
    match = re.search(r"const D = (.*?);\n", html)
    require("<canvas" in html and match is not None, "phase 14: the viewer has no payload")
    payload = json.loads(match.group(1))
    graph = viewer["graph"]
    require(len(payload["keyframes"]) == len(graph.keyframes) > 0,
            f"phase 14: viewer keyframes {len(payload['keyframes'])} != {len(graph.keyframes)}")
    # the worst-k ranking of interactive_viz._edge_error_payload (k = 5, level 0)
    g = graph.graph
    _, chi2 = graph.edge_errors()
    by_id = {k.id: k for k in graph.keyframes}
    idx_of = {g.vertex_index(("kf", kid)): kid for kid in by_id}
    ranked = sorted(((float(chi2[k]), k, idx_of[int(g.edge_i[k])], idx_of[int(g.edge_j[k])])
                     for k in range(g.num_edges)
                     if g.edge_active[k] and g.robust[k]
                     and int(g.edge_i[k]) in idx_of and int(g.edge_j[k]) in idx_of),
                    reverse=True)[:5]
    with_levels = sorted(str(k) for _, k, a, b in ranked
                         if all(by_id[x].frame.levels is not None
                                and by_id[x].frame.levels[0] is not None for x in (a, b)))
    require(sorted(payload["errimgs"]) == with_levels,
            f"phase 14: viewer error grids {sorted(payload['errimgs'])} != {with_levels}")
    return {"keyframes": len(payload["keyframes"]), "edges": len(payload["edges"]),
            "ranked_loop_edges": len(ranked), "error_grids": len(payload["errimgs"]),
            "clouds": len(payload["clouds"]), "bytes": len(html),
            "export_seconds": viewer["seconds"]}


def _records_digest(records):
    """sha256 of a front end's decoded records (every field as float64), to
    compare runs of two trees."""
    import hashlib

    flat = [np.ravel(np.asarray(x, np.float64)) for r in records for x in r]
    return hashlib.sha256(np.concatenate(flat).tobytes()).hexdigest()


def check_recorded_sequence(slam_cfg, hard_i, hard_d, gt):
    """Phase 18: phase 5's frames written as a TUM directory by the port's
    PNG writer, decoded back (serially and through the prefetcher), reduced
    natively, then through the benchmark CLI's three engines with
    ``--dataset``.  Returns ({run: (kernel 1 launches, kernel 1b launches)},
    the summary)."""
    import importlib.util
    import tempfile
    import zlib

    from dvo_slam_tpu_torch import native
    from dvo_slam_tpu_torch.models import streaming
    from dvo_slam_tpu_torch.ops.camera import TUM_FR1
    from dvo_slam_tpu_torch.tools import recorded_sequence as rs
    from dvo_slam_tpu_torch.tools.fused_check import require

    t_phase = time.perf_counter()
    build = {"cv2_importable": importlib.util.find_spec("cv2") is not None,
             "zlib_runtime": zlib.ZLIB_RUNTIME_VERSION, "build_error": native.build_error(),
             "library": native.library_path()}
    print("phase 18:", json.dumps(build), flush=True)
    require(build["build_error"] is None, f"phase 18: the native ingest did not build: {build}")

    decoded = []  # every native decode of a frame pair, the CLI's included
    load = native.load_rgbd_native

    def counted_load(*args, **kwargs):
        decoded.append(args[0])
        return load(*args, **kwargs)

    kept = {}  # what the CLI's streaming engine handed StreamingSLAM and got back
    track = streaming.StreamingSLAM.track_sequence
    traj = streaming.StreamingSLAM.trajectory

    def kept_track(self, iu8, du16, stamps, *args, **kwargs):
        est = track(self, iu8, du16, stamps, *args, **kwargs)
        kept.update(iu8=iu8.copy(), du16=du16.copy(), stamps=np.asarray(stamps), est=est)
        return est

    def kept_trajectory(self):
        out = traj(self)
        kept["trajectory"] = out
        return out

    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "rgbd_dataset_fr1_synthetic")
        # every row cycles the five filters, so every unfilter path decodes
        written = rs.write_sequence(root, hard_i, hard_d, gt, filters="cycle",
                                    workers=RENDER_WORKERS)
        decode = rs.check_decode(root, hard_i, hard_d)
        reduce = rs.time_reduction(hard_i, hard_d, slam_cfg.tracker.last_level)
        require(reduce["path"] == "native", f"phase 18: the reduction took {reduce}")
        native.load_rgbd_native = counted_load
        streaming.StreamingSLAM.track_sequence = kept_track
        streaming.StreamingSLAM.trajectory = kept_trajectory
        try:
            for engine in ("odometry", "keyframe", "streaming"):
                decoded.clear()
                _reset_counts()
                runs[engine] = rs.run_engine(root, engine, os.path.join(tmp, engine))
                runs[engine]["native_decodes"] = len(decoded)
        finally:
            native.load_rgbd_native = load
            streaming.StreamingSLAM.track_sequence = track
            streaming.StreamingSLAM.trajectory = traj
        ingest_path = streaming.host_reduce_ingest.last_path

    for engine, run in runs.items():
        require(run["rc"] == 0, f"phase 18 {engine}: the CLI exited {run['rc']}")
        require(run["native_decodes"] >= NUM_FRAMES,
                f"phase 18 {engine}: {run['native_decodes']} native decodes (cv2 taken?)")
        require(not run["fallbacks"], f"phase 18 {engine}: a graph solve fell back: "
                f"{run['fallbacks']}")
        one, batched = run["launches"]["warp_fused_stats"], run["launches"][
            "warp_fused_stats_batched"]
        require(one == run["one_steps"] and batched == run["batched_steps"],
                f"phase 18 {engine}: launches {run['launches']} != executed steps "
                f"{run['one_steps']} / {run['batched_steps']}")
        require(one > 0 and (batched > 0) == (engine != "odometry"),
                f"phase 18 {engine}: launches {run['launches']}")
        require(not run["other_launches"],
                f"phase 18 {engine}: other kernels or warp_and_sample_cm ran: {run['other_launches']}")
        launches[engine] = (one, batched)
        require(run["report"]["frames"] == NUM_FRAMES, f"phase 18 {engine}: {run['report']}")
    require(runs["odometry"]["report"]["ate_rmse_m"] < HARD_ATE_GATE_M,
            f"phase 18: odometry ATE {runs['odometry']['report']['ate_rmse_m']} m")
    for engine in ("keyframe", "streaming"):
        report = runs[engine]["report"]
        require(report["ate_rmse_m"] < ONLINE_ATE_GATE_M and
                report["ate_rmse_optimized_m"] < E2E_ATE_GATE_M,
                f"phase 18 {engine}: online ATE {report['ate_rmse_m']} m, graph ATE "
                f"{report['ate_rmse_optimized_m']} m")
    require(ingest_path == "native", f"phase 18: the streaming engine's ingest took {ingest_path}")

    # (a) the CLI's streaming engine against StreamingSLAM in this process on
    # the same u8 frames and the CLI's u16 round trip of the loader's float
    # depth, applied here on purpose: it is the reference's defect
    # (cli/benchmark.py:137), which truncates 4,580 of the 65,535 values
    stamps = np.array([float(f"{k / 30.0:.6f}") for k in range(NUM_FRAMES)])
    require(np.array_equal(kept["iu8"], hard_i) and
            np.array_equal(kept["du16"], rs.roundtrip_u16(hard_d)) and
            np.array_equal(kept["stamps"], stamps),
            "phase 18: the CLI handed StreamingSLAM other frames than the round trip gives")
    slam = streaming.StreamingSLAM(TUM_FR1, slam_cfg)
    _reset_counts()
    with rs.counted_solves() as calls:
        est = slam.track_sequence(hard_i, rs.roundtrip_u16(hard_d), stamps)
        trajectory_in_process = slam.trajectory()
    slam.graph.shutdown()
    counts = _launches()
    _note_ingest("18_in_process", counts)
    steps = rs.steps_of(calls)
    require(counts["warp_fused_stats"] == steps["one_steps"] > 0 and
            counts["warp_fused_stats_batched"] == steps["batched_steps"] > 0,
            f"phase 18 in-process: launches {counts} != executed steps {steps}")
    launches["in_process"] = (counts["warp_fused_stats"], counts["warp_fused_stats_batched"])
    require(np.array_equal(est, kept["est"]), "phase 18: the CLI's online poses differ from "
            "the in-process StreamingSLAM's")
    require(all(np.array_equal(a, b) for a, b in zip(trajectory_in_process, kept["trajectory"])),
            "phase 18: the CLI's optimized trajectory differs from the in-process one")

    summary = {
        "frames": NUM_FRAMES, "write": written, "decode": decode, "reduce": reduce,
        "ingest_path": ingest_path, "in_process_bit_equal": True,
        "engines": {e: {k: v for k, v in r.items() if k != "report"} | {
            k: r["report"].get(k) for k in ("ate_rmse_m", "ate_rmse_optimized_m",
                                            "rpe_translational_m", "rpe_rotational_rad")}
            for e, r in runs.items()},
        "seconds": time.perf_counter() - t_phase,
    }
    print("phase 18:", json.dumps(summary, default=float), flush=True)
    return launches, summary


def check_backend_scale():
    """Phase 19: the reference's back-end probes on the card at a cut
    size: ``backend_scale_probe`` at 40 keyframes x 7 frames (60x80; past
    the auto policy's 128 vertices), ``final_pass_profile`` and
    ``cg_iteration_stats`` at its smallest default size, its CG as while
    graphs, as host-polled graphs and eagerly (the same iterations and
    bits; the while form's host reads per GN step the live edges' one).
    Returns (kernel 1b launches, ``set_while``'s runs in the while-form
    CG solves, the summary)."""
    import contextlib
    import io

    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.models import pose_graph as pg
    from dvo_slam_tpu_torch.tools import backend_scale_probe, cg_iteration_stats
    from dvo_slam_tpu_torch.tools import final_pass_profile
    from dvo_slam_tpu_torch.tools import recorded_sequence as rs
    from dvo_slam_tpu_torch.tools.fused_check import require

    t_phase = time.perf_counter()
    out = io.StringIO()
    _reset_counts()
    with rs.counted_solves() as calls, contextlib.redirect_stdout(out):
        first, second = backend_scale_probe.main(PROBE_KEYFRAMES, PROBE_FRAMES_PER_MAP)
    counts = _launches()
    steps = rs.steps_of(calls)
    require(counts["warp_fused_stats"] == steps["one_steps"] and
            counts["warp_fused_stats_batched"] == steps["batched_steps"] > 0,
            f"phase 19: launches {counts} != the waves' executed steps {steps}")
    _require_only({k: v for k, v in counts.items() if k != "warp_fused_stats"},
                  "warp_fused_stats_batched", steps["batched_steps"], "phase 19")
    require((first["vertices"], second["edges_after_final"]) == PROBE_GRAPH,
            f"phase 19: vertices and edges {first['vertices']}, {second['edges_after_final']} "
            f"!= the reference probe's {PROBE_GRAPH}")
    require(first["vertices"] > 128 and any(r != "dense" for r in second["routes"]),
            f"phase 19: the final pass did not pass the dense route's line: {first}, {second}")
    require(not second["fallbacks"], f"phase 19: a graph solve fell back: {second['fallbacks']}")
    require(np.isfinite(second["ate_m"]) and abs(second["ate_m"] - PROBE_ATE_M) < PROBE_ATE_ATOL_M,
            f"phase 19: ATE {second['ate_m']} m, the reference probe's {PROBE_ATE_M} m")
    probe_s = time.perf_counter() - t_phase
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        size, rounds, totals = final_pass_profile.main()
        _reset_counts()
        (cg,) = cg_iteration_stats.main(["--sizes", "512", "--gn-steps", str(PROBE_GN_STEPS)])
        _launches()
    set_while_runs = irls_graph.while_counts.set_while
    require(len(rounds) == 10 and all(np.isfinite(r["opt_ms"]) for r in rounds),
            f"phase 19: final pass rounds {rounds}")
    require(len(cg["cg_iterations_per_gn_step"]) == PROBE_GN_STEPS and
            np.isfinite(cg["auto_chi2_history"]).all(), f"phase 19: CG stats {cg}")
    runs = cg["runs"]
    require(runs["forms_bit_equal"] and all(
        runs[name]["cg_iterations_per_gn_step"] == runs["eager"]["cg_iterations_per_gn_step"]
        for name in ("while", "polled")), f"phase 19: CG forms differ: {runs}")
    require(runs["while"]["host_reads_per_gn_step"] == [1] * PROBE_GN_STEPS,
            f"phase 19: the while form's host reads per GN step: {runs['while']}")
    # the while form's solves: its untimed first GN step (the captures),
    # which repeats the first timed step's solve, then the timed steps
    its = runs["while"]["cg_iterations_per_gn_step"]
    chunks = sum(-(-k // pg.CG_CHUNK_STEPS) for k in its[:1] + its)
    require(irls_graph.while_counts.launches == PROBE_GN_STEPS + 1 and set_while_runs == chunks,
            f"phase 19: {irls_graph.while_counts.launches} CG while-graph launches, set_while "
            f"{set_while_runs} runs for {chunks} chunks")
    summary = {
        "backend_scale_probe": {"feed": first, "final": second, "seconds": probe_s,
                                "kernel_1b_steps": steps["batched_steps"],
                                "kernel_1b_iterations": steps["batched_iterations"]},
        "final_pass_profile": {**size, **totals, "routes": sorted({r["route"] for r in rounds})},
        "cg_iteration_stats": cg, "cg_set_while_runs": set_while_runs,
        "other_probes_seconds": time.perf_counter() - t0,
        "seconds": time.perf_counter() - t_phase,
    }
    print("phase 19:", json.dumps(summary, default=float), flush=True)
    return counts["warp_fused_stats_batched"], set_while_runs, summary


def check_dp_slam_and_driver(slam_cfg, intrinsics, easy_i, easy_d, easy_poses):
    """Phase 15: ``DataParallelSLAM`` on a one-rank NCCL process group (two
    hard-scene streams of 40 frames rendered as ``bench.py:228-239``
    renders them) against each stream's one-stream front end; then every
    section of the port's driver (``dvo_slam_tpu_torch/bench.py``) once at
    a cut size, each section's launches against its solves' iterations
    (``tools/driver_launches.py``).  Returns ({part: (kernel 1 launches,
    kernel 1b launches)} with the non-depth-buffered launches of kernel 1b
    under ``driver_nobuf``, and the summary)."""
    import tempfile

    from dvo_slam_tpu_torch import bench
    from dvo_slam_tpu_torch.models import streaming
    from dvo_slam_tpu_torch.parallel import distributed, mesh as mesh_lib
    from dvo_slam_tpu_torch.parallel.dp_slam import DataParallelSLAM
    from dvo_slam_tpu_torch.tools import driver_launches
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import synthetic, trajectory

    # the streams of bench.py's --mesh path
    gt = synthetic.circular_trajectory(DP_FRAMES, radius=0.15, rot_amplitude=0.12,
                                       z_amplitude=0.05)
    scene = synthetic.occluded_scene()
    rendered = [bench.render_sequence(gt, SHAPE, scene=scene, seed0=3000 + 97 * b,
                                      intrinsics=intrinsics, workers=RENDER_WORKERS)
                for b in range(DP_STREAMS)]
    iu = np.stack([r[0] for r in rendered])
    du = np.stack([r[1] for r in rendered])
    stamps = np.arange(DP_FRAMES) / 30.0

    with tempfile.TemporaryDirectory() as store:
        distributed.initialize(init_method=f"file://{store}/rendezvous", world_size=1,
                               rank=0, backend="nccl")
        try:
            mesh = mesh_lib.make_mesh(1)
            device = mesh.device
            dp = DataParallelSLAM(intrinsics, slam_cfg, mesh=mesh)
            with driver_launches.counting() as solves:
                _reset_counts()
                online, dp_seconds = _synchronized_seconds(
                    lambda: dp.track_sequences(iu, du, stamps))
                counts = _launches()
            trajectories = dp.trajectories()
            keyframes = [len(s.graph.keyframes) for s in dp.slams]
            dp.shutdown()
        finally:
            distributed.shutdown()
    one, batched = solves.one, solves.batched  # executed steps
    require(counts["warp_fused_stats"] == one > 0,
            f"phase 15: kernel 1 launches {counts['warp_fused_stats']} != the bootstraps' "
            f"executed steps {one}")
    _require_only({k: v for k, v in counts.items() if k != "warp_fused_stats"},
                  "warp_fused_stats_batched", batched, "phase 15")
    require(online.shape == (DP_STREAMS, DP_FRAMES, 4, 4) and len(trajectories) == DP_STREAMS,
            f"phase 15: online {online.shape}, {len(trajectories)} trajectories")

    # each stream against its one-stream front end (comparison runs, not counted)
    solo_diff, not_bit_equal = [], []
    for b in range(DP_STREAMS):
        solo = streaming.StreamingSLAM(intrinsics, slam_cfg)
        _, want = solo.track_frontend(iu[b], du[b])
        solo.graph.shutdown()
        solo_diff.append(float(np.abs(online[b] - want).max()))
        if not np.array_equal(online[b], want):
            not_bit_equal.append(b)
    require(not not_bit_equal,
            f"phase 15: streams {not_bit_equal} part from their one-stream front ends by "
            f"{solo_diff}")
    graph_ates = [float(trajectory.ate_rmse(st, poses, stamps, gt)) for st, poses in trajectories]
    online_ates = [float(trajectory.ate_rmse(stamps, online[b], stamps, gt))
                   for b in range(DP_STREAMS)]
    require(max(graph_ates) < E2E_ATE_GATE_M, f"phase 15: graph ATEs {graph_ates} m")
    require(max(online_ates) < ONLINE_ATE_GATE_M, f"phase 15: online ATEs {online_ates} m")

    # the driver: every section once at a cut size, on phase 4's easy frames
    n = DRIVER_FRAMES
    setup = bench.Setup(slam_cfg, intrinsics, device, SHAPE,
                        easy_poses[:n], easy_i[:n], easy_d[:n], RENDER_WORKERS)
    driver_kwargs = {
        "e2e": dict(frames=n, pipeline_chunk=n // 2, reps=1),
        "tracker": dict(reps=1),
        "multistream": dict(streams=bench.MS_STREAMS, frames=DRIVER_STREAM_FRAMES),
        "bsweep": dict(sweep=DRIVER_SWEEP),
    }
    with tempfile.TemporaryDirectory() as out:
        _reset_counts()
        t0 = time.perf_counter()
        report, passed, sections = driver_launches.count_sections(
            setup, list(bench.SECTION_FUNCTIONS), rep=bench.Report(f"{out}/partial.json"),
            **driver_kwargs)
        driver_seconds = time.perf_counter() - t0
        driver_counts = _launches()
    record = report.result
    require(not report.failed, f"phase 15: driver sections failed: {report.failed} {record}")
    expected = bench_keys(bench.MS_STREAMS, [b for b, _ in DRIVER_SWEEP])
    require(set(record) == expected,
            f"phase 15: driver keys {sorted(set(record) ^ expected)} differ from bench.py's")
    wrong = driver_launches.mismatches(sections)
    require(not wrong, f"phase 15: the driver's launches differ from its executed steps: {wrong}")
    nobuf = sections["multistream"]["nobuf_launches"]
    require(nobuf > 0, "phase 15: the lockstep_nobuf runs launched kernel 1b no time")

    summary = {
        "streams": DP_STREAMS, "frames": DP_FRAMES, "keyframes": keyframes,
        "graph_ate_rmse_m": graph_ates, "online_ate_rmse_m": online_ates,
        "max_pose_diff_vs_one_stream": solo_diff,
        "e2e_aggregate_frames_per_s": DP_STREAMS * DP_FRAMES / dp_seconds,
        "e2e_seconds": dp_seconds, "launches": counts,
        "bootstrap_iterations": solves.one_iterations,
        "lockstep_iterations": solves.batched_iterations,
        "executed_steps": {"kernel_1": one, "kernel_1b": batched},
        "driver": {"frames": n, "stream_frames": DRIVER_STREAM_FRAMES,
                   "sweep": DRIVER_SWEEP, "seconds": driver_seconds, "exit_rule": passed,
                   "launches": {k: driver_counts[k] for k in
                                ("warp_fused_stats", "warp_fused_stats_batched")},
                   "sections": sections, "record": record},
    }
    print("phase 15:", json.dumps(summary), flush=True)
    return {"dp": (counts["warp_fused_stats"], counts["warp_fused_stats_batched"]),
            "driver": (driver_counts["warp_fused_stats"],
                       driver_counts["warp_fused_stats_batched"]),
            "driver_nobuf": nobuf}, summary


def bench_keys(streams, sweep_streams):
    """The keys of ``bench.py``'s record for every section: :264-267, :332-336,
    :379-386, :428-432, :446, :494-497, :533-536, :570-573 and :587."""
    return ({"metric", "unit", "device", "slam_e2e_fps", "slam_e2e_ate_rmse_m",
             "backend_phase_ms_per_frame", "online_latency_ms", "value", "vs_baseline",
             "ate_rmse_m", "ate_rmse_hard_m", "slam_frontend_fps", "slam_ate_rmse_m", "gates"}
            | {f"aggregate_fps_{streams}stream_{name}"
               for name in ("lockstep", "sequential", "lockstep_nobuf")}
            | {f"aggregate_fps_{b}stream_sequential" for b in sweep_streams})


def check_modular_and_warps(cfg, intrinsics, frames, d_i, d_d, easy_poses, est, s_i, s_d):
    """Phase 16: the modular tracker backend and the warps on the card.
    Returns the summary."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
    from dvo_slam_tpu_torch.models import dense_tracker
    from dvo_slam_tpu_torch.odometry import track_sequence
    from dvo_slam_tpu_torch.ops import residuals, warp
    from dvo_slam_tpu_torch.parallel.multistream import make_multistream_tracker
    from dvo_slam_tpu_torch.tools import fused_check, graph_check
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.utils import trajectory

    started = time.perf_counter()
    device = d_i.device

    # (a) kernel 1's folded call against the modular evaluation, per level
    P_prev = torch.tensor(CHECK_P_PREV, dtype=torch.float32, device=device)
    per_evaluation = [
        fused_check.compare_modular_to_kernel(cfg, intrinsics, frames[0], frames[1], level,
                                              bool(first), P_prev)
        for level in range(cfg.first_level, cfg.last_level - 1, -1) for first in (0, 1)]
    for row in per_evaluation:
        print("phase 16a:", json.dumps(row), flush=True)

    # (b) frame-to-frame tracking on phase 4's first frames, every tensor on
    # the card, no evaluation kernel launched (each step takes the step kernels)
    xla = dataclasses.replace(cfg, kernel_backend="xla")
    IF, SE = InfluenceFunction, ScaleEstimator
    configs = {
        "tdist_xla": xla,
        "huber_normal": dataclasses.replace(xla, influence_function=IF.HUBER,
                                            scale_estimator=SE.NORMAL),
        "tukey_mad": dataclasses.replace(xla, influence_function=IF.TUKEY, scale_estimator=SE.MAD),
        "huber_mad": dataclasses.replace(xla, influence_function=IF.HUBER, scale_estimator=SE.MAD),
        "unit_unit": dataclasses.replace(xla, influence_function=IF.UNIT, scale_estimator=SE.UNIT),
        "no_weighting": dataclasses.replace(xla, use_weighting=False),
    }
    sub_i, sub_d = d_i[:MODULAR_FRAMES], d_d[:MODULAR_FRAMES]
    stamps = np.arange(MODULAR_FRAMES) / 30.0
    gt = easy_poses[:MODULAR_FRAMES]
    phase4_ate = trajectory.ate_rmse(stamps, est[:MODULAR_FRAMES], stamps, gt)
    devices = set()
    evaluate = dense_tracker.compute_residuals

    def watched(*args):
        devices.update(a.device.type for a in args if isinstance(a, torch.Tensor))
        return evaluate(*args)

    dense_tracker.compute_residuals = watched
    try:
        track_sequence(configs["huber_mad"], intrinsics, d_i[:3], d_d[:3])  # warm-up
        _reset_counts()
        results = []
        _, kernel_iterations, kernel_seconds = track_sequence(cfg, intrinsics, sub_i, sub_d,
                                                              on_result=results.append)
        kernel_counts = _launches()
        _require_only(kernel_counts, "warp_fused_stats", _steps(r.level_stats for r in results),
                      "phase 16b kernel 1")
        tracking = {}
        for name, c in configs.items():
            _reset_counts()
            before = residuals.compute_residuals.calls
            results = []
            poses, iterations, seconds = track_sequence(c, intrinsics, sub_i, sub_d,
                                                        on_result=results.append)
            counts = _launches()
            evaluations = residuals.compute_residuals.calls - before
            steps = _steps(r.level_stats for r in results)
            _note_steps(f"phase 16b {name}", counts, steps)
            counts = {k: v for k, v in counts.items()
                      if k not in STEP_COUNTS + GLUE_COUNTS + MATCH_COUNTS}
            require(not any(counts.values()), f"phase 16b {name}: kernels ran: {counts}")
            require(evaluations == steps > 0,
                    f"phase 16b {name}: {evaluations} modular evaluations, {steps} executed steps")
            require(np.isfinite(poses).all(), f"phase 16b {name}: non-finite poses")
            tracking[name] = {
                "ate_rmse_m": trajectory.ate_rmse(stamps, poses, stamps, gt),
                "tracked_frames_per_s": (MODULAR_FRAMES - 1) / seconds, "seconds": seconds,
                "solver_iterations": iterations, "ms_per_iteration": 1000.0 * seconds / iterations}
    finally:
        dense_tracker.compute_residuals = evaluate
    require(devices == {device.type},
            f"phase 16b: the modular evaluation read {devices} tensors, the frames are on {device}")
    gap = abs(tracking["tdist_xla"]["ate_rmse_m"] - phase4_ate)
    require(gap <= MODULAR_ATE_GAP_M,
            f"phase 16b: the xla route's ATE is {gap} m from phase 4's (gate {MODULAR_ATE_GAP_M})")

    # B streams of phase 7 in lockstep on the modular path, against solo runs
    huber_mad = configs["huber_mad"]
    sub = (s_i[:MODULAR_STREAMS, :MODULAR_STREAM_FRAMES],
           s_d[:MODULAR_STREAMS, :MODULAR_STREAM_FRAMES])
    _reset_counts()
    lock, lock_seconds = _synchronized_seconds(
        lambda: make_multistream_tracker(huber_mad, intrinsics).tracks(*sub))
    lock_counts = _launches()
    _note_steps("phase 16b lockstep", lock_counts)
    # the lockstep path ingests each rig frame through the ingest kernels
    _note_ingest("16b lockstep", lock_counts, MODULAR_STREAM_FRAMES)
    lock_counts = {k: v for k, v in lock_counts.items()
                   if k not in STEP_COUNTS + INGEST_COUNTS + GLUE_COUNTS + MATCH_COUNTS}
    require(not any(lock_counts.values()), f"phase 16b lockstep: kernels ran: {lock_counts}")
    solo, solo_seconds = _synchronized_seconds(
        lambda: make_multistream_tracker(huber_mad, intrinsics, schedule="sequential").tracks(*sub))
    differ = (lock.iterations != solo.iterations) | (lock.termination != solo.termination)
    flips = [tuple(int(i) for i in at) for at in torch.nonzero(differ).tolist()]
    require(len(flips) <= SCHEDULE_FLIP_SHARE * differ.numel(),
            f"phase 16b lockstep: {len(flips)} of {differ.numel()} stream-frame-levels differ")
    # ROADMAP C (g): the same run on the eager loop, each batched
    # evaluation repeated stream by stream: do the flips fall at level
    # solves whose b parted?
    with graph_check.loop_mode(False, 1), fused_check.solo_evaluations() as rows:
        again = make_multistream_tracker(huber_mad, intrinsics).tracks(*sub)
    require(torch.equal(again.iterations, lock.iterations)
            and torch.equal(again.termination, lock.termination),
            "phase 16b lockstep: the eager rerun's counts differ from the graph run's")
    levels = cfg.first_level - cfg.last_level + 1
    b_parted = {}  # level solve -> per stream, b's largest difference over its largest entry
    not_bit_equal = {field: 0 for field in ("n", "precision", "ll", "A")}
    for row in rows:
        b_parted[row["solve"]] = np.maximum(b_parted.get(row["solve"], 0.0), row["b_scaled"])
        for field in not_bit_equal:
            not_bit_equal[field] += sum(not same for same in row[field])
    lockstep = {
        "streams": MODULAR_STREAMS, "frames": MODULAR_STREAM_FRAMES,
        "stream_frame_levels": differ.numel(), "flips": len(flips),
        "flips_at_stream_frame_level": flips,
        "b_scaled_at_flips": [float(b_parted[f * levels + lv][b]) for b, f, lv in flips],
        "stream_level_solves_with_b_parted": int(sum((v > 0).sum() for v in b_parted.values())),
        "stream_level_solves": MODULAR_STREAMS * len(b_parted),
        "max_b_scaled": float(max(v.max() for v in b_parted.values())),
        "evaluations_not_bit_equal": not_bit_equal,
        "max_pose_err_vs_solo": float(_pose_errors(lock.poses.cpu().numpy(),
                                                   solo.poses.cpu().numpy()).max()),
        "lockstep_iterations": lock.loop_iterations, "solo_iterations": solo.loop_iterations,
        "aggregate_frames_per_s": MODULAR_STREAMS * (MODULAR_STREAM_FRAMES - 1) / lock_seconds,
        "solo_aggregate_frames_per_s":
            MODULAR_STREAMS * (MODULAR_STREAM_FRAMES - 1) / solo_seconds,
    }

    print("phase 16b:", json.dumps({
        "frames": MODULAR_FRAMES, "phase4_ate_rmse_m": phase4_ate,
        "kernel1": {"seconds": kernel_seconds, "solver_iterations": kernel_iterations,
                    "ms_per_iteration": 1000.0 * kernel_seconds / kernel_iterations,
                    "tracked_frames_per_s": (MODULAR_FRAMES - 1) / kernel_seconds},
        "modular": tracking, "lockstep": lockstep}), flush=True)

    # (c) the warps on the card at L1, against CPU copies
    level = cfg.last_level
    k = intrinsics.at_level(level)
    ref, cur = frames[0][level], frames[1][level]
    T_gt = torch.tensor(np.linalg.inv(easy_poses[1]) @ easy_poses[0], dtype=torch.float32)
    err, ok = warp.intensity_error_image(ref, cur, k, T_gt.to(device))
    err_id, ok_id = warp.intensity_error_image(ref, cur, k, torch.eye(4, device=device))
    require(err.device == device and bool(ok.any()), "phase 16c: no valid error image on the card")
    mean_gt, mean_id = float(err[ok].mean()), float(err_id[ok_id].mean())
    require(mean_gt < mean_id, f"phase 16c: error at the truth {mean_gt} >= at identity {mean_id}")
    on_cpu = lambda lv: type(lv)(*(f.cpu() for f in lv))  # noqa: E731
    err_c, ok_c = warp.intensity_error_image(on_cpu(ref), on_cpu(cur), k, T_gt)
    mask_differ = int((ok.cpu() != ok_c).sum())
    require(mask_differ <= WARP_MASK_SHARE * ok.numel(),
            f"phase 16c: {mask_differ} valid pixels differ from the CPU's")
    both = ok.cpu() & ok_c
    value_err = float((err.cpu() - err_c)[both].abs().max())
    require(value_err <= WARP_VALUE_ATOL, f"phase 16c: error image {value_err} from the CPU's")
    depth, depth_ok = warp.warp_depth_forward_advanced(ref.depth, ref.valid, k, T_gt.to(device))
    normals, normals_ok = warp.compute_normals(ref.depth, ref.valid, k)
    require(bool(depth_ok.any()) and bool(torch.isfinite(depth[depth_ok]).all())
            and bool(normals_ok.any()) and bool(torch.isfinite(normals[normals_ok]).all()),
            "phase 16c: non-finite forward warp or normals")

    summary = {
        "per_evaluation": per_evaluation,
        "tracking_ate_rmse_m": {name: row["ate_rmse_m"] for name, row in tracking.items()},
        "lockstep_flips": len(flips),
        "warps": {"error_mean_at_truth": mean_gt, "error_mean_at_identity": mean_id,
                  "valid_pixels": int(ok.sum()), "valid_differ_from_cpu": mask_differ,
                  "max_abs_err_vs_cpu": value_err,
                  "forward_depth_valid": int(depth_ok.sum()),
                  "normals_valid": int(normals_ok.sum())},
        "seconds": time.perf_counter() - started,
    }
    print("phase 16:", json.dumps({k: v for k, v in summary.items() if k != "per_evaluation"}),
          flush=True)
    return summary


def check_graph_loop(cfg, intrinsics, d_i, d_d, s_i, s_d):
    """Phase 17: the IRLS loop's forms on the card against the eager loop:
    the while graph, the host-polled graphs at each K; then ``set_while``
    against its plain version.  Returns (the summary, ``set_while``'s rows
    by stream count)."""
    import dataclasses

    import torch

    from dvo_slam_tpu_torch.config import InfluenceFunction, ScaleEstimator
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.tools import chunk_sweep, graph_check, profile_odometry
    from dvo_slam_tpu_torch.tools.fused_check import require

    started = time.perf_counter()
    one = (d_i[:GRAPH_FRAMES], d_d[:GRAPH_FRAMES])
    many = (s_i[:GRAPH_STREAMS, :GRAPH_STREAM_FRAMES], s_d[:GRAPH_STREAMS, :GRAPH_STREAM_FRAMES])
    k = _chunk()

    # (a) the modular path: the while graph and the host-polled graphs at
    # the card's K against the eager loop at K = 1, every level's carry and
    # counts bit for bit
    xla = dataclasses.replace(cfg, kernel_backend="xla")
    modular = {"xla_tdist": xla,
               "xla_huber_mad": dataclasses.replace(xla, influence_function=InfluenceFunction.HUBER,
                                                    scale_estimator=ScaleEstimator.MAD)}
    equal = {}
    for name, c in modular.items():
        for workload, fn, args in (("one_stream", chunk_sweep.one_stream, one),
                                   ("lockstep", chunk_sweep.lockstep, many)):
            _, eager = fn(c, intrinsics, *args, graphs=False, chunk=1, warm=False)
            for form, polled in (("while", False), ("polled", True)):
                row, levels = fn(c, intrinsics, *args, graphs=True, chunk=k, warm=False,
                                 polled=polled)
                diffs = graph_check.differences(levels, eager)
                require(not diffs, f"phase 17 {name} {workload} {form}: the graph loop parts "
                                   f"from the eager loop: {diffs[:5]}")
                equal[f"{name}_{workload}_{form}"] = {
                    "level_solves": len(levels), "executed_steps": row["executed_steps"],
                    "irls_reads_per_frame": row["irls_reads_per_frame"]}

    # (b) kernels 1 and 1b: the eager loop, the host-polled graphs at each K
    # and the while graph, in turns, each held bit-equal to the eager loop
    rows = chunk_sweep.sweep(cfg, intrinsics, *one, *many, CHUNK_SWEEP)
    for (workload, mode), row in rows.items():
        require(row["bit_equal_to_eager"],
                f"phase 17 {workload} {mode}: the graph loop parts from the eager loop: "
                f"{row['differences']}")
        require(mode != "while K=1" or row["irls_reads_per_frame"] == 0,
                f"phase 17 {workload}: the while graph read done {row['irls_reads_per_frame']} "
                "times per frame")
        print("phase 17:", json.dumps({"workload": workload, "mode": mode, **row}), flush=True)

    # (c) the node types the while bodies hold, one entry per backend and
    # stream count (the levels' captures hold the same types)
    nodes = {}
    for entry in profile_odometry.graph_nodes():
        nodes.setdefault(f"{entry['backend']} streams={entry['streams'] or 1}",
                         {"head": entry["head"], "tail": entry["tail"]})

    # (d) set_while against its plain version
    set_while = graph_check.set_while_check(torch.device("cuda", 0))
    for row in set_while:
        require(row["abs_err"] == 0, f"phase 17: set_while against its plain loop: {row}")
    summary = {"chunk_steps": k, "frames": GRAPH_FRAMES, "streams": GRAPH_STREAMS,
               "stream_frames": GRAPH_STREAM_FRAMES, "modular_bit_equal": equal,
               "graph_nodes": nodes, "set_while": set_while,
               "graph_cache": irls_graph.stats(),
               "memory_reserved_bytes": torch.cuda.memory_reserved(),
               "seconds": time.perf_counter() - started}
    print("phase 17:", json.dumps(summary), flush=True)
    return summary, {(row["streams"], row["loop_on"]): row for row in set_while}


def _gap_ulps(a, b) -> float:
    """The largest |a - b| of two float32 tensors in ulps of the larger of
    their largest finite magnitudes (NaNs and infinities must sit alike)."""
    import torch

    from dvo_slam_tpu_torch.tools.fused_check import require

    a, b = a.double().cpu(), b.double().cpu()
    finite = torch.isfinite(a)
    require(torch.equal(finite, torch.isfinite(b)) and torch.equal(
        a[~finite].nan_to_num(), b[~finite].nan_to_num()), "NaNs or infinities part")
    a, b = a[finite], b[finite]
    if torch.equal(a, b):
        return 0.0
    scale = max(float(a.abs().max()), float(b.abs().max()))
    return float((a - b).abs().max()) / float(np.spacing(np.float32(scale)))


# bytes the step kernels move per stream: the head reads x, T, initial and
# writes three 4x4s; the tail reads the evaluation (48 words), the head's
# 48 and the carry (99 words and a byte) and writes the carry
STEP_BYTES = 4 * (38 + 48 + 48 + 48 + 99 + 99) + 2
STEP_WALK = 4  # phase 20's steps from a level's start (the card test's walk)
# the largest gap of a float field or trace row to the plain step's, in ulps
# of the field's scale (tests_cuda/test_step_tail_cuda.py's GAP_ULPS; 13 seen)
STEP_GAP_ULPS = 32


def check_step_kernels(cfg, intrinsics, frames, records_sha256):
    """Phase 20: the IRLS step kernels against the plain step and their
    times, at B = 1 and B = ``STREAMS`` on phase 3's pairs at L1 (frame k
    against k + 1).  Returns the kernels line's row."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker as dt
    from dvo_slam_tpu_torch.ops import irls_step
    from dvo_slam_tpu_torch.tools.fused_check import require

    def owned(fields):
        return type(fields)(*(t.contiguous().clone() for t in fields))

    level = cfg.last_level
    prepared = [dt.prepare_frame(cfg, intrinsics, f) for f in frames[:STREAMS + 1]]
    shape = tuple(prepared[0].sel[level].shape[-2:])
    rows = {}
    for streams in (1, STREAMS):
        batch = () if streams == 1 else (streams,)

        def pick(field, offset):
            tensors = [getattr(prepared[b + offset], field)[level] for b in range(streams)]
            return tensors[0] if streams == 1 else torch.stack(tensors)

        evaluate = dt._evaluation(cfg, "pallas", intrinsics.at_level(level), shape,
                                  (pick("refpack", 0), pick("quad", 1)))
        start = tuple(t.contiguous() for t in dt.match_start(  # as a level's static buffers
            None, batch, torch.float32, prepared[0].refpack[level].device))
        consts = dt._constants(cfg, start[0])
        carry = dt._Carry(*(t.contiguous() for t in dt._initial_carry(*start, consts)))
        trace = dt._empty_trace(cfg, start[0])
        gaps = {}
        # STEP_WALK steps from the level's start: each from the plain step's
        # carry and trace, through the plain step and the kernels (the first
        # also from the start values, the tail making the initial carry)
        for k in range(STEP_WALK):
            first = k == 0
            want, want_trace = dt._chunk(cfg, evaluate, owned(carry), owned(trace), 1, first,
                                         consts)
            kinds = [dt._chunk(cfg, evaluate, owned(carry), owned(trace), 1, first, None,
                               fused=True)]
            if first:
                kinds.append(dt._chunk(cfg, evaluate, None, owned(trace), 1, True, None,
                                       fused=True, start=start))
            for got, got_trace in kinds:
                pairs = [(name, getattr(got, name), getattr(want, name))
                         for name in dt._Carry._fields]
                pairs += [("trace." + name, a, b)
                          for name, a, b in zip(dt.IterationStats._fields, got_trace, want_trace)]
                for name, a, b in pairs:
                    if a.is_floating_point():
                        gaps[name] = max(gaps.get(name, 0.0), _gap_ulps(a, b))
                        require(gaps[name] <= STEP_GAP_ULPS,
                                f"phase 20 B = {streams} step {k}: {name} {gaps[name]} ulps "
                                f"from the plain step (limit {STEP_GAP_ULPS})")
                    else:
                        require(torch.equal(a, b),
                                f"phase 20 B = {streams} step {k}: {name} {a} != {b}")
            carry, trace = want, want_trace
        carry = dt._Carry(*(t.contiguous() for t in dt._initial_carry(*start, consts)))
        # the times, on one evaluation held fixed
        inc, T_new, initial_new = irls_step.step_head_cuda(carry.x, carry.T, carry.initial)
        evaluation = evaluate(T_new, carry.precision, True)
        fixed = lambda T, P, first: evaluation  # noqa: E731
        freeze = streams > 1
        row = {"streams": streams, "level": level, "steps": STEP_WALK, "gap_ulps": gaps,
               "max_gap_ulps": max(gaps.values()), "gap_limit_ulps": STEP_GAP_ULPS}
        row["device_ms"] = device_ms(lambda: dt._chunk(cfg, fixed, None, None, 1, True, None,
                                                       fused=True, start=start))
        row["head_device_ms"] = device_ms(
            lambda: irls_step.step_head_cuda(carry.x, carry.T, carry.initial))
        out = dt._Carry(*(torch.empty_like(t) for t in carry))
        row["tail_device_ms"] = device_ms(lambda: irls_step.step_tail_cuda(
            evaluation, (inc, T_new, initial_new), carry, out, None, freeze=freeze,
            smoothing=cfg.use_estimate_smoothing, mu=cfg.mu, precision=cfg.precision,
            max_iterations=cfg.max_iterations_per_level))
        row["plain_device_ms"] = device_ms(lambda: dt._chunk(cfg, fixed, carry, None, 1, True,
                                                             consts))
        row["bound_ms"], row["bound_by"] = _bound(STEP_BYTES * streams)
        rows[streams] = row
    one = rows[1]
    summary = {"by_streams": list(rows.values()), "launches_by_phase": dict(STEP_BY_PHASE),
               "phase14_records_sha256": records_sha256}
    print("phase 20:", json.dumps(summary), flush=True)
    return {"max_gap_ulps": max(r["max_gap_ulps"] for r in rows.values()),
            "ms": one["device_ms"], "plain_ms": one["plain_device_ms"],
            "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
            "by_streams": list(rows.values())}


def check_match_glue(cfg, intrinsics, frames):
    """Phase 21: the glue kernels (a match's setup, links and result row)
    against the plain glue on one match's real carries, their device times
    each alone beside the plain glue's, and the match graph's nodes outside
    its levels' loops (and its level heads' copies) with the kernels,
    beside the plain glue captured alone (``graph_check.plain_glue_census``),
    at B = 1 and B = ``STREAMS`` on phase 3's pairs (frame
    k against k + 1, warm-started at a small twist).  Fails when an integer
    differs or a float field leaves ``STEP_GAP_ULPS``.  Returns the kernels
    line's row."""
    import torch

    from dvo_slam_tpu_torch.models import dense_tracker as dt
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.ops import match_glue, se3
    from dvo_slam_tpu_torch.tools import graph_check
    from dvo_slam_tpu_torch.tools.fused_check import require

    prepared = [dt.prepare_frame(cfg, intrinsics, f) for f in frames[:STREAMS + 1]]
    device = prepared[0].refpack[cfg.first_level].device
    levels = list(range(cfg.first_level, cfg.last_level - 1, -1))
    f32 = torch.float32
    rows = {}
    for streams in (1, STREAMS):
        batch = () if streams == 1 else (streams,)

        def stack(offset):
            picked = prepared[offset:offset + streams]
            return picked[0] if streams == 1 else dt.PreparedFrame(*(
                tuple(None if level[0] is None else torch.stack(level) for level in zip(*field))
                for field in zip(*picked)))

        ref, cur = stack(0), stack(1)
        twist = torch.tensor([0.004, -0.003, 0.002, 0.003, -0.002, 0.001], device=device)
        scale = torch.linspace(0.5, 1.5, streams, device=device).reshape(batch + (1,))
        init = se3.exp_se3(twist * scale if batch else twist).contiguous()
        gaps = {}

        def hold(part, got, want):
            for name, a, b in zip(("x", "T", "initial", "precision"), got, want):
                b = b.expand(a.shape)
                key = f"{part}.{name}"
                gaps[key] = max(gaps.get(key, 0.0), _gap_ulps(a, b))
                require(gaps[key] <= STEP_GAP_ULPS,
                        f"phase 21 B = {streams}: {key} {gaps[key]} ulps from the plain glue "
                        f"(limit {STEP_GAP_ULPS})")

        start = dt.match_start(init, batch, f32, device)
        hold("setup", match_glue.setup_cuda(init, batch, device), start)
        finals, refpacks = [], []
        for level in levels:
            final = dt._match_level(cfg, intrinsics.at_level(level), ref.sel[level],
                                    ref.refpack[level], cur.quad[level], *start)[0]
            finals.append(final)
            refpacks.append(ref.refpack[level])
            start = dt.next_start(final)
            hold("link", match_glue.link_cuda(final.inc_applied, final.T, final.initial,
                                              final.precision), start)
        stats = [dt.level_stats(r, f) for r, f in zip(refpacks, finals)]
        want = dt.flatten_result(dt.match_result(cfg, finals[-1], stats))
        got = dt._glue_result(cfg, finals, refpacks)
        base = dt.FLAT_BASE
        require(torch.equal(got[..., base:], want[..., base:]),
                f"phase 21 B = {streams}: the result's counts differ from the plain glue's")
        for name, part in (("T", slice(0, 16)), ("information", slice(16, 52)),
                           ("nll", slice(52, 53))):
            key = "result." + name
            gaps[key] = _gap_ulps(got[..., part], want[..., part])
            require(gaps[key] <= STEP_GAP_ULPS,
                    f"phase 21 B = {streams}: {key} {gaps[key]} ulps from the plain glue "
                    f"(limit {STEP_GAP_ULPS})")
        last = finals[-1]
        start_out = match_glue.setup_cuda(init, batch, device)
        row_out = got.clone()
        row = {"streams": streams, "levels": len(levels), "gap_ulps": gaps,
               "max_gap_ulps": max(gaps.values()), "gap_limit_ulps": STEP_GAP_ULPS}
        row["setup_device_ms"] = device_ms(
            lambda: match_glue.setup_cuda(init, batch, device, start_out))
        row["link_device_ms"] = device_ms(lambda: match_glue.link_cuda(
            last.inc_applied, last.T, last.initial, last.precision, start_out))
        row["result_device_ms"] = device_ms(lambda: dt._glue_result(cfg, finals, refpacks,
                                                                    row_out))
        def glue():
            match_glue.setup_cuda(init, batch, device, start_out)
            for f in finals[:-1]:
                match_glue.link_cuda(f.inc_applied, f.T, f.initial, f.precision, start_out)
            dt._glue_result(cfg, finals, refpacks, row_out)

        def plain():
            dt.match_start(init, batch, f32, device)
            for f in finals[:-1]:
                dt.next_start(f)
            dt.flatten_result(dt.match_result(cfg, last, [
                dt.level_stats(r, f) for r, f in zip(refpacks, finals)]))

        # a match's glue: the device alone (behind a spin), and with the host enqueueing it
        row["device_ms"], row["plain_device_ms"] = device_ms(glue), device_ms(plain)
        row["wrapper_ms"], row["plain_wrapper_ms"] = median_ms(glue), median_ms(plain)
        pixels = sum(int(r.shape[-1]) for r in refpacks)
        # a stream's bytes: the setup's 64 in and 168 out, each link's 208 and
        # 168, the result's selection rows, its carries' 436 and its row out
        moved = streams * (64 + 168 + (len(levels) - 1) * (208 + 168) + 4 * pixels + 436
                           + 4 * (base + 4 * len(levels)))
        row["bound_ms"], row["bound_by"] = _bound(moved)
        # the match graph's nodes outside its levels' loops, and its heads',
        # against the same glue as captured PyTorch ops
        plain = graph_check.plain_glue_census(cfg, init, finals, refpacks)
        irls_graph.release()
        with graph_check.loop_mode(True, 1, polled=False):
            dt.match_prepared(cfg, intrinsics, ref, cur, init)
        match = next(m for m in irls_graph._matches.values() if m.exec is not None)
        heads = [g.census()["head"] for g in match.levels]
        census = {"plain": {"glue_nodes": sum(plain.values()), "glue": plain},
                  "kernels": {"glue_nodes": sum(match.census()["glue"].values()),
                              "glue": match.census()["glue"],
                              "head_memcpy": sum(h.get("memcpy", 0) for h in heads),
                              "heads": heads}}
        irls_graph.release()
        require(census["kernels"]["glue_nodes"] <= 8 and census["kernels"]["head_memcpy"] == 0,
                f"phase 21 B = {streams}: the match graph's glue {census['kernels']}")
        row["census"] = census
        rows[streams] = row
    one = rows[1]
    print("phase 21:", json.dumps({"by_streams": list(rows.values())}), flush=True)
    return {"max_gap_ulps": max(r["max_gap_ulps"] for r in rows.values()),
            "ms": one["device_ms"], "plain_ms": one["plain_device_ms"],
            "wrapper_ms": one["wrapper_ms"], "bound_ms": one["bound_ms"],
            "bound_by": one["bound_by"], "by_streams": list(rows.values())}


def check_copy_and_probe():
    """Phase 10: the copy kernel against ``clone()``, then the gather probe
    (whose ``pcopy`` variant is the copy kernel's main path).  Returns the
    kernel's row."""
    import torch

    from dvo_slam_tpu_torch.ops import table_copy
    from dvo_slam_tpu_torch.tools import gather_probe
    from dvo_slam_tpu_torch.tools.fused_check import require

    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = {name: torch.randn(shape, device="cuda", generator=gen)
              for name, shape in COPY_SHAPES.items()}
    c, n = COPY_SHAPES["l1_table"]
    # a contiguous table 4 bytes past a 16-byte boundary: the scalar loop
    tables["unaligned"] = torch.randn(c * n + 1, device="cuda", generator=gen)[1:].view(c, n)
    worst = 0.0
    for name, x in tables.items():
        out = table_copy.table_copy_cuda(x)
        want = table_copy.table_copy_plain(x)
        torch.cuda.synchronize()
        require(out.data_ptr() != x.data_ptr() and out.shape == x.shape, f"copy of {name}")
        require(torch.equal(out.view(torch.int32), want.view(torch.int32)),
                f"copy kernel: {name} not bit-equal to clone()")
        worst = max(worst, float((out - want).abs().max()))
    full = tables["l1_table"]
    del tables
    moved = 2 * _bytes(full)
    row = {"name": "table_copy", "route": "cuda", "source": COPY_SOURCE, "replaces": COPY_REPLACES,
           "max_abs_err": worst}

    def kernel():
        return table_copy.table_copy_cuda(full)

    def plain():
        return table_copy.table_copy_plain(full)

    # cold: the main path copies out of a stack larger than the L2 cache
    flush = torch.empty(COLD_FLUSH_BYTES // 4, device="cuda")
    _timed(row, kernel, plain, timer=lambda fn: cold_ms(fn, flush))
    del flush
    _timed(row, kernel, plain, timer=device_ms, prefix="warm_")
    _timed(row, kernel, plain, prefix="wrapper_")
    row["bound_ms"], row["bound_by"] = _bound(moved)
    row["library_ms"] = row["plain_ms"]  # clone(): one PyTorch call, the same function
    profiled_ms, _ = gather_probe.device_time(kernel)
    profiled_plain_ms, _ = gather_probe.device_time(plain)
    print("phase 10:", json.dumps({
        "copy_checked": {k: list(v) for k, v in COPY_SHAPES.items()}, "unaligned": [c, n],
        "bit_equal": True, "cold_ms": row["ms"], "cold_plain_ms": row["plain_ms"],
        "warm_ms": row["warm_ms"], "warm_plain_ms": row["warm_plain_ms"],
        "wrapper_ms": row["wrapper_ms"], "wrapper_plain_ms": row["wrapper_plain_ms"],
        "bound_ms": row["bound_ms"],
        "cold_gb_per_s": moved / row["ms"] / 1e6, "cold_plain_gb_per_s": moved / row["plain_ms"] / 1e6,
        "warm_gb_per_s": moved / row["warm_ms"] / 1e6,
        "warm_plain_gb_per_s": moved / row["warm_plain_ms"] / 1e6,
        "profiler_device_ms": profiled_ms, "profiler_plain_device_ms": profiled_plain_ms,
    }), flush=True)

    _reset_counts()
    rows = gather_probe.probe(STREAMS, SHAPE[0] // 2, SHAPE[1] // 2)
    row["launches"] = table_copy.table_copy_cuda.launches
    require(row["launches"] == 2 * STREAMS,
            f"copy kernel launched {row['launches']} times in the probe, not {2 * STREAMS}")
    for r in rows:
        print("phase 10:", json.dumps(r), flush=True)
    return row


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    import threading

    from dvo_slam_tpu_torch import _build, benchmark_config, native
    from dvo_slam_tpu_torch.odometry import (
        build_frame,
        render_sequence,
        track_sequence,
        upload_sequence,
    )
    from dvo_slam_tpu_torch.ops.camera import TUM_FR1
    from dvo_slam_tpu_torch.parallel.multistream import as_frames
    from dvo_slam_tpu_torch.tools.fused_check import require
    from dvo_slam_tpu_torch.tools.multistream_bench import render_streams
    from dvo_slam_tpu_torch.utils import synthetic, trajectory

    # the twin is the kernel's oracle: its Gram product in IEEE float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    started = time.perf_counter()

    def elapsed(phases):
        print(f"{phases}: done {time.perf_counter() - started:.1f} s after the start", flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1: device {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(f"phase 1: nvidia-smi name, power.limit: {smi}", flush=True)

    # phase 2: build (the four sources at once, one nvcc each, and g++ the
    # native ingest beside them, so that no timed phase pays its build)
    t0 = time.perf_counter()
    ingest = threading.Thread(target=native.native_available)
    ingest.start()
    libraries = _build.load_libraries(["fused_stats", "table_copy", "while_graph", "ingest"])
    ingest.join()
    require(native.build_error() is None, f"the native ingest did not build: "
            f"{native.build_error()}")
    print(f"phase 2: {native.library_path()}: g++, built with the kernels", flush=True)
    for name, entries in (
        ("fused_stats", ("dvo_warp_fused_stats", "dvo_fused_stats", "dvo_fused_stats_batched",
                         "dvo_fused_partials", "dvo_warp_fused_partials", "dvo_sharded_loglik",
                         "dvo_sharded_tail", "dvo_irls_step_head", "dvo_irls_step_tail")),
        ("table_copy", ("dvo_table_copy",)),
        ("while_graph", ("dvo_while_graph_build", "dvo_while_graph_launch",
                         "dvo_while_graph_destroy", "dvo_graph_node_census")),
        ("ingest", ("dvo_ingest", "dvo_ingest_sizes")),
    ):
        for entry in entries:
            require(hasattr(libraries[name].lib, entry), f"the {name} library lacks {entry}")
    print(f"phase 2: built the four libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for library in libraries.values():
        print(f"phase 2: {library.path}: nvcc {library.build_seconds:.2f} s", flush=True)
        for line in library.compiler_log.strip().splitlines():
            print("phase 2: nvcc:", line)

    cfg = benchmark_config().tracker

    # phase 3: kernels vs plain versions on a rendered 640x480 sequence
    easy_poses = synthetic.circular_trajectory(NUM_FRAMES, radius=0.05, rot_amplitude=0.02)
    t0 = time.perf_counter()
    easy_i, easy_d = render_sequence(easy_poses, SHAPE, TUM_FR1, seed0=0, workers=RENDER_WORKERS)
    print(f"phase 3: rendered {NUM_FRAMES} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    d_i, d_d = upload_sequence(easy_i, easy_d, device)
    frames = [build_frame(cfg, d_i[k], d_d[k]) for k in range(STREAMS + 1)]
    folded = check_folded(cfg, TUM_FR1, frames)
    _, sharded_worst, sharded_timed = check_sharded_kernels(cfg, TUM_FR1, frames)
    checks = check_kernels(cfg, TUM_FR1, frames[0], frames[1])
    ingest_row = check_ingest(cfg, TUM_FR1, easy_i, easy_d)
    elapsed("phases 1-3")

    # phase 4: 100-frame odometry through the folded kernel
    track_sequence(cfg, TUM_FR1, d_i[:3], d_d[:3])  # warm-up, not counted
    _reset_counts()
    odometry_results = []
    est, iterations, seconds = track_sequence(cfg, TUM_FR1, d_i, d_d,
                                              on_result=odometry_results.append)
    counts = _launches()
    launches = counts["warp_fused_stats"]
    level_stats = [r.level_stats for r in odometry_results]
    _require_only(counts, "warp_fused_stats", _steps(level_stats), "phase 4")
    while_4 = _require_while(_iterations(level_stats), "phase 4")
    stamps = np.arange(NUM_FRAMES) / 30.0
    ate = trajectory.ate_rmse(stamps, est, stamps, easy_poses)
    fps = (NUM_FRAMES - 1) / seconds
    require(np.isfinite(est).all() and np.isfinite(ate), "non-finite odometry")
    print("phase 4:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": ate, "tracked_frames_per_s": fps,
        "seconds": seconds, "solver_iterations": iterations, "chunk_steps": _chunk(),
        "executed_steps": _steps(level_stats), "launches": counts,
        "set_while_runs": while_4["set_while_runs"],
        "irls_reads_per_frame": while_4["irls_done_reads"] / (NUM_FRAMES - 1),
        "ms_per_iteration": 1000.0 * seconds / iterations,
    }), flush=True)

    # phase 5: the hard (occluded) scene, accuracy gate
    hard_poses = synthetic.circular_trajectory(
        NUM_FRAMES, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05
    )
    hard_i, hard_d = render_sequence(
        hard_poses, SHAPE, TUM_FR1, scene=synthetic.occluded_scene(), seed0=1000,
        workers=RENDER_WORKERS,
    )
    h_i, h_d = upload_sequence(hard_i, hard_d, device)
    _reset_counts()
    hard_results = []
    hard_est, hard_iterations, hard_seconds = track_sequence(cfg, TUM_FR1, h_i, h_d,
                                                             on_result=hard_results.append)
    hard_counts = _launches()
    hard_launches = hard_counts["warp_fused_stats"]
    hard_stats = [r.level_stats for r in hard_results]
    _require_only(hard_counts, "warp_fused_stats", _steps(hard_stats), "phase 5")
    hard_ate = trajectory.ate_rmse(stamps, hard_est, stamps, hard_poses)
    print("phase 5:", json.dumps({
        "frames": NUM_FRAMES, "ate_rmse_m": hard_ate,
        "tracked_frames_per_s": (NUM_FRAMES - 1) / hard_seconds,
        "seconds": hard_seconds, "solver_iterations": hard_iterations,
        "executed_steps": _steps(hard_stats), "launches": hard_counts,
        "irls_reads_per_frame": _done_reads() / (NUM_FRAMES - 1),
        "ms_per_iteration": 1000.0 * hard_seconds / hard_iterations,
    }), flush=True)
    require(hard_ate < HARD_ATE_GATE_M, f"hard-scene ATE {hard_ate} m >= {HARD_ATE_GATE_M} m")
    elapsed("phases 4-5")

    # phases 11-12: the tracking front end on phase 4's frames (run here,
    # before any profiler session, so that their frames/s compare with
    # phase 4's)
    camera_launches, _ = check_camera_tracker(cfg, TUM_FR1, d_i, d_d, odometry_results,
                                              easy_poses, fps)
    init_launches, dual_launches, _ = check_local_tracker(cfg, TUM_FR1, d_i, d_d, easy_poses, fps)
    dual_row = time_dual_kernel(cfg, TUM_FR1, frames)
    elapsed("phases 11-12")

    # phase 13: KeyframeTracker (the SLAM system) on phase 5's frames
    slam_one, slam_batched, wave_rows, phase13, online13 = check_keyframe_tracker(
        benchmark_config(), TUM_FR1, h_i, h_d, hard_poses)
    elapsed("phase 13")

    # phase 14: StreamingSLAM on the same frames, then the benchmark CLI
    streaming_launches, phase14 = check_streaming(benchmark_config(), TUM_FR1, hard_i, hard_d,
                                                  hard_poses, online13, phase13["keyframes"])
    elapsed("phase 14")

    # phase 18: the same frames as a TUM directory on disk through the CLI
    recorded_launches, _ = check_recorded_sequence(benchmark_config(), hard_i, hard_d,
                                                   hard_poses)
    elapsed("phase 18")

    # phase 19: the back-end probes past the dense route's 128 vertices
    probe_launches, set_while_19, _ = check_backend_scale()
    elapsed("phase 19")

    # phase 15: DataParallelSLAM on a one-rank process group, then the driver
    dp_launches, _ = check_dp_slam_and_driver(benchmark_config(), TUM_FR1, easy_i, easy_d,
                                              easy_poses)
    elapsed("phase 15")

    # phase 6: the sharded paths on a one-rank process group
    frames += [build_frame(cfg, d_i[k], d_d[k]) for k in range(len(frames), SHARDED_PAIRS + 1)]
    partials_launches, set_while_6, _ = check_sharded(cfg, TUM_FR1, frames, easy_poses)
    elapsed("phase 6")

    # phase 7: B streams in lockstep, the batched kernel first
    intensity, depth, stream_gt = render_streams(STREAMS, STREAM_FRAMES, SHAPE, TUM_FR1,
                                                 workers=RENDER_WORKERS)
    s_i, s_d = as_frames(intensity, depth, device)
    first_pairs = [
        (build_frame(cfg, s_i[b, 0], s_d[b, 0]), build_frame(cfg, s_i[b, 1], s_d[b, 1]))
        for b in range(STREAMS)
    ]
    batched_rows, batched_worst = check_batched_kernel(cfg, TUM_FR1, first_pairs)
    batched_launches, set_while_7, _ = check_lockstep(cfg, TUM_FR1, s_i, s_d, stream_gt, fps)
    elapsed("phase 7")

    # phase 8: schedules; phase 9: temporal chunks of phase 4's sequence
    check_schedules(cfg, TUM_FR1, s_i, s_d)
    check_temporal(cfg, TUM_FR1, d_i, d_d, est, easy_poses)
    elapsed("phases 8-9")

    # phase 16: the modular backend and the warps (after phase 7, whose
    # streams it reads, and before phase 10's profiler sessions)
    check_modular_and_warps(cfg, TUM_FR1, frames, d_i, d_d, easy_poses, est, s_i, s_d)
    elapsed("phase 16")

    # phase 17: the IRLS loop's forms against the eager loop, and set_while
    _, set_while_rows = check_graph_loop(cfg, TUM_FR1, d_i, d_d, s_i, s_d)
    elapsed("phase 17")

    # phase 20: the IRLS step kernels against the plain step, and their times
    step_row = check_step_kernels(cfg, TUM_FR1, frames, phase14["records_sha256"])
    elapsed("phase 20")

    # phase 21: the glue kernels against the plain glue, their times, and the
    # match graph's nodes with each
    glue_row = check_match_glue(cfg, TUM_FR1, frames)
    elapsed("phase 21")

    # phase 10: the copy kernel and the gather probe
    copy_row = check_copy_and_probe()
    sharded_kernel_counts = count_sharded_kernels(cfg, TUM_FR1, frames)
    ingest_events = count_ingest_kernels(cfg, TUM_FR1, easy_i, easy_d)
    elapsed("phase 10 and the kernel counts")

    kernels = []
    folded_rows, folded_worst, folded_batched_rows, folded_batched_worst = folded
    l1 = next(r for r in folded_rows
              if r["level"] == cfg.last_level and r["first"] == 0 and r["depth_buffered"])
    l1_batched, l1_nobuf = (next(r for r in folded_batched_rows if r["level"] == cfg.last_level
                                 and r["first"] == 0 and r["depth_buffered"] is buffered)
                            for buffered in (True, False))
    sampled_rows, sampled_worst = checks["fused_stats"]
    sampled_l1 = next(r for r in sampled_rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
    batched_l1 = next(r for r in batched_rows
                      if r["level"] == cfg.last_level and r["first_iter"] == "0")
    timing_keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # kernels #1 and #1b: the two launches of csrc/fused_stats.cu, whose main
    # path enters them through the folded entry point; the sampled-input
    # entry point (the same launches, another prologue) is checked in phases
    # 3 and 7 and runs on no tracker path
    by_phase = {
        "fused_stats": {"4": launches, "5": hard_launches, "11": camera_launches,
                        "12": init_launches, "13": slam_one,
                        "14_pipelined": streaming_launches["pipelined"][0],
                        "14_monolithic": streaming_launches["monolithic"][0],
                        "14_cli": streaming_launches["cli"][0],
                        "15_dp_slam": dp_launches["dp"][0], "15_driver": dp_launches["driver"][0],
                        **{f"18_{run}": n[0] for run, n in recorded_launches.items()}},
        "fused_stats_batched": {"7": batched_launches, "12": dual_launches, "13": slam_batched,
                                "14_pipelined": streaming_launches["pipelined"][1],
                                "14_monolithic": streaming_launches["monolithic"][1],
                                "14_cli": streaming_launches["cli"][1],
                                "15_dp_slam": dp_launches["dp"][1],
                                "15_driver": dp_launches["driver"][1],
                                **{f"18_{run}": n[1] for run, n in recorded_launches.items()},
                                "19_backend_scale_probe": probe_launches},
    }
    for name, replaces, row, worst, sampled_entry, sampled_row, sampled_errors in (
        ("fused_stats", STATS_REPLACES, l1, folded_worst, "dvo_fused_stats", sampled_l1,
         sampled_worst),
        ("fused_stats_batched", BATCHED_REPLACES, l1_batched, folded_batched_worst[True],
         "dvo_fused_stats_batched", batched_l1, batched_worst),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces,
            "entry": "dvo_warp_fused_stats", "launches": sum(by_phase[name].values()),
            "launches_by_phase": by_phase[name],
            "max_abs_err": worst["max_abs_err"], **{k: row[k] for k in timing_keys},
            "library_ms": None, **{k: v for k, v in worst.items() if k != "max_abs_err"},
            **{k: row[k] for k in row if "device_ms" in k or k.endswith("x_streams_ms")
               or k == "unfolded_pair_ms"},
            "sampled_entry": {"entry": sampled_entry, "main_path_launches": 0,
                              **{k: sampled_row[k] for k in timing_keys}, **sampled_errors},
        })
    # kernel #1b at the dual match's shape (B = 2), phase 12's launches
    row_keys = ("ms", "plain_ms", "device_ms", "plain_device_ms", "bound_ms", "bound_by")
    kernels[-1]["dual_match_b2"] = {k: dual_row[k] for k in row_keys}
    # and at the largest validation wave's shape (phase 13), coarse and fine
    kernels[-1]["validation_wave"] = {
        name: {k: row[k] for k in ("streams", "level", "max_scaled_err") + row_keys}
        for name, row in zip(("coarse", "fine"), wave_rows)}
    # kernel #1b's template without depth-buffered sampling: phase 15's
    # lockstep_nobuf runs (counted in fused_stats_batched's 15_driver too)
    nobuf_worst = folded_batched_worst[False]
    kernels.append({
        "name": "fused_stats_batched_nobuf", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": BATCHED_REPLACES, "entry": "dvo_warp_fused_stats", "depth_buffered": False,
        "launches": dp_launches["driver_nobuf"],
        "launches_by_phase": {"15_driver_lockstep_nobuf": dp_launches["driver_nobuf"]},
        "max_abs_err": nobuf_worst["max_abs_err"], **{k: l1_nobuf[k] for k in timing_keys},
        "library_ms": None, **{k: v for k, v in nobuf_worst.items() if k != "max_abs_err"},
        **{k: l1_nobuf[k] for k in l1_nobuf if "device_ms" in k or k.endswith("x_streams_ms")},
    })
    # kernel #2: the sharded evaluation's three launches (the folded entry
    # point, phase 6's path); the sampled-input entry point is checked in
    # phase 3 and runs on no main path
    rows, worst = checks["fused_partials"]
    l1 = next(r for r in rows if r["level"] == cfg.last_level and r["first_iter"] == 0)
    whole, half, quarter = sharded_timed
    kernels.append({
        "name": "fused_partials", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": PARTIALS_REPLACES, "entry": "dvo_warp_fused_partials",
        "launches": partials_launches, "max_abs_err": sharded_worst["max_abs_err"],
        **{k: whole[k] for k in timing_keys}, "library_ms": None,
        **{k: v for k, v in sharded_worst.items() if k != "max_abs_err"},
        **{k: v for k, v in whole.items() if "device_ms" in k or k == "unfolded_trio_ms"},
        "half_frame": {k: v for k, v in half.items() if "ms" in k or k == "pixels_per_rank"},
        "quarter_frame": {k: v for k, v in quarter.items() if "ms" in k or k == "pixels_per_rank"},
        "device_kernels_per_iteration": sharded_kernel_counts,
        "sampled_entry": {"entry": "dvo_fused_partials", "main_path_launches": 0,
                          **{k: l1[k] for k in timing_keys}, **worst},
    })
    kernels.append(copy_row)
    # the while graph's set_while: one run per executed chunk of every loop
    # on the card (the tracker levels of phases 4, 7 and 14, the sharded
    # level and the distributed CG of phase 6, block-CG of phase 19
    # counted), held against its plain loop in phase 17 at both senses of
    # its condition (loop_on False: while a done flag is false, the IRLS
    # levels; True: while active, CG) at phase 4's one stream, phase 7's 8
    # streams and beyond; ms per step of the timed loop (a tail of two tiny
    # kernels and set_while) against the plain loop's host-read step
    by_phase = {"4": while_4["set_while_runs"], "7": set_while_7,
                **{f"14_{run}": n[2] for run, n in streaming_launches.items()},
                **set_while_6, "19_cg": set_while_19}
    one_stream, eight = set_while_rows[1, False], set_while_rows[STREAMS, False]
    active = set_while_rows[1, True]
    bound_ms, bound_by = _bound(1 + 16)  # one flag read, the run counter read and written
    kernels.append({
        "name": "set_while", "route": "cuda", "source": WHILE_SOURCE,
        "replaces": WHILE_REPLACES, "entry": "dvo_while_graph_build",
        "launches": sum(by_phase.values()), "launches_by_phase": by_phase,
        "max_abs_err": max(r["abs_err"] for r in set_while_rows.values()),
        "ms": one_stream["ms_per_step"], "plain_ms": one_stream["plain_ms_per_step"],
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "by_streams_and_sense": list(set_while_rows.values()),
        "eight_streams": {"ms": eight["ms_per_step"], "plain_ms": eight["plain_ms_per_step"],
                          "bound_ms": _bound(STREAMS + 16)[0]},
        "loop_on_active": {"replaces": CG_WHILE_REPLACES, "ms": active["ms_per_step"],
                           "plain_ms": active["plain_ms_per_step"], "bound_ms": bound_ms},
    })
    # ingest's two kernels (kernel A the pyramid, kernel B the tables): one
    # launch of each per frame of every from_raw on the card; a kernel of the
    # port that replaces no Pallas kernel
    kernels.append({
        "name": "ingest", "route": "cuda", "source": INGEST_SOURCE, "replaces": INGEST_REPLACES,
        "entry": "dvo_ingest", "launches": sum(a for a, _ in INGEST_BY_PHASE.values()),
        "launches_by_phase": {p: a for p, (a, _) in INGEST_BY_PHASE.items()},
        "pack_launches_by_phase": {p: b for p, (_, b) in INGEST_BY_PHASE.items()},
        **ingest_row, "library_ms": None, "device_events": ingest_events,
    })
    # the step kernels (the head and tail of every tracker step on the card,
    # the modular path's too); a kernel of the port that replaces no Pallas
    # kernel
    kernels.append({
        "name": "irls_step", "route": "cuda", "source": KERNEL_SOURCE, "replaces": STEP_REPLACES,
        "entry": "dvo_irls_step_head, dvo_irls_step_tail",
        "launches": sum(STEP_BY_PHASE.values()), "launches_by_phase": dict(STEP_BY_PHASE),
        **step_row, "library_ms": None,
    })
    # the glue kernels (a match's setup, links and result row on the card);
    # kernels of the port that replace no Pallas kernel
    kernels.append({
        "name": "match_glue", "route": "cuda", "source": KERNEL_SOURCE, "replaces": GLUE_REPLACES,
        "entry": "dvo_match_setup, dvo_match_link, dvo_match_result",
        "launches": sum(GLUE_BY_PHASE.values()), "launches_by_phase": dict(GLUE_BY_PHASE),
        **glue_row, "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
