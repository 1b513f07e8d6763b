"""Kernel launches against solver iterations, section by section, for the
port's benchmark driver (``dvo_slam_tpu_torch/bench.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.driver_launches [--sections e2e,...,bsweep]

Runs the driver's sections one at a time through ``bench.run_sections``,
at their default sizes (every section, ``bsweep`` included, unless named),
and counts for each section the launches of every kernel wrapper and the
solver loop iterations of the solves that reach kernels 1 and 1b.  The
IRLS loop runs in chunks of K steps (``dense_tracker.CHUNK_STEPS``; a step
past a level's ``done`` is inert but still evaluates), so a kernel
launches once per executed step: per level K * ceil(iterations / K), the
level's slowest stream's iterations in lockstep.  On the card a level is
one while-graph launch, whose chunks are counted on the card and folded
into the launch counts when they are read (``launches``).  The rule held
is launches = executed steps, with the iterations reported beside them:

  * ``odometry.track_sequence`` (``tracker``, ``hard``): each match's
    levels, kernel 1;
  * the runs of ``make_multistream_tracker`` (``multistream``,
    ``bsweep``): per frame and level the slowest stream's iterations,
    kernel 1b in lockstep (the runs without depth-buffered sampling also
    apart), and every stream's own in sequence, kernel 1;
  * every ``match_prepared`` call of the streaming front end and of the
    SLAM models (``e2e``, ``latency``, ``frontend``): per level its slowest
    stream's iterations, kernel 1 for one stream and kernel 1b for more.

Prints one JSON line per section (on the card with the memory held after
it: reserved, allocated, the peak, and the IRLS graph cache), then the
driver's record; exits 1 when a section failed or its launches differ from
its executed steps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading

import torch

from .. import bench
from ..models import dense_tracker, irls_graph
from ..models import frames as frames_mod
from ..models import streaming
from ..ops import fused_kernels, residuals, table_copy
from ..parallel import multistream
from . import graph_check

ONE, BATCHED = "warp_fused_stats", "warp_fused_stats_batched"


def wrappers():
    """{name: wrapper} of every kernel's launch count."""
    return {
        "warp_fused_partials": fused_kernels.warp_fused_partials_cuda,
        "sharded_loglik": fused_kernels.sharded_loglik_cuda,
        "sharded_tail": fused_kernels.sharded_tail_cuda,
        ONE: fused_kernels.warp_fused_stats_cuda,
        BATCHED: fused_kernels.warp_fused_stats_batched_cuda,
        "fused_stats": fused_kernels.fused_stats_cuda,
        "fused_stats_batched": fused_kernels.fused_stats_batched_cuda,
        "fused_partials": fused_kernels.fused_partials_cuda,
        "table_copy": table_copy.table_copy_cuda,
    }


def launches():
    """{name: launches so far} of every wrapper, with ``warp_and_sample_cm``'s
    calls; the while graphs' launches folded in first (a host read)."""
    irls_graph.fold_counts()
    counts = {name: wrapper.launches for name, wrapper in wrappers().items()}
    counts["warp_and_sample_cm_calls"] = residuals.warp_and_sample_cm.calls
    return counts


def reset_counts():
    """Every kernel's launch count, ``warp_and_sample_cm``'s and
    ``compute_residuals``' calls, the IRLS loop's ``done`` reads and the
    while form's and match graphs' counts to 0 (the while graphs' launches
    folded in first, so that none from before lands after)."""
    irls_graph.fold_counts()
    for wrapper in wrappers().values():
        wrapper.launches = 0
    residuals.warp_and_sample_cm.calls = 0
    residuals.compute_residuals.calls = 0
    dense_tracker.read_done.calls = 0
    irls_graph.while_counts.launches = irls_graph.while_counts.set_while = 0
    irls_graph.match_counts.launches = irls_graph.match_counts.per_level = 0
    irls_graph.match_counts.levels = 0


def lockstep_iterations(level_stats) -> int:
    """Loop iterations of one ``match_prepared`` call: per level its slowest stream's."""
    return sum(graph_check.slowest(s) for s in level_stats)


def executed_steps(level_stats) -> int:
    """Steps the chunked IRLS loop ran for one ``match_prepared`` call,
    which is its kernel's launches: per level K * ceil(iterations / K),
    with the slowest stream's iterations and K = ``dense_tracker.CHUNK_STEPS``."""
    return graph_check.counts(level_stats, dense_tracker.CHUNK_STEPS)[1]


def streams(level_stats) -> int:
    """The stream count of a ``match_prepared`` call's level statistics."""
    return int(level_stats[0].iterations.numel())


class Iterations:
    """Executed steps that kernel 1 (``one``) and kernel 1b (``batched``)
    should have launched for, and the solver loop iterations beside them
    (``*_iterations``); ``nobuf_steps`` and ``nobuf_launches`` are those of
    the lockstep runs without depth-buffered sampling (kernel 1b's other
    template)."""

    FIELDS = ("one", "batched", "one_iterations", "batched_iterations", "nobuf_steps",
              "nobuf_launches")

    def __init__(self):
        for name in self.FIELDS:
            setattr(self, name, 0)
        self._lock = threading.Lock()  # the graph's worker thread matches too

    def add(self, **counts):
        with self._lock:
            for name, value in counts.items():
                setattr(self, name, getattr(self, name) + value)


@contextlib.contextmanager
def counting():
    """Counts the executed steps and solver iterations of the driver's
    solves while open (patches ``bench.track_sequence``,
    ``multistream.make_multistream_tracker``, the ``match_prepared`` of
    ``models.streaming`` and the ``match_prepared_flat`` of
    ``models.frames``, whose result rows it decodes)."""
    counter = Iterations()
    track_sequence = bench.track_sequence
    make_tracker = multistream.make_multistream_tracker

    def counted_sequence(*args, on_result=None, **kwargs):
        steps = []

        def record(result):
            steps.append(executed_steps(result.level_stats))
            if on_result is not None:
                on_result(result)

        out = track_sequence(*args, on_result=record, **kwargs)
        counter.add(one=sum(steps), one_iterations=out[1])
        return out

    def counted_tracker(cfg, intrinsics, *args, **kwargs):
        run = make_tracker(cfg, intrinsics, *args, **kwargs)
        lockstep = kwargs.get("schedule", "lockstep") == "lockstep"
        nobuf = lockstep and not cfg.depth_buffered_sampling

        def counted_run(intensity_u8, depth_u16):
            before = launches()[BATCHED] if nobuf else 0  # a fold: a host read
            tracks = run.tracks(intensity_u8, depth_u16)
            its = tracks.iterations  # [B, T - 1, levels]
            chunk = dense_tracker.CHUNK_STEPS
            if not lockstep:
                counter.add(one=dense_tracker.executed_steps(its, chunk),
                            one_iterations=tracks.loop_iterations)
                return tracks.poses
            steps = dense_tracker.executed_steps(its.amax(dim=0), chunk)
            counter.add(batched=steps, batched_iterations=tracks.loop_iterations)
            if nobuf:
                counter.add(nobuf_steps=steps, nobuf_launches=launches()[BATCHED] - before)
            return tracks.poses

        counted_run.tracks = run.tracks
        return counted_run

    def record(ls):
        if streams(ls) == 1:
            counter.add(one=executed_steps(ls), one_iterations=lockstep_iterations(ls))
        else:
            counter.add(batched=executed_steps(ls), batched_iterations=lockstep_iterations(ls))

    def counted_match(fn):
        def match(*args, **kwargs):
            result = fn(*args, **kwargs)
            record(result.level_stats)
            return result
        return match

    def counted_rows(fn):
        def match(*args, **kwargs):
            rows = fn(*args, **kwargs)
            record(dense_tracker.result_from_row(torch.as_tensor(rows)).level_stats)
            return rows
        return match

    patches = [(bench, "track_sequence", counted_sequence),
               (multistream, "make_multistream_tracker", counted_tracker),
               (streaming, "match_prepared", counted_match(streaming.match_prepared)),
               (frames_mod, "match_prepared_flat", counted_rows(frames_mod.match_prepared_flat))]
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield counter
    finally:
        for obj, name, fn in originals:
            setattr(obj, name, fn)


def count_sections(setup: bench.Setup, wanted=(), rep=None, **kwargs):
    """``bench.run_sections(setup, wanted, rep, **kwargs)`` one section at a
    time, in the driver's order, each counted.  Returns (report, the exit
    rule's verdict, {section: its launches and iterations})."""
    rep = rep or bench.Report()
    names = [n for n in bench.SECTIONS + ("bsweep",)
             if (n in wanted if wanted else n in bench.SECTIONS)]
    verdict, per_section = False, {}
    for name in names:
        before = launches()
        with counting() as counter:
            rep, verdict = bench.run_sections(setup, [name], rep, **kwargs)
        after = launches()
        per_section[name] = {
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "kernel_1_steps": counter.one, "kernel_1b_steps": counter.batched,
            "kernel_1_iterations": counter.one_iterations,
            "kernel_1b_iterations": counter.batched_iterations,
            "nobuf_steps": counter.nobuf_steps, "nobuf_launches": counter.nobuf_launches,
        }
        if torch.device(setup.device).type == "cuda":
            per_section[name]["memory"] = memory(setup.device)
    return rep, verdict, per_section


def memory(device) -> dict:
    """The card's memory after a section: the allocator's reserved and
    allocated bytes, its peak reservation, and the IRLS graph cache
    (``irls_graph.stats()``)."""
    return {"reserved_bytes": torch.cuda.memory_reserved(device),
            "allocated_bytes": torch.cuda.memory_allocated(device),
            "max_reserved_bytes": torch.cuda.max_memory_reserved(device),
            "graph_cache": irls_graph.stats()}


def mismatches(per_section) -> list:
    """Each section whose launches differ from its executed steps, or that
    launched another kernel than 1 and 1b (the copy kernel aside)."""
    out = []
    for name, s in per_section.items():
        got = s["launches"]
        for kernel, want in ((ONE, s["kernel_1_steps"]), (BATCHED, s["kernel_1b_steps"]),
                             ("nobuf", s["nobuf_steps"])):
            have = s["nobuf_launches"] if kernel == "nobuf" else got.get(kernel, 0)
            if have != want:
                out.append(f"{name}: {kernel} launched {have} times for {want} executed steps")
        others = {k: v for k, v in got.items() if k not in (ONE, BATCHED, "table_copy")}
        if others:
            out.append(f"{name}: other kernels or warp_and_sample_cm ran: {others}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default="",
                    help="comma-separated sections (default: every one, bsweep included)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False  # as the driver runs
    wanted = list(filter(None, args.sections.split(","))) or list(bench.SECTION_FUNCTIONS)
    setup = bench.make_setup(workers=os.cpu_count() or 1)
    rep, _, per_section = count_sections(setup, wanted)
    for name, counts in per_section.items():
        print(json.dumps({"section": name, **counts}), flush=True)
    print(json.dumps(rep.result), flush=True)
    wrong = mismatches(per_section)
    for line in wrong:
        print("driver_launches:", line, file=sys.stderr)
    return 1 if wrong or rep.failed else 0


if __name__ == "__main__":
    sys.exit(main())
