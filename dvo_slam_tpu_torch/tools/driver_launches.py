"""Kernel launches against solver iterations, section by section, for the
port's benchmark driver (``dvo_slam_tpu_torch/bench.py``).

Run on a machine with a CUDA card, from the repository root:

    python -m dvo_slam_tpu_torch.tools.driver_launches [--sections e2e,...,bsweep]

Runs the driver's sections one at a time through ``bench.run_sections``,
at their default sizes (every section, ``bsweep`` included, unless named),
and counts for each section the launches of every kernel wrapper and the
solver loop iterations of the solves that reach kernels 1 and 1b:

  * ``odometry.track_sequence`` (``tracker``, ``hard``): its iterations,
    one launch of kernel 1 each;
  * the runs of ``make_multistream_tracker`` (``multistream``,
    ``bsweep``): their loop iterations, kernel 1b in lockstep (the runs
    without depth-buffered sampling also apart) and kernel 1 in sequence;
  * every ``match_prepared`` call of the streaming front end and of the
    SLAM models (``e2e``, ``latency``, ``frontend``): per level its slowest
    stream's iterations, kernel 1 for one stream and kernel 1b for more.

Prints one JSON line per section, then the driver's record; exits 1 when
a section failed or its launches differ from its iterations.
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
from ..models import frames as frames_mod
from ..models import streaming
from ..ops import fused_kernels, residuals, table_copy
from ..parallel import multistream

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
    """{name: launches so far} of every wrapper, with ``warp_and_sample_cm``'s calls."""
    counts = {name: wrapper.launches for name, wrapper in wrappers().items()}
    counts["warp_and_sample_cm_calls"] = residuals.warp_and_sample_cm.calls
    return counts


def lockstep_iterations(level_stats) -> int:
    """Loop iterations of one ``match_prepared`` call: per level its slowest stream's."""
    return sum(int(s.iterations.max()) if isinstance(s.iterations, torch.Tensor)
               else int(s.iterations) for s in level_stats)


def streams(level_stats) -> int:
    """The stream count of a ``match_prepared`` call's level statistics."""
    it = level_stats[0].iterations
    return int(it.numel()) if isinstance(it, torch.Tensor) else 1


class Iterations:
    """Solver loop iterations that kernel 1 (``one``) and kernel 1b
    (``batched``) should have launched for; ``nobuf_iterations`` and
    ``nobuf_launches`` are those of the lockstep runs without depth-buffered
    sampling (kernel 1b's other template)."""

    def __init__(self):
        self.one = self.batched = self.nobuf_iterations = self.nobuf_launches = 0
        self._lock = threading.Lock()  # the graph's worker thread matches too

    def add(self, one=0, batched=0, nobuf_iterations=0, nobuf_launches=0):
        with self._lock:
            self.one += one
            self.batched += batched
            self.nobuf_iterations += nobuf_iterations
            self.nobuf_launches += nobuf_launches


@contextlib.contextmanager
def counting():
    """Counts the solver iterations of the driver's solves while open
    (patches ``bench.track_sequence``, ``multistream.make_multistream_tracker``
    and the ``match_prepared`` of ``models.streaming`` and ``models.frames``)."""
    counter = Iterations()
    track_sequence = bench.track_sequence
    make_tracker = multistream.make_multistream_tracker

    def counted_sequence(*args, **kwargs):
        out = track_sequence(*args, **kwargs)
        counter.add(one=out[1])
        return out

    def counted_tracker(cfg, intrinsics, *args, **kwargs):
        run = make_tracker(cfg, intrinsics, *args, **kwargs)
        lockstep = kwargs.get("schedule", "lockstep") == "lockstep"

        def counted_run(intensity_u8, depth_u16):
            before = wrappers()[BATCHED].launches
            tracks = run.tracks(intensity_u8, depth_u16)
            loop = tracks.loop_iterations
            if not lockstep:
                counter.add(one=loop)
            elif cfg.depth_buffered_sampling:
                counter.add(batched=loop)
            else:
                counter.add(batched=loop, nobuf_iterations=loop,
                            nobuf_launches=wrappers()[BATCHED].launches - before)
            return tracks.poses

        counted_run.tracks = run.tracks
        return counted_run

    def counted_match(fn):
        def match(*args, **kwargs):
            result = fn(*args, **kwargs)
            n = lockstep_iterations(result.level_stats)
            counter.add(**({"one": n} if streams(result.level_stats) == 1 else {"batched": n}))
            return result
        return match

    patches = [(bench, "track_sequence", counted_sequence),
               (multistream, "make_multistream_tracker", counted_tracker),
               (streaming, "match_prepared", counted_match(streaming.match_prepared)),
               (frames_mod, "match_prepared", counted_match(frames_mod.match_prepared))]
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
            "kernel_1_iterations": counter.one, "kernel_1b_iterations": counter.batched,
            "nobuf_iterations": counter.nobuf_iterations,
            "nobuf_launches": counter.nobuf_launches,
        }
    return rep, verdict, per_section


def mismatches(per_section) -> list:
    """Each section whose launches differ from its iterations, or that
    launched another kernel than 1 and 1b (the copy kernel aside)."""
    out = []
    for name, s in per_section.items():
        got = s["launches"]
        for kernel, want in ((ONE, s["kernel_1_iterations"]), (BATCHED, s["kernel_1b_iterations"]),
                             ("nobuf", s["nobuf_iterations"])):
            have = s["nobuf_launches"] if kernel == "nobuf" else got.get(kernel, 0)
            if have != want:
                out.append(f"{name}: {kernel} launched {have} times for {want} iterations")
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
