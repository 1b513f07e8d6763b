"""Kernel 1b's share of its roofline (%): the least time of one lockstep
evaluation (``roofline_batched.evaluation_bound_s`` at the level's shape,
the evaluation's B streams and the distinct frames they read), weighted
by the evaluations the program ran over the profiled slice by (level, B,
frames) (``frames.batch_evaluations``: the dual match at B = 2, the
validation waves at B = 2n, a session's first match at B = 1), over the
two launches' mean device time per evaluation in the trace.  CUPTI sees
part of the launches inside the graphs, so the share reads the mix of
the evaluations it saw as well as the kernel (PERF.md).  None where the
trace holds no launch or the program does not count its evaluations."""
from slam_bench import program, roofline, roofline_batched, trace


def read(run):
    if run.trace is None or "evaluations" not in run.counters.get("after", {}):
        return None
    gram = trace.device_events(run.trace, program.KERNEL_NAMES[0])
    both = gram + trace.device_events(run.trace, program.KERNEL_NAMES[1])
    before = run.counters["before"]["evaluations"]
    ran = {key: n - before.get(key, 0) for key, n in run.counters["after"]["evaluations"].items()}
    evaluations = sum(ran.values())
    if not gram or not evaluations:
        return None
    shape = run.config["sequence"]["shape"]
    bound = sum(n * roofline_batched.evaluation_bound_s(*roofline.level_shape(shape, level), *frames)
                for (level, *frames), n in ran.items())
    device_s = sum(ev.end - ev.start for ev in both) * 1e-6 / len(gram)
    return 100.0 * (bound / evaluations) / device_s
