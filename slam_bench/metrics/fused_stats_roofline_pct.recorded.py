"""Kernel 1's share of its roofline (%): the least time of one tracker
evaluation (``roofline.evaluation_bound_s`` at each solved level's shape,
weighted by the profiled frames' evaluations per level) over kernel 1's
mean device time per evaluation in the trace (its two launches).  None
where the trace holds no launch of it."""
from slam_bench import program, roofline, trace


def read(run):
    if run.trace is None:
        return None
    gram = trace.device_events(run.trace, program.KERNEL_NAMES[0])
    both = gram + trace.device_events(run.trace, program.KERNEL_NAMES[1])
    frames = [f for f in run.frames if f.traced and f.info.get("levels")]
    if not gram or not frames:
        return None
    device_s = sum(ev.end - ev.start for ev in both) * 1e-6 / len(gram)
    tracker = run.config["tracker"]
    shape = run.config["sequence"]["shape"]
    bound = evaluations = 0.0
    for f in frames:
        for j, its in enumerate(f.info["levels"]):
            level = tracker["first_level"] - j
            bound += its * roofline.evaluation_bound_s(*roofline.level_shape(shape, level))
            evaluations += its
    return 100.0 * (bound / evaluations) / device_s if evaluations else None
