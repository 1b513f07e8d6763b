"""Kernel 1b's share of its roofline at the rig's B (%): B times the least
time of one tracker evaluation (``roofline.evaluation_bound_s`` at each
solved level's shape), weighted by the profiled rig frames' lockstep
evaluations per level (``levels``: the loop's iterations, each one launch
pair at B), over the two launches' mean device time per evaluation in the
trace.  Every evaluation of the cell runs at the same B, so the mean mixes
levels only.  None where the trace holds no launch of it."""
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
    streams = len(run.config["streams"])
    first = run.config["tracker"]["first_level"]
    shape = run.config["sequence"]["shape"]
    bound = evaluations = 0.0
    for f in frames:
        for j, its in enumerate(f.info["levels"]):
            bound += its * streams * roofline.evaluation_bound_s(
                *roofline.level_shape(shape, first - j))
            evaluations += its
    return 100.0 * (bound / evaluations) / device_s if evaluations else None
