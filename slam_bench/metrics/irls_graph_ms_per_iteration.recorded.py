"""ms per IRLS iteration between the timing events of the program's
``dvo.level.graph`` spans (each level's while-graph launch), over the
frame's iterations (``levels``), summed over the frames outside the
profiled slice: the card's time inside the while graphs, whatever CUPTI
records of their bodies.  An upper bound on it: the pair also holds the
launch call's latency when the stream was idle, where the profiler's busy
time is a lower bound.  None without events."""
from slam_bench import spans

spans.arm()


def read(run):
    frames = [f for f in spans.untraced(run)
              if f.record.info.get("levels") and "dvo.level.graph" in f.device_ms]
    iterations = sum(sum(f.record.info["levels"]) for f in frames)
    return (sum(f.device_ms["dvo.level.graph"] for f in frames) / iterations
            if iterations else None)
