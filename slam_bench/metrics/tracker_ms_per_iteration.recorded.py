"""ms per IRLS iteration: the span around ``update`` (the match, its
while-graph levels and the pose's copy to the host) over the frame's
iterations, summed over the frames outside the profiled slice."""


def read(run):
    frames = [f for f in run.untraced() if f.info.get("levels")]
    iterations = sum(sum(f.info["levels"]) for f in frames)
    return sum(f.end - f.ingested for f in frames) * 1e3 / iterations if iterations else None
