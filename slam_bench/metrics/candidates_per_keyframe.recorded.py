"""Loop-closure candidates per keyframe: the candidates the back end's
search found over the keyframes it inserted (``KeyframeGraph.counts``),
summed over the sessions that ended inside the window.  None where the
program does not count them."""


def read(run):
    counts = run.timers.get("counts") or {}
    if "candidates" not in counts or not counts.get("keyframes"):
        return None
    return counts["candidates"] / counts["keyframes"]
