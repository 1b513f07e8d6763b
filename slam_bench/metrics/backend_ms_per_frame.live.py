"""The back end's ms per frame: the totals of ``KeyframeGraph.timers``
(constraint search, validation, insertion, optimisation) over the window,
read when it closes, over the window's frames."""


def read(run):
    total = run.timers.get("total_s")
    return total * 1e3 / len(run.frames) if total is not None and run.frames else None
