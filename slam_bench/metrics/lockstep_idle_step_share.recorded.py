"""Share of the lockstep loop's stream-steps spent on streams already done:
1 - (the streams' own IRLS iterations) / (B times the lockstep loop's
iterations, which run each level until its slowest stream is done), summed
over the levels and the window's rig frames (the program's
``LockstepTracker.counts()``, always on).  0 where the B streams need the
same iterations on every level.  None where the program does not count
them."""


def read(run):
    counts = run.timers.get("counts") or {}
    steps = sum((counts.get("stream_steps") or {}).values())
    if not steps:
        return None
    return 1.0 - sum((counts.get("iterations") or {}).values()) / steps
