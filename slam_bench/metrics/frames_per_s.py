"""frames/s, closed loop: frames whose pose reached the host in the window
over the window's seconds (from its opening to the last pose)."""

def read(run):
    done = [f for f in run.frames if f.pose is not None]
    return len(done) / run.window_s if done and run.window_s > 0 else None
