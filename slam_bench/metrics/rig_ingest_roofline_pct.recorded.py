"""The batched ingest kernels' share of their roofline (%): the least time
of one rig frame's ingest (``roofline_ingest.ingest_bound_s``: the B raw
frames read once, kernel A's and kernel B's outputs written once, at the
configuration's shape, levels, solve range and B, the levels below the
solve range not stored) over the mean device time a rig frame of the two
launches (``pyramid_kernel``, ``pack_kernel``) in the trace.  None where
the trace holds no launch of them."""
from slam_bench import roofline_ingest, trace


def read(run):
    if run.trace is None:
        return None
    pyramid = trace.device_events(run.trace, "pyramid_kernel")
    both = pyramid + trace.device_events(run.trace, "pack_kernel")
    if not pyramid:
        return None
    tracker = run.config["tracker"]
    bound = roofline_ingest.ingest_bound_s(
        tuple(run.config["sequence"]["shape"]), tracker["first_level"] + 1,
        (tracker["last_level"], tracker["first_level"]), len(run.config["streams"]),
        skip_below=tracker["last_level"])
    device_s = sum(ev.end - ev.start for ev in both) * 1e-6 / len(pyramid)
    return 100.0 * bound / device_s
