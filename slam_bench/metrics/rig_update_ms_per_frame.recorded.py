"""ms per rig frame of the program's ``dvo.rig.update`` span on the host
(``LockstepTracker.update``: the lockstep match of the rig's B pairs, its
wait for the card and the B poses' copy to the host), over the window's
frames outside the profiled slice.  None where the program records no such
span (``spans``)."""
import numpy as np

from slam_bench import spans

spans.arm()


def read(run):
    ms = [f.host_ms["dvo.rig.update"] for f in spans.untraced(run) if "dvo.rig.update" in f.host_ms]
    return float(np.mean(ms)) if ms else None
