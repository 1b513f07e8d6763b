"""Whole ``KeyframeTracker`` sessions on the card, back to back in one
process, at 120x160 and at 640x480: the benchmark's keyframe-session
configuration (``slam_bench/configs/tum_fr3_office_slam_batch.json``) on
its rendered recording, shortened, with its entry's warm-up
(``slam_bench/entries/keyframe_sessions.py``: a short session and a
validation wave of each size).  After the warm-up no graph is captured,
built or evicted in either session (no ``dvo.graph.capture``,
``.while_build`` or ``.evict`` span, and the graph cache's keys unchanged);
the two sessions give the same map, and neither leaves its worker thread.
"""

import copy
import threading

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BUILDS = ("dvo.graph.capture", "dvo.graph.while_build", "dvo.graph.evict")


@pytest.mark.parametrize("factor, frames", [(4, 90), (1, 200)], ids=["120x160", "640x480"])
def test_second_session_captures_no_graph(factor, frames):
    from dvo_slam_tpu_torch.models import irls_graph
    from dvo_slam_tpu_torch.models.keyframe_graph import WORKER_NAME
    from dvo_slam_tpu_torch.utils import timers
    from slam_bench import manifest, traffic

    device = torch.device("cuda", 0)
    cell = manifest.cell("fr3_office_slam.recorded")
    config = copy.deepcopy(cell.config)
    config["sequence"]["shape"] = [s // factor for s in config["sequence"]["shape"]]
    for key in ("fx", "fy", "ox", "oy"):
        config["intrinsics"][key] /= factor
    rec = traffic.make_recording(config, frames, 2**31 + 11, device)
    entry_mod = manifest.entry("keyframe_sessions")
    irls_graph.release()
    entry_mod.warm_up(config, cell.traffic, rec, device)
    before = irls_graph.stats()
    workers = {t for t in threading.enumerate() if t.name == WORKER_NAME}  # other tests' graphs
    entry = entry_mod.Entry(config, device)
    maps, built = [], []
    timers.enable("cuda")
    try:
        for _ in range(2):
            entry.start_pass()
            for i in range(frames):
                pose = entry.update(entry.ingest(rec.intensity[i], rec.depth[i],
                                                 float(rec.stamps[i])))
                assert np.all(np.isfinite(pose))
            session_map, counts = entry.end_session()
            maps.append(session_map)
            torch.cuda.synchronize()
            built.append(sorted(s.name for s in timers.drain() if s.name in BUILDS))
    finally:
        timers.disable()
    assert built == [[], []]
    after = irls_graph.stats()
    assert (after["keys"], after["evicted"]) == (before["keys"], before["evicted"])
    assert counts["keyframes"] >= 2 and counts["waves"] >= 1
    for field in maps[0]._fields:
        np.testing.assert_array_equal(getattr(maps[0], field), getattr(maps[1], field),
                                      err_msg=field)
    assert {t for t in threading.enumerate() if t.name == WORKER_NAME} <= workers
    irls_graph.release()
