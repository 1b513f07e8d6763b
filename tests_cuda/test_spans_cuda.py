"""The span recorder's timing events on the card (``utils/timers``).

A ``CameraTracker`` at 640x480 and ``benchmark_config()``'s tracker tracks
a circle of rendered frames with the recorder on; twelve of them run under
``torch.profiler`` (in a child process: a second profiler session in a
process records none of a CUDA graph's kernels).  Checked:

* the ``dvo.level.graph`` event ms of the profiled frames is at least the
  device time of kernel 1 that CUPTI recorded over them (the events hold
  the whole while graph, CUPTI part of its body);
* a frame's event spans (its ingest's ``dvo.ingest.kernel`` and its match
  graph's ``dvo.level.graph``, the only spans with events) do not overlap:
  their sum is at most the time between two events recorded before its
  ingest and after its pose came back, and each is nonnegative;
* the frame's ingest took the kernel route (``dvo.ingest.stage`` and
  ``.kernel``, not the plain chain's ``.upload``, ``.pyramid`` and
  ``.prepare``);
* ``drain`` reads the spans that have completed when ``update`` returns
  under ``torch.cuda.set_sync_debug_mode("error")``, and the rest once
  the stream has passed them;
* no graph is captured, built or evicted once the warm-up is over (no
  ``dvo.graph.*`` span in the window).
"""

import json
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, os, tempfile
import torch
from dvo_slam_tpu_torch import benchmark_config, odometry
from dvo_slam_tpu_torch.models.camera_tracker import CameraTracker
from dvo_slam_tpu_torch.ops.camera import TUM_FR1
from dvo_slam_tpu_torch.utils import synthetic, timers

torch.backends.cuda.matmul.allow_tf32 = False
cfg = benchmark_config().tracker
poses = synthetic.circular_trajectory(24, radius=0.05, rot_amplitude=0.02)
intensity, depth = odometry.render_sequence(poses, (480, 640), TUM_FR1, workers=4)
tracker = CameraTracker(TUM_FR1, cfg, device="cuda")
for k in range(6):  # the warm-up: every level's graphs
    tracker.update(tracker.make_frame_raw(intensity[k], depth[k], k / 30.0))
torch.cuda.synchronize()
timers.enable("cuda")
out = {"frames": [], "pending_after_update": 0, "built": []}  # the last end event may still be queued
prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                          torch.profiler.ProfilerActivity.CUDA])
prof.start()
for k in range(6, 18):
    before, after = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before.record()
    frame = tracker.make_frame_raw(intensity[k], depth[k], k / 30.0)
    tracker.update(frame)
    after.record()
    torch.cuda.set_sync_debug_mode("error")
    spans = timers.drain()
    torch.cuda.set_sync_debug_mode(0)
    out["pending_after_update"] += len(timers._recorder._pending)
    after.synchronize()
    spans += timers.drain()
    mine = [s for s in spans if s.frame == frame.frame_id]
    out["built"] += [s.name for s in spans if s.name.startswith("dvo.graph.")]
    out["frames"].append({
        "id": frame.frame_id, "window_ms": before.elapsed_time(after),
        "iterations": sum(int(s.iterations) for s in tracker.last_result.level_stats),
        "left": len(timers._recorder._pending),
        "spans": [[s.name, s.device_ms] for s in mine if s.device_ms is not None],
        "names": sorted({s.name for s in mine}),
    })
prof.stop()
fd, path = tempfile.mkstemp(suffix=".json")
os.close(fd)
prof.export_chrome_trace(path)
with open(path) as f:
    events = json.load(f)["traceEvents"]
os.unlink(path)
out["kernel1_ms"] = sum(e["dur"] for e in events if e.get("cat") == "kernel" and (
    "gram_kernel" in e["name"] or "loglik_kernel" in e["name"])) * 1e-3
print("RESULT " + json.dumps(out))
"""


def test_level_graph_events_hold_the_graphs_and_do_not_overlap():
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    out = json.loads(line[len("RESULT "):])
    assert out["built"] == []
    graph_ms = 0.0
    for f in out["frames"]:
        assert f["left"] == 0, f  # every event of the frame was read
        assert {"dvo.ingest", "dvo.ingest.stage", "dvo.ingest.kernel",
                "dvo.update", "dvo.level.copy_in", "dvo.match.graph", "dvo.level.graph",
                "dvo.match.result"} <= set(f["names"]), f["names"]
        assert not {"dvo.ingest.upload", "dvo.ingest.pyramid", "dvo.ingest.prepare"} & set(
            f["names"]), f["names"]
        assert {name for name, _ in f["spans"]} == {"dvo.ingest.kernel", "dvo.level.graph"}
        ms = [m for _, m in f["spans"]]
        assert min(ms) >= 0.0
        assert sum(ms) <= f["window_ms"] * 1.001 + 1e-3, f
        graph_ms += sum(m for name, m in f["spans"] if name == "dvo.level.graph")
    assert out["kernel1_ms"] > 0.0
    assert graph_ms >= out["kernel1_ms"], (graph_ms, out["kernel1_ms"])
