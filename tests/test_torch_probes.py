"""The port's probes of the reference's ``tools/``, at a cut size on the
CPU.

- ``dvo_slam_tpu_torch/tools/iteration_stats.py`` (the reference's
  ``tools/iteration_stats.py``): on 4 frames at 30x40 the per-frame,
  per-level iterations, terminations and valid constraints equal the
  reference's ``match_pyramids`` run op by op (``jax.disable_jit``) over
  the same frames with the same constant-velocity guess, as the reference
  tool runs it; the summary's steps, inert steps and reads per K follow
  from the iterations (K * ceil(iterations / K) and ceil(iterations / K)
  per level).
- ``dvo_slam_tpu_torch/tools/e2e_breakdown.py`` (the reference's
  ``tools/e2e_breakdown.py``): on ``tests/test_torch_streaming.py``'s tiny
  30x40 configuration, 8 frames in chunks of 4: every stage's seconds
  present and non-negative, the totals their sums, the split's records
  bit-equal to the pipelined run's, finite ATEs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu import config as j_config
from dvo_slam_tpu.models import dense_tracker as j_dt
from dvo_slam_tpu.ops import pyramid as j_pyr
from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics

from dvo_slam_tpu_torch import convert
from dvo_slam_tpu_torch.odometry import render_sequence, upload_sequence
from dvo_slam_tpu_torch.ops.camera import Intrinsics
from dvo_slam_tpu_torch.tools import e2e_breakdown, iteration_stats
from dvo_slam_tpu_torch.utils import synthetic
from test_torch_streaming import TINY_CFG

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K_TINY = Intrinsics(40.0, 40.0, 19.5, 14.5)
SHAPE_TINY = (30, 40)
FRAMES = 4
CFG = j_config.TrackerConfig(first_level=1, last_level=0, max_iterations_per_level=15,
                             precision=1e-4, use_initial_estimate=True)


@pytest.fixture(scope="module")
def tiny_loop():
    poses = synthetic.circular_trajectory(FRAMES, radius=0.05, rot_amplitude=0.02)
    return render_sequence(poses, SHAPE_TINY, K_TINY)


def test_iteration_stats_match_reference(tiny_loop):
    iu8, du16 = tiny_loop
    per_frame = iteration_stats.track_levels(convert.config_from_reference(CFG), K_TINY,
                                             *upload_sequence(iu8, du16, "cpu"))
    want = []
    with jax.disable_jit():
        pyrs = []
        for t in range(FRAMES):
            d, v = j_pyr.convert_raw_depth(jnp.asarray(du16[t]))
            pyrs.append(j_pyr.build_pyramid(jnp.asarray(iu8[t]).astype(jnp.float32), d, v,
                                            CFG.num_levels))
        rel = jnp.eye(4, dtype=jnp.float32)
        for t in range(FRAMES - 1):
            r = j_dt.match_pyramids(CFG, JIntrinsics(*K_TINY), pyrs[t], pyrs[t + 1], rel)
            want.append([(lv, int(s.iterations), int(s.termination), int(s.valid_constraints))
                         for lv, s in zip((1, 0), r.level_stats)])
            rel = r.transformation
    assert per_frame == want


def test_iteration_stats_summary_counts_steps_per_chunk():
    per_frame = [[(1, 3, 2, 100), (0, 5, 2, 400)], [(1, 1, 3, 90), (0, 4, 2, 380)]]
    out = iteration_stats.summarize(per_frame, chunks=(1, 2, 4))
    assert out["frames"] == 2 and out["iterations_per_frame"] == (3 + 5 + 1 + 4) / 2
    assert out["levels"]["L0"]["mean_iterations"] == 4.5
    assert out["levels"]["L1"]["terminations"] == {2: 1, 3: 1}
    assert out["per_chunk"]["K=1"] == {"steps_per_frame": 6.5, "inert_steps_per_frame": 0.0,
                                       "reads_per_frame": 6.5}
    assert out["per_chunk"]["K=2"] == {"steps_per_frame": (4 + 6 + 2 + 4) / 2,
                                       "inert_steps_per_frame": 1.5,
                                       "reads_per_frame": (2 + 3 + 1 + 2) / 2}
    assert out["per_chunk"]["K=4"]["steps_per_frame"] == (4 + 8 + 4 + 4) / 2


def test_e2e_breakdown_at_a_cut_size():
    poses = synthetic.circular_trajectory(8, radius=0.04, rot_amplitude=0.02)
    iu8, du16 = render_sequence(poses, SHAPE_TINY, K_TINY)
    out = e2e_breakdown.breakdown(convert.config_from_reference(TINY_CFG), K_TINY, iu8, du16,
                                  poses, torch.device("cpu"), pipeline_chunk=4)
    stages = ("reduce_s", "upload_s", "scan_s", "decode_s", "replay_s", "final_s")
    assert all(out[k] >= 0.0 for k in stages + ("pipelined_s",))
    assert out["frontend_s"] == pytest.approx(sum(out[k] for k in stages[:4]))
    assert out["total_s"] == pytest.approx(out["frontend_s"] + out["replay_s"] + out["final_s"])
    assert out["hidden_by_pipelining_s"] == pytest.approx(out["total_s"] - out["pipelined_s"])
    assert out["records_equal_to_pipelined"]
    assert out["frames"] == 8 and out["keyframes"] >= 1
    assert np.isfinite([out["ate_online_m"], out["ate_optimized_m"],
                        out["pipelined_ate_optimized_m"]]).all()
