"""The port's NumPy renderer is bit-equal to the reference's: the port
renders its frames without importing the JAX package, and a frame must
be the same frame on both sides."""

import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops.camera import Intrinsics as JIntrinsics
from dvo_slam_tpu.utils import synthetic as j_syn

from dvo_slam_tpu_torch.ops.camera import Intrinsics as TIntrinsics
from dvo_slam_tpu_torch.utils import synthetic as t_syn

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

K = (80.0, 80.0, 39.5, 29.5)
SHAPE = (60, 80)


@pytest.mark.parametrize("scene", ["default", "occluded"])
@pytest.mark.parametrize(
    "noise",
    [
        {},
        dict(depth_noise=0.002, intensity_noise=1.0, invalid_fraction=0.05),
    ],
    ids=["clean", "noisy"],
)
def test_render_frame_bit_equal(scene, noise):
    poses = j_syn.circular_trajectory(10, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05)
    np.testing.assert_array_equal(
        t_syn.circular_trajectory(10, radius=0.15, rot_amplitude=0.12, z_amplitude=0.05),
        poses,
    )
    make = {"default": "default_scene", "occluded": "occluded_scene"}[scene]
    for k in (0, 3):
        ref = j_syn.render_frame(
            poses[k], JIntrinsics(*K), SHAPE, scene=getattr(j_syn, make)(), seed=k, **noise
        )
        port = t_syn.render_frame(
            poses[k], TIntrinsics(*K), SHAPE, scene=getattr(t_syn, make)(), seed=k, **noise
        )
        for a, b in zip(port, ref):
            np.testing.assert_array_equal(a, b)
        if noise:
            assert not ref[2].all()  # some invalid pixels
