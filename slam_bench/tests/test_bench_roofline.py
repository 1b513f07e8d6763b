"""The roofline count from shapes alone."""

from slam_bench import roofline


def test_level_shapes():
    assert roofline.level_shape((480, 640), 0) == (480, 640)
    assert roofline.level_shape((480, 640), 1) == (240, 320)
    assert roofline.level_shape((480, 640), 3) == (60, 80)
    assert roofline.level_shape((121, 161), 1) == (60, 80)


def test_bytes_flops_and_bound():
    n = 240 * 320
    assert roofline.evaluation_bytes(240, 320) == 8 * 4 * n + 42 * 4
    assert roofline.evaluation_flops(240, 320) == roofline.FLOPS_PER_PIXEL * n
    bound = roofline.evaluation_bound_s(240, 320)
    # memory-bound: 2.46 MB at 3.35 TB/s, 0.73 us
    assert bound == (8 * 4 * n + 168) / 3.35e12
    assert roofline.evaluation_flops(240, 320) / 67e12 < bound
    assert abs(bound - 0.7337e-6) < 1e-9
    # a level a quarter the size takes a quarter of the time, less the system's bytes
    assert roofline.evaluation_bound_s(120, 160) < bound / 3.99
