"""The gather probe's layouts and the table copy, on the CPU.

Every variant of ``dvo_slam_tpu_torch/tools/gather_probe.py`` samples the
same values as the ``batched`` form (the lockstep tracker's), bit for bit,
at 30x40 with B = 3; ``pcopy`` with the plain copy (``clone()``), which is
what ``table_copy`` dispatches to for CPU tensors.  The ``batched`` sample
matches the reference's single-table sampler stream by stream (validity
equal, values within atol 1e-5: the compiled reference contracts the
bilinear blend).  The timing needs a card and is not run here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvo_slam_tpu.ops import interp as j_interp

from dvo_slam_tpu_torch.ops import table_copy
from dvo_slam_tpu_torch.tools import gather_probe

torch.set_num_threads(1)  # Tier-1 runs several xdist workers

STREAMS, HEIGHT, WIDTH = 3, 30, 40


@pytest.fixture(scope="module")
def inputs():
    return gather_probe.make_inputs(STREAMS, HEIGHT, WIDTH, seed=0, device="cpu")


@pytest.fixture(scope="module")
def batched(inputs):
    return {
        i: gather_probe.sample("batched", gather_probe.prepare("batched", inputs), inputs, i)
        for i in range(4)
    }


@pytest.mark.parametrize("iteration", [0, 1, 3])
@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_variant_samples_as_batched(inputs, batched, variant, iteration):
    values, valid = gather_probe.sample(
        variant, gather_probe.prepare(variant, inputs), inputs, iteration
    )
    streams = 1 if variant == "single" else STREAMS
    assert values.shape == (streams, 8, HEIGHT * WIDTH) and valid.shape == (streams, HEIGHT * WIDTH)
    want_values, want_valid = batched[iteration]
    assert torch.equal(values, want_values[:streams])
    assert torch.equal(valid, want_valid[:streams])


def test_check_variants_counts_every_variant(inputs):
    compared = gather_probe.check_variants(inputs)
    n = 8 * HEIGHT * WIDTH
    assert compared == {v: (n if v == "single" else STREAMS * n) for v in gather_probe.VARIANTS}


def test_check_variants_catches_a_wrong_layout(inputs, monkeypatch):
    """A layout that reads the wrong stream's table fails the check."""
    prepare = gather_probe.prepare

    def swapped(variant, probe_inputs):
        tables = prepare(variant, probe_inputs)
        return tables[::-1] if variant == "tuple" else tables

    monkeypatch.setattr(gather_probe, "prepare", swapped)
    with pytest.raises(RuntimeError, match="'tuple'"):
        gather_probe.check_variants(inputs, ("tuple",))


def test_batched_matches_reference_sampler(inputs, batched):
    values, valid = batched[2]
    u = inputs.u + 0.5
    for b in range(STREAMS):
        ref_v, ref_ok = j_interp.bilinear_sample_quad_cm(
            jnp.asarray(inputs.table[b].numpy()), (HEIGHT, WIDTH),
            jnp.asarray(u[b].numpy()), jnp.asarray(inputs.v[b].numpy()),
        )
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(ref_ok))
        np.testing.assert_allclose(values[b].numpy(), np.asarray(ref_v), atol=1e-5)


def test_make_inputs_is_seeded():
    a = gather_probe.make_inputs(2, 6, 8, seed=4, device="cpu")
    b = gather_probe.make_inputs(2, 6, 8, seed=4, device="cpu")
    c = gather_probe.make_inputs(2, 6, 8, seed=5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert not torch.equal(a.table, c.table)
    assert a.table.shape == (2, 32, 48) and a.u.shape == a.v.shape == (2, 48)


def test_unknown_variant():
    inputs = gather_probe.make_inputs(1, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        gather_probe.prepare("sharedT", inputs)


class _Event:
    """The two fields of a profiler event that ``device_ms_per_call`` reads."""

    def __init__(self, on_card, us):
        kind = torch.autograd.DeviceType
        self.device_type = kind.CUDA if on_card else kind.CPU
        self.time_range = type("Range", (), {"elapsed_us": lambda _self: us})()


def test_device_time_sums_the_card_events_per_call():
    events = [_Event(True, 300), _Event(False, 5000), _Event(True, 100)]
    assert gather_probe.device_ms_per_call(events, calls=4) == pytest.approx(0.1)


@pytest.mark.parametrize("events", [[], [_Event(False, 5000)]], ids=["none", "host-only"])
def test_device_time_without_card_events_is_not_measured(events):
    assert gather_probe.device_ms_per_call(events, calls=4) is None


@pytest.mark.parametrize("shape", [(32, 1200), (7, 1001), (1, 3)])
def test_table_copy_on_cpu_is_the_plain_copy(shape):
    x = torch.from_numpy(np.random.default_rng(0).normal(size=shape).astype(np.float32))
    before = table_copy.table_copy_cuda.launches
    out = table_copy.table_copy(x)
    assert table_copy.table_copy_cuda.launches == before  # no kernel on the CPU
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out.view(torch.int32), x.view(torch.int32))
    assert torch.equal(table_copy.table_copy_plain(x), x)


def test_table_copy_kernel_needs_a_cuda_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        table_copy.table_copy_cuda(torch.zeros(2, 3))
