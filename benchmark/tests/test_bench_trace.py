"""The trace reduction on a hand-made event list: kernels take the phase
whose range holds their launch call, the ranges' device mirrors and the
copies are not kernels, and busy time is the union of device intervals."""

import pytest

from benchmark import trace as tr


class Ev:
    def __init__(self, name, device, start, dur, corr=0):
        self._v = (name, device, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType." + self._v[1]

    def start_ns(self):
        return self._v[2] * 1000

    def duration_ns(self):
        return self._v[3] * 1000

    def correlation_id(self):
        return self._v[4]


EVENTS = [
    Ev(tr.WINDOW_RANGE, "CPU", 0, 1000),
    Ev("_prepare_song", "CPU", 10, 200),
    Ev("cudaLaunchKernel", "CPU", 20, 5, corr=7),
    Ev("_convert_rows", "CPU", 300, 300),
    Ev("cudaLaunchKernel", "CPU", 310, 5, corr=8),
    Ev("cuLaunchKernelEx", "CPU", 320, 5, corr=9),
    Ev("cudaLaunchKernel", "CPU", 700, 5, corr=10),
    Ev("aten::mm", "CPU", 800, 150),
    Ev("gru_step", "CUDA", 100, 50, corr=7),
    Ev("pair_kernel<128>", "CUDA", 400, 100, corr=8),
    Ev("pair_kernel<64>", "CUDA", 450, 100, corr=9),
    Ev("elementwise", "CUDA", 710, 40, corr=10),
    Ev("Memcpy HtoD", "CUDA", 760, 10),
    Ev("_convert_rows", "CUDA", 400, 150),        # the range's device mirror
    Ev(tr.WINDOW_RANGE, "CUDA", 0, 1000),
]


@pytest.fixture
def reduced():
    return tr.reduce_events(EVENTS)


def test_kernels_take_their_launch_phase(reduced):
    phases = {name: ph for name, _, _, ph in reduced.kernels}
    assert phases == {"gru_step": "_prepare_song", "pair_kernel<128>": "_convert_rows",
                      "pair_kernel<64>": "_convert_rows", "elementwise": None}
    assert reduced.kernel_ns(phase="_convert_rows") == 200_000
    assert reduced.kernel_ns(("pair_kernel",)) == 200_000
    assert reduced.unattributed == 0


def test_busy_is_the_union_and_gaps_the_rest(reduced):
    # busy 100-150, 400-550, 710-750, 760-770 (us)
    assert reduced.busy_ns() == (50 + 150 + 40 + 10) * 1000
    assert reduced.idle_gaps()[0] == (0, 100_000)
    gaps = dict(tr.gap_breakdown(reduced))
    assert gaps["aten::mm"] == pytest.approx(230e-6)     # 770-1000, inside the op
    assert gaps["_prepare_song"] == pytest.approx(100e-6)  # 0-100, inside the range
    assert gaps["python (no op)"] == pytest.approx(410e-6)  # 150-400 and 550-710
    assert gaps["gaps under 20 us"] == pytest.approx(10e-6)  # 750-760
    assert sum(gaps.values()) == pytest.approx((1000 - 250) * 1e-6)


def test_a_trace_without_the_window_range_is_refused():
    with pytest.raises(RuntimeError):
        tr.reduce_events(EVENTS[1:])
