"""The window's arithmetic on synthetic calls."""
import pytest

from benchmark.harness import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_runs_until_a_call_ends_past_its_length():
    clock = Clock()
    times = [0.3, 0.3, 0.3, 0.3, 5.0]

    def call(i):
        clock.t += times[i]
        return 10, {"i": i}

    win = window.run(call, 1.0, clock=clock)
    assert len(win.calls) == 4  # the 4th ends at 1.2 s, past 1.0
    assert win.seconds == pytest.approx(1.2)


def test_rate_counts_every_call_including_the_last():
    calls = [window.Call(0.0, 1.0, 100), window.Call(1.0, 2.0, 100),
             window.Call(2.0, 4.0, 100)]
    win = window.Window(0.0, 4.0, calls)
    assert window.rate(win) == pytest.approx(75.0)


def test_p95_is_over_every_call():
    durations = [0.010] * 95 + [0.020] * 4 + [1.0]
    t, calls = 0.0, []
    for d in durations:
        calls.append(window.Call(t, t + d, 1))
        t += d
    win = window.Window(0.0, t, calls)
    assert window.call_p95_ms(win) == pytest.approx(10.0)
    calls.append(window.Call(t, t + 2.0, 1))
    assert window.call_p95_ms(window.Window(0.0, t + 2.0, calls)) == \
        pytest.approx(20.0)


@pytest.mark.parametrize("values,q,want", [
    ([3, 1, 2], 50, 2), ([1, 2, 3, 4], 95, 4), (list(range(1, 201)), 95,
                                               190), ([7], 95, 7)])
def test_nearest_rank(values, q, want):
    assert window.percentile(values, q) == want


def test_failed_calls_are_counted_and_fatal_ones_raise():
    clock = Clock()

    def call(i):
        clock.t += 0.4
        if i == 1:
            raise RuntimeError("boom")
        return 1, {}

    win = window.run(call, 1.0, clock=clock)
    assert win.failed == 1 and len(win.calls) == 3
    assert window.rate(win) == pytest.approx(2 / 1.2)

    class Stop(RuntimeError):
        pass

    def fatal(i):
        raise Stop("no inputs")

    with pytest.raises(Stop):
        window.run(fatal, 1.0, clock=clock, fatal=(Stop,))


def test_part_rates_split_the_work_by_where_each_call_ends():
    calls = [window.Call(0.0, 1.0, 100), window.Call(1.0, 2.5, 100),
             window.Call(2.5, 4.0, 100)]
    win = window.Window(0.0, 4.0, calls)
    assert window.part_rates(win, 2) == pytest.approx([50.0, 100.0])
    assert sum(window.part_rates(win, 4)) / 4 == pytest.approx(
        window.rate(win))
