"""The window rule: at least one batch, no batch started that would not
fit by the mean wall so far, and the window is the sum of the walls."""

import pytest

from harness import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _run(walls, seconds):
    clock = Clock()

    def batch(i):
        clock.t += walls[i]
        return i

    return window.run_window(batch, seconds, clock=clock)


@pytest.mark.parametrize("walls,seconds,expect", [
    ([45.0, 45.0], 51, 1),            # one batch longer than half the window
    ([80.0, 80.0], 51, 1),            # a batch longer than the window still runs
    ([20.0, 20.0, 20.0, 20.0], 51, 2),  # 40 + 20 > 51: no third
    ([10.0, 10.0, 10.0, 10.0, 10.0, 10.0], 51, 5),
    ([10.0, 30.0, 10.0], 51, 2),      # the mean after two is 20: 40 + 20 > 51
])
def test_batches_started(walls, seconds, expect):
    done = _run(walls, seconds)
    assert len(done) == expect
    assert [r for _, r in done] == list(range(expect))
    assert sum(w for w, _ in done) == pytest.approx(sum(walls[:expect]))


def test_rates_over_the_whole_window():
    from harness import cells

    run = {"setup_s": 3.0, "window_s": 50.0, "counts": {"lockstep": 0, "cold": 0},
           "trace": None,
           "batches": [{"lanes": 512, "converged": 512, "lockstep": 30,
                        "wall_s": 30.0},
                       {"lanes": 512, "converged": 500, "lockstep": 20,
                        "wall_s": 20.0}]}
    assert cells.reader("converged_solves_per_s")(run) == pytest.approx(
        1012 / 50.0)
    assert cells.reader("lockstep_iter_ms")(run) == pytest.approx(1e3)
    assert cells.reader("lockstep_iters_per_batch")(run) == pytest.approx(25)
