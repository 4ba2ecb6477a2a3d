"""The measured window: whole batches back to back.

The program returns only when a whole batch is solved, so a part of a
batch cannot be counted. The window therefore runs whole batches: it starts
batch i only while the time already measured plus the mean wall of the
batches so far fits in the window's length, and it always runs one. The
window's length is the sum of the batches' walls, each ending when the
device has finished (``run_batch`` synchronizes), so every rate is over all
the work and all the time of the window.
"""

from __future__ import annotations

import time
from typing import Callable


def run_window(run_batch: Callable[[int], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> list:
    """Run ``run_batch(i)`` for i = 0, 1, ... under the rule above; returns
    ``[(wall_s, result), ...]``, one entry per batch."""
    done = []
    while True:
        if done:
            elapsed = sum(w for w, _ in done)
            if elapsed + elapsed / len(done) > seconds:
                break
        t0 = clock()
        out = run_batch(len(done))
        done.append((clock() - t0, out))
    return done
