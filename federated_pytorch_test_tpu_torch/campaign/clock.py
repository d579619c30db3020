"""Deterministic virtual clock: accelerated time for soak campaigns.

Port of ``federated_pytorch_test_tpu/campaign/clock.py``, copied as it is.

The determinism contract: the virtual clock NEVER
feeds math or recorded values — it only scales how long the process
actually waits.  Every recorded duration (the supervisor's
``backoff_seconds``, the health monitor's round-count windows) keeps
its unscaled deterministic value, so ``control.replay``'s pure-function
re-derivation is untouched; ``accel`` merely divides the wall-clock
spent sleeping, which was never recorded in a replay-checked field to
begin with.  A simulated week of diurnal load therefore runs in CI
minutes with a bit-identical stream.
"""

from __future__ import annotations

import time
from typing import Callable


class VirtualClock:
    """Scales sleeps by ``accel`` virtual seconds per wall second.

    ``sleep(virtual_seconds)`` waits ``virtual_seconds / accel`` wall
    seconds (``accel >= 1`` compresses, ``accel = 1`` is real time) and
    advances the virtual-time ledger either way.  Inject it wherever a
    component accepts a ``sleep=`` callable — the restart supervisor's
    backoff is the canonical site — and the component's recorded values
    stay byte-identical to the unaccelerated run.
    """

    def __init__(self, accel: float = 1.0,
                 sleep: Callable[[float], None] = time.sleep):
        if accel <= 0:
            raise ValueError(f"virtual-clock accel={accel} must be > 0")
        self.accel = float(accel)
        self._sleep = sleep
        self.virtual_slept = 0.0
        self.wall_slept = 0.0

    def sleep(self, seconds: float) -> None:
        """Wait ``seconds`` VIRTUAL seconds (``seconds/accel`` wall)."""
        if seconds <= 0:
            return
        wall = seconds / self.accel
        self._sleep(wall)
        self.virtual_slept += float(seconds)
        self.wall_slept += wall

    def __repr__(self) -> str:
        return (f"VirtualClock(accel={self.accel:g}, "
                f"virtual_slept={self.virtual_slept:.3f}s, "
                f"wall_slept={self.wall_slept:.3f}s)")


def selftest() -> str:
    """No real waiting: a recording fake stands in for time.sleep."""
    waits: list = []
    c = VirtualClock(accel=120.0, sleep=waits.append)
    c.sleep(60.0)
    c.sleep(0.0)
    c.sleep(6.0)
    assert waits == [0.5, 0.05], waits
    assert c.virtual_slept == 66.0 and abs(c.wall_slept - 0.55) < 1e-12
    try:
        VirtualClock(accel=0.0)
    except ValueError:
        pass
    else:
        raise AssertionError("accel=0 accepted")
    return "virtual clock selftest OK: 66.0 virtual s in 0.55 wall s"


if __name__ == "__main__":
    print(selftest())
