"""Fault-tolerance machinery of the training loop (port of
``repro.train.fault_tolerance``).

* preemption / failure -> checkpoint + restart: ``PreemptionHandler`` and
  the ``Checkpointer``;
* stragglers -> detection (``StepTimer``, a rolling median);
* liveness -> a ``Heartbeat`` file read by an external supervisor.  The
  port writes it atomically (a temporary file, then ``os.replace``), so a
  reader never sees it empty or half written;
* ``FailureInjector`` raises at a chosen step, for restart tests.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from collections import deque


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a cooperative 'please checkpoint' flag.

    The train loop polls ``should_stop`` each step and writes a final
    checkpoint before exiting."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handle)
            except ValueError:  # not the main thread (tests)
                pass

    def _handle(self, signum, frame):
        self._stop.set()

    def request_stop(self):  # programmatic (tests / simulated failures)
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


class StepTimer:
    """Straggler detector: flags steps slower than ``threshold`` x the
    rolling median.  ``clock`` injectable for tests."""

    def __init__(self, window: int = 32, threshold: float = 2.5, clock=time.monotonic):
        self.window = window
        self.threshold = threshold
        self.clock = clock
        self.durations: deque[float] = deque(maxlen=window)
        self._t0: float | None = None
        self.straggler_events: list[tuple[int, float, float]] = []
        self.step_idx = 0

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> tuple[float, bool]:
        """Returns (duration, is_straggler)."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = self.clock() - self._t0
        self._t0 = None
        is_straggler = False
        if len(self.durations) >= max(4, self.window // 4):
            med = sorted(self.durations)[len(self.durations) // 2]
            if dt > self.threshold * med:
                is_straggler = True
                self.straggler_events.append((self.step_idx, dt, med))
        self.durations.append(dt)
        self.step_idx += 1
        return dt, is_straggler


class Heartbeat:
    """Background thread rewriting a liveness file every ``interval`` s.

    Each beat writes ``<path>.tmp`` and renames it over ``path``
    (``os.replace`` is atomic on POSIX), so ``is_alive`` never reads an
    empty file between the open and the write."""

    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def beat(self):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(time.time()))
        os.replace(tmp, self.path)

    def _run(self):
        while not self._stop.is_set():
            self.beat()
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        if os.path.exists(self.path):
            os.unlink(self.path)

    @staticmethod
    def is_alive(path: str, timeout: float = 30.0) -> bool:
        try:
            with open(path) as f:
                return time.time() - float(f.read()) < timeout
        except (OSError, ValueError):
            return False


class FailureInjector:
    """Deterministic failure injection for integration tests: raises at a
    chosen step, to exercise checkpoint-restart-resume."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step

    def maybe_fail(self, step: int):
        if self.fail_at_step is not None and step == self.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
