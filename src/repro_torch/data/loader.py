"""Host data loader with background prefetch (port of
``repro.data.loader``; ``device=`` where the reference takes
``sharding=``).

A thread calls the pure ``batch_fn(step, shard, n_shards)`` ahead of the
loop and, given a device, hands each batch over as tensors there.  Every
array is copied before the hand-off: ``torch.from_numpy`` shares the host
array's memory, and a generator that reuses its buffers would change a
batch already handed over (the reference's PR 8 aliasing bug).
Restart-exactness: the loader's state is just the step counter.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch


def to_device(batch: dict, device) -> dict:
    """``batch``'s arrays as tensors on ``device``, each copied off the host
    array first."""
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in batch.items()}


class PrefetchLoader:
    def __init__(self, batch_fn: Callable[[int, int, int], dict], device=None,
                 start_step: int = 0, prefetch: int = 2):
        self.batch_fn = batch_fn
        self.device = device
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_fn(step, 0, 1)
            if self.device is not None:
                batch = to_device(batch, self.device)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:  # drain so the worker can exit
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
