"""Timers — device-accurate timing (reference util/benchmark.hpp Timer /
CPUTimer: a GPU Timer records a cudaEvent pair and reads the span with
cudaEventElapsedTime after synchronizing on the stop event).

The port's counterpart of the JAX package's `caffe_mpi_tpu/utils/timers.py`.
`Timer(device)` on a CUDA device records a `torch.cuda.Event` pair on the
current stream: `stop()` records the end event and synchronizes on it, so
a span around queued work measures that work on the card, not its
enqueue. On the CPU (`Timer()`, or a CPU device) it reads
`time.perf_counter`, as the JAX Timer does.
"""

from __future__ import annotations

import time


class Timer:
    """Accumulating start/stop timer; `device` picks the clock: CUDA
    events for a CUDA device, the host's perf_counter otherwise."""

    def __init__(self, device=None):
        self._cuda = device is not None and getattr(
            device, "type", str(device).split(":")[0]) == "cuda"
        self._device = device
        self._start = None
        self._start_event = None
        self._elapsed = 0.0
        self.running = False

    def start(self) -> None:
        if self._cuda:
            import torch
            with torch.cuda.device(self._device):
                self._start_event = torch.cuda.Event(enable_timing=True)
                self._start_event.record()
        else:
            self._start = time.perf_counter()
        self.running = True

    def _span(self) -> float:
        """Seconds since start(). On the card an end event is recorded on
        the current stream and waited for (cudaEventSynchronize), not the
        whole device."""
        if not self._cuda:
            return time.perf_counter() - self._start
        import torch
        with torch.cuda.device(self._device):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        end.synchronize()
        return self._start_event.elapsed_time(end) / 1e3

    def stop(self) -> float:
        """End the span; returns the seconds accumulated so far."""
        if self.running:
            self._elapsed += self._span()
            self.running = False
        return self._elapsed

    def seconds(self) -> float:
        if self.running:
            return self._elapsed + self._span()
        return self._elapsed

    def milliseconds(self) -> float:
        return self.seconds() * 1e3

    def reset(self) -> None:
        self._elapsed = 0.0
        self.running = False


class CPUTimer(Timer):
    """Host-side spans (reference CPUTimer): the host clock whatever the
    device."""

    def __init__(self):
        super().__init__(None)
