"""Console progress bar with ETA — host-side analog of the reference's 1 Hz
reporter thread (src/camera.h:67-109), driven by per-chunk completions
instead of polling."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, total: int, bar_length: int = 30, stream=None, min_interval=0.5):
        self.total = max(1, total)
        self.bar_length = bar_length
        self.stream = stream or sys.stderr
        self.t0 = time.monotonic()
        self.done = 0
        self._last_print = 0.0
        self.min_interval = min_interval

    def update(self, n: int = 1):
        self.done += n
        now = time.monotonic()
        if now - self._last_print < self.min_interval and self.done < self.total:
            return
        self._last_print = now
        progress = self.done / self.total
        filled = int(progress * self.bar_length + 0.5)
        dt = now - self.t0
        rate = self.done / dt if dt > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else 0.0
        mins, secs = divmod(int(eta + 0.999), 60)
        hrs, mins = divmod(mins, 60)
        eta_s = (f"{hrs}:" if hrs else "") + f"{mins:02d}:{secs:02d}"
        self.stream.write(
            f"\r[{'#' * filled}{' ' * (self.bar_length - filled)}] "
            f"{int(progress * 100):3d}% | {self.done}/{self.total} | ETA: {eta_s}"
        )
        self.stream.flush()

    def finish(self):
        dt = time.monotonic() - self.t0
        mins, secs = divmod(int(dt + 0.999), 60)
        hrs, mins = divmod(mins, 60)
        run_s = (f"{hrs}:" if hrs else "") + f"{mins:02d}:{secs:02d}"
        self.stream.write(
            f"\r[{'#' * self.bar_length}] 100% | {self.total}/{self.total} "
            f"| Runtime: {run_s}\n"
        )
        self.stream.flush()
