"""Leveled logging and a console progress bar: `common/sys/logging.h:
17-56` and the tile progress bar (`devices/device_singleray/
progress.cpp:20-60`).

Counterpart of `yulio_raytracer_tpu/utils/logging.py`.  The reference's
parser clears `log_display` for `--no-logging`; the port's parser clears
`RenderSettings.log_display` instead, and its entry points hand that on
here (`api/cli.py`, `api/output.py`).
"""
from __future__ import annotations

import sys
import time

CRITICAL, ERROR, WARNING, INFO, DEBUG = 0, 1, 2, 3, 4
_NAMES = ['CRITICAL', 'ERROR', 'WARNING', 'INFO', 'DEBUG']

log_level = INFO
log_display = True          # --no-logging clears it (renderer.cpp:989)
log_time = False
_t0 = time.time()


def log(level: int, msg: str):
    if not log_display or level > log_level:
        return
    prefix = f"[{_NAMES[level]}]"
    if log_time:
        prefix += f"[{time.time() - _t0:8.3f}s]"
    print(f"{prefix} {msg}", file=sys.stderr)


def critical(msg): log(CRITICAL, msg)
def error(msg): log(ERROR, msg)
def warning(msg): log(WARNING, msg)
def info(msg): log(INFO, msg)
def debug(msg): log(DEBUG, msg)


class Progress:
    """Console progress bar over render passes (progress.cpp:20-60)."""

    def __init__(self, total: int, label: str = 'rendering',
                 width: int = 40, stream=None):
        self.total = max(total, 1)
        self.label = label
        self.width = width
        self.stream = sys.stderr if stream is None else stream
        self._drawn = -1

    def start(self):
        self.update(0)

    def update(self, done: int):
        if not log_display:
            return
        frac = min(done / self.total, 1.0)
        n = int(frac * self.width)
        if n == self._drawn:
            return
        self._drawn = n
        bar = '+' * n + '-' * (self.width - n)
        self.stream.write(f"\r{self.label} [{bar}] {frac * 100:5.1f}%")
        self.stream.flush()

    def end(self):
        if not log_display:
            return
        self.update(self.total)
        self.stream.write("\n")
        self.stream.flush()
