"""Logging and metering (counterpart of the JAX package's
`utils/meters.py`): the stdout tee `Logger`, the running-average
`AverageMeter` and the wall-clock `StepTimer` the training loop prints."""

from __future__ import annotations

import sys
import time


class Logger:
    """Tee stdout to a logfile (install via `sys.stdout = Logger(path)`);
    `close()` closes the file."""

    def __init__(self, filename: str = "default.log", stream=None):
        self.terminal = stream or sys.stdout
        self.log = open(filename, "w")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        if "\n" in message:
            # training prints are minutes apart; an unflushed logfile
            # makes a long run look hung from outside
            self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Wall-clock time of each batch (`batch`) and of the wait for its
    data (`data`, from the end of the last batch to the data's arrival)."""

    def __init__(self):
        self.batch = AverageMeter()
        self.data = AverageMeter()
        self._t = time.time()

    def mark_data(self):
        now = time.time()
        self.data.update(now - self._t)
        return now

    def mark_batch(self):
        now = time.time()
        self.batch.update(now - self._t)
        self._t = now
