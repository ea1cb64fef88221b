"""Utilities: logging, progress, result caching, a wall timer.

A copy of :mod:`biseqt_tpu.utils` (the reference's ``biseqt/util.py`` and
``experiments/util.py — ProgressIndicator, with_dumpfile``); pure
Python, no device work.  Loggers live under ``biseqt_tpu_torch.``.
"""

from __future__ import annotations

import functools
import logging
import os
import pickle
import sys
import time

__all__ = ["ProgressIndicator", "with_dumpfile", "get_logger", "Timer"]


def get_logger(name: str, level=logging.INFO) -> logging.Logger:
    """Per-component logger with a sane default handler."""
    logger = logging.getLogger("biseqt_tpu_torch.%s" % name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s] %(name)s %(levelname)s: %(message)s", "%H:%M:%S"
        ))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class ProgressIndicator:
    """Throttled progress reporting for long builds (ref: util.py)."""

    def __init__(self, total: int = None, msg: str = "", f=sys.stderr,
                 interval: float = 1.0):
        self.total = total
        self.msg = msg
        self.f = f
        self.interval = interval
        self.count = 0
        self._last = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.time()
        self._last = 0.0
        return self

    def progress(self, inc: int = 1):
        self.count += inc
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        if self.total:
            self.f.write(
                "\r%s %d/%d (%.0f%%)" % (
                    self.msg, self.count, self.total,
                    100.0 * self.count / self.total,
                )
            )
        else:
            self.f.write("\r%s %d" % (self.msg, self.count))
        self.f.flush()

    def finish(self):
        dt = time.time() - (self._t0 or time.time())
        self.f.write("\r%s %d done (%.1fs)\n" % (self.msg, self.count, dt))
        self.f.flush()


def with_dumpfile(fn):
    """Cache a function's return value in a pickle (ref: experiments/util.py).

    The wrapped function gains ``dumpfile=`` and ``ignore_existing=``
    kwargs; when a dumpfile exists the stored result is returned without
    recomputation — the reference's experiment checkpointing mechanism.
    """

    @functools.wraps(fn)
    def wrapper(*args, dumpfile: str = None, ignore_existing: bool = False,
                **kwargs):
        if dumpfile and not ignore_existing and os.path.exists(dumpfile):
            with open(dumpfile, "rb") as f:
                return pickle.load(f)
        out = fn(*args, **kwargs)
        if dumpfile:
            d = os.path.dirname(dumpfile)
            if d:
                os.makedirs(d, exist_ok=True)
            # atomic replace: a kill mid-dump must not leave a truncated
            # pickle that poisons every later run's cache-hit path
            tmp = dumpfile + ".tmp.%d" % os.getpid()
            with open(tmp, "wb") as f:
                pickle.dump(out, f)
            os.replace(tmp, dumpfile)
        return out

    return wrapper


class Timer:
    """Context-manager wall timer: ``with Timer() as t: ...; t.elapsed``."""

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self.t0
        return False
