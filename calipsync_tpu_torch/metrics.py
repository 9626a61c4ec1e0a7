"""Structured metrics and logging (the port's own copy of
calipsync_tpu/metrics.py).

Process-wide counters, gauges and timing stats with JSONL export, and a
logger factory with one format. Thread-safe; serving records into it at a
dict update per event (``serve/stream_manager.py``, ``cli.py serve``).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import defaultdict
from typing import Dict, Optional


def get_logger(name: str = "calipsync") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class Metrics:
    """Counters, gauges and streaming timing stats keyed by name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = defaultdict(float)
        self._gauges: Dict[str, float] = {}
        self._timings: Dict[str, list] = defaultdict(
            lambda: [0, 0.0, 0.0, float("inf"), 0.0])  # n, sum, sumsq, min, max

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            t = self._timings[name]
            t[0] += 1
            t[1] += seconds
            t[2] += seconds * seconds
            t[3] = min(t[3], seconds)
            t[4] = max(t[4], seconds)

    def time(self, name: str):
        metrics = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.time()
                return self

            def __exit__(self, *exc):
                metrics.observe(name, time.time() - self.t0)

        return _Ctx()

    def snapshot(self) -> dict:
        with self._lock:
            timings = {}
            for k, (n, s, ss, mn, mx) in self._timings.items():
                mean = s / n if n else 0.0
                var = max(0.0, ss / n - mean * mean) if n else 0.0
                timings[k] = {"count": n, "mean_ms": mean * 1000,
                              "std_ms": var ** 0.5 * 1000,
                              "min_ms": mn * 1000 if n else 0.0,
                              "max_ms": mx * 1000}
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "timings": timings,
                    "ts": time.time()}

    def dump_jsonl(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.snapshot()) + "\n")

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._timings.clear()


_global: Optional[Metrics] = None
_global_lock = threading.Lock()


def global_metrics() -> Metrics:
    global _global
    with _global_lock:
        if _global is None:
            _global = Metrics()
        return _global
