"""Tracing and serving metrics (port of the JAX package's
``utils/profiling.py``).

* `trace` / `named_scope`: a named region in a ``torch.profiler`` trace
  (``record_function``), so the engine's model calls show up by name.
* `profile_to`: a ``torch.profiler`` trace of a region (the host, and the
  card where there is one) written under a directory for TensorBoard or
  Perfetto.
* `Meter`: tokens/s and TTFT percentiles for serving loops, fed by the
  engine's per-request completions.
* `get_logger`: stdlib logging with a shared format.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "metalchat_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
    return logger


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """A named region on the host timeline of a ``torch.profiler`` trace."""
    with record_function(name):
        yield


named_scope = trace


@contextlib.contextmanager
def profile_to(logdir: str) -> Iterator[None]:
    """Trace the region under ``torch.profiler`` (the host's operators, and
    the card's kernels when CUDA is available) and write the trace under
    ``logdir`` as a ``*.pt.trace.json`` file (TensorBoard's profiler
    plugin, Perfetto), as the JAX package's ``profile_to`` writes its
    device trace there."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@dataclass
class Meter:
    """Serving throughput meter: TTFT percentiles + aggregate tokens/s."""

    ttfts: List[float] = field(default_factory=list)
    service_ttfts: List[float] = field(default_factory=list)
    token_counts: List[int] = field(default_factory=list)
    _started: float = 0.0
    _elapsed: float = 0.0

    def start(self) -> None:
        self._started = time.perf_counter()

    def stop(self) -> None:
        self._elapsed += time.perf_counter() - self._started

    def record_request(self, ttft: Optional[float], tokens: int,
                       service_ttft: Optional[float] = None) -> None:
        if ttft is not None:
            self.ttfts.append(ttft)
        if service_ttft is not None:
            self.service_ttfts.append(service_ttft)
        self.token_counts.append(tokens)

    @staticmethod
    def _percentile(data: List[float], pct: float) -> Optional[float]:
        if not data:
            return None
        data = sorted(data)
        idx = min(len(data) - 1, int(pct / 100.0 * len(data)))
        return data[idx]

    def percentile_ttft(self, pct: float) -> Optional[float]:
        return self._percentile(self.ttfts, pct)

    def summary(self) -> Dict[str, float]:
        total = sum(self.token_counts)
        out: Dict[str, float] = {
            "requests": float(len(self.token_counts)),
            "total_tokens": float(total),
        }
        if self._elapsed > 0:
            out["tokens_per_sec"] = total / self._elapsed
        for name, data in (("ttft", self.ttfts),
                           ("service_ttft", self.service_ttfts)):
            p50 = self._percentile(data, 50)
            p99 = self._percentile(data, 99)
            if p50 is not None:
                out[f"{name}_p50"] = p50
            if p99 is not None:
                out[f"{name}_p99"] = p99
        return out
