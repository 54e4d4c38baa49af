"""Data pipeline: deterministic synthetic token streams and background
prefetch with straggler mitigation.

A copy of ``repro._unused.train.data`` (numpy only; the port imports
nothing of the JAX package), so the batches are the reference's draws:

  * per-host sharding — each host materializes only its slice of the global
    batch (``local_batch``), so the pipeline scales with hosts;
  * bounded background prefetch (thread + queue) overlaps host-side batch
    assembly with device execution;
  * straggler mitigation — ``next_batch(timeout)`` falls back to the cached
    previous batch when the producer misses its deadline (counted in
    ``stats``);
  * deterministic resume — the stream is a pure function of (seed, step,
    host), drawn from ``SeedSequence([seed, step, host_index])``.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLMStream", "PrefetchPipeline"]


@dataclass
class SyntheticLMStream:
    """Deterministic synthetic LM batches: tokens ~ Zipf, labels = shift."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        if self.global_batch % self.host_count:
            raise ValueError("global_batch must divide by host_count")
        self.local_batch = self.global_batch // self.host_count
        # Zipf-ish distribution over the vocab (heavy head, long tail)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )
        toks = rng.choice(
            self.vocab, size=(self.local_batch, self.seq_len + 1), p=self._probs
        ).astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class PrefetchPipeline:
    """Bounded prefetch + straggler skip over any step-indexed batch source."""

    def __init__(self, source, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._last_good: Optional[dict] = None
        self.stats = {"produced": 0, "straggler_fallbacks": 0}
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = 0
        while not self._stop.is_set():
            batch = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            self.stats["produced"] += 1
            step += 1

    def next_batch(self, timeout: float | None = None) -> dict:
        """Next batch; on producer straggle past ``timeout`` seconds, reuse
        the previous batch (training continues; counted in stats)."""
        try:
            _, batch = self.q.get(timeout=timeout)
            self._last_good = batch
            return batch
        except queue.Empty:
            if self._last_good is None:
                _, batch = self.q.get()  # first batch: no fallback available
                self._last_good = batch
                return batch
            self.stats["straggler_fallbacks"] += 1
            return self._last_good

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
