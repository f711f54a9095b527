"""Deterministic, restart-safe synthetic token pipeline; the counterpart of
``repro.data.pipeline``.

Batches are a pure function of (seed, step): a job restarted from step N
sees exactly the stream it would have seen. ``make_batch`` is the
reference's NumPy code, so both packages make the same bits. A background
prefetch thread keeps ``depth`` batches ahead of the training loop, already
on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import Device, resolve_device
from repro_torch.configs.base import ModelConfig


def _batch_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int, step: int,
               with_frontend: bool = True) -> Dict[str, np.ndarray]:
    """Markov-chain synthetic tokens (non-uniform so loss is learnable)."""
    rng = _batch_rng(seed, step)
    v = cfg.vocab
    # Low-entropy transitions: next = (prev * a + noise) % vocab.
    starts = rng.integers(0, v, size=(batch, 1))
    steps = rng.integers(0, 17, size=(batch, seq))
    tokens = (starts + np.cumsum(steps, axis=1)) % v
    tokens = tokens.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if with_frontend and cfg.frontend != "none":
        f = cfg.frontend_len
        out["frontend"] = rng.standard_normal(
            (batch, f, cfg.d_model)).astype(np.float32) * 0.02
    return out


class _ProducerFailed:
    """Queue sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataPipeline:
    """Prefetching iterator of batches on ``device`` (the card unless named).

    Producer failures propagate: an exception on the prefetch thread reaches
    the consumer as a :class:`RuntimeError` (with the original as
    ``__cause__``) at the next ``__next__``, instead of leaving the training
    loop blocked on an empty queue.
    """

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
                 start_step: int = 0, device: Device = None, depth: int = 2):
        if cfg.frontend == "vision_stub":
            seq = seq - cfg.frontend_len
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.step = start_step
        self.device = resolve_device(device)
        self.depth = depth
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._failure: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _produce_one(self, step: int) -> Dict[str, torch.Tensor]:
        host = make_batch(self.cfg, self.batch, self.seq, self.seed, step)
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = self._produce_one(step)
            except BaseException as exc:  # noqa: BLE001 — relayed to consumer
                self._failure = exc
                self._offer(_ProducerFailed(exc))
                return
            # Produce once, then retry the same item until it fits (or the
            # pipeline is stopped).
            if self._offer(item):
                step += 1

    def _offer(self, item) -> bool:
        """Put with stop-polling: returns False only when shutting down."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while True:
            try:
                # Bounded waits so a dead producer surfaces instead of
                # blocking the training loop on an empty queue forever.
                item = self._queue.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    exc = self._failure
                    raise RuntimeError(
                        "data pipeline producer thread died"
                        + (f": {type(exc).__name__}: {exc}" if exc else "")
                    ) from exc
        if isinstance(item, _ProducerFailed):
            raise RuntimeError(
                f"data pipeline producer failed: "
                f"{type(item.exc).__name__}: {item.exc}") from item.exc
        self.step += 1
        return item

    def close(self, timeout: float = 2.0):
        """Stop the producer; raises if the thread is stuck (leaking it
        silently would hide a wedged copy to the device for the life of the
        process)."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                "data pipeline producer thread failed to stop within "
                f"{timeout:.1f}s (blocked outside the queue?)")
