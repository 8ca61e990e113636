"""Deterministic synthetic data pipeline — the port of
``repro/data/pipeline.py``.

Each step's global batch is a pure function of (seed, step): the same
``np.random.default_rng((seed, step))`` draws as the reference, so the port
and the reference train on identical batches, and a restarted run
regenerates exactly the batches it lost with no loader state beyond the
step counter.  :func:`to_device` turns a batch into torch tensors (tokens
int32, frontend embeddings in the model's dtype, rounded as numpy's
bfloat16 rounds them).  A background thread (:class:`Prefetcher`) keeps
``depth`` batches in flight.  The reference's ``device_batch`` places
shards on a mesh, which waits for multi-GPU (ROADMAP A10).
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.frontend import FRONTEND_DIMS


@dataclass(frozen=True)
class DataConfig:
    seed: int = 17
    global_batch: int = 8
    seq_len: int = 128


def batch_struct(cfg, data: DataConfig) -> dict:
    """Shapes and dtypes of one batch: {name: (shape, torch dtype)}."""
    B, S = data.global_batch, data.seq_len
    if cfg.frontend:
        return {"embeds": ((B, S, FRONTEND_DIMS[cfg.frontend]),
                           cfg.torch_dtype),
                "targets": ((B, S), torch.int32)}
    return {"tokens": ((B, S), torch.int32)}


def make_batch(cfg, data: DataConfig, step: int, *, lo: int = 0,
               hi: int | None = None) -> dict:
    """The batch of ``step`` as numpy arrays; [lo, hi) selects a host's
    rows.  Tokens are int32; a frontend's embeddings stay fp32 here (numpy
    has no bfloat16) and take the model's dtype in :func:`to_device`."""
    hi = data.global_batch if hi is None else hi
    rng = np.random.default_rng((data.seed, step))
    tokens = rng.integers(0, cfg.vocab_size,
                          size=(data.global_batch, data.seq_len),
                          dtype=np.int32)[lo:hi]
    if cfg.frontend:
        emb = rng.standard_normal(
            (data.global_batch, data.seq_len, FRONTEND_DIMS[cfg.frontend]),
            dtype=np.float32)[lo:hi]
        return {"embeds": emb, "targets": tokens}
    return {"tokens": tokens}


def to_device(cfg, batch: dict, device) -> dict:
    """A :func:`make_batch` batch as torch tensors on ``device``: integer
    arrays as int32, embeddings in ``cfg``'s dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.to(torch.int32) if k != "embeds" else t.to(cfg.torch_dtype)
        out[k] = t.to(device)
    return out


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded): yields (step,
    batch on ``device``) from ``start_step`` on."""

    def __init__(self, cfg, data: DataConfig, device="cpu",
                 start_step: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = to_device(cfg, make_batch(cfg, data, step), device)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1
        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()

    def close(self):
        self._stop.set()
        self._t.join()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
