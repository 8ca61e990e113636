"""Deterministic synthetic data pipeline — the port of
``repro/data/pipeline.py``.

Each step's global batch is a pure function of (seed, step): the same
``np.random.default_rng((seed, step))`` draws as the reference, so the port
and the reference train on identical batches, and a restarted run
regenerates exactly the batches it lost with no loader state beyond the
step counter.  :func:`to_device` turns a batch into torch tensors (tokens
int32, frontend embeddings in the model's dtype, rounded as numpy's
bfloat16 rounds them).  :func:`device_batch` is a rank's rows of a step's
batch on a mesh (the reference's ``device_batch``, whose sharding
materializes each device's rows of ``data_spec``), on the rank's device.
A background thread (:class:`Prefetcher`) keeps ``depth`` batches in
flight.
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.frontend import FRONTEND_DIMS
from repro_torch.sharding import rules


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


def device_batch(cfg, data: DataConfig, step: int, mesh=None,
                 device="cpu") -> dict:
    """The batch of ``step`` as :func:`to_device` gives it on ``device``:
    under ``mesh`` only this rank's rows, its slice of ``rules.data_spec``
    over the batch axes (made as :func:`make_batch`'s [lo, hi), which
    draws the whole batch and keeps those rows); the whole batch without
    a mesh.  Rows the batch axes do not divide raise."""
    lo, hi = 0, data.global_batch
    if mesh is not None:
        rows = rules.local_slices((data.global_batch,),
                                  rules.data_spec(mesh, 1), mesh)[0]
        lo, hi = rows.start, rows.stop
    return to_device(cfg, make_batch(cfg, data, step, lo=lo, hi=hi), device)


class Prefetcher:
    """Background-thread batch prefetch (depth-bounded): yields (step,
    :func:`device_batch`'s batch on ``device``, under ``mesh`` the rank's
    rows) from ``start_step`` on."""

    def __init__(self, cfg, data: DataConfig, device="cpu",
                 start_step: int = 0, depth: int = 2, mesh=None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                batch = device_batch(cfg, data, step, mesh, device)
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
