"""Synthetic data pipeline (port of `repro.train.data`): deterministic,
shard-aware, host-prefetched.

`SyntheticDataset.batch(step)` draws from numpy's
`default_rng((seed, step, process_index))` in the reference's order, so
its numpy batches are bit-equal to the reference's; `to_device` turns one
into tensors on the card (embeddings in cfg.dtype).  `Prefetcher` keeps
`prefetch` batches ahead of the step loop in a thread, each passed
through `put_fn` (the host-to-device copy overlaps the previous step).
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.train.batching import batch_shapes


class SyntheticDataset:
    """Zipf-distributed token streams (vocab-shaped, deterministic)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.process_index, self.process_count = process_index, process_count
        self.shapes = batch_shapes(cfg, shape, "train")

    def batch(self, step: int) -> dict:
        """This process's share of the global batch of `step`, as numpy
        arrays: int32 ids (Zipf(1.3) - 1, clipped below vocab, or below 4
        for positions3), loss_mask ones, embeddings N(0, 1) float32."""
        rng = np.random.default_rng((self.seed, step, self.process_index))
        out = {}
        for k, (sh, dt) in self.shapes.items():
            local = (sh[0] // self.process_count,) + tuple(sh[1:])
            if k == "positions3":
                local = (3, sh[1] // self.process_count) + tuple(sh[2:])
            if dt == torch.int32:
                hi = self.cfg.vocab if k in ("tokens", "labels") else 4
                # zipf-ish skew, clipped into the vocab
                z = rng.zipf(1.3, size=local) - 1
                out[k] = np.asarray(np.minimum(z, hi - 1), np.int32)
            elif k == "loss_mask":
                out[k] = np.ones(local, np.float32)
            else:
                out[k] = rng.normal(0, 1, local).astype(np.float32)
        return out


def to_device(batch: dict, cfg: ModelConfig, device) -> dict:
    """A numpy batch as tensors on `device`: embeddings in cfg.dtype, the
    rest in their own dtype."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if k == "embeds":
            t = t.to(dtype_of(cfg))
        out[k] = t.to(device, non_blocking=True)
    return out


class Prefetcher:
    def __init__(self, dataset: SyntheticDataset, prefetch: int = 2,
                 start_step: int = 0, put_fn=None):
        self.dataset = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.put_fn = put_fn or (lambda b: b)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        while not self._stop.is_set():
            try:
                self.q.put((self._step, self.put_fn(self.dataset.batch(self._step))),
                           timeout=0.2)
                self._step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
