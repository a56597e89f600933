"""Per-arch batch construction (port of `repro.train.batching`): the batch
shapes, meta-device stand-ins for the dry-run (`input_specs`), random
batches and the forward's inputs.

The modality frontends are stubs, as in the reference: an audio batch
carries precomputed frame embeddings in place of tokens, a vision batch
a prefix of N_PATCHES patch embeddings before its tokens, with 3-D
(t, h, w) M-RoPE position ids over the whole sequence.  `synthetic_batch`
draws from numpy's `default_rng(seed)` in the reference's order, so both
packages build the same batch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of

N_PATCHES = 1024   # vision prefix length inside seq_len (stubbed frontend)


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec, kind: str | None = None) -> dict:
    """{name: (shape, dtype)} for one global batch."""
    kind = kind or shape.kind
    b, s = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg)
    train = {"labels": ((b, s), torch.int32), "loss_mask": ((b, s), torch.float32)}
    if kind == "decode":
        out = {"tokens": ((b, 1), torch.int32)}
        if cfg.pos_emb == "mrope":
            out["positions3"] = ((3, b, 1), torch.int32)
        return out
    if cfg.modality == "audio":
        out = {"embeds": ((b, s, cfg.d_model), dt)}
    elif cfg.modality == "vision":
        p = min(N_PATCHES, s // 2)
        out = {"tokens": ((b, s - p), torch.int32),
               "embeds": ((b, p, cfg.d_model), dt),
               "positions3": ((3, b, s), torch.int32)}
    else:
        out = {"tokens": ((b, s), torch.int32)}
    if kind == "train":
        out.update(train)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, kind: str | None = None) -> dict:
    """Stand-ins for every model input on the meta device (shapes and
    dtypes, no storage), the reference's `ShapeDtypeStruct`s."""
    return {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, dt) in batch_shapes(cfg, shape, kind).items()}


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                    kind: str | None = None, device=None) -> dict:
    """A random batch with `batch_shapes`' structure on `device`: integer
    ids below vocab (tokens, labels) or below the last axis' length
    (positions3), loss_mask ones, embeddings N(0, 1) in cfg.dtype."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (sh, dt) in batch_shapes(cfg, shape, kind).items():
        if dt == torch.int32:
            hi = cfg.vocab if k in ("tokens", "labels") else max(sh[-1], 2)
            arr = torch.from_numpy(rng.integers(0, hi, sh).astype(np.int32))
        elif k == "loss_mask":
            arr = torch.ones(sh, dtype=dt)
        else:
            arr = torch.from_numpy(rng.normal(0, 1, sh)).to(dt)
        out[k] = arr.to(device)
    return out


def forward_kwargs(cfg: ModelConfig, batch: dict) -> dict:
    """The forward() inputs of a batch (labels stay behind)."""
    return {k: batch[k] for k in ("tokens", "embeds", "positions3") if k in batch}
