"""Assigned input-shape sets (same four for every LM arch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``.  long_500k requires sub-quadratic
attention (SSM / hybrid / sliding-window); encoder-only archs have no
decode shapes.  Skips are recorded per-arch in DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# reduced variants for CPU smoke tests
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


def runnable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(ok, reason-if-skipped) per the assignment's skip rules."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""
