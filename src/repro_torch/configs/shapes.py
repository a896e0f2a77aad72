"""Assigned input-shape sets for the LM-family architectures: the port's copy
of ``repro.configs.shapes``.

``train_*`` / ``prefill_*`` lower ``train_step`` / prefill forward;
``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV /
SSM cache of ``seq_len``), NOT ``train_step``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str             # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    # microbatch accumulation for training (tuned per arch in dryrun)
    accum: int = 1


TRAIN_4K = ShapeSpec("train_4k", "train", seq_len=4_096, global_batch=256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", seq_len=32_768, global_batch=32)
DECODE_32K = ShapeSpec("decode_32k", "decode", seq_len=32_768, global_batch=128)
LONG_500K = ShapeSpec("long_500k", "decode", seq_len=524_288, global_batch=1)

ALL_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shapes_for(arch) -> list:
    """Applicable shape cells for an arch (long_500k needs sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch.subquadratic:
        out.append(LONG_500K)
    return out
