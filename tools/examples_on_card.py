#!/usr/bin/env python3
"""``chip_smoke.py``'s examples phase alone, on one card.

    python3 tools/examples_on_card.py

Builds the kernels (``chip_smoke.phase_device``), then runs
``chip_smoke.phase_examples`` twice in this one process: the first round
right after the build (cold: cuBLAS and the optimizer's kernels start
there), the second warm, as the phase runs inside the full
``chip_smoke.py``, where every earlier phase has warmed the process.
Each round holds every check of the phase and prints its lines: the train
pair's wall seconds, each arch's ms a serve step and launches. Prints, as
its last lines, one JSON object of both rounds and the card's name and
power limit. Needs one card; exits non-zero without one.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG first)
import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("examples_on_card: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    dev = cs.phase_device()
    rounds = [cs.phase_examples() for _ in range(2)]   # cold, then warm
    print(json.dumps({"rounds": rounds}))
    print(f"card: {dev['smi']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
