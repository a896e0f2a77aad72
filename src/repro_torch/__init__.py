"""PyTorch + CUDA port of the ``repro`` model substrate, for NVIDIA Hopper.

The subpackages mirror ``repro``'s names (``configs``, ``kernels``,
``models``, ``serving``, ``launch``) so each module's counterpart is easy to
find. The port imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro`` (its tests import both, and ``bridge`` moves numpy pytrees across).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``resolve_device``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means ``cuda`` and raises when no card is present; a CPU run
    must be asked for by name. Nothing here falls back silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
