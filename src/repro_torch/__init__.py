"""PyTorch + CUDA port of the ``repro`` model substrate, for NVIDIA Hopper.

The subpackages mirror ``repro``'s names (``configs``, ``kernels``,
``models``, ``serving``, ``launch``) so each module's counterpart is easy to
find. The port imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro`` (its tests import both, and ``bridge`` moves numpy pytrees across).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (``resolve_device``).

Importing the package loads no ``torch``: the engine (``repro_torch.core``)
is pure Python, and its process-mode workers and node agents start without
paying for torch's import. The modules that need torch import it themselves.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means ``cuda`` and raises when no card is present; a CPU run
    must be asked for by name. Nothing here falls back silently. ``"meta"``
    builds shapes without storage (``launch.input_specs``).
    """
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
