"""Device resolution shared by the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``. Asking for the card
where there is none raises; nothing quietly moves to the CPU. The CPU runs
the port only when the caller asks for it (``device="cpu"``), as the tests
do.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device`` ("cuda" with the current card's
    index, so that it compares equal to a tensor's device); raises if it
    names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
