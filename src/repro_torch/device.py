"""The device rule of the port: run on the card unless the caller asks
for the CPU, and never fall back quietly."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None
                   ) -> torch.device:
    """``None`` means the current CUDA device. Raises when CUDA is asked
    for (or defaulted to) and there is none; pass ``device="cpu"`` to run
    the plain PyTorch versions on the CPU instead. A CUDA device comes back
    with its index, as a tensor's ``.device`` reports it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device unless told otherwise, "
                "and torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
