"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None, meta: bool = False) -> torch.device:
    """The torch device an entry point runs on.

    ``None`` means CUDA: the port runs on the card unless the caller asks
    for the host with ``device="cpu"``.  Asking for CUDA where no CUDA
    device exists raises instead of quietly running on the CPU.  With
    ``meta``, an entry point that can trace shapes and dtypes without
    computing (the model's, for the dry run) also takes ``"meta"`` when
    the caller names it; it is never a default.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta" and meta:
        return dev
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
