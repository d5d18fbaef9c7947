"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    `None` means the card.  When no card is present this raises instead of
    quietly running on the CPU: a CPU run must be asked for by name
    (`device="cpu"`), as the tests do.  On the card the port computes in
    IEEE float32, as its reference does, so TF32 is turned off for cuBLAS
    and cuDNN (torch's default runs cuDNN convolutions in TF32).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
