"""Process-level PyTorch setup applied by the framework's entry points.

Counterpart of the JAX package's ``utils/jax_setup.py``: device resolution
and the float32 matmul precision the reference assumes.

- Entry points run on the card. ``device=None`` means ``"cuda"``; a caller
  that wants the CPU says ``device="cpu"``. Asking for CUDA where it is not
  available raises instead of quietly running on the host.
- TF32 is off for matmuls and cuDNN, so the f32 products (the Lipschitz
  power iteration, the eval logits, the newton solver) keep full f32
  precision like the reference's XLA products.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def setup_torch() -> None:
    """Pin f32 matmul precision. Idempotent and cheap."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the first CUDA card; raise when CUDA is asked for and
    absent. The CPU is only ever chosen explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: this framework runs on an NVIDIA GPU "
                "by default; pass device='cpu' to run on the host instead"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected 'cuda' or 'cpu')")
    setup_torch()
    return dev

