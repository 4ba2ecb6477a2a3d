"""Full-precision float32 algebra for the solver.

Reduced-precision KKT algebra kills the interior-point method: with ~3
decimal digits per product the Mehrotra IPM on the flagship K=50 problem
plateaus at a relative duality gap of O(0.1) and the SCvx loop above it never
converges (measured in the JAX package: 22 iterations at full float32 and
0/256 converged lanes with bf16 products). TF32 keeps about the same 3
digits, so the port turns it off for matrix products and for cuDNN alike.

This is not a configuration knob: every entry point of the port calls
``full_precision()`` before it computes.
"""

from __future__ import annotations

import torch


def full_precision() -> None:
    """Disable TF32 for CUDA matrix products and cuDNN (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``None`` means the card. Raises when the card is asked for and absent:
    the port never runs on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port's plain "
            "PyTorch path on the CPU")
    full_precision()
    return dev
