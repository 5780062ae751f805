"""Device selection for the port's entry points.

Every entry point that creates tensors runs on the card unless its caller
asks for the CPU (`device="cpu"`, or `--platform cpu` on the CLI). A call
that did not ask for the CPU on a machine without a card raises: it never
carries on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: `device` if given, else
    `cuda`. Raises if CUDA is asked for (explicitly or by default) and
    the machine has no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "conflux_tpu_torch runs on an NVIDIA card by default and this "
            "machine has none; pass device='cpu' (CLI: --platform cpu) to "
            "run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def sync(device) -> None:
    """Wait until the work queued on `device` is done (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
