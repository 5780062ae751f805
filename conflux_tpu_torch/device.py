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


# --------------------------------------------------------------------------- #
# streams: the serving engine's lane stream beside the callers' default
# --------------------------------------------------------------------------- #


def same_device(a, b) -> bool:
    """True when `a` and `b` name one device (cuda without an index is
    device 0, as the port's sessions use it)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _cuda_leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _cuda_leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _cuda_leaves(v)
    elif isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            yield tree
    elif getattr(tree, "shards", None) is not None:
        # a mesh session's batch-sharded leaf (`batched.Sharded`)
        yield from _cuda_leaves(tree.shards)


def order_after_default(device) -> None:
    """On a stream other than the default one, order the current stream
    after the work queued on the default stream so far: what follows reads
    tensors that callers produce there (`plan.factor`, `update`,
    `refactor`). A no-op on the CPU and on the default stream."""
    if torch.device(device).type != "cuda":
        return
    current, default = torch.cuda.current_stream(device), torch.cuda.default_stream(device)
    if current != default:
        current.wait_stream(default)


def hand_to_default(tree) -> None:
    """Tensors that may have been made on an engine lane's stream, handed to
    callers who use them on the default stream: record that use
    (`record_stream`), so their memory is not reused before the callers'
    work on them completes (for a tensor made on the default stream the
    record changes nothing). A no-op for CPU tensors."""
    for t in _cuda_leaves(tree):
        t.record_stream(torch.cuda.default_stream(t.device))


def read_on_current(tree) -> None:
    """Tensors another stream made, read by work queued now on the current
    stream: record that use, so freeing them does not release their memory
    before this stream's work on them completes. A no-op for CPU
    tensors."""
    for t in _cuda_leaves(tree):
        t.record_stream(torch.cuda.current_stream(t.device))
