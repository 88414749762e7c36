"""Device selection and stream helpers.

Entry points take an explicit ``device`` and default to ``"cuda"``. Asking
for CUDA on a machine without a visible GPU raises: the port never carries
on silently on the CPU. ``device="cpu"`` is for the caller that asks for
it (the CPU tests), and then every kernel wrapper takes its plain PyTorch
version; ``device="meta"`` is for the dry run (``launch.dryrun``), where
every tensor has a shape and a dtype and no data, and a kernel wrapper
returns its outputs' shapes and records its cost without running.

Work on a CUDA device runs on explicit streams, never on the legacy
default stream: each pipeline runtime owns one exec stream and staging
owns one copy stream per device (``core.staging.copy_stream``). On a CPU
device every stream is ``None`` and the helpers below are no-ops.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import bf16

DeviceLike = Union[str, torch.device]


def as_device(device: DeviceLike) -> torch.device:
    """Resolve ``device`` without touching the CUDA runtime."""
    return device if isinstance(device, torch.device) else torch.device(device)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no CUDA device is visible. ``"meta"`` (shapes and dtypes only, no
    data: the dry run) is taken where the caller names it."""
    dev = as_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        set_f32_precision()
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def set_f32_precision() -> None:
    """The lossless path runs in IEEE f32: TF32 off for cuBLAS (einsum and
    the plain GEMMs) and for cuDNN (``ConvDirect``). Process-wide, because
    these flags are process-wide in torch; asserted here."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def new_stream(device: torch.device) -> Optional["torch.cuda.Stream"]:
    return torch.cuda.Stream(device) if device.type == "cuda" else None


@contextlib.contextmanager
def on_stream(stream):
    """Make ``stream`` current for the block (no-op for ``None``)."""
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def sync(stream) -> None:
    if stream is not None:
        stream.synchronize()


def to_device(x, device: torch.device, stream=None) -> torch.Tensor:
    """Input activation -> tensor on ``device`` (copied on ``stream`` and
    synchronized, so the result is usable from any stream)."""
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = bf16.to_tensor(np.array(x, copy=True))
    if t.device == device:
        return t
    with on_stream(stream):
        t = t.to(device)
    sync(stream)
    return t


def to_numpy(t) -> np.ndarray:
    """Host array of a tensor; bf16 comes back as ``bf16.BFLOAT16``."""
    if isinstance(t, torch.Tensor):
        return bf16.to_numpy(t.detach().cpu())
    return np.asarray(t)
