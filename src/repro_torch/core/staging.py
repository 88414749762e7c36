"""Host→device weight staging — the pipeline's 'stage' op.

One subtlety makes this more than a loop of ``tensor.to(device)``: on the
CPU ``torch.from_numpy`` *aliases* the numpy buffer instead of copying it.
A read-only mmap view from a weight bundle staged that way would keep
pointing at file-backed pages, leaving its disk I/O to fault in lazily
inside the execute op — exactly the host-side work staging exists to move
off the critical exec chain.

``stage_weights`` therefore materializes read-only (file-backed) views
into anonymous memory first: the stage op pays the page-in and transfer
cost, and execute runs against device-resident buffers that can never
touch the disk. Heap arrays produced by kernel transforms pass straight
through. bf16 host arrays (uint16 bit patterns under ``bf16.BFLOAT16``)
become ``torch.bfloat16`` tensors by a view. The profiler uses the same helper, so measured ``stage_s`` is
the cost the runtime actually pays.

On a CUDA device the copies run on the device's dedicated copy stream and
end in an event (``StagedWeights.event``). The stage op synchronizes on it
before it returns, so its trace is the real transfer time; the consumer
still makes its own stream wait on the event and calls ``record_stream``
(``consume``), because the tensors were allocated on the copy stream and
the caching allocator must not hand their memory out under a running
kernel.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import bf16
from repro_torch.device import as_device


class StagedWeights(dict):
    """A weight dict staged to a device, plus the copy stream's event
    (``None`` on the CPU)."""
    event: Optional["torch.cuda.Event"] = None


_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The process-wide host→device copy stream of a CUDA device."""
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = _streams[device] = torch.cuda.Stream(device)
        return s


def stage_weights(w: Dict[str, Any], device) -> StagedWeights:
    device = as_device(device)
    staged = StagedWeights()
    host = {}
    for k, v in w.items():
        if isinstance(v, torch.Tensor):
            host[k] = v
            continue
        v = np.asarray(v)
        if not v.flags.writeable:
            v = np.array(v)  # fault file-backed pages into anonymous memory
        host[k] = bf16.to_tensor(np.ascontiguousarray(v))
    if device.type != "cuda":
        staged.update(host)
        return staged
    stream = copy_stream(device)
    with torch.cuda.stream(stream):
        for k, t in host.items():
            staged[k] = t.to(device)
        staged.event = torch.cuda.Event()
        staged.event.record(stream)
    staged.event.synchronize()
    return staged


def consume(w: Dict[str, Any], stream) -> Dict[str, Any]:
    """Make ``stream`` wait for ``w``'s staging copies and mark the staged
    tensors as used on it. No-op on the CPU."""
    if stream is None:
        return w
    ev = getattr(w, "event", None)
    if ev is not None:
        stream.wait_event(ev)
    for t in w.values():
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.record_stream(stream)
    return w
