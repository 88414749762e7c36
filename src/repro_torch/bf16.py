"""bfloat16 host arrays without ``ml_dtypes``.

numpy has no bfloat16. The JAX package holds bf16 host arrays as
``ml_dtypes.bfloat16``, a package of the JAX installation that the port
does not depend on. The port carries them as their uint16 bit patterns
under ``BFLOAT16``, a uint16 dtype tagged "bfloat16" in its numpy metadata
(the tag survives views, slices, reshapes and copies). So:

  * a store holds the same bytes and CRCs as the reference writes, under
    the same "bfloat16" dtype tag (``checkpoint.bundle``);
  * ``dtype_name`` says "bfloat16" — never "uint16" — for avatars,
    ``plan.json``, ``profile_db.json`` and the shape-class keys, so those
    read across the two packages;
  * ``to_tensor`` turns such an array into a ``torch.bfloat16`` tensor by
    a view (``torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)``)
    and ``to_numpy`` does the reverse.

Arrays typed ``ml_dtypes.bfloat16`` (handed over by a caller that has the
package) are recognized by their dtype's name and viewed the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

NAME = "bfloat16"
BFLOAT16 = np.dtype(np.uint16, metadata={"name": NAME})


def is_bf16(a: Any) -> bool:
    """True for a bf16 array or dtype: tagged uint16 or ``ml_dtypes``."""
    dt = a if isinstance(a, np.dtype) else getattr(a, "dtype", None)
    if not isinstance(dt, np.dtype):
        return False
    meta = dt.metadata
    return bool(meta and meta.get("name") == NAME) or dt.name == NAME


def dtype_name(a: Any) -> str:
    """numpy-style dtype name of an array, numpy dtype or torch dtype,
    "bfloat16" for bf16 in every form."""
    if isinstance(a, torch.Tensor):
        a = a.dtype
    if isinstance(a, torch.dtype):
        return str(a).replace("torch.", "")
    if is_bf16(a):
        return NAME
    dt = a if isinstance(a, np.dtype) else np.asarray(a).dtype
    return str(dt)


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype for a dtype tag; "bfloat16" gives ``BFLOAT16``."""
    return BFLOAT16 if name == NAME else np.dtype(name)


def from_float(a: Any) -> np.ndarray:
    """Round a float array to bf16 (nearest, ties to even — what
    ``jnp.asarray(a, jnp.bfloat16)`` and ``torch.Tensor.to(bfloat16)``
    do), as a ``BFLOAT16`` array."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = ((u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16).astype(np.uint16)
    nan = np.isnan(u.view(np.float32))
    if nan.any():
        r[nan] = np.where((u[nan] >> 31) != 0, 0xFFC0, 0x7FC0)
    return r.view(BFLOAT16)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """``torch.from_numpy`` that maps bf16 arrays to ``torch.bfloat16``
    (a view: no copy, the buffer is aliased as ``from_numpy`` aliases)."""
    if is_bf16(a):
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's numpy view; bf16 comes back as ``BFLOAT16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(BFLOAT16)
    return t.numpy()
