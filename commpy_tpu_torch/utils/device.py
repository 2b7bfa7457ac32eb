"""Device resolution and cached device copies of host tables."""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resolve_device", "on_device", "device_constant"]


def resolve_device(device) -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for but absent.

    Entry points default to ``"cuda"``.  Nothing moves to the CPU unless
    the caller passes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the host"
        )
    return dev


def on_device(x, device) -> torch.Tensor:
    """``x`` (tensor, array or list) as a tensor on ``device``.

    A tensor already on a device of the requested type stays where it is
    when ``device`` names no index; anything else is copied there.
    """
    dev = resolve_device(device)
    if (isinstance(x, torch.Tensor) and x.device.type == dev.type
            and dev.index is None):
        return x
    return torch.as_tensor(x, device=dev)


@functools.lru_cache(maxsize=256)
def _cached(data: bytes, dtype: str, shape: tuple, device: str):
    arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return torch.as_tensor(arr.copy(), device=device)


def device_constant(array, device) -> torch.Tensor:
    """A device copy of a small host table, made once per content and device.

    A blocking host-to-device copy synchronises the stream, so the tables a
    hot path uses (constellations, masks, index vectors, branch vectors)
    are copied once and reused.  The returned tensor is shared: do not
    modify it.
    """
    a = np.ascontiguousarray(array)
    return _cached(a.tobytes(), a.dtype.str, a.shape,
                   str(torch.device(device)))
