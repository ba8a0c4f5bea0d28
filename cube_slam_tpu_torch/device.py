"""Device selection and per-device constant tables."""

from __future__ import annotations

import functools

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The CUDA device the port's measured path runs on. Raises when no card
    is visible: there is no silent fallback to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cube_slam_tpu_torch: no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    card (raising where there is none). A caller that wants the CPU says
    device="cpu"."""
    return require_cuda() if device is None else as_device(device)


def as_device(device) -> torch.device:
    """Normalise a device argument; a bare "cuda" names the current card, so
    per-device caches key on one object per card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def _table(raw: bytes, np_dtype: str, shape: tuple, dtype: torch.dtype, device: torch.device):
    data = np.frombuffer(raw, dtype=np_dtype).reshape(shape)
    return torch.tensor(data, dtype=dtype, device=device)


def table(array, device, dtype=torch.float32) -> torch.Tensor:
    """A constant numpy table as a tensor, placed once per device and cached:
    the JAX package's module-level tables become these."""
    data = np.ascontiguousarray(array)
    return _table(data.tobytes(), data.dtype.str, data.shape, dtype, as_device(device))
