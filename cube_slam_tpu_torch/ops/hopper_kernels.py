"""Dispatch to the hand-written Hopper kernels.

The JAX package's one Pallas kernel (cube_slam_tpu/ops/pallas_kernels.py::
_edt_pass2_kernel, with the column pass it consumes) is csrc/edt.cu here.
`edt_l2` sends a CUDA tensor to that kernel and a CPU tensor to the plain
PyTorch version (ops/distance_transform.py), which is also what the kernel
is tested against. Nothing falls back: a kernel that fails to build or to
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import distance_transform as dt

# kernel launches of edt_l2 since the last reset (chip_smoke.py reads it to
# show the main path went through the kernel)
edt_launches = 0

# d = x - u steps by exactly 1.0 and d² < 2^24 stays an exact float32
# integer, so the kernel's fmaf(d, d, g²) rounds as the plain g² + d² does
_MAX_W = 4096
# the column pass keeps 12 bytes per row of a 32-column strip in shared memory
_MAX_H = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "cube_slam_edt_l2": [_P, _P, _P, _I, _I, _I, _P],
    "cube_slam_edt_column_pass": [_P, _P, _I, _I, _I, _P],
    "cube_slam_edt_row_pass": [_P, _P, _I, _I, _P],
}


def _fn(name):
    fn = getattr(_build.load("cuda_kernels"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, device, *args):
    """Call kernel entry point `name` on `device`'s current stream."""
    fn = _fn(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def build():
    """Build and load the CUDA kernels now (else at the first launch)."""
    for name in _ARGTYPES:
        _fn(name)


def _check_edges(edges):
    if not edges.is_cuda:
        raise ValueError("the EDT kernel takes a CUDA tensor")
    if edges.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"the EDT kernel takes a bool or uint8 mask, not {edges.dtype}")
    if edges.ndim != 3 or not edges.is_contiguous():
        raise ValueError("the EDT kernel takes a contiguous (B, H, W) mask")
    B, H, W = edges.shape
    if W > _MAX_W or H > _MAX_H:
        raise ValueError(f"the EDT kernel takes H <= {_MAX_H} and W <= {_MAX_W}, not {H}x{W}")
    return B, H, W


def edt_l2_cuda(edges: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: (B, H, W) contiguous bool/uint8 CUDA tensor ->
    (B, H, W) float32 exact L2 distances, on the current stream."""
    global edt_launches
    B, H, W = _check_edges(edges)
    out = torch.empty((B, H, W), dtype=torch.float32, device=edges.device)
    if edges.numel() == 0:
        return out
    g2 = torch.empty_like(out)
    _launch("cube_slam_edt_l2", edges.device, edges.data_ptr(), g2.data_ptr(), out.data_ptr(), B, H, W)
    edt_launches += 1
    return out


def edt_column_pass_cuda(edges: torch.Tensor, g2: torch.Tensor) -> None:
    """The kernel's column pass alone, into `g2` (B, H, W) float32: g² of the
    vertical distance. For timing the passes apart; not the main path."""
    B, H, W = _check_edges(edges)
    if (g2.shape != edges.shape or g2.dtype != torch.float32 or not g2.is_contiguous()
            or g2.device != edges.device):
        raise ValueError("g2 must be a contiguous float32 tensor of the mask's shape and device")
    if edges.numel() == 0:
        return
    _launch("cube_slam_edt_column_pass", edges.device, edges.data_ptr(), g2.data_ptr(), B, H, W)


def edt_row_pass_cuda(g2: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel's row pass alone: `out` = sqrt(min_u g2[.., u] + (x - u)²)
    row by row. For timing the passes apart; not the main path."""
    if not g2.is_cuda or g2.dtype != torch.float32 or not g2.is_contiguous():
        raise ValueError("g2 must be a contiguous float32 CUDA tensor")
    if (out.shape != g2.shape or out.dtype != torch.float32 or not out.is_contiguous()
            or out.device != g2.device):
        raise ValueError("out must be a contiguous float32 tensor of g2's shape and device")
    W = g2.shape[-1]
    if g2.numel() == 0:
        return
    if W > _MAX_W:
        raise ValueError(f"the EDT kernel takes W <= {_MAX_W}, not {W}")
    _launch("cube_slam_edt_row_pass", g2.device, g2.data_ptr(), out.data_ptr(), g2.numel() // W, W)


def edt_l2(edges: torch.Tensor) -> torch.Tensor:
    """Exact L2 EDT of (B, H, W) or (H, W) bool edge masks. CUDA tensors run
    the kernel of csrc/edt.cu; CPU tensors run the plain version."""
    if edges.device.type == "cpu":
        return dt.edt_l2(edges)
    if edges.ndim == 2:
        return edt_l2_cuda(edges[None].contiguous())[0]
    return edt_l2_cuda(edges.contiguous())
