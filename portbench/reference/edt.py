"""A plain exact Euclidean distance transform: for every pixel, the squared
distance to the nearest edge pixel of its map, by brute force over the
edge pixels (integer arithmetic, in blocks of pixels). The judge of the
port's EDT kernel (csrc/edt.cu via ops/hopper_kernels.py::edt_l2), whose
stated semantics it follows: a map with no edge reads 1e9 everywhere.
`dtype` other than int64 computes the distances in that floating type (the
control)."""

import torch

NO_EDGE_SQ = 1e9
BLOCK = 1 << 26  # pixel-edge pairs of one block


def squared(edges, dtype=torch.int64):
    """(B, H, W) bool edge maps -> (B, H, W) squared distances (int64, or
    `dtype`)."""
    edges = torch.as_tensor(edges).bool()
    if edges.ndim == 2:
        edges = edges[None]
    B, H, W = edges.shape
    dev = edges.device
    out = torch.empty((B, H * W), dtype=dtype, device=dev)
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    pix = torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=1).to(dtype)
    for b in range(B):
        e = torch.nonzero(edges[b]).to(dtype)
        if len(e) == 0:
            out[b] = NO_EDGE_SQ
            continue
        step = max(1, BLOCK // len(e))
        for i in range(0, H * W, step):
            d = pix[i:i + step, None, :] - e[None, :, :]
            out[b, i:i + step] = torch.amin(torch.sum(d * d, dim=-1), dim=1)
    return out.reshape(B, H, W)
