"""Line Band Descriptors (LBD) + binary line matching.

PyTorch counterpart of cube_slam_tpu/ops/lbd.py, the re-design of
line_lbd's BinaryDescriptor (line_lbd/libs/binary_descriptor.cpp:1146+
computeLBD: 9 bands x (mean, std) of rectified gradient projections,
binarized by pairwise comparisons, matched with multi-index hashing):

* every line's support region is sampled on a fixed (bands x rows x cols)
  grid by one batched bilinear gather over all lines,
* image gradients are rotated into the line frame (dL along, dO orthogonal)
  and rectified into (dL+, dL-, dO+, dO-),
* band statistics (mean + population std over the band rows, Gaussian-
  weighted across bands) form the 72-d float descriptor, L2-normalized,
* binarization uses the JAX package's seeded pair-comparison table, giving
  256-bit codes packed as (N, 8) int32 words with the bits of JAX's uint32
  words (bit b of word w is pair 32 w + b),
* matching is the whole-set XOR/popcount Hamming matrix (ops/matching.py),
  the dense replacement for the Mihasher inverted tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import table
from . import image as im_ops
from . import lsd as lsd_ops
from . import matching
from .orb import words_to_int32

N_BANDS = 9
BAND_ROWS = 7          # rows per band across the line
N_SAMPLES = 32         # samples along the line
TOTAL_ROWS = N_BANDS * BAND_ROWS

# jnp.linspace(0, 1, 32)'s float32 values (iota * (1/31)); torch.linspace
# rounds 8 of them differently
_SAMPLES = np.arange(N_SAMPLES, dtype=np.float32) * np.float32(1.0 / (N_SAMPLES - 1))
_ROW_OFFS = np.arange(TOTAL_ROWS, dtype=np.float32) - np.float32((TOTAL_ROWS - 1) / 2.0)
# Gaussian weight across rows (global, sigma = half region) as in LBD; a
# float64 table rounded once, so every device reads the same weights (each
# library's float32 exp differs from XLA's in the last bit on a few rows)
_ROW_WEIGHT = np.exp(-(_ROW_OFFS.astype(np.float64) ** 2) / (2.0 * (TOTAL_ROWS / 2.0) ** 2)).astype(np.float32)


def _bilinear(img, x, y):
    """Bilinear samples of (H, W) `img` at float (x, y) of any shape; the
    corner indices clip to [0, W-2] x [0, H-2] and the weights to [0, 1]."""
    H, W = img.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, W - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, H - 2)
    fx = torch.clamp(x - x0.to(x.dtype), 0.0, 1.0)
    fy = torch.clamp(y - y0.to(y.dtype), 0.0, 1.0)
    flat = img.reshape(-1)
    i00 = y0 * W + x0
    v00 = flat[i00]
    v01 = flat[i00 + 1]
    v10 = flat[i00 + W]
    v11 = flat[i00 + W + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _make_binary_pairs(seed=7, n_bits=256, dim=72):
    """The JAX package's seeded comparison pairs, the same numpy draws."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, dim, n_bits)
    b = rng.integers(0, dim, n_bits)
    clash = a == b
    b = np.where(clash, (b + 1) % dim, b)
    return a.astype(np.int32), b.astype(np.int32)


_PAIR_A, _PAIR_B = _make_binary_pairs()


def lbd_descriptors(img, lines, valid):
    """img (H, W) float32; lines (N, 4) [x1 y1 x2 y2]; valid (N,) bool.

    Returns (float_desc (N, 72) float32, binary_desc (N, 8) int32); both are
    zero on invalid rows."""
    dev = img.device
    gx, gy = im_ops.sobel(img)

    p1 = lines[:, :2]
    d = lines[:, 2:] - p1
    length = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-6)
    dl = d / length[:, None]                      # along-line unit
    dn = torch.stack([-dl[:, 1], dl[:, 0]], dim=-1)  # orthogonal

    s = table(_SAMPLES, dev)
    offs = table(_ROW_OFFS, dev)
    centers = p1[:, None, :] + s[None, :, None] * d[:, None, :]                  # (N, S, 2)
    pts = centers[:, None, :, :] + offs[None, :, None, None] * dn[:, None, None, :]  # (N, R, S, 2)

    gxs = _bilinear(gx, pts[..., 0], pts[..., 1])  # (N, R, S)
    gys = _bilinear(gy, pts[..., 0], pts[..., 1])
    gL = gxs * dl[:, 0, None, None] + gys * dl[:, 1, None, None]
    gO = gxs * dn[:, 0, None, None] + gys * dn[:, 1, None, None]
    feats = torch.stack([torch.clamp(gL, min=0), torch.clamp(-gL, min=0),
                         torch.clamp(gO, min=0), torch.clamp(-gO, min=0)], dim=-1)  # (N, R, S, 4)
    feats = feats * table(_ROW_WEIGHT, dev)[None, :, None, None]

    # band statistics: per band, mean and population std over (rows x samples)
    bands = feats.reshape(-1, N_BANDS, BAND_ROWS * N_SAMPLES, 4)
    mean = torch.mean(bands, dim=2)                   # (N, 9, 4)
    std = torch.std(bands, dim=2, correction=0)       # (N, 9, 4)
    desc = torch.cat([mean, std], dim=-1).reshape(-1, 8 * N_BANDS)  # (N, 72)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    fdesc = desc / torch.where(norm > 1e-9, norm, 1.0)
    fdesc = torch.where(valid[:, None], fdesc, 0.0)

    # binarize: 256 pairwise comparisons -> (N, 8) words
    a = table(_PAIR_A, dev, torch.int64)
    b = table(_PAIR_B, dev, torch.int64)
    bits = (fdesc[:, a] > fdesc[:, b]).to(torch.int64).reshape(-1, 8, 32)
    words = torch.sum(bits << torch.arange(32, device=dev, dtype=torch.int64), dim=-1)
    return fdesc, torch.where(valid[:, None], words_to_int32(words), 0)


def describe_lines_pyramid(img, n_octaves=2, detector="lsd", max_lines=128, **detect_kwargs):
    """Detect + describe lines over the octave pyramid (the LSDDetector
    octave loop + per-octave computeLBD_, line_lbd_allclass.cpp:282-337,
    binary_descriptor.cpp:2379, LSDDetector.cpp:55-73). Descriptors are
    computed on each OCTAVE image in octave coordinates; endpoints are
    reported in BASE pixels.

    Returns a dict: lines (n_octaves*max_lines, 4) base px, octave (n,)
    int32, valid (n,) bool, fdesc (n, 72), bdesc (n, 8) int32. The merged
    set feeds match_lines directly (cross-octave matching, as the
    reference's matchLBD over all KeyLines)."""
    pyr = lsd_ops.detect_lines_pyramid(img, n_octaves=n_octaves, detector=detector, max_lines=max_lines,
                                       **detect_kwargs)
    fds, bds = [], []
    for o, im in enumerate(pyr["octave_images"]):
        sl = slice(o * max_lines, (o + 1) * max_lines)
        fd, bd = lbd_descriptors(im, pyr["lines_octave"][sl], pyr["valid"][sl])
        fds.append(fd)
        bds.append(bd)
    return {
        "lines": pyr["lines_base"],
        "octave": pyr["octave"],
        "valid": pyr["valid"],
        "fdesc": torch.cat(fds),
        "bdesc": torch.cat(bds),
    }


def match_lines(desc1, valid1, desc2, valid2, max_dist=80, ratio=0.9):
    """Binary line matching (BinaryDescriptorMatcher analog): dense Hamming
    + mutual/ratio filtering. Returns (match (N1,) idx or -1, dist)."""
    d = matching.hamming_matrix(desc1, desc2, valid1, valid2)
    return matching.match_mutual_ratio(d, max_dist=max_dist, ratio=ratio, mutual=True)
