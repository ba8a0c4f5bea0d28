"""Line-segment detection — the SPMD equivalents of LSD and EDLine.

PyTorch counterpart of cube_slam_tpu/ops/lsd.py (`detect_lines`,
`detect_edlines` and the octave pyramid `detect_lines_pyramid`). The
reference bundles von Gioi's LSD (line_lbd/libs/lsd.cpp:440 `flsd`) and wraps
it in `line_lbd_detect::detect_raw_lines`
(line_lbd/class/line_lbd_allclass.cpp:125-189). Region growing is
sequential, so the JAX package re-designed it for parallel hardware while
keeping the contract (image -> [x1 y1 x2 y2] segments with length filtering):

1. 2x2 gradients and level-line angles exactly as LSD,
2. support regions as ANGLE-CONSTRAINED CONNECTED COMPONENTS: iterative
   min-label propagation over 8-neighbors whose level-line angles agree
   within the LSD tolerance (22.5 deg), with a pointer-jumping gather,
3. per-component weighted PCA (segment sums) for the line direction,
   endpoints from extreme projections onto the principal axis,
4. density/length/aspect filters standing in for LSD's NFA test.

Output is a fixed-capacity (max_lines, 4) tensor + validity mask, sorted by
length descending. The float segment sums add in a fixed order on every
run (`graph/ba._segment_sum`: index_add_ on the CPU, a sorted
index_put_(accumulate=True) on the card), so the card's lines repeat bit for
bit; they may still differ from the JAX package's in the last bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..graph.ba import _segment_sum
from ..utils import profiler
from . import image as im_ops

_ANGLE_TOL = math.radians(22.5)


def _lsd_gradients(img):
    """LSD 2x2 gradients (lsd.cpp: grad computed on 2x2 cell at (x, y))."""
    H, W = img.shape
    ip = F.pad(img[None, None], (0, 1, 0, 1), mode="replicate")[0, 0]
    a = ip[:H, :W]          # I[y, x]
    b = ip[:H, 1:W + 1]     # I[y, x+1]
    c = ip[1:H + 1, :W]     # I[y+1, x]
    d = ip[1:H + 1, 1:W + 1]
    gx = (b + d - a - c) * 0.5
    gy = (c + d - a - b) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    # level-line angle (perpendicular to gradient), as in LSD
    angle = torch.atan2(gx, -gy)
    return gx, gy, mag, angle


def _angle_close(a1, a2, tol=_ANGLE_TOL):
    d = torch.abs(a1 - a2)
    d = torch.minimum(d, 2 * math.pi - d)
    # LSD region growing compares level-line angles mod 2pi
    return d < tol


def _shift(x, dy, dx, fill):
    """shifted[y, x] = x[y+dy, x+dx], `fill` outside the image."""
    H, W = x.shape
    p = F.pad(x[None, None].to(torch.float32) if x.dtype == torch.bool else x[None, None],
              (1, 1, 1, 1), value=fill)[0, 0]
    out = p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    return out > 0.5 if x.dtype == torch.bool else out


def _propagate_labels(labels, angle, active, num_iters):
    """Iterated min-label propagation across angle-compatible 8-neighbors,
    with label doubling (jump to the label of the current representative)
    after each sweep; a fixed number of sweeps (segments are thin and
    elongated, so label distance shrinks quickly along the segment)."""
    H, W = labels.shape
    BIGL = H * W + 1
    # the neighbour tables do not change across sweeps
    nbrs = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            na = _shift(angle, dy, dx, 1e9)
            nact = _shift(active, dy, dx, False)
            nbrs.append((dy, dx, nact & _angle_close(angle, na)))

    lab = labels
    for _ in range(num_iters):
        best = lab
        for dy, dx, ok in nbrs:
            nl = _shift(lab, dy, dx, BIGL)
            best = torch.where(ok & (nl < best), nl, best)
        flat = best.reshape(-1)
        rep = flat[torch.clamp(flat, 0, H * W - 1)].reshape(H, W)
        best = torch.minimum(best, torch.where(best < BIGL, rep, BIGL))
        lab = torch.where(active, best, BIGL)
    return lab


def _fit_lines_from_support(active, angle, mag, min_pixels, min_length, min_density,
                            max_width_ratio, max_lines, num_prop_iters, max_abs_width=None):
    """Support mask + per-pixel angle/weight -> (lines (max_lines, 4), valid).
    Angle-constrained connected components, weighted-PCA line fit, geometric
    filters, top-k by length. `max_abs_width` (px) bounds the fitted width
    (EDLine's straightness bound); None leaves it open."""
    H, W = active.shape
    N = H * W
    dev = active.device

    init_labels = torch.where(active, torch.arange(N, dtype=torch.int32, device=dev).reshape(H, W),
                              torch.tensor(N + 1, dtype=torch.int32, device=dev))
    with profiler.span("lsd.labels"):
        labels = _propagate_labels(init_labels, angle, active, num_prop_iters)
    with profiler.span("lsd.fit"):
        return _fit_components(active, labels, mag, min_pixels, min_length, min_density, max_width_ratio,
                               max_lines, max_abs_width)


def _fit_components(active, labels, mag, min_pixels, min_length, min_density, max_width_ratio, max_lines,
                    max_abs_width):
    """Labelled support -> (lines (max_lines, 4), valid): the weighted-PCA
    fit of every component by segment sums, the filters, the top-k."""
    H, W = active.shape
    N = H * W
    dev = active.device
    act = active.reshape(-1)
    flat_lab = torch.where(act, labels.reshape(-1), N).long()  # N = trash bin
    ar = torch.arange(N, dtype=torch.float32, device=dev)
    xs = ar % W
    ys = torch.floor(ar / W)
    w = torch.where(act, mag.reshape(-1), 0.0)

    def seg(v):
        return _segment_sum(v, flat_lab, N + 1)

    s_w = seg(w)
    s_x = seg(w * xs)
    s_y = seg(w * ys)
    s_xx = seg(w * xs * xs)
    s_yy = seg(w * ys * ys)
    s_xy = seg(w * xs * ys)
    s_n = seg(act.to(torch.float32))

    s_w_safe = torch.where(s_w > 0, s_w, 1.0)
    cx = s_x / s_w_safe
    cy = s_y / s_w_safe
    vxx = s_xx / s_w_safe - cx * cx
    vyy = s_yy / s_w_safe - cy * cy
    vxy = s_xy / s_w_safe - cx * cy

    # principal axis of the 2x2 covariance (closed form)
    tr = vxx + vyy
    det = vxx * vyy - vxy * vxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    lam1 = tr / 2.0 + disc  # major
    lam2 = tr / 2.0 - disc  # minor
    # eigvec for lam1 (vxy ~ 0: axis-aligned — pick the larger variance axis)
    ex = torch.where(torch.abs(vxy) > 1e-9, lam1 - vyy, torch.where(vxx >= vyy, 1.0, 0.0))
    ey = torch.where(torch.abs(vxy) > 1e-9, vxy, torch.where(vxx >= vyy, 0.0, 1.0))
    en = torch.sqrt(ex * ex + ey * ey)
    ex = ex / torch.where(en > 1e-9, en, 1.0)
    ey = ey / torch.where(en > 1e-9, en, 1.0)

    # endpoint extents: min/max projection of member pixels onto the axis
    proj = (xs - cx[flat_lab]) * ex[flat_lab] + (ys - cy[flat_lab]) * ey[flat_lab]
    s_min = torch.full((N + 1,), 1e9, device=dev).scatter_reduce_(
        0, flat_lab, torch.where(act, proj, 1e9), "amin", include_self=False)
    s_max = torch.full((N + 1,), -1e9, device=dev).scatter_reduce_(
        0, flat_lab, torch.where(act, proj, -1e9), "amax", include_self=False)

    length = s_max - s_min
    width = torch.sqrt(torch.clamp(lam2, min=0.0)) * 3.46  # ~full width (2*sqrt(3)*std)
    density = s_n / torch.clamp(length * torch.clamp(width, min=1.0), min=1.0)

    good = (
        (s_n >= min_pixels)
        & (length >= min_length)
        & (width <= torch.clamp(max_width_ratio * length, min=3.0))
        & (density >= min_density)
    )
    if max_abs_width is not None:
        # EDLine-style straightness bound: member pixels must stay within a
        # fixed orthogonal distance of the fitted line (lineFitErrThreshold)
        good = good & (width <= max_abs_width)
    good[N:] = False  # trash bin

    x1 = cx + s_min * ex
    y1 = cy + s_min * ey
    x2 = cx + s_max * ex
    y2 = cy + s_max * ey
    # left-to-right convention
    flipme = x2 < x1
    x1n = torch.where(flipme, x2, x1)
    y1n = torch.where(flipme, y2, y1)
    x2n = torch.where(flipme, x1, x2)
    y2n = torch.where(flipme, y1, y2)

    score = torch.where(good, length, -1.0)
    top_score, top_idx = torch.topk(score, max_lines)
    lines = torch.stack([x1n[top_idx], y1n[top_idx], x2n[top_idx], y2n[top_idx]], dim=-1)
    valid = top_score > 0
    lines = torch.where(valid[:, None], lines, 0.0)
    return lines, valid


def detect_lines(
    img,
    mag_threshold=5.22,
    min_pixels=20,
    min_length=15.0,
    min_density=0.5,
    max_width_ratio=0.25,
    max_lines=128,
    num_prop_iters=32,
):
    """LSD flavor: (H, W) float32 grayscale tensor -> (lines (max_lines, 4),
    valid), on the image's device.

    Support = pixels with gradient magnitude above LSD's rho
    (~5.22 for q=2: 2 / sin(tol) * q/255-quantization). Lines sorted by
    length descending, [x1 y1 x2 y2] with x1 <= x2
    (align_left_right_edges convention). Spans: lsd.detect, with
    lsd.gradients, lsd.labels (the label propagation) and lsd.fit (the
    segment-sum fit) inside.
    """
    with profiler.span("lsd.detect"):
        with profiler.span("lsd.gradients"):
            gx, gy, mag, angle = _lsd_gradients(img)
            active = mag > mag_threshold
        return _fit_lines_from_support(
            active, angle, mag, min_pixels, min_length, min_density,
            max_width_ratio, max_lines, num_prop_iters)


def detect_edlines(
    img,
    grad_threshold=30.0,
    min_pixels=12,
    min_length=15.0,
    max_fit_width=2.5,
    max_lines=128,
    num_prop_iters=32,
):
    """EDLine flavor (binary_descriptor.cpp:792-818 EDLineDetector).

    EDLine walks 1-px edge chains drawn from gradient anchors and fits
    segments with a bounded fit error. Here the NMS-thinned edge map
    (ops/image.canny_nms, the same anchor/peak criterion) is the support
    set; angle-constrained components group chain pixels; the fit's
    minor-axis width bound (max_fit_width, px) enforces EDLine's
    lineFitErrThreshold. Thin supports make LSD's density and width-ratio
    filters moot, so they are open."""
    strong, _weak = im_ops.canny_nms(img, low=grad_threshold, high=grad_threshold)
    _gx, _gy, mag, angle = _lsd_gradients(img)
    active = strong & (mag > 1e-3)
    return _fit_lines_from_support(
        active, angle, mag, min_pixels, min_length, 0.0, 1e9,
        max_lines, num_prop_iters, max_abs_width=max_fit_width)


def detect_lines_pyramid(img, n_octaves=2, detector="lsd", max_lines=128, min_length=15.0, **kwargs):
    """Octave-pyramid detection (LSDDetector.cpp:55-73 + the per-octave
    loop of line_lbd_allclass.cpp:282-337): pyrDown per octave, detection
    on each octave image with the same metric length threshold
    (min_length / 2**o octave pixels), endpoints rescaled to base pixels.

    Returns a dict with lines_base (n_octaves*max_lines, 4) in BASE pixels,
    lines_octave (same shape) in octave pixels, octave (n,) int32, valid
    (n,) bool, and octave_images, the n_octaves pyramid images (for the
    per-octave descriptors, the reference's computeLBD_(octaveImages))."""
    detect = {"lsd": detect_lines, "edline": detect_edlines}[detector]
    imgs = [img.to(torch.float32)]
    for _ in range(n_octaves - 1):
        imgs.append(im_ops.pyr_down(imgs[-1]))

    lines_base, lines_oct, octs, valids = [], [], [], []
    for o, im in enumerate(imgs):
        ln, va = detect(im, min_length=min_length / (2.0 ** o), max_lines=max_lines, **kwargs)
        lines_oct.append(ln)
        lines_base.append(ln * (2.0 ** o))
        octs.append(torch.full((max_lines,), o, dtype=torch.int32, device=img.device))
        valids.append(va)
    return {
        "lines_base": torch.cat(lines_base),
        "lines_octave": torch.cat(lines_oct),
        "octave": torch.cat(octs),
        "valid": torch.cat(valids),
        "octave_images": imgs,
    }
