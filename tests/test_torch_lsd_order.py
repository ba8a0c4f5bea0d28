"""LSD's segment sums add in a fixed order (ops/lsd.py through
graph/ba._segment_sum): on the CPU the sum is index_add_'s, bit for bit, so
the CPU lines are what they were; and the card's order (a stable sort by
segment, then a sequential add per segment, as index_put_(accumulate=True)
does there) gives the same bits on these inputs, emulated here on the CPU.
The card itself is checked in chip_smoke.py phase 4 (the lines of 58
frames twice, bit-identical) and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
from torch_parity_utils import K_HALF, room_scene

from cube_slam_tpu_torch.graph.ba import _segment_sum
from cube_slam_tpu_torch.ops import lsd as tlsd
from cube_slam_tpu_torch.utils import synth


def _lsd_moments():
    """The per-pixel labels (N = trash bin) and moment terms LSD sums, on a
    rendered 320x240 frame."""
    Twc = synth.camera_path(6, kind="orbit", target=[0.0, 3.2, 0.6])[2]
    img = torch.as_tensor(np.round(room_scene().render(Twc, K_HALF, wh=(320, 240))).astype(np.float32))
    seen = {}
    real = tlsd._fit_lines_from_support

    def spy(active, angle, mag, *a):
        seen.update(active=active, angle=angle, mag=mag, args=a)
        return real(active, angle, mag, *a)

    tlsd._fit_lines_from_support = spy
    try:
        tlsd.detect_lines(img, min_length=15.0, max_lines=128)
    finally:
        tlsd._fit_lines_from_support = real
    active, angle, mag = seen["active"], seen["angle"], seen["mag"]
    H, W = active.shape
    N = H * W
    labels = tlsd._propagate_labels(
        torch.where(active, torch.arange(N, dtype=torch.int32).reshape(H, W), torch.tensor(N + 1, dtype=torch.int32)),
        angle, active, seen["args"][-1])
    act = active.reshape(-1)
    flat = torch.where(act, labels.reshape(-1), N).long()
    ar = torch.arange(N, dtype=torch.float32)
    xs, ys = ar % W, torch.floor(ar / W)
    w = torch.where(act, mag.reshape(-1), 0.0)
    return flat, [w, w * xs, w * ys, w * xs * xs, w * ys * ys, w * xs * ys, act.to(torch.float32)], N + 1


TERMS = ["w", "w x", "w y", "w x x", "w y y", "w x y", "count"]


@pytest.fixture(scope="module")
def moments():
    return _lsd_moments()


@pytest.mark.parametrize("term", TERMS)
def test_ordered_segment_sum_is_index_add_bit_for_bit(moments, term):
    flat, terms, n = moments
    assert int((flat < n - 1).sum()) > 1000  # real support regions
    v = terms[TERMS.index(term)]
    ref = torch.zeros(n).index_add_(0, flat, v)
    assert torch.equal(_segment_sum(v, flat, n), ref)
    # the card's order: segments sorted stably, each added in sequence
    order = torch.sort(flat, stable=True).indices
    assert torch.equal(torch.zeros(n).index_add_(0, flat[order], v[order]), ref)
