"""Tests of cube_slam_tpu_torch that need a CUDA card: the hand-written
kernels against their plain PyTorch versions on the card. They carry the
`cuda` marker and skip on a machine without a card. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cube_slam_tpu_torch.ops import distance_transform as tdt
from cube_slam_tpu_torch.ops import hopper_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mask(shape, density):
    """A seeded random mask; density "rect" puts 10% edges inside one
    rectangle per map, as the detector's `strong & rect` does, and "one
    empty" leaves map 1 of the batch without edges (its rows have no finite
    vertical distance)."""
    r = np.random.default_rng(0)
    if density == "rect":
        B, H, W = shape
        m = np.zeros(shape, dtype=bool)
        m[:, H // 4:3 * H // 4, W // 3:2 * W // 3] = r.uniform(size=(B, 3 * H // 4 - H // 4, 2 * W // 3 - W // 3)) < 0.1
        return m
    if density == "one empty":
        m = r.uniform(size=shape) < 0.05
        m[1] = False
        return m
    return r.uniform(size=shape) < density


@pytest.mark.parametrize("shape,density", [
    ((2, 37, 131), 0.05), ((1, 480, 640), 0.01), ((4, 480, 640), 0.1),
    ((1, 48, 64), 0.0), ((1, 48, 64), 1.0), ((1, 1, 1), 1.0), ((3, 1, 700), 0.01),
    # widths around the kernel's tiles (8 outputs, 16 sources, 32-column strips)
    ((2, 64, 1), 0.1), ((1, 64, 31), 0.05), ((2, 40, 33), 0.05), ((1, 50, 131), 0.02),
    ((1, 30, 641), 0.01), ((1, 20, 4096), 0.002),
    ((1, 1, 33), 0.2),    # H = 1
    ((3, 7, 100), 0.05),  # 21 rows x 13 tiles: the last block is partly empty
    ((3, 70, 90), "one empty"), ((4, 480, 640), "rect"),
    ((12, 480, 640), 0.01),  # 4 boxes x 3 heights
    ((1, 5000, 40), 0.0005),  # H > 4096: the column pass takes over 48 KB of shared memory
])
def test_edt_kernel_bit_identical_to_plain(cuda, shape, density):
    m = torch.as_tensor(_mask(shape, density), device=cuda)
    before = hk.edt_launches
    out = hk.edt_l2(m)
    torch.cuda.synchronize()
    assert hk.edt_launches == before + 1
    assert out.dtype == torch.float32 and out.shape == m.shape
    assert torch.equal(out, tdt.edt_l2(m))


@pytest.mark.parametrize("shape", [(2, 37, 131), (1, 480, 640), (3, 33, 4096)])
def test_edt_passes_match_plain(cuda, shape):
    """Each pass alone: the column pass gives the plain version's g², and
    the row pass over it the plain EDT. Neither counts as a launch of
    edt_l2."""
    m = torch.as_tensor(_mask(shape, 0.02), device=cuda)
    g2 = torch.empty(shape, dtype=torch.float32, device=cuda)
    out = torch.empty_like(g2)
    before = hk.edt_launches
    hk.edt_column_pass_cuda(m, g2)
    hk.edt_row_pass_cuda(g2, out)
    torch.cuda.synchronize()
    assert hk.edt_launches == before
    g = tdt.vertical_dist(m)
    assert torch.equal(g2, g * g)
    assert torch.equal(out, tdt.edt_l2(m))


def test_edt_row_pass_into_unaligned_view(cuda):
    """The row pass stores float4s only where `out` is 16-byte aligned: into
    a contiguous view with a storage offset it stores floats, and its output
    is the same."""
    m = torch.as_tensor(_mask((2, 24, 64), 0.05), device=cuda)
    g2 = torch.empty(m.shape, dtype=torch.float32, device=cuda)
    buf = torch.zeros(m.numel() + 1, dtype=torch.float32, device=cuda)
    out = buf[1:].view(m.shape)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    hk.edt_column_pass_cuda(m, g2)
    hk.edt_row_pass_cuda(g2, out)
    torch.cuda.synchronize()
    assert float(buf[0]) == 0.0
    assert torch.equal(out, tdt.edt_l2(m))


def test_edt_kernel_rejects_bad_input(cuda):
    with pytest.raises(TypeError):
        hk.edt_l2_cuda(torch.zeros((1, 4, 4), dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        hk.edt_l2_cuda(torch.zeros((4, 4, 2), dtype=torch.bool, device=cuda).transpose(0, 1))
    with pytest.raises(ValueError):
        hk.edt_l2_cuda(torch.zeros((1, 2, hk._MAX_W + 1), dtype=torch.bool, device=cuda))


def test_step_frame_card_vs_cpu(cuda):
    """The tracker's per-frame step on the card against the CPU, from one
    state: the port's tracker runs Gate A's frames 0-9 on the CPU, then
    frame 10's step_frame runs on both devices from that map and tracker
    state. The same acceptance; pose within 1e-3; inlier counts within 2%
    and association tables 98% equal (float sums differ between devices,
    and a match at a tie can flip)."""
    from torch_parity_utils import GATE_A_CONFIG, GATE_A_K, gate_a_sequence

    from cube_slam_tpu_torch.ops.orb import OrbPyramidConfig
    from cube_slam_tpu_torch.slam import tracking as trk
    from cube_slam_tpu_torch.slam.system import MonocularTracker, TrackerConfig

    frames, _ = gate_a_sequence()
    host = MonocularTracker(GATE_A_K, (320, 240), TrackerConfig(**GATE_A_CONFIG), device="cpu")
    for f in frames[:10]:
        host.track(f)
    host.flush()
    assert host.state == "OK"
    m = host.map
    vis, found = host._counters()
    state = [host.last_Tcw, host.velocity, host.last_frame.mp.astype(np.int32)]
    fields = [getattr(m, k) for k in ("mp_pos", "mp_desc", "mp_level", "mp_valid", "mp_normal",
                                      "mp_min_dist", "mp_max_dist")]
    wh = np.array([320, 240], np.float32)

    def run(device):
        t = [torch.as_tensor(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32 else a,
                             device=device) for a in [frames[10]] + state + fields]
        out = trk.step_frame(*t, vis.to(device), found.to(device),
                             torch.as_tensor(GATE_A_K, device=device), torch.as_tensor(wh, device=device),
                             orb_cfg=OrbPyramidConfig(600, n_levels=3))
        return out[0].cpu().numpy(), out[1][2].cpu().numpy()

    (sc, mc), (sg, mg) = run("cpu"), run(cuda)
    assert sg[18] == sc[18] == 1.0
    np.testing.assert_allclose(sg[:16], sc[:16], atol=1e-3)
    assert abs(sg[17] - sc[17]) <= 0.02 * sc[17]
    assert (mg == mc).mean() >= 0.98


def test_lsd_lines_repeat_bit_for_bit_on_the_card(cuda):
    """LSD's segment sums add in a fixed order on the card
    (graph/ba._segment_sum), so two computations of a frame's lines are
    bit-identical, as chip_smoke.py phase 4 checks over 58 frames."""
    from cube_slam_tpu_torch.ops import lsd
    from cube_slam_tpu_torch.utils import io, synth

    seq = synth.SynthSequence(3, K=io.CabinetSequence.K, wh=(640, 480))
    for f in range(3):
        g = torch.as_tensor(seq.gray(f), device=cuda)
        a = lsd.detect_lines(g, min_length=15.0, max_lines=128)
        b = lsd.detect_lines(g, min_length=15.0, max_lines=128)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_klt_and_harris_card_vs_cpu(cuda):
    """ops/klt.py on the card against the CPU on the dynamic gate's frames
    2 and 3 (chip_smoke.dynamic_gate_scene): Harris on the eroded box mask
    gives the same corners, and pyr_lk of them with the projected-centre
    flow as the seed the same status and tracks within
    chip_smoke.KLT_TRACK_TOL pixels (the window sums add in another order
    on the card)."""
    from torch_parity_utils import cs

    from cube_slam_tpu_torch.ops import klt
    from cube_slam_tpu_torch.slam.dynamic import _erode

    g = cs.dynamic_gate_scene()
    f0, f1, mask = g["frames"][2], g["frames"][3], _erode(g["masks"][2])
    b0, b1 = g["bboxes"][2], g["bboxes"][3]
    guess = np.broadcast_to(((b1[:2] + b1[2:] / 2) - (b0[:2] + b0[2:] / 2)).astype(np.float32), (48, 2)).copy()

    def run(d):
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=d)  # noqa: E731
        xy, valid = klt.harris_corners(t(f0), max_corners=48, mask=t(mask))
        pts, status = klt.pyr_lk(t(f0), t(f1), xy, valid, init_flow=t(guess), max_err=45.0)
        return [x.cpu().numpy() for x in (xy, valid, pts, status)]

    c, k = run("cpu"), run(cuda)
    assert np.array_equal(k[0], c[0]) and np.array_equal(k[1], c[1]) and c[1].sum() >= 10
    assert np.array_equal(k[3], c[3]) and c[3].sum() >= 10
    assert np.abs(k[2] - c[2])[c[3]].max() <= cs.KLT_TRACK_TOL
