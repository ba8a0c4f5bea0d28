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


def _render(i=1):
    from cube_slam_tpu_torch.utils import io, synth

    return synth.SynthSequence(3, K=io.CabinetSequence.K, wh=(640, 480)).gray(i)


def test_detect_lines_pyramid_card_vs_cpu(cuda):
    """The LSD and EDLine pyramids on a 640x480 render, card vs CPU, as
    chip_smoke.py phase 14C checks them on four frames: end to end, and the
    line fit on the CPU's support (active pixels, angles, magnitudes), the
    card finds at least chip_smoke.LINE_MATCH_SHARE of the CPU's segments
    within chip_smoke.LINE_SET_TOL px (its segment sums and atan2 round
    differently, which flips segments on a filter's threshold or at a full
    top-k's cut); two card runs are bit-identical."""
    from torch_parity_utils import cs

    from cube_slam_tpu_torch.ops import lsd

    img = _render()
    found, total = 0, 0
    for detector in ("edline", "lsd"):
        c = lsd.detect_lines_pyramid(torch.as_tensor(img), detector=detector)
        k = lsd.detect_lines_pyramid(torch.as_tensor(img, device=cuda), detector=detector)
        k2 = lsd.detect_lines_pyramid(torch.as_tensor(img, device=cuda), detector=detector)
        assert torch.equal(k["lines_base"], k2["lines_base"]) and torch.equal(k["valid"], k2["valid"])
        for o in range(2):
            sl = slice(o * 128, (o + 1) * 128)
            a = c["lines_base"][sl].numpy()[c["valid"][sl].numpy()]
            found += cs._line_sets_matched(a, k["lines_base"][sl].cpu().numpy()[k["valid"][sl].cpu().numpy()],
                                           cs.LINE_SET_TOL)
            args, kw = cs._fit_inputs(lsd, detector, c["octave_images"][o], o)
            fits = [lsd._fit_lines_from_support(*[x.to(d) if torch.is_tensor(x) else x for x in args], **kw)
                    for d in ("cpu", cuda)]
            lines = [ln.cpu().numpy()[va.cpu().numpy()] for ln, va in fits]
            found += cs._line_sets_matched(lines[0], lines[1], cs.LINE_SET_TOL)
            total += len(a) + len(lines[0])
    assert total > 400 and found >= cs.LINE_MATCH_SHARE * total, (found, total)


def test_lbd_descriptors_card_vs_cpu(cuda):
    """LBD on the same lines: fdesc within chip_smoke.FDESC_TOL, a bit
    differs only at a near-tie (its two entries within it), the card repeats
    bit for bit, and match_lines gives the same matches on the same words."""
    from torch_parity_utils import cs

    from cube_slam_tpu_torch.ops import lbd, lsd

    img = torch.as_tensor(_render())
    lines, valid = lsd.detect_lines(img, min_length=15.0, max_lines=128)
    fc, bc = lbd.lbd_descriptors(img, lines, valid)
    fk, bk = lbd.lbd_descriptors(img.to(cuda), lines.to(cuda), valid.to(cuda))
    fk2, bk2 = lbd.lbd_descriptors(img.to(cuda), lines.to(cuda), valid.to(cuda))
    assert torch.equal(fk, fk2) and torch.equal(bk, bk2)
    fc, bc, fk, bk = fc.numpy(), bc.numpy(), fk.cpu().numpy(), bk.cpu().numpy()
    assert np.abs(fk - fc).max() <= cs.FDESC_TOL
    tie = np.abs(fc[:, lbd._PAIR_A] - fc[:, lbd._PAIR_B]) <= cs.FDESC_TOL
    assert not ((cs._bits(bk) != cs._bits(bc)) & ~tie).any()
    mc = lbd.match_lines(torch.as_tensor(bc), valid, torch.as_tensor(bc[::-1].copy()), valid.flip(0))
    mk = lbd.match_lines(torch.as_tensor(bc, device=cuda), valid.to(cuda), torch.as_tensor(bc[::-1].copy(), device=cuda),
                         valid.flip(0).to(cuda))
    assert all(torch.equal(a, b.cpu()) for a, b in zip(mc, mk))


def test_chamfer_card_vs_cpu(cuda):
    """chamfer_l2_3x3 on the card equals the CPU's bit for bit (adds of the
    same constants, exact mins) on random, empty, full and Canny masks."""
    from cube_slam_tpu_torch.ops import image

    r = np.random.default_rng(0)
    masks = [r.uniform(size=(37, 131)) < 0.05, np.zeros((24, 40), bool), np.ones((24, 40), bool),
             image.canny(torch.as_tensor(_render())).numpy()]
    for m in masks:
        c = tdt.chamfer_l2_3x3(torch.as_tensor(m))
        k = tdt.chamfer_l2_3x3(torch.as_tensor(m, device=cuda))
        assert torch.equal(c, k.cpu())


def test_sharded_one_nccl_rank_matches_unsharded(cuda):
    """The three sharded calls (optimize_graph_sharded, sharded_local_ba,
    detect_lattice_sharded) over a one-rank NCCL mesh on the card against
    their one-device counterparts on tests/test_parallel.py's scenes, within
    its bounds (chip_smoke.sharded_gaps); the sharded detector launches the
    EDT kernel once."""
    import torch.distributed as dist
    from torch_parity_utils import cs, parallel_inputs

    from cube_slam_tpu_torch.parallel.mesh import make_mesh

    inp = parallel_inputs()
    mesh = make_mesh(1, device=cuda)
    try:
        assert dist.get_backend(mesh.get_group()) == "nccl"
        out, _, launches = cs.sharded_calls(mesh, inp, cuda)
    finally:
        dist.destroy_process_group()
    ref, _ = cs.unsharded_calls(inp, cuda)
    gaps, ok = cs.sharded_gaps(out, ref)
    assert ok, gaps
    assert launches == 1


@pytest.mark.parametrize("op,syncs", [
    ("cpu", 1), ("item", 1), ("nonzero", 1), ("bool", 1), ("elementwise", 0), ("upload", 1), ("query", 0)])
def test_sync_counter_counts_one_per_read_back(cuda, op, syncs):
    """The profiler's `sync` counter: one known synchronizing operation
    inside a span counts exactly 1 on that span, an asynchronous one 0, and
    the sync debug mode is restored when the profiler is disabled. An
    upload from pageable host memory waits on the stream: it counts."""
    import numpy as np

    from cube_slam_tpu_torch.utils import profiler

    x = torch.arange(8, dtype=torch.float32, device=cuda)
    run = {"cpu": lambda: x.cpu(), "item": lambda: x.sum().item(), "nonzero": lambda: (x > 3).nonzero(),
           "bool": lambda: bool(x[0] > 0), "elementwise": lambda: x * 2,
           "upload": lambda: torch.as_tensor(np.ones(4, np.float32), device=cuda),
           "query": lambda: torch.cuda.Event().query()}[op]
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    profiler.drain()
    profiler.enable()
    try:
        with profiler.span("outer"):
            with profiler.span("op"):
                run()
    finally:
        profiler.disable()
    spans = {s.name: s for s in profiler.drain()}
    assert (spans["op"].counts or {}).get("sync", 0) == syncs
    assert spans["outer"].counts is None
    assert torch.cuda.get_sync_debug_mode() == mode
