#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before a result is printed):

0. the device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and the torch / CUDA versions.
1. the build: the EDT CUDA kernels (csrc/edt.cu, nvcc for sm_90a) and the
   host line-merge library (csrc/host/merge_lines.cpp, g++), with seconds,
   and ptxas's registers, shared memory and spills of both EDT kernels.
2. kernel against plain: the EDT kernel must be bit-identical
   (torch.equal) to the plain PyTorch EDT on the card, on random, ragged
   and degenerate masks. Then at (1, 3, 12) x 480 x 640: the column pass
   and the row pass timed apart, the whole kernel per call, and the plain
   EDT, beside the bound (see `edt_bound_ms`).
3. the detector on one 640x480 synthetic frame with roll/pitch sampling,
   once through the kernel and once through the plain EDT; the packed
   top-k must agree. The EDT kernel is held against the plain version again
   on the edge maps the detector hands it, and timed there beside its bound
   (these are the numbers in the kernels line). Prints detector ms per
   frame.
4. the slice: ObjectSlamDemo.run_online over the 58-frame 640x480 synthetic
   orbit (graph capacity 64 frames, 5 LM iterations per frame), with the
   kernel launch counter reset just before it; prints frames/s, stage ms
   per frame, ATE and the cuboid's error against the synthetic truth. Then
   the port's LSD lines of the 58 frames are computed twice on the card and
   must be bit-identical (the segment sums add in a fixed order).
5. a small reference: the same online run at 320x240 over 3 frames on the
   card and on the CPU (the plain path) must agree.
6. the monocular ORB tracker at full width: MonocularTracker.track() over
   the same 58-frame 640x480 orbit at the repo's TUM-cabinet preset (1500
   features, 8 levels, loop closing off), then final_trajectory(). Prints
   frames tracked, keyframes, map points, scaled ATE, ms per tracked frame
   and per keyframe frame, the profiler's per-stage split, and the device
   busy share over frames 20-25 of the same run under torch.profiler
   (frames/s and the per-frame times leave those 6 frames out). The plain
   tracker runs
   no hand kernel (it detects no objects): the kernel counts are reset
   before it and read after it, and must stay 0.
7. tracker card vs CPU: the 14-frame 320x240 tracker sequence of
   tests/test_torch_tracker.py on the card and on the CPU, both with the
   local-BA fold forced synchronous; the same frames tracked, the same
   keyframe count, and poses that agree up to the monocular gauge:
   rotations within TRACKER_ROT_TOL, camera centres within
   TRACKER_CENTRE_TOL (RMS) after a Sim3 alignment. The card runs twice,
   and whether the two runs are bit-identical is printed.
8. the object tracker at full width: ObjectSlamTracker.track(gray, boxes,
   lines) over the first OBJECT_FRAMES frames of the same 58-frame 640x480
   orbit (the shortest prefix of at least 30 frames on which the run
   still promotes a landmark and tracks 0.7 of its frames) at the same
   preset, with ground_Twc0 the first truth pose, the truth box as the 2D
   box and the port's LSD lines; the kernel count is reset just before it.
   Prints each frame's kind, the tracker's outcome, each landmark against
   the true box, the scaled ATE,
   frames/s and ms per tracked / keyframe frame, the profiler's object
   spans, the EDT launches against the detector calls, and the device
   events of one object BA under torch.profiler.
9. object tracker card vs CPU: the 24-frame 320x240 object gate of
   tests/test_torch_object_tracker.py (the port's LSD lines), the fold
   forced synchronous. The CPU initializes it (frames 0-9); copies of that
   tracker run the rest on the card twice and on the CPU (which must repeat
   the original bit for bit): the same frames tracked, keyframes on the
   same frames, landmarks, scale flag, poses within phase 7's bounds, the
   landmark within OBJECT_LANDMARK_*_TOL; whether the card runs are
   bit-identical is printed.
10. loop closing. A: the object tracker with everything on (loop closing,
   its global BA, loop_min_gap_kfs 6) over the 61-frame there-and-back
   640x480 orbit of tests/test_full_system.py at the phase-8 preset, truth
   boxes and the port's LSD lines; the kernel count is reset just before
   it. Prints the tracker's outcome, each loop closed (keyframe pair, Sim3
   inliers, scale), the scaled ATE, frames/s, ms per tracked / keyframe
   frame, the loop.* and obj.* spans, and the EDT launches against the
   detector calls. B: that test's end-of-loop drift and revisit duplicates
   injected into A's live map (inject_loop_drift says how and why it
   departs from the test), then _try_close_loop on the revisit: a loop
   must close and lower the keyframe ATE, the landmark's drift error and
   final_trajectory()'s error, and a TUM file of the trajectory must read
   back the same. C: the constructed 14-keyframe drifted loop
   (utils/synth.build_drifted_loop) through MonocularTracker._try_close_loop
   twice on the card and once on the CPU: the same loop edge, the same
   fused associations and keyframe poses within LOOP_POSE_TOL before the
   global BA; whether the two card runs are bit-identical is printed.
11. the depth inputs. A: RgbdTracker.track(gray, depth) over phase 6's
   58-frame 640x480 orbit with each frame's rendered depth, at the TUM
   preset (1500 features x 8 levels, depth_max 8 m). B: StereoTracker.track(
   left, right) over a 40-frame 1241x376 orbit at KITTI 00-02's camera
   (3000 features x 8 levels, baseline 0.537 m, depth_max 40 m), each right
   image rendered from the left pose moved by the baseline along the
   camera's x axis. Each prints frames tracked, keyframes, map points, the
   unaligned metric ATE (the first tracked pose mapped by its truth pose),
   frames/s, median ms per tracked and per keyframe frame, the kf.* and
   ba.fold spans and the host transfers that _kf_map_ratio makes; B also
   stereo_match_keypoints' ms per frame (CUDA events) and the keypoints it
   matches. Neither path launches the EDT kernel (checked). C: the two
   gates of tests/test_rgbd_stereo.py (320x240) on the card twice and on
   the CPU, the fold forced synchronous: the same frames tracked and
   keyframes, poses within DEPTH_POSE_TOL, the two card runs bit-identical.
12. the KITTI trackers, offline cuboid rows of the room box (tracklet ids,
   the car prior = the box's half extents; no detector, so no EDT launch,
   checked). A: KittiMonoTracker.track(left) over phase 11B's 40 left
   images (1241x376, 3000 features x 8 levels, two-view initialization,
   the object-depth scale anchor at each keyframe, ground recovery every 3
   keyframes at the mount's height). B: KittiStereoTracker.track(left,
   right) over the same 40 pairs at 11B's baseline and depth range. Each
   prints frames tracked, keyframes, map points, the unaligned metric ATE
   (aligned on the first tracked frame only) beside the similarity-aligned
   one, the landmark against the true box and the prior, frames/s, the
   median ms per tracked and keyframe frame and the obj.* / kitti.* spans
   per keyframe; A also the anchor scales and the ground recoveries. C: the
   two KITTI gates (tests/test_kitti_mode.py:37's 14 frames, bootstrapped
   from the object's depth, and tests/test_rgbd_stereo.py:71's 10 pairs,
   320x240, uint8 grey levels) through run_kitti_sequence /
   run_kitti_stereo_sequence with output_prefix, on the card twice and on
   the CPU: the same tracked frames and ground recoveries, the same first
   anchor, keyframe and anchor counts, the second anchor and the written
   files within KITTI_ENTRY_BOUNDS (how far 1-ulp perturbations move the
   JAX package's own run: these runs fork on rounding), the two card runs
   bit-identical; it prints both runs' cuboid rows.
13. dynamic objects (no detector, so no EDT launch, checked). A:
   KittiMonoTracker(dynamic=True).track(left) over phase 11B's 40-frame
   1241x376 orbit re-rendered with the room box driving along world +x
   (offline rows with tracklet 7, the car prior = the box's half extents,
   the map bootstrapped from frame 0's rendered depth, 3000 features x 8
   levels). B: DynamicRgbdTracker.track(gray, depth, detections) over phase
   6's 58-frame 640x480 orbit with the box driving (TUM preset, instance
   masks: KLT chains, forward-backward LK and Harris re-seeding on the
   card). Each prints frames tracked, keyframes, map points, the metric
   ATE, the object's velocity against the truth, its median per-keyframe
   position error and displacement error, frames/s, the dyn.* spans per
   keyframe and KLT's device ms and calls per frame. C: harris_corners and
   pyr_lk on a 13B frame pair, dynamic_object_ba on
   tests/test_dynamic_ba.py's scene and track_dynamic_object on
   tests/test_dynamic_pipeline.py's, then the gates of
   tests/test_dynamic_tracker.py (DynamicRgbdTracker) and
   tests/test_kitti_dynamic.py (run_kitti_sequence(dynamic=True) with
   output_prefix), each on the card twice and on the CPU: within
   KLT_TRACK_TOL, DYNAMIC_BA_TOL and DYNAMIC_GATE_BOUNDS (the CPU tests'
   bounds), the card runs bit-identical.

14. line features (the reference's line_lbd; no detector, so no EDT
   launch, checked). A: over phase 6's 58-frame 640x480 orbit,
   describe_lines_pyramid (2 octaves x 128 lines, LBD descriptors) with
   detector "lsd" and with "edline" on each frame, and match_lines between
   consecutive frames: the valid lines per octave and the matches per pair
   (medians), the share of matches that agree with the truth motion (the
   matched segment's midpoint, back-projected with the rendered depth
   through its truth pose and projected into the next frame, within
   LINE_AGREE_PX of the matched segment's line), beside the JAX package's
   figures on the same frames (LINE_REFERENCE, tools/line_reference.py);
   the share may fall at most LINE_AGREE_SLACK below JAX's. Also the ms per
   frame of detection, LBD and matching (CUDA events) and the kernel
   launches per describe_lines_pyramid and match_lines call. C: on four of
   those frames, card (twice) vs CPU: the pyramid's lines end to end, and
   the line fit on the CPU's support as sets within LINE_SET_TOL px; LBD of
   the CPU's lines within FDESC_TOL, bits flipped only at near-ties;
   match_lines equal on the same words; chamfer_l2_3x3 torch.equal on the
   detector's edge maps of phase 3; pnp_ransac_dlt on
   tests/test_torch_initializer_pnp.py's scene with the same inliers and Tcw
   within PNP_TCW_TOL; the two card runs bit-identical.

Each phase prints its seconds, and the last [time] line the whole run's
against the 1,200 s limit.

The second-to-last line is a JSON object of the kernels and their numbers;
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SLICE_FRAMES = 58
SLICE_WH = (640, 480)
DETECTOR_TOL = 1e-4   # packed top-k fields, kernel vs plain EDT (same card)
SMALL_TOL = 5e-3      # card vs CPU online run (see tests/test_torch_slice.py)
TRACKER_MIN_TRACKED = 0.7  # share of its frames phase 6 (and phase 8) must track
PROFILED_FRAMES = range(20, 26)  # phase 6's frames under torch.profiler
TRACKER_ATE_MAX = 0.6      # m: phase 6 read 0.2811 on its first card run (JAX: 0.216)
# phase 7, card vs CPU up to the monocular gauge (the map's scale is free and
# float rounding moves it by a few percent): rotations, and the camera
# centres' RMS after a Sim3 alignment. Four card runs read <= 2.6e-3 and
# <= 5.8e-4.
TRACKER_ROT_TOL = 1e-2
TRACKER_CENTRE_TOL = 5e-3
# phase 9: the object gate initializes at frame 9; its landmark's centre (m)
# and half-scale (m) card vs CPU. The landmark's object BA is rank deficient
# on this sequence (no box edge: the box touches the image border; the JAX
# package drives the scale to its 0.01 floor), so float rounding moves it
# far: card vs CPU 0.42-0.72 m and 0.20-0.22 m (three calls), JAX vs the
# port on the CPU 0.6 m. The bounds only say it is the same object: the
# box's distance to the camera (~3 m) halved, and its largest true half
# extent
OBJECT_GATE_INIT = 9
# phase 8 (Gate C) runs this prefix of phase 6's 58-frame orbit
OBJECT_FRAMES = 30
OBJECT_LANDMARK_CENTRE_TOL = 1.5
OBJECT_LANDMARK_SCALE_TOL = 0.6
# phase 10: the there-and-back orbit of tests/test_full_system.py, and the
# constructed loop's keyframe poses card vs CPU after correction and fusion,
# before the global BA (the CPU parity tests hold the port to JAX there
# within 1e-4)
LOOP_FRAMES = 61
LOOP_POSE_TOL = 1e-3
# phase 11: the depth inputs. 11A at the TUM preset over phase 6's orbit;
# 11B at KITTI 00-02's camera (cube_slam_tpu/config.py kitti_config), its
# stereo baseline (examples/run_kitti_stereo_slam.py) and depth range
# (cube_slam_tpu/slam/kitti.py KittiStereoTracker)
KITTI_K = np.array([[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]])
KITTI_WH = (1241, 376)
KITTI_BASELINE = 0.537150588
STEREO_FRAMES = 40
RGBD_DEPTH_MAX = 8.0
STEREO_DEPTH_MAX = 40.0
DEPTH_MIN_TRACKED = 0.8
RGBD_ATE_MAX = 0.15    # m, tests/test_rgbd_stereo.py's RGBD bound
STEREO_ATE_MAX = 0.2   # m, its stereo bound
# 11C: tracked poses card vs CPU (entries of Tcw; the CPU parity tests hold
# the port to JAX within 5e-3)
DEPTH_POSE_TOL = 5e-3
# phase 12
KITTI_MONO_OBJECT_BOOTSTRAP = False  # 12A: two-view initialization
# 12C: the two KITTI gates at 320x240 (tests/test_kitti_mode.py:37's mono
# scene and tests/test_rgbd_stereo.py:71's stereo scene): camera, box half
# extents, stereo baseline, tracker and ground configuration as the JAX
# tests; tests/torch_parity_utils.py builds its KITTI gates from these
KITTI_GATE_K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
KITTI_GATE_WH = (320, 240)
KITTI_GATE_HALF = np.array([0.5, 0.35, 0.8], dtype=np.float32)
KITTI_GATE_BASELINE = 0.12
KITTI_GATE_MONO = dict(n_features=600, n_levels=3, max_kf=24, max_mp=4096, min_init_kps=80, min_init_matches=80,
                       enable_loop_closing=False)
KITTI_GATE_STEREO = dict(n_features=600, n_levels=3, max_kf=24, max_mp=4096, min_inliers_local=15)
KITTI_GATE_GROUND = dict(nominal_height=1.4, every_kfs=3, min_points=12, inlier_thresh=0.03)
# The gates through the entry points, against JAX's run on the CPU
# (tests/test_torch_kitti_stereo.py) and card against CPU (12C): the radius
# of JAX's 1-ulp spread in the same runs, the largest gap of any of 24
# perturbed runs from its unperturbed one (tools/kitti_gate_spread.py
# --gate mono-entry / stereo-entry --at keyframes): counts of keyframes and
# anchors, the second anchor (relative), and in the written files the
# camera centres (m), the rotation entries, the landmark's centre (m), its
# yaw modulo pi and its half-scale (m). The mono landmark's orientation is
# not determined by this gate (JAX's own runs put its yaw up to 1.06 rad
# from its run, and JAX's landmark sits at Euler roll -1.42 rad where the
# box's is 1.62), so its yaw is not bounded (None); the stereo half-scale's 1.04 m is the
# object BA's gauge step, which rescales fixed-scale landmarks too (ROADMAP
# queue 3).
KITTI_ENTRY_BOUNDS = {
    "mono": dict(keyframes=1, anchors=2, anchor=5.8e-6, centre=0.642, rotation=0.043, landmark=0.755, yaw=None,
                 scale=0.136),
    "stereo": dict(keyframes=1, anchors=0, anchor=0.0, centre=0.277, rotation=0.0545, landmark=0.502, yaw=0.13,
                   scale=1.037),
}
def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, warmup=3, reps=20):
    """Median milliseconds of fn() over `reps` runs, timed with CUDA events
    after `warmup` untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=20, reps=10):
    """Device milliseconds of one fn(): a CUDA graph of `calls` back-to-back
    calls replayed under CUDA events (median of `reps`), over `calls`. The
    host's launch time is not in it; the graph's gaps between kernels are."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, warmup=2, reps=reps) / calls


# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, HBM3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


# FP32 operations per pixel of the exact lower envelope (Felzenszwalb and
# Huttenlocher): a forward and a backward scan down each column (an add and
# a min each), then per row an amortised two parabola intersections per
# source (~6 each) and one evaluation per output (a subtract and an FMA),
# rounded up
EDT_OPS_PER_PIXEL = 20


def edt_bound_ms(shape):
    """The least time the card could take for an exact EDT of a (B, H, W)
    mask: EDT_OPS_PER_PIXEL operations per pixel at the FP32 peak, or 1 byte
    in and 4 out per pixel at the HBM rate, whichever is larger. Returns
    (ms, what bounds it)."""
    B, H, W = shape
    ops_s = EDT_OPS_PER_PIXEL * B * H * W / FP32_FLOPS
    bytes_s = 5.0 * B * H * W / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def edt_brute_force_ms(shape):
    """The floor of the algorithm the kernel runs, not of the function: the
    brute-force min-plus's 2*B*H*W^2 operations (an add and a min per
    candidate, the Pallas kernel's own CostEstimate) at the FP32 peak."""
    B, H, W = shape
    return 1e3 * 2.0 * B * H * W * W / FP32_FLOPS


def phase0_device():
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        sys.exit(1)
    from cube_slam_tpu_torch.device import require_cuda

    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return dev


def phase1_build():
    from cube_slam_tpu_torch.ops import _build, hopper_kernels

    hopper_kernels.build()
    _build.load("host")
    log(f"[build] cuda_kernels {_build.build_seconds['cuda_kernels']:.2f} s, "
        f"host {_build.build_seconds['host']:.2f} s")
    report = ptxas_report(_build.build_logs["cuda_kernels"])
    assert set(report) == {"edt_column_pass", "edt_row_pass"}, f"no ptxas report of both kernels: {report}"
    for kernel, lines in report.items():
        log(f"[build] ptxas {kernel}: " + "; ".join(lines))
    log("[build] (both kernels take their shared memory dynamically, sized at launch: ptxas counts "
        "only static shared memory)")


def ptxas_report(log_text):
    """ptxas -v's lines per EDT kernel: registers, shared memory, spills."""
    import re

    report, kernel = {}, None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?\S*?(edt_(?:column|row)_pass)", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("Used" in line or "spill" in line or "smem" in line):
            report.setdefault(kernel, []).append(line.split(":", 1)[-1].strip() if "ptxas" in line else line.strip())
    return report


def phase2_edt(dev):
    from cube_slam_tpu_torch.ops import distance_transform as dt
    from cube_slam_tpu_torch.ops import hopper_kernels as hk

    rng = np.random.default_rng(0)
    cases = {
        "1x480x640 d=1%": rng.uniform(size=(1, 480, 640)) < 0.01,
        "1x480x640 d=10%": rng.uniform(size=(1, 480, 640)) < 0.10,
        "4x480x640 d=1%": rng.uniform(size=(4, 480, 640)) < 0.01,
        "4x480x640 d=10%": rng.uniform(size=(4, 480, 640)) < 0.10,
        "2x37x131": rng.uniform(size=(2, 37, 131)) < 0.05,
        "3x7x100": rng.uniform(size=(3, 7, 100)) < 0.05,
        "2x30x641": rng.uniform(size=(2, 30, 641)) < 0.02,
        "1x20x4096": rng.uniform(size=(1, 20, 4096)) < 0.002,
        "12x480x640 d=1%": rng.uniform(size=(12, 480, 640)) < 0.01,
        "all false 1x480x640": np.zeros((1, 480, 640), dtype=bool),
        "all true 1x480x640": np.ones((1, 480, 640), dtype=bool),
        "1x1x1": np.ones((1, 1, 1), dtype=bool),
    }
    max_err = 0.0
    for name, m in cases.items():
        mc = torch.as_tensor(m, device=dev)
        k = hk.edt_l2(mc)
        p = dt.edt_l2(mc)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"EDT kernel differs from plain on {name}: "
                                 f"max |diff| {float((k - p).abs().max())}")
        max_err = max(max_err, float((k - p).abs().max()))
        if name.startswith("all false"):
            assert torch.all(k == torch.sqrt(torch.tensor(1e9, device=dev))), name
    log(f"[edt] kernel == plain (torch.equal) on {len(cases)} cases")

    for B in (1, 3, 12):
        mc = torch.as_tensor(rng.uniform(size=(B, 480, 640)) < 0.01, device=dev)
        g2 = torch.empty(mc.shape, dtype=torch.float32, device=dev)
        out = torch.empty_like(g2)
        col = graph_ms(lambda: hk.edt_column_pass_cuda(mc, g2))
        row = graph_ms(lambda: hk.edt_row_pass_cuda(g2, out))
        dev_ms = graph_ms(lambda: hk.edt_l2(mc))
        kms = cuda_ms(lambda: hk.edt_l2(mc))
        pms = cuda_ms(lambda: dt.edt_l2(mc))
        bound, by = edt_bound_ms(mc.shape)
        brute = edt_brute_force_ms(mc.shape)
        log(f"[edt] ({B}, 480, 640) d=1%: column pass {col:.4f} ms, row pass {row:.4f} ms, whole kernel "
            f"{dev_ms:.4f} ms (device time: CUDA graph of 20 calls); per call {kms:.4f} ms, plain "
            f"{pms:.4f} ms (median of 20, CUDA events); bound {bound:.4f} ms ({by}), "
            f"{100 * bound / dev_ms:.1f}% of it in device time, {100 * bound / kms:.1f}% per call; "
            f"brute-force floor {brute:.4f} ms, {100 * brute / dev_ms:.1f}% of it in device time")
    return max_err


def synth_sequence(n, wh):
    from cube_slam_tpu_torch.utils import io, synth

    K = io.CabinetSequence.K.copy()
    if wh != (640, 480):
        K[:2] *= wh[0] / 640.0
    return synth.SynthSequence(n, K=K, wh=wh)


def phase3_detector(dev, seq):
    from cube_slam_tpu_torch.models import detector as det_mod
    from cube_slam_tpu_torch.ops import distance_transform as dt
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.ops import lsd

    f = 1
    gray = seq.gray(f)
    lines, valid = lsd.detect_lines(torch.as_tensor(gray, device=dev), min_length=15.0, max_lines=128)
    lines_np = lines.cpu().numpy()[valid.cpu().numpy()]
    det = det_mod.CuboidDetector(device=dev)
    det.set_calibration(seq.K)
    det.nominal_skew_ratio = 2.0
    det.whether_sample_cam_roll_pitch = True
    args, _ = det.prepare_batch(gray, seq.truth_Twc(0), seq.yolo_boxes(f)[:1, :4], lines_np)

    before = hk.edt_launches
    res, _, _, _, pk = det_mod.detect_lattice_batch(**args)
    launches = hk.edt_launches - before
    seen = []  # the edge maps the detector hands the EDT

    def plain_edt(edges):
        seen.append(edges)
        return dt.edt_l2(edges)

    pp = det_mod._detect_lattice(**args, edt=plain_edt)[4]
    torch.cuda.synchronize()
    vk, vp = pk[..., 32] > 0.5, pp[..., 32] > 0.5
    assert torch.equal(vk, vp), "top-k valid masks differ (kernel vs plain EDT)"
    assert bool(vk[0, 0]), "no cuboid proposal on the detector frame"
    gap = float((pk - pp)[vk].abs().max())
    assert gap <= DETECTOR_TOL, f"packed top-k differs by {gap}"
    assert launches >= 1, "the detector did not launch the EDT kernel"

    edges = seen[0]
    k = hk.edt_l2(edges)
    torch.cuda.synchronize()
    assert torch.equal(k, dt.edt_l2(edges)), "EDT kernel differs from plain on the detector's edges"
    edt = {"ms": cuda_ms(lambda: hk.edt_l2(edges)), "plain_ms": cuda_ms(lambda: dt.edt_l2(edges)),
           "device_ms": graph_ms(lambda: hk.edt_l2(edges))}
    edt["bound_ms"], edt["bound_by"] = edt_bound_ms(edges.shape)
    edt["bound_share"] = edt["bound_ms"] / edt["ms"]
    edt["brute_force_ms"] = edt_brute_force_ms(edges.shape)
    log(f"[edt] the detector's own edge maps {tuple(edges.shape)}: kernel == plain (torch.equal); "
        f"kernel {edt['ms']:.4f} ms per call, plain {edt['plain_ms']:.4f} ms (median of 20, CUDA events); "
        f"device time {edt['device_ms']:.4f} ms (CUDA graph of 20 calls); bound {edt['bound_ms']:.5f} ms "
        f"({edt['bound_by']}: 5 B per pixel / 3.35 TB/s against {EDT_OPS_PER_PIXEL} operations per pixel "
        f"/ 67 TFLOP/s), {100 * edt['bound_share']:.1f}% of it per call, "
        f"{100 * edt['bound_ms'] / edt['device_ms']:.1f}% in device time; brute-force floor "
        f"{edt['brute_force_ms']:.4f} ms (2*B*H*W^2 / 67 TFLOP/s), "
        f"{100 * edt['brute_force_ms'] / edt['device_ms']:.1f}% of it in device time")

    ms = cuda_ms(lambda: det_mod.detect_lattice_batch(**args), warmup=2, reps=10)
    ms_plain = cuda_ms(lambda: det_mod._detect_lattice(**args, edt=dt.edt_l2), warmup=2, reps=10)
    log(f"[detector] {gray.shape[1]}x{gray.shape[0]}, {res.valid.shape[1]} proposals per bbox: "
        f"top-k kernel vs plain max |diff| {gap:.3g}; {ms:.3f} ms/frame with the kernel, "
        f"{ms_plain:.3f} ms/frame with the plain EDT (median of 10, CUDA events); "
        f"EDT launches per call {launches}")
    return edt, edges


def phase4_slice(dev, seq):
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.slam.object_slam import ObjectSlamDemo, evaluate_ate

    # render (host numpy) before the clock starts: frames are inputs
    t0 = time.perf_counter()
    for f in range(seq.num_frames):
        seq.gray(f)
    log(f"[slice] rendered {seq.num_frames} frames {seq.wh[0]}x{seq.wh[1]} in "
        f"{time.perf_counter() - t0:.1f} s (host numpy)")
    n_det_calls = sum(1 for f in range(seq.num_frames) if seq.yolo_boxes(f).size)

    demo = ObjectSlamDemo(max_frames=64, num_lm_iters=5, device=dev)
    torch.cuda.synchronize()
    hk.edt_launches = 0
    t0 = time.perf_counter()
    res = demo.run_online(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hk.edt_launches

    assert np.isfinite(res.chi2_history).all(), "non-finite chi2"
    assert res.raw_cube_valid[0], "frame 0 has no detection"
    assert launches > 0, "the slice did not launch the EDT kernel"
    assert launches >= n_det_calls, f"{launches} EDT launches for {n_det_calls} detector calls"
    N = seq.num_frames
    truth = np.stack([seq.truth_Twc(f) for f in range(N)])
    ate = evaluate_ate(res.est_Twc, truth)
    box_T, box_half = seq.scene.box_pose_scale()
    centre_err = float(np.linalg.norm(res.cube_pose_history[-1][:3, 3] - box_T[:3, 3]))
    scale_err = float(np.abs(res.cube_scale_history[-1] - box_half).max())
    st = {k: 1e3 * float(np.mean(v)) for k, v in demo.stage_seconds.items()}
    log(f"[slice] {N} frames, F=64, 5 LM iterations: {N / wall:.3f} frames/s detect+BA "
        f"({wall:.2f} s); per frame: lines {st['lines']:.2f} ms, detect {st['detect']:.2f} ms, "
        f"LM {st['lm']:.2f} ms (host clock, each stage ends in a device read)")
    log(f"[slice] frames with a detection {int(res.raw_cube_valid.sum())}/{N}; ATE {ate:.4f} m; "
        f"final cuboid centre error {centre_err:.4f} m, max half-scale error {scale_err:.4f} m; "
        f"EDT launches {launches} for {n_det_calls} detector calls")

    # the port's lines repeat bit for bit: two computations of every frame
    from cube_slam_tpu_torch.ops import lsd

    differ = []
    for f in range(N):
        g = torch.as_tensor(seq.gray(f), device=dev)
        a = lsd.detect_lines(g, min_length=15.0, max_lines=128)
        b = lsd.detect_lines(g, min_length=15.0, max_lines=128)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            differ.append(f)
    log(f"[slice] LSD lines of the {N} frames computed twice on the card: bit-identical on "
        f"{N - len(differ)}/{N} frames" + (f" (differ on {differ})" if differ else ""))
    assert not differ, f"LSD lines differ between two computations on frames {differ}"
    return launches


def phase5_small_reference(dev):
    from cube_slam_tpu_torch.slam.object_slam import ObjectSlamDemo

    seq = synth_sequence(3, (320, 240))
    rg = ObjectSlamDemo(max_frames=8, num_lm_iters=5, device=dev).run_online(seq)
    rc = ObjectSlamDemo(max_frames=8, num_lm_iters=5, device="cpu").run_online(seq)
    assert np.array_equal(rg.raw_cube_valid, rc.raw_cube_valid), "detections differ card vs CPU"
    for name in ("est_Twc", "cube_pose_history", "cube_scale_history"):
        gap = float(np.abs(getattr(rg, name) - getattr(rc, name)).max())
        assert gap <= SMALL_TOL, f"{name} differs card vs CPU by {gap}"
    log(f"[small] 3 frames 320x240 on the card and on the CPU agree within {SMALL_TOL}")


def _always_fold(cls):
    """`cls` folding each local BA at once: the card's event-polled fold may
    land a frame later than the CPU's, which changes the map."""

    class AlwaysFold(cls):
        def _apply_pending_map(self, only_if_ready=False):
            return super()._apply_pending_map(only_if_ready=False)

    return AlwaysFold


def _scaled_ate(traj, truth):
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled

    est = [(fid, np.linalg.inv(T)) for fid, T in traj if T is not None]
    if len(est) < 3:
        return float("nan")
    return evaluate_ate_scaled(np.stack([T for _, T in est]), np.stack([truth[f] for f, _ in est]))


def drive(trk, inputs, sync=None, after_frame=None):
    """Track one frame per entry of `inputs` (track()'s positional
    arguments), timing each on the host clock with `sync` (by default
    torch.cuda.synchronize) after it, then take final_trajectory().
    `after_frame(f)` runs after frame f is synced.
    Returns (ms per frame, each frame's kind: "lost", "init", "kf" or
    "tracked", the final trajectory, the whole run's wall seconds)."""
    sync = sync or torch.cuda.synchronize
    ms, kind = [], []
    sync()
    t_all = time.perf_counter()
    for f, args in enumerate(inputs):
        was = trk.state
        t0 = time.perf_counter()
        out = trk.track(*args)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        kind.append("lost" if out is None else "init" if was == "NOT_INITIALIZED"
                    else "kf" if trk.last_kf_frame_id == f else "tracked")
        if after_frame is not None:
            after_frame(f)
    traj = trk.final_trajectory()
    sync()
    return ms, kind, traj, time.perf_counter() - t_all


def _promoted_into(trk, promoted):
    """A drive() hook adding each live landmark's (slot, generation) to
    `promoted` after every frame."""

    def note(f):
        st = trk.objects.store
        promoted.update((int(o), int(st.gen[o])) for o in np.where(st.valid)[0])

    return note


def busy_share(prof):
    """The device's busy time under a finished torch.profiler run: the union
    of the card's kernel and copy intervals. Returns
    (device events, busy seconds, the six costliest kernels by device us)."""
    from torch.autograd import DeviceType

    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy, end = 0.0, -1.0
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return len(iv), busy * 1e-6, sorted(by_name.items(), key=lambda kv: -kv[1])[:6]


def phase6_tracker(dev, seq):
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.slam.system import MonocularTracker, TrackerConfig
    from cube_slam_tpu_torch.utils import profiler

    N = seq.num_frames
    frames = [seq.gray(f) for f in range(N)]
    truth = [seq.truth_Twc(f) for f in range(N)]
    # the repo's TUM-cabinet preset (cube_slam_tpu/config.py: OrbConfig
    # n_features 1500, n_levels 8; loop closing off); other fields default
    cfg = TrackerConfig(n_features=1500, n_levels=8, enable_loop_closing=False)
    trk = MonocularTracker(seq.K, seq.wh, cfg, device=dev)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof_t = []

    def profile_frames(f):  # frames PROFILED_FRAMES run under the profiler
        if f == PROFILED_FRAMES.start - 1:
            prof.start()
            prof_t.append(time.perf_counter())
        elif f == PROFILED_FRAMES.stop - 1:
            prof_t.append(time.perf_counter())
            prof.stop()

    profiler.reset()
    profiler.enable()
    hk.edt_launches = 0
    ms, kind, traj, _ = drive(trk, [(g,) for g in frames], after_frame=profile_frames)
    launches = hk.edt_launches
    # frames/s and the per-frame times leave out the profiled frames
    timed_frames = [f for f in range(N) if f not in PROFILED_FRAMES]
    wall = 1e-3 * sum(ms[f] for f in timed_frames)
    ms = [ms[f] for f in timed_frames]
    kind_all, kind = kind, [kind[f] for f in timed_frames]
    profiler.disable()
    spans = profiler.aggregated()
    profiler.reset()

    tracked = [fid for fid, T in traj if T is not None]
    ate = _scaled_ate(traj, truth)
    ate_tracked = _scaled_ate(trk.trajectory, truth)
    n_kf, n_mp = int(trk.map.kf_valid.sum()), int(trk.map.mp_valid.sum())
    init = kind_all.index("init") if "init" in kind_all else None
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    mean = lambda k: statistics.mean([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    log(f"[tracker] {N} frames {seq.wh[0]}x{seq.wh[1]}, 1500 features x 8 levels: initialized at frame "
        f"{init}; tracked {len(tracked)}/{N}; keyframes {n_kf}; map points {n_mp}; scaled ATE "
        f"{ate:.4f} m (final trajectory), {ate_tracked:.4f} m (as tracked)")
    log(f"[tracker] {len(timed_frames) / wall:.3f} frames/s of track() ({wall:.2f} s over the "
        f"{len(timed_frames)} frames outside the profiled ones, host clock, synchronized per "
        f"frame); tracked non-keyframe frames: median {med('tracked'):.2f} ms, mean "
        f"{mean('tracked'):.2f} ms ({kind.count('tracked')}); keyframe frames: median {med('kf'):.2f} ms, "
        f"mean {mean('kf'):.2f} ms ({kind.count('kf')}); untracked frames {kind.count('lost')}")
    split = {name: spans.get(name, (0.0, 0, 0, 0, 0)) for name in
             ("track.dispatch", "track.result_read", "track.rescue", "kf.total", "kf.ba_dispatch",
              "ba.fold", "step.orb", "step.motion", "step.local_search", "step.final_pose")}
    log("[tracker] split (total ms / calls): "
        + "; ".join(f"{k} {v[0]:.1f}/{v[4]}" for k, v in split.items())
        + " — step_frame = track.dispatch + track.result_read, and step.* its stages' host "
        "queueing; local BA = kf.ba_dispatch + ba.fold")
    log(f"[tracker] EDT launches during the tracker run: {launches} (its path runs no hand kernel)")

    assert len(prof_t) == 2, f"frames {PROFILED_FRAMES} lie outside the {N}-frame run"
    n_events, busy, top = busy_share(prof)
    prof_wall = prof_t[1] - prof_t[0]
    if n_events:
        log(f"[tracker] device busy share over frames {PROFILED_FRAMES.start}-{PROFILED_FRAMES.stop - 1} "
            f"under torch.profiler: {100 * busy / prof_wall:.1f}% ({busy * 1e3:.1f} ms busy of "
            f"{prof_wall * 1e3:.1f} ms wall, {n_events} device events)")
        log("[tracker] device time by kernel over those frames: "
            + "; ".join(f"{name[:60]} {us / 1e3:.1f} ms" for name, us in top))
    else:
        log("[tracker] device busy share: not measured (torch.profiler recorded no device events)")

    assert init is not None, "the tracker never initialized"
    assert len(tracked) >= TRACKER_MIN_TRACKED * N, f"tracked only {len(tracked)}/{N}"
    assert np.isfinite(ate) and ate < TRACKER_ATE_MAX, f"scaled ATE {ate}"
    assert launches == 0  # the plain tracker detects no objects: no EDT


def phase7_tracker_card_vs_cpu(dev):
    from cube_slam_tpu_torch.slam.system import MonocularTracker, TrackerConfig
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled
    from cube_slam_tpu_torch.utils import synth

    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
    scene = synth.RoomScene(seed=2)
    poses = synth.camera_path(14)
    frames = [np.clip(scene.render(P, K, wh=(320, 240)), 0, 255).astype(np.uint8) for P in poses]
    cfg = TrackerConfig(n_features=600, n_levels=3, max_kf=24, max_mp=4096, min_init_kps=80,
                        min_init_matches=80, enable_loop_closing=False)
    runs = []
    for device in (dev, dev, "cpu"):
        trk = _always_fold(MonocularTracker)(K, (320, 240), cfg, device=device)
        for g in frames:
            trk.track(g)
        runs.append((trk.final_trajectory(), int(trk.map.kf_valid.sum()), int(trk.map.mp_valid.sum())))
    (tg, kg, mg), (tg2, _, _), (tc, kc, mc) = runs
    fg = [f for f, T in tg if T is not None]
    fc = [f for f, T in tc if T is not None]
    assert fg == fc, f"tracked frames differ: card {fg}, CPU {fc}"
    assert kg == kc, f"keyframes differ: card {kg}, CPU {kc}"
    repeat = all((a is None and b is None) or np.array_equal(a, b) for (_, a), (_, b) in zip(tg, tg2))
    pairs = [(a, b) for (_, a), (_, b) in zip(tg, tc) if a is not None]
    rot = max(float(np.abs(a[:3, :3] - b[:3, :3]).max()) for a, b in pairs)
    Twc_g = np.stack([np.linalg.inv(a) for a, _ in pairs])
    Twc_c = np.stack([np.linalg.inv(b) for _, b in pairs])
    centre = evaluate_ate_scaled(Twc_g, Twc_c)
    spread = lambda T: np.linalg.norm(T[:, :3, 3] - T[:, :3, 3].mean(0))  # noqa: E731
    raw = max(float(np.abs(a - b).max()) for a, b in pairs)
    assert rot <= TRACKER_ROT_TOL, f"rotations differ card vs CPU by {rot}"
    assert centre <= TRACKER_CENTRE_TOL, f"Sim3-aligned camera centres differ card vs CPU by {centre}"
    log(f"[tracker-small] 14 frames 320x240 on the card and on the CPU: tracked {fg[0]}-{fg[-1]} "
        f"({len(fg)}) on both, keyframes {kg} on both, map points {mg} / {mc}; rotations within "
        f"{rot:.3g} (bound {TRACKER_ROT_TOL}), Sim3-aligned centres RMS {centre:.3g} (bound "
        f"{TRACKER_CENTRE_TOL}); map scale card/CPU {spread(Twc_g) / spread(Twc_c):.4f}, raw pose gap "
        f"{raw:.3g}; two card runs bit-identical: {repeat}")


def _object_frames(seq, dev, n=None):
    """Per frame of the first `n` (default: all): the gray image, the truth
    box rows (or None) and the port's LSD lines (min_length 15, max_lines
    128) on `dev`."""
    from cube_slam_tpu_torch.ops import lsd

    out = []
    for f in range(seq.num_frames if n is None else n):
        g = seq.gray(f)
        lines, valid = lsd.detect_lines(torch.as_tensor(g, device=dev), min_length=15.0, max_lines=128)
        boxes = seq.yolo_boxes(f)
        out.append((g, boxes[:, :4] if len(boxes) else None, lines.cpu().numpy()[valid.cpu().numpy()]))
    return out


def _landmarks(trk, scene):
    """Each live landmark: (slot, centre, scale, min_log_error norm against
    the true box in the ground frame, centre error in m)."""
    from cube_slam_tpu_torch.models import cuboid as cb

    box_T, box_half = scene.box_pose_scale()
    truth = cb.Cuboid(torch.tensor(box_T, dtype=torch.float32), torch.tensor(box_half, dtype=torch.float32))
    st = trk.objects.store
    rows = []
    for o in np.where(st.valid)[0]:
        err = cb.min_log_error(cb.Cuboid(torch.tensor(st.pose[o]), torch.tensor(st.scale[o])), truth)
        rows.append((int(o), st.pose[o][:3, 3].copy(), st.scale[o].copy(), float(torch.linalg.vector_norm(err)),
                     float(np.linalg.norm(st.pose[o][:3, 3] - box_T[:3, 3]))))
    return rows


def _object_ba_profile(args, kwargs):
    """One object BA (local_ba_objects_two_stage) on the card: its time
    (CUDA events, median of 3 after 1 warm-up) and, under torch.profiler,
    its device events, their busy time and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cube_slam_tpu_torch.graph import object_ba

    ms = cuda_ms(lambda: object_ba.local_ba_objects_two_stage(*args, **kwargs), warmup=1, reps=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        object_ba.local_ba_objects_two_stage(*args, **kwargs)
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return ms, len(ev), sum(by_name.values()) / 1e3, top


def phase8_object_tracker(dev, seq):
    from cube_slam_tpu_torch.graph import object_ba
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.slam.system import ObjectSlamTracker, TrackerConfig
    from cube_slam_tpu_torch.utils import profiler

    N = OBJECT_FRAMES
    t0 = time.perf_counter()
    inputs = _object_frames(seq, dev, N)
    lines_ms = 1e3 * (time.perf_counter() - t0) / N
    truth = [seq.truth_Twc(f) for f in range(N)]
    cfg = TrackerConfig(n_features=1500, n_levels=8, enable_loop_closing=False)
    trk = ObjectSlamTracker(seq.K, seq.wh, cfg, ground_Twc0=seq.truth_Twc(0), device=dev)
    det = trk.objects.detector
    calls = [0]
    detect = det.detect_cuboid

    def counted(*a, **k):
        calls[0] += 1
        return detect(*a, **k)

    det.detect_cuboid = counted
    last_ba = {}
    solve = object_ba.local_ba_objects_two_stage

    def kept(*a, **k):
        last_ba.update(args=a, kwargs=k)
        return solve(*a, **k)

    object_ba.local_ba_objects_two_stage = kept
    profiler.reset()
    profiler.enable()
    promoted, first_promoted = set(), []
    note = _promoted_into(trk, promoted)

    def after_frame(f):
        note(f)
        if promoted and not first_promoted:
            first_promoted.append(f)

    try:
        hk.edt_launches = 0
        ms, kind, traj, wall = drive(trk, inputs, after_frame=after_frame)
        launches = hk.edt_launches
    finally:
        object_ba.local_ba_objects_two_stage = solve
        profiler.disable()
    spans = profiler.aggregated()
    profiler.reset()

    tracked = [fid for fid, T in traj if T is not None]
    ate = _scaled_ate(traj, truth)
    ate_tracked = _scaled_ate(trk.trajectory, truth)
    init = kind.index("init") if "init" in kind else None
    lms = _landmarks(trk, seq.scene)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    mean = lambda k: statistics.mean([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    log(f"[objects] the first {N} frames of the {seq.num_frames}-frame orbit, {seq.wh[0]}x{seq.wh[1]}, 1500 features "
        f"x 8 levels, truth box, port LSD lines ({lines_ms:.2f} ms/frame, outside the clock): per frame (- lost, I init, "
        f"K keyframe, t tracked) {''.join({'lost': '-', 'init': 'I', 'kf': 'K', 'tracked': 't'}[k] for k in kind)}; "
        f"first landmark alive after frame {first_promoted[0] if first_promoted else None}")
    log(f"[objects] initialized at frame {init}; tracked {len(tracked)}/{N}; "
        f"keyframes {int(trk.map.kf_valid.sum())}; map points {int(trk.map.mp_valid.sum())}; landmarks "
        f"{len(lms)} alive, {len(promoted)} promoted; mono_scale_initialized {trk.mono_scale_initialized}; "
        f"scaled ATE {ate:.4f} m (final trajectory), {ate_tracked:.4f} m (as tracked)")
    box_T, box_half = seq.scene.box_pose_scale()
    for o, c, sc, err, cerr in lms:
        log(f"[objects] landmark {o}: centre {np.round(c, 4).tolist()} (true {np.round(box_T[:3, 3], 4).tolist()}, "
            f"{cerr:.4f} m off), half-scale {np.round(sc, 4).tolist()} (true {np.round(box_half, 4).tolist()}); "
            f"min_log_error norm {err:.4f} (ground frame)")
    log(f"[objects] {N / wall:.3f} frames/s of track() ({wall:.2f} s, host clock, synchronized per frame); "
        f"tracked non-keyframe frames: median {med('tracked'):.2f} ms, mean {mean('tracked'):.2f} ms "
        f"({kind.count('tracked')}); keyframe frames: median {med('kf'):.2f} ms, mean {mean('kf'):.2f} ms "
        f"({kind.count('kf')}); initialization frame {med('init'):.2f} ms; untracked frames {kind.count('lost')}")
    split = {name: spans.get(name, (0.0, 0, 0, 0, 0)) for name in
             ("obj.detect", "obj.associate", "obj.ba", "kf.total", "kf.ba_dispatch", "ba.fold",
              "track.dispatch", "track.result_read")}
    log("[objects] split (total ms / calls): " + "; ".join(f"{k} {v[0]:.1f}/{v[4]}" for k, v in split.items())
        + " — obj.* run after kf.total's plain keyframe step")
    log(f"[objects] EDT launches on the object tracker path: {launches} for {calls[0]} detector calls "
        f"(one per keyframe with a box, plus the scale initialization)")
    if last_ba:
        ba_ms, n_ev, busy, top = _object_ba_profile(last_ba["args"], last_ba["kwargs"])
        Kf, P, O = (last_ba["args"][i].shape[0] for i in range(3))
        log(f"[objects] the last object BA again (Kf {Kf}, P {P}, O {O}, 5 + 10 LM steps): {ba_ms:.1f} ms "
            f"(median of 3, CUDA events); under torch.profiler {n_ev} device events, {busy:.1f} ms of device "
            f"time; top: " + "; ".join(f"{name[:50]} {us / 1e3:.1f} ms" for name, us in top))

    assert init is not None, "the object tracker never initialized"
    assert len(tracked) >= TRACKER_MIN_TRACKED * N, f"tracked only {len(tracked)}/{N}"
    assert np.isfinite(ate), f"scaled ATE {ate}"
    assert launches > 0 and launches == calls[0], f"{launches} EDT launches for {calls[0]} detector calls"
    # the JAX package promotes one landmark on this sequence (PERF.md §5)
    assert promoted, "no landmark promoted"
    return launches


def _object_gate():
    """The 24-frame object gate of tests/test_torch_object_tracker.py with the
    port's LSD lines (computed once on the CPU): (frames, boxes, lines, truth
    Twc, scene, K)."""
    from cube_slam_tpu_torch.ops import lsd
    from cube_slam_tpu_torch.utils import synth

    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
    scene = synth.RoomScene(seed=3, box_center=[0.0, 3.2, 0.45], box_half=[0.6, 0.4, 0.45])
    poses = synth.camera_path(40, kind="orbit", target=[0.0, 3.2, 0.6])[:24]
    frames, boxes, lines = [], [], []
    for P in poses:
        g = np.clip(scene.render(P, K, wh=(320, 240)), 0, 255).astype(np.uint8)
        ln, lv = lsd.detect_lines(torch.as_tensor(g, dtype=torch.float32), min_length=15.0, max_lines=128)
        bb = scene.box_bbox_2d(P, K, wh=(320, 240))
        frames.append(g)
        boxes.append(None if bb is None else bb[None, :])
        lines.append(ln.numpy()[lv.numpy()])
    return frames, boxes, lines, poses, scene, K


def _carry(src, cls, device):
    """A copy of the ObjectSlamTracker `src` (the class `cls`) on `device`:
    its host map and object manager, pose state, trajectories, keyframe
    database, last frame and counters. The copy re-seeds its device state
    from the host at its next frame, as `src` does after initialization."""
    import copy

    from cube_slam_tpu_torch.slam import state as st

    t = cls(src.K, src.img_wh, copy.deepcopy(src.cfg), ground_Twc0=src.ground_align,
            camera_object_weight=src.camera_object_weight, device=device)
    t.map = st.map_state_from_arrays(vars(src.map))
    for name in ("state", "last_Tcw", "velocity", "frame_id", "last_kf_frame_id", "ref_kf", "tracked_inliers",
                 "_last_rel", "trajectory", "_traj_rel", "loop_detector", "mono_scale_initialized",
                 "_world_is_ground", "_pending_obs"):
        setattr(t, name, copy.deepcopy(getattr(src, name)))
    lf = src.last_frame
    t.last_frame = st.FrameFeatures(xy=lf.xy.copy(), level=lf.level.copy(), angle=lf.angle.copy(),
                                    desc=lf.desc.copy(), valid=lf.valid.copy(), mp=lf.mp.copy())
    if src._vis_acc is not None:
        t._vis_acc, t._found_acc = src._vis_acc.to(device, copy=True), src._found_acc.to(device, copy=True)
    t.objects.load_state(vars(src.objects))
    if src._ground_est is not None:
        t._ground_est.filtered_height = src._ground_est.filtered_height
        t._ground_est.kf_counter = src._ground_est.kf_counter
    return t


def phase9_object_card_vs_cpu(dev):
    from cube_slam_tpu_torch.slam.system import ObjectSlamTracker, TrackerConfig
    from cube_slam_tpu_torch.slam.tracking import evaluate_ate_scaled

    AlwaysFold = _always_fold(ObjectSlamTracker)
    frames, boxes, lines, poses, scene, K = _object_gate()
    cfg = TrackerConfig(n_features=800, n_levels=3, max_kf=24, max_mp=4096, min_init_kps=80, min_init_matches=80,
                        match_radius_motion=20.0, enable_loop_closing=False)

    def run_from(trk, start):
        last = {}  # each landmark (slot, generation) -> its centre and half-scale on its last frame alive
        for g, bb, ln in list(zip(frames, boxes, lines))[start:]:
            trk.track(g, bboxes_2d=bb, lines=ln)
            st = trk.objects.store
            last.update({(int(o), int(st.gen[o])): (st.pose[o][:3, 3].copy(), st.scale[o].copy())
                         for o in np.where(st.valid)[0]})
        return dict(traj=trk.final_trajectory(),
                    kf_frames=sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids()),
                    last=[last[key] for key in sorted(last)], lms=_landmarks(trk, scene),
                    msi=trk.mono_scale_initialized,
                    store=(trk.objects.store.pose.copy(), trk.objects.store.scale.copy()))

    # the initialization's two-keyframe BA has a free monocular scale that
    # float rounding moves by tens of percent (the JAX package and the port
    # on the CPU end 25% apart on this sequence; PERF.md), so the card runs
    # start from the CPU's initialized tracker: frames 0-9 on the CPU, then
    # the card twice and the CPU once more from copies of that state
    cpu = AlwaysFold(K, (320, 240), cfg, ground_Twc0=poses[0], device="cpu")
    for g, bb, ln in list(zip(frames, boxes, lines))[:OBJECT_GATE_INIT + 1]:
        cpu.track(g, bboxes_2d=bb, lines=ln)
    assert cpu.state == "OK", "the object gate did not initialize by frame 9 on the CPU"
    copies = [_carry(cpu, AlwaysFold, d) for d in (dev, dev, "cpu")]
    c = run_from(cpu, OBJECT_GATE_INIT + 1)
    g, g2, cc = (run_from(t, OBJECT_GATE_INIT + 1) for t in copies)
    same = all((a is None and b is None) or np.array_equal(a, b) for (_, a), (_, b) in zip(c["traj"], cc["traj"]))
    assert same and all(np.array_equal(a, b) for a, b in zip(c["store"], cc["store"])), \
        "a CPU copy of the CPU tracker did not repeat it (the carry is incomplete)"
    fg = [f for f, T in g["traj"] if T is not None]
    fc = [f for f, T in c["traj"] if T is not None]
    assert fg == fc, f"tracked frames differ: card {fg}, CPU {fc}"
    assert g["kf_frames"] == c["kf_frames"], f"keyframes differ: card {g['kf_frames']}, CPU {c['kf_frames']}"
    assert (len(g["last"]), len(g["lms"])) == (len(c["last"]), len(c["lms"])), "landmarks differ card vs CPU"
    assert g["msi"] == c["msi"], "mono_scale_initialized differs card vs CPU"
    repeat = all((a is None and b is None) or np.array_equal(a, b) for (_, a), (_, b) in zip(g["traj"], g2["traj"]))
    pairs = [(a, b) for (_, a), (_, b) in zip(g["traj"], c["traj"]) if a is not None]
    rot = max(float(np.abs(a[:3, :3] - b[:3, :3]).max()) for a, b in pairs)
    centre = evaluate_ate_scaled(np.stack([np.linalg.inv(a) for a, _ in pairs]),
                                 np.stack([np.linalg.inv(b) for _, b in pairs]))
    # every landmark as it was on its last frame alive (a culled one included)
    lm_centre = max((float(np.linalg.norm(a[0] - b[0])) for a, b in zip(g["last"], c["last"])), default=0.0)
    lm_scale = max((float(np.abs(a[1] - b[1]).max()) for a, b in zip(g["last"], c["last"])), default=0.0)
    log(f"[objects-small] 24 frames 320x240, initialized on the CPU (frame {OBJECT_GATE_INIT}), then frames "
        f"{OBJECT_GATE_INIT + 1}-23 on the card (twice) and on the CPU: tracked {fg[0]}-{fg[-1]} ({len(fg)}) "
        f"on both; keyframes at frames {g['kf_frames']} on both; landmarks {len(g['lms'])} alive, "
        f"{len(g['last'])} promoted on both; mono_scale_initialized {g['msi']} on both; rotations within "
        f"{rot:.3g} (bound {TRACKER_ROT_TOL}), Sim3-aligned centres RMS {centre:.3g} (bound {TRACKER_CENTRE_TOL}); "
        f"landmarks on their last frame alive: centre {lm_centre:.4g} m apart (bound "
        f"{OBJECT_LANDMARK_CENTRE_TOL}), half-scale {lm_scale:.4g} m apart (bound {OBJECT_LANDMARK_SCALE_TOL}); "
        f"two card runs bit-identical: {repeat}; "
        f"a CPU copy repeats the CPU run bit for bit")
    for tag, r in (("card", g), ("CPU", c)):
        for ctr, sc in r["last"]:
            log(f"[objects-small] {tag} landmark on its last frame alive: centre {np.round(ctr, 4).tolist()}, "
                f"half-scale {np.round(sc, 4).tolist()}")
    assert rot <= TRACKER_ROT_TOL, f"rotations differ card vs CPU by {rot}"
    assert centre <= TRACKER_CENTRE_TOL, f"Sim3-aligned camera centres differ card vs CPU by {centre}"
    assert lm_centre <= OBJECT_LANDMARK_CENTRE_TOL, f"landmark centres differ card vs CPU by {lm_centre}"
    assert lm_scale <= OBJECT_LANDMARK_SCALE_TOL, f"landmark scales differ card vs CPU by {lm_scale}"


def loop_sequence(n=LOOP_FRAMES, wh=SLICE_WH):
    """Phase 10A's input: synth_sequence's scene and intrinsics along the
    there-and-back orbit of tests/test_full_system.py:43-46, whose cosine
    time warp takes the velocity smoothly through zero at the turnaround."""
    from cube_slam_tpu_torch.utils import synth

    seq = synth_sequence(n, wh)
    ss = 0.5 - 0.5 * np.cos(np.linspace(0.0, 2.0 * np.pi, n))
    seq.poses = synth.camera_path(n, kind="orbit", target=[0.0, 3.2, 0.6], s_values=ss)
    return seq


def loop_config(TrackerConfig):
    """Phase 10A's tracker configuration (either package's TrackerConfig):
    the phase-8 preset with loop closing, its global BA, and candidates 6
    keyframes apart (tests/test_full_system.py)."""
    return TrackerConfig(n_features=1500, n_levels=8, enable_loop_closing=True, loop_global_ba=True,
                         loop_min_gap_kfs=6)


def inject_loop_drift(trk):
    """The end-of-loop drift of tests/test_full_system.py:91-163, injected
    into an object tracker of either package after its run. The revisit is
    the keyframe sharing the most map points with a partner at least
    loop_min_gap_kfs database entries before it; later keyframes are
    dropped and the keyframe rotations projected onto SO(3). From the
    partner on, rank r carries the warp D^(r - rank(partner)): keyframes,
    map points by their earliest observing keyframe, the landmark by the
    keyframe it rides on. Observations across the drift, and every point of
    the revisit, are re-made as displaced duplicates. (The test's own
    injection, the last keyframe's early points only, leaves 16 duplicates
    on these maps, too few to verify, and the revisit covisible with its
    neighbours, which on this texture's flat signatures puts every
    candidate under the detector's floor; ROADMAP queue 3 has the rest.)
    Returns what the checks read."""
    from cube_slam_tpu_torch.utils import np_geometry as np_geo

    m = trk.map
    st = trk.objects.store
    assert st.valid.any(), "no landmark alive to ride the correction"
    o = int(np.where(st.valid)[0][np.argmax(st.n_obs[st.valid])])
    kfs = sorted((int(k) for k in m.kf_ids()), key=lambda k: int(m.kf_frame_id[k]))
    Ks = len(kfs)
    assert Ks >= 8, f"need a real keyframe chain, got {Ks}"
    rank = {k: i for i, k in enumerate(kfs)}
    order = trk.loop_detector._order
    C = m.covisibility_matrix()
    pairs = [(int(C[a, b]), a, b) for a in order for b in order
             if order[a] - order[b] >= trk.cfg.loop_min_gap_kfs and m.kf_valid[a] and m.kf_valid[b]]
    assert pairs, "no keyframe pair far enough apart in the database"
    shared, k_rev, partner = max(pairs)
    # the map as it stood at the revisit: later keyframes are dropped, so
    # the revisit is the newest keyframe, as in the test
    for k in kfs[kfs.index(k_rev) + 1:]:
        m.erase_kf(k)
        trk.loop_detector.remove(k)
    trk.ref_kf = k_rev
    kfs = kfs[: kfs.index(k_rev) + 1]
    # the tracker's keyframe rotations drift from orthonormal along a run (the
    # JAX package's too, ROADMAP queue 3), and the correction's rigid
    # inverses (R^T) assume SO(3): each is first projected back onto it
    for k in kfs:
        U, _, Vt = np.linalg.svd(m.kf_tcw[k][:3, :3].astype(np.float64))
        m.kf_tcw[k, :3, :3] = (U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt).astype(np.float32)
    final_pre = dict(trk.final_trajectory())
    Ks = len(kfs)
    rank = {k: i for i, k in enumerate(kfs)}
    tcw_pre = {k: m.kf_tcw[k].copy() for k in kfs}
    mp_pre = m.mp_pos.copy()
    obj_center_pre = st.pose[o][:3, 3].copy()
    # up to the partner the map is the reference side, so every pair the
    # loop can match relates the same two warps
    D = np_geo.se3_exp([0.0, 0.025, 0.0, 0.0625, 0.0, 0.025])
    W = [np.eye(4)] * (rank[partner] + 1)
    while len(W) <= Ks:
        W.append(W[-1] @ D)
    for k in kfs:
        m.kf_tcw[k] = (tcw_pre[k].astype(np.float64) @ np_geo.inv_T(W[rank[k]])).astype(np.float32)
    # map points ride the warp of their earliest observing keyframe
    kf_idx, _, mp_idx = m.observations_of(m.mp_ids())
    first_rank = np.full(m.max_mp, Ks, dtype=np.int64)
    np.minimum.at(first_rank, mp_idx, np.array([rank[int(k)] for k in kf_idx], dtype=np.int64))
    for mp in m.mp_ids():
        r = int(first_rank[mp]) if first_rank[mp] < Ks else rank.get(int(m.mp_first_kf[mp]), 0)
        m.mp_pos[mp] = (W[r][:3, :3] @ mp_pre[mp].astype(np.float64) + W[r][:3, 3]).astype(np.float32)
    # the landmark rides the keyframe that _on_loop_corrected anchors it to:
    # its latest measurement whose keyframe slot is alive (the test takes the
    # highest-ranked one, which a recycled slot can make another keyframe)
    anchor_kf = next(d.kf_id for d in reversed(trk.objects.meas[o]) if d.kf_id in rank)
    Wo = W[rank[anchor_kf]]
    st.pose[o] = (Wo @ st.pose[o].astype(np.float64)).astype(np.float32)
    # a drifted tracker keeps no association across the drift: observations
    # made from beyond the partner's successor of reference-side points are
    # re-made as displaced duplicates, one per point, at the warp of its
    # earliest drifted observer
    rp = rank[partner]
    kf_idx, kp_idx, mp_idx = m.observations_of(m.mp_ids())
    obs_rank = np.array([rank[int(k)] for k in kf_idx], dtype=np.int64)
    cross = (first_rank[mp_idx] <= rp) & (obs_rank > rp + 1)
    n_cross = 0
    for orig in np.unique(mp_idx[cross]):
        sel_o = cross & (mp_idx == orig)
        dup = m.alloc_mps(1)
        if len(dup) == 0:
            break
        Wd = W[int(obs_rank[sel_o].min())]
        _copy_point(m, int(orig), int(dup[0]), Wd, mp_pre, int(kf_idx[sel_o][0]))
        mp_pre[dup[0]] = mp_pre[orig]
        m.kf_kp_mp[kf_idx[sel_o], kp_idx[sel_o]] = dup[0]
        m.mp_nobs[dup[0]] = int(sel_o.sum())
        m.mp_nobs[orig] -= int(sel_o.sum())
        n_cross += 1
    # the revisit keyframe's structure, re-triangulated as displaced
    # duplicates: under real drift it shares no map point with the keyframes
    # before it (a covisible pair is not a loop, LoopClosing.cc:152-158)
    Wr = W[rank[k_rev]]
    kp_mp = m.kf_kp_mp[k_rev]
    sel = [j for j in np.where((kp_mp >= 0) & m.kf_kp_valid[k_rev])[0] if m.mp_valid[kp_mp[j]]]
    dups = m.alloc_mps(len(sel))
    for dup, j in zip(dups, sel):
        _copy_point(m, int(kp_mp[j]), int(dup), Wr, mp_pre, k_rev)
        m.mp_nobs[dup] = 1
        m.kf_kp_mp[k_rev, j] = dup

    def kf_ate():
        errs = [np.linalg.norm(np_geo.inv_T(m.kf_tcw[k].astype(np.float64))[:3, 3]
                               - np_geo.inv_T(tcw_pre[k].astype(np.float64))[:3, 3]) for k in kfs]
        return float(np.sqrt(np.mean(np.square(errs))))

    def obj_err():
        return float(np.linalg.norm(st.pose[o][:3, 3] - obj_center_pre))

    def traj_ate():
        """final_trajectory()'s camera centres against their pre-drift ones."""
        final = dict(trk.final_trajectory())
        errs = [np.linalg.norm(np_geo.inv_T(final[f].astype(np.float64))[:3, 3]
                               - np_geo.inv_T(T.astype(np.float64))[:3, 3])
                for f, T in final_pre.items() if T is not None]
        return float(np.sqrt(np.mean(np.square(errs))))

    return dict(k_rev=k_rev, partner=partner, shared=shared, kfs=kfs, o=o, anchor=anchor_kf, n_dups=len(dups),
                n_cross=n_cross, kf_ate=kf_ate, obj_err=obj_err, traj_ate=traj_ate, ate_drifted=kf_ate(),
                obj_err_drifted=obj_err(), traj_ate_drifted=traj_ate())


def _copy_point(m, orig, dup, W, mp_pre, first_kf):
    """Map point `dup` as a duplicate of `orig`: its pre-drift position under
    the warp W, its descriptor and viewing geometry, first seen by first_kf."""
    m.mp_pos[dup] = (W[:3, :3] @ mp_pre[orig].astype(np.float64) + W[:3, 3]).astype(np.float32)
    m.mp_desc[dup] = m.mp_desc[orig]
    m.mp_valid[dup] = True
    m.mp_first_kf[dup] = first_kf
    m.mp_normal[dup] = m.mp_normal[orig]
    m.mp_min_dist[dup] = m.mp_min_dist[orig]
    m.mp_max_dist[dup] = m.mp_max_dist[orig]


def _spans(names):
    from cube_slam_tpu_torch.utils import profiler

    spans = profiler.aggregated()
    return "; ".join(f"{k} {spans[k][0]:.1f}/{spans[k][4]}" for k in names if k in spans)


LOOP_SPANS = ("loop.detect", "loop.verify", "loop.correct", "loop.fuse", "loop.gba")


class LoopClosures:
    """Each loop the tracker closes: the verification that passed and the
    correction it drove, recorded around the two functions of `lc` (the
    port's slam/loop_closing unless another package's is given)."""

    def __init__(self, trk, lc=None):
        if lc is None:
            from cube_slam_tpu_torch.slam import loop_closing as lc

        self.lc, self.trk, self.rows, self._ver = lc, trk, [], {}
        self.verify, self.correct = lc.verify_loop_sim3, lc.correct_loop

    def _verify(self, m, a, b, **k):
        self._ver[(a, b)] = out = self.verify(m, a, b, **k)
        return out

    def _correct(self, m, loop_kf, matched_kf, sim3_correction, **k):
        self.rows.append(dict(frame=self.trk.frame_id, pair=(int(matched_kf), int(loop_kf)),
                              frames=(int(m.kf_frame_id[matched_kf]), int(m.kf_frame_id[loop_kf])),
                              inliers=self._ver[(loop_kf, matched_kf)][3], scale=float(sim3_correction[0])))
        return self.correct(m, loop_kf, matched_kf, sim3_correction, **k)

    def __enter__(self):
        self.lc.verify_loop_sim3, self.lc.correct_loop = self._verify, self._correct
        return self

    def __exit__(self, *exc):
        self.lc.verify_loop_sim3, self.lc.correct_loop = self.verify, self.correct


def phase10a_loop_run(dev):
    """Everything on over the 61-frame orbit. Returns the tracker and its EDT
    launches."""
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.slam.system import ObjectSlamTracker, TrackerConfig
    from cube_slam_tpu_torch.utils import profiler

    seq = loop_sequence()
    N = seq.num_frames
    inputs = _object_frames(seq, dev)  # lines before the clock
    truth = [seq.truth_Twc(f) for f in range(N)]
    trk = ObjectSlamTracker(seq.K, seq.wh, loop_config(TrackerConfig), ground_Twc0=seq.truth_Twc(0), device=dev)
    det = trk.objects.detector
    calls = [0]
    detect = det.detect_cuboid

    def counted(*a, **k):
        calls[0] += 1
        return detect(*a, **k)

    det.detect_cuboid = counted
    profiler.reset()
    profiler.enable()
    promoted = set()
    try:
        with LoopClosures(trk) as closures:
            hk.edt_launches = 0
            ms, kind, traj, wall = drive(trk, inputs, after_frame=_promoted_into(trk, promoted))
            launches = hk.edt_launches
        spans_a = _spans(LOOP_SPANS + ("obj.detect", "obj.associate", "obj.ba", "kf.total"))
    finally:
        profiler.disable()
        profiler.reset()

    tracked = [fid for fid, T in traj if T is not None]
    ate = _scaled_ate(traj, truth)
    lms = _landmarks(trk, seq.scene)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    log(f"[loop] {N} frames {seq.wh[0]}x{seq.wh[1]} there and back, 1500 features x 8 levels, loop closing "
        f"on (global BA, min gap 6 keyframes), truth box, port LSD lines: initialized at frame "
        f"{kind.index('init') if 'init' in kind else None}; tracked {len(tracked)}/{N}; keyframes "
        f"{int(trk.map.kf_valid.sum())}; map points {int(trk.map.mp_valid.sum())}; landmarks {len(lms)} alive, "
        f"{len(promoted)} promoted; mono_scale_initialized {trk.mono_scale_initialized}; loops closed "
        f"{trk.loops_closed}; scaled ATE {ate:.4f} m (final trajectory)")
    for c in closures.rows:
        log(f"[loop] closed at frame {c['frame']}: keyframes {c['pair'][0]} (frame {c['frames'][0]}) <- "
            f"{c['pair'][1]} (frame {c['frames'][1]}), {c['inliers']} Sim3 inliers, scale {c['scale']:.4f}")
    for o, c, sc, err, cerr in lms:
        log(f"[loop] landmark {o}: centre {np.round(c, 4).tolist()} ({cerr:.4f} m off the true box), half-scale "
            f"{np.round(sc, 4).tolist()}; min_log_error norm {err:.4f}")
    log(f"[loop] {N / wall:.3f} frames/s of track() ({wall:.2f} s, host clock, synchronized per frame); "
        f"tracked non-keyframe frames: median {med('tracked'):.2f} ms ({kind.count('tracked')}); keyframe "
        f"frames: median {med('kf'):.2f} ms ({kind.count('kf')}); untracked frames {kind.count('lost')}")
    log(f"[loop] split (total ms / calls): {spans_a}")
    m = trk.map
    ortho = [float(np.abs(m.kf_tcw[k][:3, :3].T @ m.kf_tcw[k][:3, :3] - np.eye(3)).max()) for k in m.kf_ids()]
    log(f"[loop] keyframe rotations' largest |R^T R - I|: {max(ortho):.3g} (the tracker's poses drift from "
        f"orthonormal along the run, as the JAX package's do)")
    log(f"[loop] EDT launches on the loop-closing object tracker path: {launches} for {calls[0]} detector calls")
    assert len(tracked) >= TRACKER_MIN_TRACKED * N, f"tracked only {len(tracked)}/{N}"
    assert np.isfinite(ate), f"scaled ATE {ate}"
    assert promoted, "no landmark promoted"
    assert launches > 0 and launches == calls[0], f"{launches} EDT launches for {calls[0]} detector calls"
    return trk, launches


def phase10b_injected_loop(trk):
    """The injected end-of-loop drift on phase 10A's live map, closed by
    _try_close_loop on the revisit keyframe."""
    from cube_slam_tpu_torch.utils import np_geometry as np_geo
    from cube_slam_tpu_torch.utils import profiler, serialization

    inj = inject_loop_drift(trk)
    k_rev = inj["k_rev"]
    loops_before = trk.loops_closed
    trk.frame_id += 1
    trk.last_Tcw = trk.map.kf_tcw[k_rev].copy()
    reanchor = trk._on_loop_corrected
    obj_steps = []

    def reanchor_kept(corrections):
        reanchor(corrections)
        obj_steps.append(inj["obj_err"]())

    trk._on_loop_corrected = reanchor_kept
    profiler.reset()
    profiler.enable()
    try:
        with LoopClosures(trk) as closures:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trk._try_close_loop(k_rev, trk.map.covisibility_counts(k_rev))
            torch.cuda.synchronize()
            close_ms = 1e3 * (time.perf_counter() - t0)
        spans_b = _spans(LOOP_SPANS)
    finally:
        profiler.disable()
        profiler.reset()
    ate_closed, obj_closed, traj_closed = inj["kf_ate"](), inj["obj_err"](), inj["traj_ate"]()
    final = dict(trk.final_trajectory())
    stamps = sorted(f for f, T in final.items() if T is not None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trajectory_tum.txt")
        serialization.save_trajectory_tum(path, np.asarray(stamps, dtype=np.float64), [final[f] for f in stamps])
        rows = np.loadtxt(path, ndmin=2)
    # the writer inverts each pose as a rigid transform (R^T, -R^T t); the
    # tracker's rotations drift from orthonormal (ROADMAP queue 3), so
    # np.linalg.inv would read another centre
    centres = np.stack([np_geo.inv_T(final[f].astype(np.float64))[:3, 3] for f in stamps])
    gap = float(np.abs(rows[:, 1:4] - centres).max())
    c = closures.rows[0] if closures.rows else None
    log(f"[loop-drift] {len(inj['kfs'])} keyframes warped by D^rank; the revisit keyframe {k_rev} (frame "
        f"{int(trk.map.kf_frame_id[k_rev])}) shared {inj['shared']} points with keyframe {inj['partner']} (frame "
        f"{int(trk.map.kf_frame_id[inj['partner']])}), its {inj['n_dups']} points made duplicates, and "
        f"{inj['n_cross']} cross-drift duplicates; _try_close_loop on it: loops closed {loops_before} -> "
        f"{trk.loops_closed}"
        + (f", keyframes {c['pair'][0]} <- {c['pair'][1]}, {c['inliers']} Sim3 inliers, scale {c['scale']:.4f}"
           if c is not None else "")
        + f"; keyframe ATE {inj['ate_drifted']:.4f} -> {ate_closed:.4f} m (x{ate_closed / inj['ate_drifted']:.3f}); "
        f"landmark {inj['o']} (anchored to keyframe {inj['anchor']}) drift error {inj['obj_err_drifted']:.4f} -> "
        f"{obj_closed:.4f} m (x{obj_closed / inj['obj_err_drifted']:.3f}; "
        f"{' -> '.join(f'{e:.4f}' for e in obj_steps)} after each re-anchoring); final trajectory against its "
        f"pre-drift self {inj['traj_ate_drifted']:.4f} -> {traj_closed:.4f} m (RMS); {close_ms:.1f} ms (host "
        f"clock); split {spans_b}")
    log(f"[loop-drift] save_trajectory_tum wrote {rows.shape[0]} poses to a temporary file; read back, their "
        f"centres are within {gap:.2g} m of final_trajectory()'s")
    assert trk.loops_closed > loops_before, "the injected loop did not close"
    assert ate_closed < inj["ate_drifted"], (inj["ate_drifted"], ate_closed)
    assert obj_closed < inj["obj_err_drifted"], (inj["obj_err_drifted"], obj_closed)
    assert traj_closed < inj["traj_ate_drifted"], (inj["traj_ate_drifted"], traj_closed)
    assert rows.shape[0] == len(stamps) and gap < 1e-5, gap


def phase10c_loop_card_vs_cpu(dev):
    """The constructed drifted loop through MonocularTracker._try_close_loop
    on the card twice and on the CPU, each map kept as it stood before the
    global BA."""
    from cube_slam_tpu_torch.slam.system import MonocularTracker, TrackerConfig
    from cube_slam_tpu_torch.utils import synth

    cfg = TrackerConfig(loop_min_gap_kfs=10, loop_covis_theta=30, loop_global_ba=True, max_kf=16, max_mp=2048)
    fields = ("kf_kp_mp", "mp_nobs", "mp_valid", "kf_tcw", "mp_pos")
    runs = []
    for device in (dev, dev, "cpu"):
        trk = MonocularTracker(synth.DRIFTED_LOOP_K, (640, 480), cfg, device=device)
        true_tcw, est_tcw, _ = synth.build_drifted_loop(trk)
        pre, gba = {}, trk.global_ba

        def kept(trk=trk, pre=pre, gba=gba):
            pre.update({f: getattr(trk.map, f).copy() for f in fields})
            gba()

        trk.global_ba = kept
        trk.frame_id = synth.DRIFTED_LOOP_N_KF
        k = synth.DRIFTED_LOOP_N_KF - 1
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        trk._try_close_loop(k, trk.map.covisibility_counts(k))
        if device != "cpu":
            torch.cuda.synchronize()
        runs.append(dict(edges=list(trk.loop_edges), pre=pre, post={f: getattr(trk.map, f).copy() for f in fields},
                         ms=1e3 * (time.perf_counter() - t0)))
    g, g2, c = runs

    def kf_ate(tcw):
        return float(np.sqrt(np.mean([np.sum((np.linalg.inv(tcw[i].astype(np.float64))[:3, 3]
                                              - np.linalg.inv(true_tcw[i].astype(np.float64))[:3, 3]) ** 2)
                                      for i in range(len(true_tcw))])))

    repeat = all(np.array_equal(g["post"][f], g2["post"][f]) for f in fields)
    gap_pre = float(np.abs(g["pre"]["kf_tcw"] - c["pre"]["kf_tcw"]).max())
    gap_post = float(np.abs(g["post"]["kf_tcw"] - c["post"]["kf_tcw"]).max())
    same_fused = np.array_equal(g["pre"]["kf_kp_mp"], c["pre"]["kf_kp_mp"])
    log(f"[loop-small] constructed 14-keyframe drifted loop: loop edges card {g['edges']}, CPU {c['edges']}; "
        f"before the global BA: fused associations equal card vs CPU {same_fused}, keyframe poses within "
        f"{gap_pre:.3g} (bound {LOOP_POSE_TOL}); after it: poses within {gap_post:.3g}, associations equal "
        f"{np.array_equal(g['post']['kf_kp_mp'], c['post']['kf_kp_mp'])}; keyframe ATE against the truth "
        f"{kf_ate(est_tcw):.4f} drifted, {kf_ate(g['post']['kf_tcw']):.4f} card, {kf_ate(c['post']['kf_tcw']):.4f} "
        f"CPU; _try_close_loop {g['ms']:.1f} / {g2['ms']:.1f} ms card, {c['ms']:.1f} ms CPU (host clock); two card "
        f"runs bit-identical: {repeat}")
    assert g["edges"] == c["edges"] == [(0, synth.DRIFTED_LOOP_N_KF - 1)], (g["edges"], c["edges"])
    assert same_fused, "the fused associations differ card vs CPU"
    assert gap_pre <= LOOP_POSE_TOL, f"corrected keyframe poses differ card vs CPU by {gap_pre}"
    assert repeat, "two card runs of the loop path differ"


# ---------------------------------------------------------------------------
# phase 11: the depth inputs
# ---------------------------------------------------------------------------

def rgbd_sequence(frames=SLICE_FRAMES):
    """((gray, depth) per frame, truth Twc, K) of phase 6's orbit, grey
    levels rounded as phase 6's frames are: 11A's and 14's inputs."""
    seq = synth_sequence(frames, SLICE_WH)
    rgbd = []
    for f in range(frames):
        img, depth = seq.scene.render(seq.poses[f], seq.K, wh=seq.wh, return_depth=True)
        rgbd.append((np.round(img).astype(np.float32), depth))
    return rgbd, seq.poses, seq.K


def depth_sequences(rgbd_frames=SLICE_FRAMES, stereo_frames=STEREO_FRAMES):
    """11A's and 11B's inputs: rgbd_sequence(), and ((left, right) per
    frame, truth Twc, K) of the stereo orbit, rounded alike."""
    from cube_slam_tpu_torch.utils import synth

    sseq = synth.SynthSequence(stereo_frames, K=KITTI_K, wh=KITTI_WH)
    stereo = []
    for Twc_l in sseq.poses:
        Twc_r = Twc_l.copy()
        Twc_r[:3, 3] = Twc_l[:3, 3] + Twc_l[:3, :3] @ np.array([KITTI_BASELINE, 0.0, 0.0])
        stereo.append(tuple(np.round(sseq.scene.render(T, sseq.K, wh=sseq.wh)).astype(np.float32)
                            for T in (Twc_l, Twc_r)))
    return rgbd_sequence(rgbd_frames), (stereo, sseq.poses, sseq.K)


def metric_ate(traj, truth):
    """Unaligned metric ATE (m): the estimated camera centres in the world of
    the first tracked frame, mapped by that frame's truth pose
    (tests/test_rgbd_stereo.py:35-38)."""
    est = [(f, np.linalg.inv(T.astype(np.float64))) for f, T in traj if T is not None]
    if not est:
        return float("nan")
    G = truth[est[0][0]]
    d = np.stack([(G @ T)[:3, 3] - truth[f][:3, 3] for f, T in est])
    return float(np.sqrt((d * d).sum(axis=1).mean()))


def _depth_run(trk, inputs, truth, tag):
    """Drive a depth tracker over `inputs` on the card; print what 11A and
    11B print and return (tracked frames, ATE)."""
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.utils import profiler

    N = len(inputs)
    ratio_calls, transfers = [0], [0]
    ratio = trk._kf_map_ratio

    def counted(feats):
        # host reads the ratio makes: the packed features and the associations
        if feats is not None and trk._pending_depth is not None:
            ratio_calls[0] += 1
            transfers[0] += int(feats._xy is None) + int(feats._mp is None and feats._mp_dev is not None)
        return ratio(feats)

    trk._kf_map_ratio = counted
    profiler.reset()
    profiler.enable()
    try:
        hk.edt_launches = 0
        ms, kind, traj, wall = drive(trk, inputs)
        launches = hk.edt_launches
        spans = profiler.aggregated()
    finally:
        profiler.disable()
        profiler.reset()
        trk._kf_map_ratio = ratio
    tracked = [f for f, T in traj if T is not None]
    ate, ate_tracked = metric_ate(traj, truth), metric_ate(trk.trajectory, truth)
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    log(f"[{tag}] initialized at frame {kind.index('init') if 'init' in kind else None}; tracked "
        f"{len(tracked)}/{N}; keyframes {int(trk.map.kf_valid.sum())}; map points {int(trk.map.mp_valid.sum())}; "
        f"unaligned metric ATE {ate:.4f} m (final trajectory), {ate_tracked:.4f} m (as tracked); loops closed "
        f"{trk.loops_closed}")
    log(f"[{tag}] {N / wall:.3f} frames/s of track() ({wall:.2f} s, host clock, synchronized per frame); "
        f"tracked non-keyframe frames: median {med('tracked'):.2f} ms ({kind.count('tracked')}); keyframe "
        f"frames: median {med('kf'):.2f} ms ({kind.count('kf')}); untracked frames {kind.count('lost')}")
    names = sorted(k for k in spans if k.startswith("kf.")) + ["ba.fold", "track.dispatch", "track.result_read"]
    log(f"[{tag}] split (total ms / calls): " + "; ".join(
        f"{k} {spans[k][0]:.1f}/{spans[k][4]}" for k in names if k in spans))
    log(f"[{tag}] host transfers made by _kf_map_ratio: {transfers[0]} in {ratio_calls[0]} calls "
        f"({transfers[0] / max(ratio_calls[0], 1):.2f} per tracked frame: the packed features and the "
        f"associations after the final pose step)")
    log(f"[{tag}] EDT launches: {launches} (the depth trackers detect no cuboids)")
    assert launches == 0
    return tracked, ate


def phase11a_rgbd(dev, rgbd):
    from cube_slam_tpu_torch.slam.system import RgbdTracker, TrackerConfig

    frames, truth, K = rgbd
    H, W = frames[0][0].shape
    # the repo's TUM preset (cube_slam_tpu/config.py: 1500 features x 8
    # levels; max_kf 96, max_mp 12,288); loop closing at its default (on)
    cfg = TrackerConfig(n_features=1500, n_levels=8, max_kf=96, max_mp=12288)
    trk = RgbdTracker(K, (W, H), cfg, depth_max=RGBD_DEPTH_MAX, device=dev)
    log(f"[rgbd] {len(frames)} frames {W}x{H}, TUM intrinsics, 1500 features x 8 levels, depth_max "
        f"{RGBD_DEPTH_MAX} m, rendered depth")
    tracked, ate = _depth_run(trk, frames, truth, "rgbd")
    assert len(tracked) >= DEPTH_MIN_TRACKED * len(frames), f"tracked only {len(tracked)}/{len(frames)}"
    assert np.isfinite(ate) and ate < RGBD_ATE_MAX, f"metric ATE {ate}"


def phase11b_stereo(dev, stereo):
    from cube_slam_tpu_torch.ops import stereo as stereo_ops
    from cube_slam_tpu_torch.slam.system import StereoTracker, TrackerConfig

    frames, truth, K = stereo
    H, W = frames[0][0].shape
    # KITTI 00-02 (cube_slam_tpu/config.py kitti_config: 3000 features x 8
    # levels), the KITTI stereo baseline and depth range
    cfg = TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = StereoTracker(K, (W, H), KITTI_BASELINE, cfg, depth_max=STEREO_DEPTH_MAX, device=dev)
    log(f"[stereo] {len(frames)} frame pairs {W}x{H}, KITTI intrinsics, baseline {KITTI_BASELINE} m, 3000 "
        f"features x 8 levels, depth_max {STEREO_DEPTH_MAX} m")
    match = stereo_ops.stereo_match_keypoints
    calls = []

    def timed_match(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = match(*a, **k)
        e1.record()
        calls.append((e0, e1, out[2]))
        return out

    stereo_ops.stereo_match_keypoints = timed_match
    try:
        tracked, ate = _depth_run(trk, frames, truth, "stereo")
    finally:
        stereo_ops.stereo_match_keypoints = match
    torch.cuda.synchronize()
    ms = [e0.elapsed_time(e1) for e0, e1, _ in calls]
    n = [int(m.sum()) for _, _, m in calls]
    log(f"[stereo] stereo_match_keypoints: median {statistics.median(ms):.3f} ms per frame (CUDA events, "
        f"min {min(ms):.3f}, max {max(ms):.3f}); matched keypoints per frame: median "
        f"{statistics.median(n)}, min {min(n)}, max {max(n)}")
    assert len(calls) == len(frames)
    assert len(tracked) >= DEPTH_MIN_TRACKED * len(frames), f"tracked only {len(tracked)}/{len(frames)}"
    assert np.isfinite(ate) and ate < STEREO_ATE_MAX, f"metric ATE {ate}"


def _depth_gate(cls, device, frames, **kw):
    """One of tests/test_rgbd_stereo.py's gates through the port's `cls` on
    `device`, its local-BA fold forced synchronous."""
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    cfg = TrackerConfig(n_features=600, n_levels=3, max_kf=24, max_mp=4096, min_inliers_local=15)
    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
    trk = _always_fold(cls)(K, (320, 240), config=cfg, device=device, **kw)
    for pair in frames:
        trk.track(*pair)
    return trk.trajectory, sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids())


def phase11c_depth_card_vs_cpu(dev):
    from cube_slam_tpu_torch.slam.system import RgbdTracker, StereoTracker
    from cube_slam_tpu_torch.utils import synth

    scene = synth.RoomScene(seed=3)
    K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
    poses = synth.camera_path(40)[:10]
    rgbd = [scene.render(P, K, wh=(320, 240), return_depth=True) for P in poses]
    scene = synth.RoomScene(seed=4)
    stereo = []
    for Twc_l in synth.camera_path(40)[:8]:
        Twc_r = Twc_l.copy()
        Twc_r[:3, 3] = Twc_l[:3, 3] + Twc_l[:3, :3] @ np.array([0.12, 0.0, 0.0])
        stereo.append((scene.render(Twc_l, K, wh=(320, 240)), scene.render(Twc_r, K, wh=(320, 240))))
    for name, cls, frames, kw in (("rgbd", RgbdTracker, rgbd, dict(depth_max=12.0)),
                                  ("stereo", StereoTracker, stereo, dict(baseline=0.12, depth_max=15.0))):
        (tg, kg), (tg2, kg2), (tc, kc) = (_depth_gate(cls, d, frames, **kw) for d in (dev, dev, "cpu"))
        fg = [f for f, T in tg if T is not None]
        fc = [f for f, T in tc if T is not None]
        assert fg == fc, f"{name}: tracked frames differ: card {fg}, CPU {fc}"
        assert kg == kc, f"{name}: keyframe frames differ: card {kg}, CPU {kc}"
        gap = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(tg, tc) if a is not None)
        repeat = kg == kg2 and all((a is None and b is None) or np.array_equal(a, b)
                                   for (_, a), (_, b) in zip(tg, tg2))
        log(f"[depth-small] {name}, {len(frames)} frames 320x240 on the card and on the CPU: tracked "
            f"{fg[0]}-{fg[-1]} ({len(fg)}) and keyframes at frames {kg} on both; poses within {gap:.3g} "
            f"(bound {DEPTH_POSE_TOL}); two card runs bit-identical: {repeat}")
        assert gap <= DEPTH_POSE_TOL, f"{name}: poses differ card vs CPU by {gap}"
        assert repeat, f"{name}: two card runs differ"


# ---------------------------------------------------------------------------
# phase 12: the KITTI trackers
# ---------------------------------------------------------------------------

KITTI_SPANS = ("obj.ingest", "obj.associate", "obj.ba", "kitti.anchor", "kitti.ground", "kf.total")


def kitti_rows(scene, poses, K, wh, half, tid):
    """Per frame the 13-column offline cuboid row [centre(3) yaw
    half-scale(3) x y w h prob tid] of the scene's box in the local ground
    frame of the first pose (the camera-to-ground mount held constant), or
    an empty (0, 13) array where the box is out of view
    (tests/test_kitti_mode.py:46-60)."""
    T_obj, _ = scene.box_pose_scale()
    rows = []
    for P in poses:
        bbox = scene.box_bbox_2d(P, K, wh=wh)
        if bbox is None:
            rows.append(np.zeros((0, 13)))
            continue
        pose_lg = poses[0] @ (np.linalg.inv(P) @ T_obj)
        yaw = float(np.arctan2(pose_lg[1, 0], pose_lg[0, 0]))
        rows.append(np.array([[pose_lg[0, 3], pose_lg[1, 3], pose_lg[2, 3], yaw, half[0], half[1], half[2],
                               bbox[0], bbox[1], bbox[2], bbox[3], 0.9, float(tid)]]))
    return rows


def first_frame_ate(traj, truth):
    """Unaligned metric ATE (m) with the worlds aligned on the first tracked
    frame only: G = truth Twc of that frame times its estimated Tcw, scale 1
    (tests/test_kitti_mode.py:23-34). Returns (ATE, G)."""
    est = [(f, np.asarray(T, dtype=np.float64)) for f, T in traj if T is not None]
    if len(est) < 2:
        return float("nan"), np.eye(4)
    G = truth[est[0][0]] @ est[0][1]
    d = [(G @ np.linalg.inv(T))[:3, 3] - truth[f][:3, 3] for f, T in est[1:]]
    return float(np.sqrt(np.mean(np.sum(np.square(d), axis=1)))), G


def kitti_inputs(stereo):
    """12A's and 12B's inputs from phase 11B's pairs: the scene and poses of
    that orbit (SynthSequence renders lazily, so nothing is rendered again)
    and the box's offline rows at KITTI's camera."""
    from cube_slam_tpu_torch.utils import synth

    frames, truth, K = stereo
    sseq = synth.SynthSequence(len(frames), K=KITTI_K, wh=KITTI_WH)
    assert np.array_equal(sseq.poses, truth)
    _, half = sseq.scene.box_pose_scale()
    return frames, truth, K, sseq.scene, half, kitti_rows(sseq.scene, truth, K, KITTI_WH, half, 1)


def _kitti_run(trk, inputs, truth, scene, tag):
    """Drive a KITTI tracker over `inputs` on the card; print its outcome,
    speed and spans, and return (tracked frames, metric ATE, G)."""
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.utils import profiler

    N = len(inputs)
    profiler.reset()
    profiler.enable()
    try:
        hk.edt_launches = 0
        ms, kind, traj, wall = drive(trk, inputs)
        launches = hk.edt_launches
        spans = profiler.aggregated()
    finally:
        profiler.disable()
        profiler.reset()
    tracked = [f for f, T in traj if T is not None]
    ate, G = first_frame_ate(traj, truth)
    n_kf = int(trk.map.kf_valid.sum())
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    log(f"[{tag}] initialized at frame {kind.index('init') if 'init' in kind else None}; tracked "
        f"{len(tracked)}/{N}; keyframes {n_kf}; map points {int(trk.map.mp_valid.sum())}; unaligned metric ATE "
        f"{ate:.4f} m (final trajectory, aligned on the first tracked frame), similarity-aligned ATE "
        f"{_scaled_ate(traj, truth):.4f} m; loops closed {trk.loops_closed}")
    box_T, _ = scene.box_pose_scale()
    st = trk.objects.store
    for o in np.where(st.valid)[0]:
        c = (G @ np.append(st.pose[o][:3, 3].astype(np.float64), 1.0))[:3]
        log(f"[{tag}] landmark {o}: centre {np.linalg.norm(c - box_T[:3, 3]):.4f} m from the true box "
            f"(aligned world), half-scale {np.round(st.scale[o], 4).tolist()} against the prior "
            f"{np.round(trk.car_prior, 4).tolist()}")
    log(f"[{tag}] {N / wall:.3f} frames/s of track() ({wall:.2f} s, host clock, synchronized per frame); "
        f"tracked non-keyframe frames: median {med('tracked'):.2f} ms ({kind.count('tracked')}); keyframe "
        f"frames: median {med('kf'):.2f} ms ({kind.count('kf')}); untracked frames {kind.count('lost')}")
    log(f"[{tag}] spans (total ms / calls, ms per keyframe frame): " + "; ".join(
        f"{k} {spans[k][0]:.1f}/{spans[k][4]}, {spans[k][0] / max(kind.count('kf'), 1):.1f}"
        for k in KITTI_SPANS if k in spans))
    log(f"[{tag}] EDT launches: {launches} (offline cuboids: no detector runs)")
    assert launches == 0
    return tracked, ate


def phase12a_kitti_mono(dev, kitti):
    from cube_slam_tpu_torch.slam.ground import GroundConfig
    from cube_slam_tpu_torch.slam.kitti import KittiMonoTracker
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    frames, truth, K, scene, half, rows = kitti
    H, W = frames[0][0].shape
    # KITTI 00-02 (cube_slam_tpu/config.py kitti_config: 3000 features x 8
    # levels); loop closing at its default (on); ground recovery as in
    # tests/test_kitti_mode.py:71-72, the nominal height the mount's
    cfg = TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    ground = GroundConfig(nominal_height=float(abs(truth[0][2, 3])), every_kfs=3, min_points=12, inlier_thresh=0.03)
    trk = KittiMonoTracker(K, (W, H), rows, truth[0], config=cfg, car_prior=half, ground_cfg=ground,
                           firstframe_depth_init=KITTI_MONO_OBJECT_BOOTSTRAP, device=dev)
    log(f"[kitti-mono] {len(frames)} left frames {W}x{H} of phase 11B, KITTI intrinsics, 3000 features x 8 "
        f"levels, offline rows of the box (tracklet 1), car prior = the box's half extents "
        f"{np.round(half, 4).tolist()}, ground recovery every 3 keyframes at nominal height "
        f"{ground.nominal_height:.3f} m; object-depth bootstrap: {KITTI_MONO_OBJECT_BOOTSTRAP}")
    tracked, ate = _kitti_run(trk, [(left,) for left, _ in frames], truth, scene, "kitti-mono")
    log(f"[kitti-mono] mono_scale_initialized {trk.mono_scale_initialized}; anchor scales applied "
        f"{[round(s, 6) for s in trk._anchor_scales]}; ground recoveries {trk.n_scale_recoveries}")
    assert len(tracked) >= TRACKER_MIN_TRACKED * len(frames), f"tracked only {len(tracked)}/{len(frames)}"
    assert trk.mono_scale_initialized, "the object-depth anchor never made the map metric"
    assert np.isfinite(ate), f"metric ATE {ate}"


def phase12b_kitti_stereo(dev, kitti):
    from cube_slam_tpu_torch.slam.kitti import KittiStereoTracker
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    frames, truth, K, scene, half, rows = kitti
    H, W = frames[0][0].shape
    cfg = TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = KittiStereoTracker(K, (W, H), KITTI_BASELINE, rows, truth[0], config=cfg, car_prior=half,
                             depth_max=STEREO_DEPTH_MAX, device=dev)
    log(f"[kitti-stereo] {len(frames)} pairs {W}x{H} of phase 11B, baseline {KITTI_BASELINE} m, 3000 features x 8 "
        f"levels, depth_max {STEREO_DEPTH_MAX} m, 12A's offline rows and car prior")
    tracked, ate = _kitti_run(trk, frames, truth, scene, "kitti-stereo")
    assert len(tracked) >= DEPTH_MIN_TRACKED * len(frames), f"tracked only {len(tracked)}/{len(frames)}"
    assert np.isfinite(ate) and ate < STEREO_ATE_MAX, f"metric ATE {ate}"
    assert trk.objects.store.valid.any(), "no object landmark"


def kitti_grey(img):
    """A render as the uint8 grey levels a KITTI folder's PNGs hold, back in
    float32."""
    return np.clip(np.round(img), 0, 255).astype(np.uint8).astype(np.float32)


class MemoryKittiSequence:
    """A KittiSequence held in memory (the card's machine may lack PIL):
    `num_frames`, `K`, `times`, `gray`, `gray_right`, `offline_cuboids`.
    Frames are rounded to the uint8 grey levels a KITTI folder's PNGs hold."""

    def __init__(self, left, K, rows, right=None):
        self.num_frames, self.K, self.times = len(left), K, 0.1 * np.arange(len(left))
        self._left = [kitti_grey(g) for g in left]
        self._right = None if right is None else [kitti_grey(g) for g in right]
        self._rows = rows

    def gray(self, i):
        return self._left[i]

    def gray_right(self, i):
        return self._right[i]

    def offline_cuboids(self, use_truth_trackid=False):
        return self._rows


def kitti_gate_scene(name):
    """A KITTI gate at 320x240: (left renders, right renders or None, truth
    Twc, offline rows, scene). "mono": tests/test_kitti_mode.py:37's 14
    frames (RoomScene seed 2, tracklet 7); "stereo":
    tests/test_rgbd_stereo.py:71's 10 pairs (seed 5, tracklet 4, the right
    camera KITTI_GATE_BASELINE along the left one's x). The box at (-0.8,
    3.8, 0.8) with half extents KITTI_GATE_HALF is the offline cuboid."""
    from cube_slam_tpu_torch.utils import synth

    seed, n, tid = (2, 14, 7) if name == "mono" else (5, 10, 4)
    scene = synth.RoomScene(seed=seed, box_center=[-0.8, 3.8, 0.8], box_half=KITTI_GATE_HALF)
    poses = synth.camera_path(40)[:n]
    left = [scene.render(P, KITTI_GATE_K, wh=KITTI_GATE_WH) for P in poses]
    right = None
    if name == "stereo":
        right = []
        for P in poses:
            Pr = P.copy()
            Pr[:3, 3] = P[:3, 3] + P[:3, :3] @ np.array([KITTI_GATE_BASELINE, 0.0, 0.0])
            right.append(scene.render(Pr, KITTI_GATE_K, wh=KITTI_GATE_WH))
    return left, right, poses, kitti_rows(scene, poses, KITTI_GATE_K, KITTI_GATE_WH, KITTI_GATE_HALF, tid), scene


def kitti_gate_kwargs(system, ground, name):
    """The tracker (and ground) configuration the gate of `name` hands a
    KITTI entry point, from either package's system and ground modules."""
    if name == "stereo":
        return dict(config=system.TrackerConfig(**KITTI_GATE_STEREO))
    return dict(config=system.TrackerConfig(**KITTI_GATE_MONO), ground_cfg=ground.GroundConfig(**KITTI_GATE_GROUND))


def object_bootstrap(cls):
    """`cls` (either package's KittiMonoTracker) bootstrapping its map from
    the first frame's object depth whatever its caller asks: two-view
    initialization never succeeds on the mono gate's scene here, in either
    package (tests/test_kitti_mode.py fails with nothing tracked)."""

    class ObjectBootstrap(cls):
        def __init__(self, *a, **k):
            k["firstframe_depth_init"] = True
            super().__init__(*a, **k)

    return ObjectBootstrap


def kitti_file_gaps(a, b):
    """The largest differences between two runs' written files (dicts of
    the TUM, KITTI and cuboid files' arrays, which must hold the same rows):
    camera centres (TUM x y z), rotation entries (the KITTI rows' R of Twc),
    and the landmark's centre, yaw and half-scale (the cuboid file's x y z,
    yaw, l w h). Yaw is compared modulo pi, the turn that maps a cuboid onto
    itself."""
    for ext in a:
        assert a[ext].shape == b[ext].shape, f"the {ext} files have other rows"
    assert np.array_equal(a["tum"][:, 0], b["tum"][:, 0]) and np.array_equal(a["cuboids"][:, 0], b["cuboids"][:, 0])
    rot = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    ca, cb = a["cuboids"], b["cuboids"]
    return dict(centre=float(np.linalg.norm(a["tum"][:, 1:4] - b["tum"][:, 1:4], axis=1).max()),
                rotation=float(np.abs(a["kitti"][:, rot] - b["kitti"][:, rot]).max()),
                landmark=float(np.linalg.norm(ca[:, 1:4] - cb[:, 1:4], axis=1).max()),
                yaw=float(np.abs((ca[:, 4] - cb[:, 4] + np.pi / 2) % np.pi - np.pi / 2).max()),
                scale=float(np.abs(ca[:, 5:8] - cb[:, 5:8]).max()))


def _kitti_entry(name, seq, init_to_ground, device, tmp):
    """One run of a KITTI entry point with output_prefix and the gate's
    tracker (and ground) configuration, the tracker class it builds by its
    module-level name swapped for the fold-synchronous one (and, for the
    mono gate, the object-depth bootstrap) for the call. Returns the
    tracker's outcome and the written files."""
    from cube_slam_tpu_torch.slam import ground, kitti, system

    prefix = os.path.join(tmp, f"{name}_{len(os.listdir(tmp))}")
    if name == "mono":
        cls, attr = object_bootstrap(_always_fold(kitti.KittiMonoTracker)), "KittiMonoTracker"
    else:
        cls, attr = _always_fold(kitti.KittiStereoTracker), "KittiStereoTracker"
    orig = getattr(kitti, attr)
    setattr(kitti, attr, cls)
    try:
        kw = dict(kitti_gate_kwargs(system, ground, name), output_prefix=prefix, device=device)
        if name == "mono":
            trk = kitti.run_kitti_sequence(seq, init_to_ground, **kw)
        else:
            trk = kitti.run_kitti_stereo_sequence(seq, init_to_ground, KITTI_GATE_BASELINE, **kw)
    finally:
        setattr(kitti, attr, orig)
    return dict(traj=trk.final_trajectory(), kf_frames=sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids()),
                anchors=list(getattr(trk, "_anchor_scales", [])), recoveries=getattr(trk, "n_scale_recoveries", 0),
                files={ext: np.loadtxt(prefix + f"_{ext}.txt", ndmin=2) for ext in ("tum", "kitti", "cuboids")})


def phase12c_kitti_card_vs_cpu(dev):
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("mono", "stereo"):
            left, right, poses, rows, _ = kitti_gate_scene(name)
            seq = MemoryKittiSequence(left, KITTI_GATE_K, rows, right)
            bound = KITTI_ENTRY_BOUNDS[name]
            g, g2, c = (_kitti_entry(name, seq, poses[0], d, tmp) for d in (dev, dev, "cpu"))
            fg = [f for f, T in g["traj"] if T is not None]
            fc = [f for f, T in c["traj"] if T is not None]
            repeat = (g["kf_frames"] == g2["kf_frames"] and g["anchors"] == g2["anchors"]
                      and all((x is None and y is None) or np.array_equal(x, y)
                              for (_, x), (_, y) in zip(g["traj"], g2["traj"]))
                      and all(np.array_equal(g["files"][k], g2["files"][k]) for k in g["files"]))
            ga, ca = g["anchors"], c["anchors"]
            gaps = dict(anchor=abs(ga[1] / ca[1] - 1.0) if len(ga) > 1 and len(ca) > 1 else 0.0,
                        **kitti_file_gaps(g["files"], c["files"]))
            log(f"[kitti-small] {name}, {seq.num_frames} frames 320x240 through run_kitti_"
                f"{'sequence' if name == 'mono' else 'stereo_sequence'} on the card (twice) and on the CPU: tracked "
                f"{fg} / {fc}; keyframes at frames {g['kf_frames']} / {c['kf_frames']}; anchors "
                f"{[round(x, 6) for x in ga]} / {[round(x, 6) for x in ca]}; recoveries "
                f"{g['recoveries']} / {c['recoveries']}; gaps " + ", ".join(f"{k} {v:.4g}" for k, v in gaps.items())
                + " (bounds " + ", ".join(f"{k} {bound[k]}" for k in gaps)
                + f"); two card runs bit-identical: {repeat}")
            log(f"[kitti-small] {name} cuboid rows (id x y z yaw l w h), card / CPU: "
                f"{g['files']['cuboids'].tolist()} / {c['files']['cuboids'].tolist()}")
            assert fg == fc, f"{name}: tracked frames differ card vs CPU"
            assert g["recoveries"] == c["recoveries"], f"{name}: ground recoveries differ card vs CPU"
            assert abs(len(g["kf_frames"]) - len(c["kf_frames"])) <= bound["keyframes"], \
                f"{name}: keyframe counts differ card vs CPU"
            assert abs(len(ga) - len(ca)) <= bound["anchors"], f"{name}: anchor counts differ card vs CPU"
            assert ga[:1] == ca[:1], f"{name}: first anchors differ card vs CPU"
            for k, v in gaps.items():
                assert bound[k] is None or v <= bound[k], f"{name}: {k} differs card vs CPU by {v} (bound {bound[k]})"
            assert repeat, f"{name}: two card runs differ"


# phase 13: the dynamic gates at 320x240, the scene of
# tests/test_dynamic_tracker.py and tests/test_kitti_dynamic.py (RoomScene
# seed 3, its box of half extents DYNAMIC_GATE_HALF driving along world +x
# at DYNAMIC_GATE_SPEED m per frame, 12 frames of camera_path(40), the
# first pose as init_to_ground / ground_Twc0, the box's truth pose moved by
# 2 cm noise as the per-frame measurement); tests/torch_parity_utils.py
# builds its dynamic gates from these
DYNAMIC_GATE_HALF = np.array([0.5, 0.35, 0.35], dtype=np.float32)
DYNAMIC_GATE_FRAMES = 12
DYNAMIC_GATE_SPEED = 0.15
DYNAMIC_GATE_TID = 7  # the mono gate's tracklet; the RGBD gate's detections carry 0
DYNAMIC_GATE_CONFIG = dict(n_features=600, n_levels=3, max_kf=24, max_mp=4096, min_init_kps=80, min_init_matches=80,
                           new_kf_max_frames=2, enable_loop_closing=False)
DYNAMIC_GATE_RGBD_DEPTH_MAX = 15.0
# 13C and the CPU parity tests: KLT tracks (pixels per point) and the
# dynamic BA's solved entries (poses, points, velocity), port against JAX
# and card against CPU (tests/test_torch_klt.py and
# tests/test_torch_dynamic_ba.py say what they measured)
KLT_TRACK_TOL = 1e-3
DYNAMIC_BA_TOL = 2e-3


def moving_box_renders(scene, poses, K, wh, speed, grey=False):
    """`scene`'s box driving along world +x at `speed` m per frame from
    where it stands, seen from `poses`: dict of frames (float grey levels,
    rounded when `grey`), depths, instance masks, 2D boxes (None where out
    of view), the truth Twc, the box's truth poses, its half extents, and per
    frame the measurement noise of tests/test_dynamic_tracker.py (numpy
    default_rng(4), one normal draw per axis, drawn only where the box is in
    view and covers more than 200 pixels; None elsewhere)."""
    rng = np.random.default_rng(4)
    c0 = np.array(scene.box_center, dtype=np.float64)
    g = dict(frames=[], depths=[], masks=[], bboxes=[], poses=poses, true_obj=[], noise=[],
             half=np.asarray(scene.box_half, dtype=np.float32))
    for i, P in enumerate(poses):
        scene.set_box_pose(c0 + np.array([speed * i, 0.0, 0.0]), yaw=0.0)
        img, depth, mask = scene.render(P, K, wh=wh, return_depth=True, return_mask=True)
        T_obj, _ = scene.box_pose_scale()
        bbox = scene.box_bbox_2d(P, K, wh=wh)
        seen = bbox is not None and mask.sum() > 200
        for k, v in (("frames", np.round(img).astype(np.float32) if grey else img), ("depths", depth),
                     ("masks", mask), ("bboxes", bbox), ("true_obj", T_obj.copy()),
                     ("noise", rng.normal(size=3) if seen else None)):
            g[k].append(v)
    return g


def dynamic_gate_scene():
    """The dynamic gates' renders (moving_box_renders of their scene)."""
    from cube_slam_tpu_torch.utils import synth

    scene = synth.RoomScene(seed=3, box_center=[-1.0, 3.5, 0.35], box_half=DYNAMIC_GATE_HALF)
    return moving_box_renders(scene, synth.camera_path(40)[:DYNAMIC_GATE_FRAMES], KITTI_GATE_K, KITTI_GATE_WH,
                              DYNAMIC_GATE_SPEED)


def moving_box_dets(g, DynamicDetection):
    """Per-frame detections of the moving box as tests/test_dynamic_tracker.py
    makes them: tracklet 0, the camera-frame box pose in float32 moved by
    0.02 m times the noise, the 2D box and the instance mask; None where the
    box is not seen. Built with either package's DynamicDetection."""
    out = []
    for P, T_obj, bbox, mask, noise in zip(g["poses"], g["true_obj"], g["bboxes"], g["masks"], g["noise"]):
        if noise is None:
            out.append(None)
            continue
        local = (np.linalg.inv(P) @ T_obj).astype(np.float32)
        local[:3, 3] += 0.02 * noise.astype(np.float32)
        out.append([DynamicDetection(tracklet_id=0, local_pose=local, scale=g["half"],
                                     bbox=np.asarray(bbox, dtype=np.float32), mask=mask)])
    return out


def moving_box_rows(g, tid):
    """Per-frame 13-column offline rows of the moving box as
    tests/test_kitti_dynamic.py makes them: the camera-frame box pose moved
    by 0.02 m times the noise, in the local ground frame of the first pose,
    tracklet `tid`; (0, 13) where the box is not seen."""
    rows = []
    h = g["half"]
    for P, T_obj, bbox, noise in zip(g["poses"], g["true_obj"], g["bboxes"], g["noise"]):
        if noise is None:
            rows.append(np.zeros((0, 13)))
            continue
        local = np.linalg.inv(P) @ T_obj
        local[:3, 3] += 0.02 * noise
        pose_lg = g["poses"][0] @ local
        yaw = float(np.arctan2(pose_lg[1, 0], pose_lg[0, 0]))
        rows.append(np.array([[pose_lg[0, 3], pose_lg[1, 3], pose_lg[2, 3], yaw, h[0], h[1], h[2],
                               bbox[0], bbox[1], bbox[2], bbox[3], 0.9, float(tid)]]))
    return rows


def dynamic_ba_scene(seed=0):
    """tests/test_dynamic_ba.py's scene in numpy: a car-like cuboid (the
    KITTI prior) driving straight along +x at 2 m/s past a camera rig
    behind and above it, 5 keyframes 0.5 s apart, 24 surface points.
    Returns (tcw, stamps, obj_pose, scale, v_true, local points, dp_kf,
    dp_obj, dp_pt, dp_uv) with K = DYNAMIC_BA_K."""
    rng = np.random.default_rng(seed)
    K = DYNAMIC_BA_K
    n_kf = 5
    scale = np.array([1.9420, 0.8143, 0.7631], dtype=np.float32)
    v_true = 2.0
    stamps = np.arange(n_kf, dtype=np.float32) * 0.5
    obj_pose = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    obj_pose[:, :3, 3] = np.stack([v_true * stamps, np.zeros(n_kf), np.full(n_kf, scale[2])], axis=1)
    Q = 24
    face = rng.integers(0, 3, Q)
    sgn = rng.choice([-1.0, 1.0], Q)
    lp = rng.uniform(-1, 1, (Q, 3)).astype(np.float32)
    for i in range(Q):
        lp[i, face[i]] = sgn[i]
    lp = lp * scale
    tcw = []
    for i in range(n_kf):
        eye = np.array([v_true * stamps[i] - 8.0, 1.5, 1.6])
        f = np.array([v_true * stamps[i], 0.0, scale[2]]) - eye
        f = f / np.linalg.norm(f)
        x = np.cross(f, np.array([0.0, 0.0, 1.0]))
        x /= np.linalg.norm(x)
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.stack([x, np.cross(f, x), f], axis=1)
        Twc[:3, 3] = eye
        tcw.append(np.linalg.inv(Twc).astype(np.float32))
    tcw = np.stack(tcw)
    dp_kf, dp_pt, dp_uv = [], [], []
    for i in range(n_kf):
        Xc = (lp @ obj_pose[i][:3, :3].T + obj_pose[i][:3, 3]) @ tcw[i][:3, :3].T + tcw[i][:3, 3]
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:3]
        for q in range(Q):
            if Xc[q, 2] > 0.5:
                dp_kf.append(i)
                dp_pt.append(q)
                dp_uv.append(uv[q])
    return (tcw, stamps, obj_pose, scale, v_true, lp, np.asarray(dp_kf), np.zeros(len(dp_kf), dtype=np.int64),
            np.asarray(dp_pt), np.stack(dp_uv))


DYNAMIC_BA_K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], dtype=np.float32)


def dynamic_pipeline_scene():
    """tests/test_dynamic_pipeline.py's scene: a static camera watching the
    box (RoomScene seed 5) drive by at 0.8 m/s, 6 frames 0.25 s apart at
    320x240, with masks and 2D boxes, and the truth poses moved by
    default_rng(0) 3 cm noise as the initial object poses. Returns
    (track_dynamic_object's positional arguments, its keywords, truth poses,
    v_true)."""
    from cube_slam_tpu_torch.utils import synth

    half = np.array([0.5, 0.35, 0.35])
    scene = synth.RoomScene(seed=5, box_center=[0.0, 3.0, 0.35], box_half=half)
    N, dt, v_true = 6, 0.25, 0.8
    stamps = np.arange(N) * dt
    eye = np.array([0.3, 0.2, 1.0])
    f = np.array([0.5, 3.0, 0.4]) - eye
    f = f / np.linalg.norm(f)
    x = np.cross(f, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    Twc = np.eye(4)
    Twc[:3, :3] = np.stack([x, np.cross(f, x), f], axis=1)
    Twc[:3, 3] = eye
    frames, masks, bboxes, true = [], [], [], []
    for i in range(N):
        scene.set_box_pose(np.array([v_true * stamps[i], 3.0, 0.35]))
        img, mask = scene.render(Twc, KITTI_GATE_K, wh=KITTI_GATE_WH, return_mask=True)
        frames.append(img)
        masks.append(mask)
        bboxes.append(scene.box_bbox_2d(Twc, KITTI_GATE_K, wh=KITTI_GATE_WH))
        true.append(scene.box_pose_scale()[0])
    true = np.stack(true)
    init = true.copy()
    init[:, :3, 3] += 0.03 * np.random.default_rng(0).normal(size=(N, 3))
    args = (frames, masks, np.stack([np.linalg.inv(Twc)] * N), stamps, init, half, KITTI_GATE_K)
    return args, dict(bboxes=bboxes, max_pts=48, ba_iters=25), true, v_true


def dynamic_gate_bootstrap(cls, depth):
    """`cls` (either package's KittiMonoTracker) as tests/test_kitti_dynamic.py
    builds it, whatever its caller asks: its map bootstrapped from the first
    frame's depth image `depth` (mono_firstframe_truth_depth_init) and the
    box's half extents as the car prior. run_kitti_sequence takes neither."""

    class DynamicGateTracker(cls):
        def __init__(self, *a, **k):
            k.update(first_depth=depth, car_prior=DYNAMIC_GATE_HALF)
            super().__init__(*a, **k)

    return DynamicGateTracker


# phase 13: 13A at 11B's KITTI orbit, 13B at phase 6's TUM orbit, the room
# box driving along world +x (m per frame: the stamps are frame ids); 13A
# needs offline rows on at least DYNAMIC_MIN_ROWS of its 40 frames
DYNAMIC_KITTI_SPEED = 0.03
DYNAMIC_RGBD_SPEED = 0.02
DYNAMIC_MIN_ROWS = 30
DYNAMIC_SPANS = ("dyn.advance", "dyn.keyframe", "dyn.ba", "kf.total", "ba.fold")
# 13C: the dynamic gates card against CPU, and the CPU tests' port against
# JAX: the radius of JAX's 1-ulp spread in the same runs, the largest gap
# of any of its perturbed runs from its unperturbed one
# (tools/kitti_gate_spread.py --gate dynamic-rgbd / dynamic-kitti /
# dynamic-kitti-entry --at keyframes): keyframe count, camera centres (m)
# and rotation entries, the object's per-keyframe positions (m), its speed
# (m per frame; m/s for the entry point's 0.1 s frames) and steering angle
# (rad), each from 24 perturbed runs. "kitti" is the mono gate through the
# tracker (float frames), "kitti-entry" through run_kitti_sequence (uint8
# grey levels). Every perturbed run tracks all 12 frames; the RGBD gate's
# keep six keyframes, but on other frames (card and CPU do too)
DYNAMIC_GATE_BOUNDS = {
    "rgbd": dict(keyframes=0, centre=0.551, rotation=0.121, object=0.210, speed=0.0413, steer=0.0411),
    "kitti": dict(keyframes=1, centre=0.104, rotation=0.0517, object=0.0399, speed=0.00485, steer=0.0755),
    "kitti-entry": dict(keyframes=1, centre=0.134, rotation=0.0580, object=0.0458, speed=0.0959, steer=0.0598),
}


class _KltTimer:
    """Device time of every pyr_lk / harris_corners call (CUDA events read
    after the run, so nothing syncs in between) and the calls made."""

    def __init__(self):
        from cube_slam_tpu_torch.ops import klt

        self.klt, self.events, self.orig = klt, [], {}

    def __enter__(self):
        for name in ("pyr_lk", "harris_corners"):
            fn = self.orig[name] = getattr(self.klt, name)

            def timed_call(*a, fn=fn, name=name, **k):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*a, **k)
                e1.record()
                self.events.append((name, e0, e1))
                return out

            setattr(self.klt, name, timed_call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.klt, name, fn)

    def totals(self):
        torch.cuda.synchronize()
        out = {}
        for name, e0, e1 in self.events:
            ms, n = out.get(name, (0.0, 0))
            out[name] = (ms + e0.elapsed_time(e1), n + 1)
        return out


def _object_outcome(trk, g, tid):
    """The tracked object against the truth: velocity, per-keyframe
    positions (by frame), the median position error and the displacement
    error over the observed span (object poses live in the ground world,
    which is the truth's here)."""
    ch = trk.dynamic.chains.get(tid)
    if ch is None or not ch.kf_pose:
        return None
    m = trk.map
    pos = {int(m.kf_frame_id[k]): p[:3, 3].astype(np.float64) for k, p in ch.kf_pose.items()}
    errs = [float(np.linalg.norm(p - g["true_obj"][f][:3, 3])) for f, p in pos.items()]
    f0, f1 = min(pos), max(pos)
    disp = pos[f1] - pos[f0]
    disp_true = g["true_obj"][f1][:3, 3] - g["true_obj"][f0][:3, 3]
    return dict(velocity=ch.velocity.astype(np.float64), pos=pos, median_err=float(np.median(errs)),
                disp_err=float(np.abs(disp - disp_true).max()), n_kf=len(pos), history=len(ch.velocity_history),
                has_local=int(ch.has_local.sum()))


def _dynamic_run(trk, inputs, g, tid, W, speed, tag):
    """Drive a dynamic tracker over `inputs` on the card; print what 13A
    and 13B print and return (tracked frames, metric ATE, object outcome)."""
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.utils import profiler

    N = len(inputs)
    profiler.reset()
    profiler.enable()
    try:
        hk.edt_launches = 0
        with _KltTimer() as kt:
            ms, kind, traj, wall = drive(trk, inputs)
        launches = hk.edt_launches
        spans = profiler.aggregated()
        klt = kt.totals()
    finally:
        profiler.disable()
        profiler.reset()
    tracked = [f for f, T in traj if T is not None]
    est = {f: W @ np.linalg.inv(np.asarray(T, dtype=np.float64)) for f, T in traj if T is not None}
    ate = float(np.sqrt(np.mean([np.sum((est[f][:3, 3] - g["poses"][f][:3, 3]) ** 2) for f in est])))
    n_kf = int(trk.map.kf_valid.sum())
    n_kf_frames = kind.count("kf")
    med = lambda k: statistics.median([t for t, c in zip(ms, kind) if c == k]) if k in kind else float("nan")  # noqa: E731
    obj = _object_outcome(trk, g, tid)
    log(f"[{tag}] initialized at frame {kind.index('init') if 'init' in kind else None}; tracked "
        f"{len(tracked)}/{N}; keyframes {n_kf}; map points {int(trk.map.mp_valid.sum())}; metric ATE {ate:.4f} m "
        f"(final trajectory in the truth world); loops closed {trk.loops_closed}")
    if obj is not None:
        log(f"[{tag}] object: velocity [v, steer] {np.round(obj['velocity'], 5).tolist()} against the truth "
            f"[{speed}, 0] (m per frame); per-keyframe poses {obj['n_kf']}, velocity updates {obj['history']}, "
            f"points with object coordinates {obj['has_local']}; median position error {obj['median_err']:.4f} m; "
            f"displacement error over the observed span {obj['disp_err']:.4f} m")
    log(f"[{tag}] {N / wall:.3f} frames/s of track() ({wall:.2f} s, host clock, synchronized per frame); "
        f"tracked non-keyframe frames: median {med('tracked'):.2f} ms ({kind.count('tracked')}); keyframe "
        f"frames: median {med('kf'):.2f} ms ({n_kf_frames}); untracked frames {kind.count('lost')}")
    log(f"[{tag}] spans (total ms / calls, ms per keyframe frame): " + "; ".join(
        f"{k} {spans[k][0]:.1f}/{spans[k][4]}, {spans[k][0] / max(n_kf_frames, 1):.1f}"
        for k in DYNAMIC_SPANS if k in spans))
    log(f"[{tag}] KLT on the card (CUDA events): " + ("; ".join(
        f"{name} {t:.2f} ms in {n} calls ({t / N:.3f} ms and {n / N:.2f} calls per frame)"
        for name, (t, n) in sorted(klt.items())) or "no call"))
    log(f"[{tag}] EDT launches: {launches} (the dynamic paths build no detector)")
    assert launches == 0
    return tracked, ate, obj, {name: n / N for name, (_, n) in klt.items()}


def dynamic_inputs(stereo, seq):
    """13A's and 13B's renders: phase 11B's orbit (KITTI camera, 1241x376)
    and phase 6's orbit (TUM camera, 640x480), each with the room box
    driving along world +x (moving_box_renders, grey levels rounded)."""
    from cube_slam_tpu_torch.utils import synth

    _, truth_k, K_k = stereo
    scene_k = synth.SynthSequence(len(truth_k), K=K_k, wh=KITTI_WH).scene
    kitti = moving_box_renders(scene_k, truth_k, K_k, KITTI_WH, DYNAMIC_KITTI_SPEED, grey=True)
    scene_r = synth_sequence(seq.num_frames, SLICE_WH).scene
    rgbd = moving_box_renders(scene_r, seq.poses, seq.K, SLICE_WH, DYNAMIC_RGBD_SPEED, grey=True)
    return (kitti, K_k), (rgbd, seq.K)


def phase13a_dynamic_kitti(dev, inputs):
    from cube_slam_tpu_torch.slam.kitti import KittiMonoTracker
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    g, K = inputs
    H, W = g["frames"][0].shape
    rows = moving_box_rows(g, DYNAMIC_GATE_TID)
    n_rows = sum(len(r) > 0 for r in rows)
    cfg = TrackerConfig(n_features=3000, n_levels=8, max_kf=96, max_mp=12288)
    trk = KittiMonoTracker(K, (W, H), rows, g["poses"][0], config=cfg, car_prior=g["half"], dynamic=True,
                           first_depth=g["depths"][0], device=dev)
    log(f"[dyn-kitti] {len(g['frames'])} frames {W}x{H} of phase 11B's orbit, KITTI intrinsics, 3000 features x 8 "
        f"levels; the box drives along world +x at {DYNAMIC_KITTI_SPEED} m per frame; offline rows (tracklet "
        f"{DYNAMIC_GATE_TID}) on {n_rows} frames; car prior = the box's half extents "
        f"{np.round(g['half'], 4).tolist()}; bootstrap from frame 0's rendered depth")
    assert n_rows >= DYNAMIC_MIN_ROWS, f"rows on only {n_rows} frames"
    tracked, ate, obj, _ = _dynamic_run(trk, [(f,) for f in g["frames"]], g, DYNAMIC_GATE_TID, g["poses"][0],
                                        DYNAMIC_KITTI_SPEED, "dyn-kitti")
    assert len(tracked) >= TRACKER_MIN_TRACKED * len(g["frames"]), f"tracked only {len(tracked)}"
    assert trk.mono_scale_initialized and np.isfinite(ate), f"metric ATE {ate}"
    assert obj is not None and obj["n_kf"] >= 3 and obj["history"] >= 1, "the moving box was not tracked"
    assert np.isfinite(obj["velocity"]).all()


def phase13b_dynamic_rgbd(dev, inputs):
    from cube_slam_tpu_torch.slam.dynamic import DynamicDetection, DynamicRgbdTracker
    from cube_slam_tpu_torch.slam.system import TrackerConfig

    g, K = inputs
    H, W = g["frames"][0].shape
    dets = moving_box_dets(g, DynamicDetection)
    cfg = TrackerConfig(n_features=1500, n_levels=8, max_kf=96, max_mp=12288)
    trk = DynamicRgbdTracker(K, (W, H), cfg, depth_max=RGBD_DEPTH_MAX, ground_Twc0=g["poses"][0], device=dev)
    log(f"[dyn-rgbd] {len(g['frames'])} frames {W}x{H} of phase 6's orbit, TUM intrinsics, 1500 features x 8 "
        f"levels, rendered depth, depth_max {RGBD_DEPTH_MAX} m; the box drives along world +x at "
        f"{DYNAMIC_RGBD_SPEED} m per frame; detections with instance masks on {sum(d is not None for d in dets)} "
        f"frames")
    tracked, ate, obj, calls = _dynamic_run(trk, [(f, d, x) for f, d, x in zip(g["frames"], g["depths"], dets)], g,
                                            0, np.eye(4), DYNAMIC_RGBD_SPEED, "dyn-rgbd")
    assert len(tracked) >= DEPTH_MIN_TRACKED * len(g["frames"]), f"tracked only {len(tracked)}"
    assert np.isfinite(ate) and ate < RGBD_ATE_MAX, f"metric ATE {ate}"
    assert obj is not None and obj["n_kf"] >= 3 and obj["history"] >= 1, "the moving box was not tracked"
    assert obj["has_local"] > 0 and np.isfinite(obj["velocity"]).all()
    return calls


def _card_cpu(fn, dev):
    """fn(device) on the card twice and on the CPU, as numpy."""
    def np_(x):
        if isinstance(x, (tuple, list)):
            return [np_(v) for v in x]
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return np_(fn(dev)), np_(fn(dev)), np_(fn("cpu"))


def _same(a, b):
    if isinstance(a, list):
        return all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def _kernels(fn):
    """Device kernels that one call of fn() launches (torch.profiler)."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def phase13c_functions(dev, g_rgbd, calls):
    """KLT, Harris, the dynamic BA and the offline pipeline card twice vs
    the CPU on the same inputs; `calls` are 13B's KLT calls per frame."""
    from cube_slam_tpu_torch.graph.dynamic_ba import dynamic_object_ba
    from cube_slam_tpu_torch.models import cuboid as cb
    from cube_slam_tpu_torch.ops import klt
    from cube_slam_tpu_torch.slam.dynamic import _erode, track_dynamic_object
    from cube_slam_tpu_torch.utils import geometry as geo

    # Harris on the box and LK of its corners into the next frame (13B's
    # frames 20 and 21), with the projected-centre flow as the seed
    f0, f1, mask = g_rgbd["frames"][20], g_rgbd["frames"][21], _erode(g_rgbd["masks"][20])
    t = lambda x, d: torch.as_tensor(np.ascontiguousarray(x), device=d)  # noqa: E731
    hz = _card_cpu(lambda d: klt.harris_corners(t(f0, d), max_corners=64, mask=t(mask, d)), dev)
    xy, valid = hz[2]
    bb0, bb1 = g_rgbd["bboxes"][20], g_rgbd["bboxes"][21]
    guess = np.broadcast_to(((bb1[:2] + bb1[2:] / 2) - (bb0[:2] + bb0[2:] / 2)).astype(np.float32), (64, 2)).copy()
    lk = _card_cpu(lambda d: klt.pyr_lk(t(f0, d), t(f1, d), t(xy, d), t(valid, d), init_flow=t(guess, d),
                                        max_err=45.0), dev)
    lk_gap = float(np.abs(lk[0][0] - lk[2][0])[lk[2][1]].max(initial=0.0))
    k_lk = _kernels(lambda: klt.pyr_lk(t(f0, dev), t(f1, dev), t(xy, dev), t(valid, dev), init_flow=t(guess, dev),
                                       max_err=45.0))
    k_hz = _kernels(lambda: klt.harris_corners(t(f0, dev), max_corners=64, mask=t(mask, dev)))
    per_frame = calls.get("pyr_lk", 0.0) * k_lk + calls.get("harris_corners", 0.0) * k_hz
    log(f"[dyn-small] harris_corners on 13B's frame 20 (box mask eroded): {int(valid.sum())} corners; card vs CPU "
        f"same corners: {_same(hz[0], hz[2])}; pyr_lk of them into frame 21: status equal {_same(lk[0][1], lk[2][1])} "
        f"({int(lk[2][1].sum())} tracked), tracks within {lk_gap:.3g} px (bound {KLT_TRACK_TOL}); card repeats "
        f"bit-identical: {_same(hz[0], hz[1]) and _same(lk[0], lk[1])}; one pyr_lk call launches {k_lk} kernels "
        f"and one harris_corners call {k_hz}: ~{per_frame:.0f} KLT kernel launches per 13B frame")
    assert _same(hz[0], hz[2]) and _same(lk[0][1], lk[2][1]) and lk_gap <= KLT_TRACK_TOL
    assert _same(hz[0], hz[1]) and _same(lk[0], lk[1])

    # the dynamic BA on tests/test_dynamic_ba.py's scene, every family
    tcw, stamps, obj_pose, scale, v_true, lp, dp_kf, dp_obj, dp_pt, dp_uv = dynamic_ba_scene()
    r = np.random.default_rng(1)
    xi = torch.as_tensor(0.05 * r.normal(size=(len(tcw), 6)), dtype=torch.float32)
    obj0 = obj_pose @ geo.se3_exp(xi).numpy()
    lp0 = (lp + 0.05 * r.normal(size=lp.shape)).astype(np.float32)
    E, n = len(dp_kf), len(tcw)
    bo_meas = cb.project_onto_image_bbox(cb.Cuboid(t(obj_pose, "cpu"), t(np.tile(scale, (n, 1)), "cpu")),
                                         t(tcw, "cpu"), t(DYNAMIC_BA_K, "cpu")).numpy()

    def ba(d):
        a = [tcw, stamps, obj0[None], scale[None], np.array([[0.5, 0.1]], np.float32), lp0, DYNAMIC_BA_K,
             dp_kf, dp_obj, dp_pt, dp_uv.astype(np.float32), np.ones(E, np.float32), np.ones(E, bool),
             np.zeros(n - 1, np.int64), np.arange(n - 1), np.arange(1, n), np.ones(n - 1, bool),
             np.arange(n) == 0, np.ones((1, n), bool), np.ones(1, bool), np.ones(len(lp), bool)]
        return dynamic_object_ba(*[t(x, d) for x in a], bo_kf=t(np.arange(n), d), bo_obj=t(np.zeros(n, np.int64), d),
                                 bo_meas=t(bo_meas, d), bo_si=t(np.full(n, 0.5, np.float32), d),
                                 bo_valid=t(np.ones(n, bool), d), num_iters=15, motion_weight=1.5, fix_rotation=True)
    out = _card_cpu(ba, dev)
    gap = max(float(np.abs(x - y).max()) for x, y in zip(out[0][:4], out[2][:4]))
    log(f"[dyn-small] dynamic_object_ba on tests/test_dynamic_ba.py's scene (points, in-box, motion, bbox; free "
        f"cameras; fix_rotation): card vs CPU entries within {gap:.3g} (bound {DYNAMIC_BA_TOL}), cost "
        f"{float(out[0][4]):.6g} / {float(out[2][4]):.6g}, speed {out[0][2][0, 0]:.5f} (truth {v_true}); card "
        f"repeats bit-identical: {_same(out[0], out[1])}")
    assert gap <= DYNAMIC_BA_TOL and _same(out[0], out[1])

    # the offline per-object pipeline on tests/test_dynamic_pipeline.py's scene
    args, kw, true, v_true = dynamic_pipeline_scene()
    res = _card_cpu(lambda d: [(x.obj_pose_per_frame, x.velocity, x.local_pts, x.n_tracked_pts)
                               for x in [track_dynamic_object(*args, device=d, **kw)]][0], dev)
    gap = max(float(np.abs(x - y).max()) for x, y in zip(res[0][:3], res[2][:3]))
    log(f"[dyn-small] track_dynamic_object on tests/test_dynamic_pipeline.py's scene: {int(res[0][3])} / "
        f"{int(res[2][3])} points, card vs CPU within {gap:.3g} (bound {DYNAMIC_BA_TOL}), speed {res[0][1][0]:.4f} "
        f"(truth {v_true}); card repeats bit-identical: {_same(res[0], res[1])}")
    assert int(res[0][3]) == int(res[2][3]) and gap <= DYNAMIC_BA_TOL and _same(res[0], res[1])


def dynamic_outcome(trk, g, tid, W):
    """A dynamic gate run's tracked frames, keyframes' frames, camera
    poses in the truth world (Twc) and object outcome."""
    traj = trk.final_trajectory()
    m = trk.map
    return dict(tracked=[f for f, T in traj if T is not None],
                kf_frames=sorted(int(m.kf_frame_id[k]) for k in m.kf_ids()),
                Twc={f: W @ np.linalg.inv(np.asarray(T, dtype=np.float64)) for f, T in traj if T is not None},
                obj=_object_outcome(trk, g, tid))


def dynamic_gaps(a, b):
    """How far two dynamic gate runs are apart: keyframe count, camera
    centres and rotation entries on the frames both tracked, the object's
    positions on the keyframe frames both hold, its speed and steering."""
    common = [f for f in a["Twc"] if f in b["Twc"]]
    oa, ob = a["obj"], b["obj"]
    objs = [f for f in oa["pos"] if f in ob["pos"]]
    return dict(keyframes=abs(len(a["kf_frames"]) - len(b["kf_frames"])),
                centre=max(float(np.linalg.norm(a["Twc"][f][:3, 3] - b["Twc"][f][:3, 3])) for f in common),
                rotation=max(float(np.abs(a["Twc"][f][:3, :3] - b["Twc"][f][:3, :3]).max()) for f in common),
                object=max(float(np.linalg.norm(oa["pos"][f] - ob["pos"][f])) for f in objs),
                speed=abs(float(oa["velocity"][0] - ob["velocity"][0])),
                steer=abs(float(oa["velocity"][1] - ob["velocity"][1])))


def dynamic_gate_run(name, device, tmp=None, modules=None):
    """One run of a dynamic gate, with the port's slam modules or with the
    (dynamic, kitti, system) modules given (device None for the JAX
    package's): "rgbd" through DynamicRgbdTracker, "kitti" through
    KittiMonoTracker(dynamic=True).track on the float renders,
    "kitti-entry" through run_kitti_sequence(dynamic=True, output_prefix in
    `tmp`) with the tracker built as tests/test_kitti_dynamic.py builds it
    (dynamic_gate_bootstrap); every tracker's local-BA fold forced
    synchronous. Returns the outcome (and for "kitti-entry" the written
    files' text)."""
    if modules is None:
        from cube_slam_tpu_torch.slam import dynamic, kitti, system
    else:
        dynamic, kitti, system = modules
    dev = {} if device is None else dict(device=device)
    g = dynamic_gate_scene()
    cfg = system.TrackerConfig(**DYNAMIC_GATE_CONFIG)
    if name == "rgbd":
        trk = dynamic.DynamicRgbdTracker(KITTI_GATE_K, KITTI_GATE_WH, cfg, depth_max=DYNAMIC_GATE_RGBD_DEPTH_MAX,
                                         ground_Twc0=g["poses"][0], **dev)
        trk._impl.__class__ = _always_fold(type(trk._impl))
        dets = moving_box_dets(g, dynamic.DynamicDetection)
        for f, d, x in zip(g["frames"], g["depths"], dets):
            trk.track(f, d, x)
        return dynamic_outcome(trk, g, 0, np.eye(4))
    cls = dynamic_gate_bootstrap(_always_fold(kitti.KittiMonoTracker), g["depths"][0])
    rows = moving_box_rows(g, DYNAMIC_GATE_TID)
    if name == "kitti":
        trk = cls(KITTI_GATE_K, KITTI_GATE_WH, rows, g["poses"][0], config=cfg, use_truth_trackid=True, dynamic=True,
                  **dev)
        for f in g["frames"]:
            trk.track(f)
        trk.flush()
        return dynamic_outcome(trk, g, DYNAMIC_GATE_TID, g["poses"][0])
    prefix = os.path.join(tmp, f"dyn_{len(os.listdir(tmp))}")
    seq = MemoryKittiSequence(g["frames"], KITTI_GATE_K, rows)
    orig = kitti.KittiMonoTracker
    kitti.KittiMonoTracker = cls
    try:
        trk = kitti.run_kitti_sequence(seq, g["poses"][0], config=cfg, dynamic=True, output_prefix=prefix, **dev)
    finally:
        kitti.KittiMonoTracker = orig
    out = dynamic_outcome(trk, g, DYNAMIC_GATE_TID, g["poses"][0])
    out["files"] = {ext: open(prefix + f"_{ext}.txt").read()
                    for ext in ("tum", "kitti", "cuboids", "cuboids_dynamic", "cuboids_velocity")}
    return out


def phase13c_gates(dev):
    """The two dynamic gates card twice vs CPU."""
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("rgbd", "kitti-entry"):
            bound = DYNAMIC_GATE_BOUNDS[name]
            g1, g2, c = (dynamic_gate_run(name, d, tmp) for d in (dev, dev, "cpu"))
            gaps = dynamic_gaps(g1, c)
            repeat = (g1["tracked"] == g2["tracked"] and g1["kf_frames"] == g2["kf_frames"]
                      and all(np.array_equal(g1["Twc"][f], g2["Twc"][f]) for f in g1["Twc"])
                      and all(np.array_equal(g1["obj"]["pos"][f], g2["obj"]["pos"][f]) for f in g1["obj"]["pos"])
                      and np.array_equal(g1["obj"]["velocity"], g2["obj"]["velocity"])
                      and g1.get("files") == g2.get("files"))
            log(f"[dyn-small] {name} gate, 12 frames 320x240 through "
                f"{'DynamicRgbdTracker' if name == 'rgbd' else 'run_kitti_sequence(dynamic=True)'} on the card "
                f"(twice) and on the CPU: tracked {g1['tracked']} / {c['tracked']}; keyframes at frames "
                f"{g1['kf_frames']} / {c['kf_frames']}; object velocity {np.round(g1['obj']['velocity'], 5).tolist()} "
                f"/ {np.round(c['obj']['velocity'], 5).tolist()}, median position error "
                f"{g1['obj']['median_err']:.4f} / {c['obj']['median_err']:.4f} m; gaps "
                + ", ".join(f"{k} {v:.4g}" for k, v in gaps.items())
                + " (bounds " + ", ".join(f"{k} {bound[k]}" for k in gaps)
                + f"); two card runs bit-identical: {repeat}")
            if name == "kitti-entry":
                log(f"[dyn-small] kitti dynamic files, card / CPU: {g1['files']['cuboids_dynamic'].split()} / "
                    f"{c['files']['cuboids_dynamic'].split()}; velocity rows {g1['files']['cuboids_velocity'].split()} "
                    f"/ {c['files']['cuboids_velocity'].split()}")
                n_dyn = [len(x["files"]["cuboids_dynamic"].splitlines()) for x in (g1, c)]
                assert n_dyn[0] == n_dyn[1] >= 3, f"dynamic rows {n_dyn}"
            assert g1["tracked"] == c["tracked"], f"{name}: tracked frames differ card vs CPU"
            for k, v in gaps.items():
                assert bound[k] is None or v <= bound[k], f"{name}: {k} differs card vs CPU by {v} (bound {bound[k]})"
            assert repeat, f"{name}: two card runs differ"


# ---------------------------------------------------------------------------
# phase 14: line features (the reference's line_lbd) over phase 6's orbit
# ---------------------------------------------------------------------------

LINE_OCTAVES = 2
LINE_MAX = 128          # lines per octave (the JAX functions' defaults)
LINE_AGREE_PX = 3.0     # a match agrees with the truth motion within this
LINE_AGREE_SLACK = 0.1  # the card's agreeing share may fall this far below JAX's
LINE_DETECTORS = ("lsd", "edline")
LINE_SMALL_FRAMES = (0, 19, 38, 57)  # 14C's frames
FDESC_TOL = 1e-5       # LBD float descriptors, card vs CPU (and port vs JAX)
LINE_SET_TOL = 0.05    # px, segment endpoints as sets (tests/test_torch_lsd_lines.py)
# share of the CPU's segments the card finds within LINE_SET_TOL px: the
# card's segment sums and atan2 round differently, which flips the few
# segments that sit on a filter's threshold or at a full top-k's cut
LINE_MATCH_SHARE = 0.99
PNP_TCW_TOL = 1e-4
# JAX's figures on the same 58 frames: tools/line_reference.py (CPU)
LINE_REFERENCE = {
    "lsd": dict(valid_per_octave=[128.0, 128.0], matches_per_pair=173, agree=0.9787104622871047),
    "edline": dict(valid_per_octave=[111.0, 110.5], matches_per_pair=132, agree=0.9472395974979603),
}


def _bits(words):
    """(N, 8) int32 words -> (N, 256) bits, bit b of word w at 32 w + b."""
    w = np.asarray(words).view(np.uint32)
    return ((w[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(len(w), 256).astype(bool)


def line_agreement(lines_a, lines_b, match, depth_a, Twc_a, Twc_b, K):
    """How many of frame a's matched lines agree with the truth motion:
    each matched segment's midpoint, back-projected with frame a's rendered
    depth through its truth pose and projected into frame b, lies within
    LINE_AGREE_PX of the matched segment's line there. Numpy in (base
    pixels), (agreeing, matched) out."""
    idx = np.where(match >= 0)[0]
    if not len(idx):
        return 0, 0
    H, W = depth_a.shape
    mid = (lines_a[idx, :2] + lines_a[idx, 2:]) / 2.0
    px = np.clip(np.round(mid).astype(np.int64), 0, [W - 1, H - 1])
    z = depth_a[px[:, 1], px[:, 0]].astype(np.float64)
    xc = np.concatenate([mid, np.ones((len(idx), 1))], axis=1) @ np.linalg.inv(K).T * z[:, None]
    xw = xc @ Twc_a[:3, :3].T + Twc_a[:3, 3]
    Tbw = np.linalg.inv(Twc_b)
    xb = xw @ Tbw[:3, :3].T + Tbw[:3, 3]
    p = xb @ np.asarray(K, dtype=np.float64).T
    p = p[:, :2] / np.where(np.abs(p[:, 2:]) > 1e-9, p[:, 2:], 1e-9)
    seg = lines_b[match[idx]]
    d = seg[:, 2:] - seg[:, :2]
    r = p - seg[:, :2]
    dist = np.abs(d[:, 0] * r[:, 1] - d[:, 1] * r[:, 0]) / np.maximum(np.linalg.norm(d, axis=1), 1e-9)
    return int(np.sum((dist < LINE_AGREE_PX) & (z > 0) & (xb[:, 2] > 0))), len(idx)


def line_figures(descs, matches, rgbd):
    """Phase 14A's figures from per-frame numpy descriptor dicts (lines,
    valid, octave) and per-pair (match, dist): the median valid lines per
    octave, the median matches per consecutive pair, and the pooled share
    of matches that agree with the truth motion."""
    frames, poses, K = rgbd
    per_oct = [statistics.median(int(np.sum(d["valid"] & (d["octave"] == o))) for d in descs)
               for o in range(LINE_OCTAVES)]
    n_match, agree = [], 0
    for f, (m, _) in enumerate(matches):
        a, n = line_agreement(descs[f]["lines"], descs[f + 1]["lines"], m, frames[f][1], poses[f], poses[f + 1], K)
        agree += a
        n_match.append(n)
    return dict(valid_per_octave=per_oct, matches_per_pair=statistics.median(n_match),
                agree=agree / max(sum(n_match), 1), matches=sum(n_match))


def _timed_describe(img, detector):
    """describe_lines_pyramid on the card with CUDA events around its
    detection (the pyramid's line detectors) and its LBD part."""
    from cube_slam_tpu_torch.ops import lbd, lsd

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    detect = lsd.detect_lines_pyramid

    def timed_detect(*a, **k):
        ev[0].record()
        out = detect(*a, **k)
        ev[1].record()
        return out

    lsd.detect_lines_pyramid = timed_detect
    try:
        d = lbd.describe_lines_pyramid(img, n_octaves=LINE_OCTAVES, detector=detector, max_lines=LINE_MAX)
    finally:
        lsd.detect_lines_pyramid = detect
    ev[2].record()
    return d, ev


def phase14a_lines(dev, rgbd):
    """describe_lines_pyramid (LSD and EDLine) on each of the 58 frames and
    match_lines between consecutive frames, on the card."""
    from cube_slam_tpu_torch.ops import hopper_kernels as hk
    from cube_slam_tpu_torch.ops import lbd

    frames, poses, K = rgbd
    H, W = frames[0][0].shape
    imgs = [torch.as_tensor(g, device=dev) for g, _ in frames]
    for detector in LINE_DETECTORS:
        lbd.describe_lines_pyramid(imgs[0], detector=detector)  # warm-up
        torch.cuda.synchronize()
        hk.edt_launches = 0
        descs, events, matches, match_ev = [], [], [], []
        t0 = time.perf_counter()
        for f, img in enumerate(imgs):
            d, ev = _timed_describe(img, detector)
            descs.append(d)
            events.append(ev)
            if f:
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                matches.append(lbd.match_lines(descs[f - 1]["bdesc"], descs[f - 1]["valid"], d["bdesc"], d["valid"]))
                e1.record()
                match_ev.append((e0, e1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = hk.edt_launches
        det_ms = statistics.median(e[0].elapsed_time(e[1]) for e in events)
        lbd_ms = statistics.median(e[1].elapsed_time(e[2]) for e in events)
        match_ms = statistics.median(e0.elapsed_time(e1) for e0, e1 in match_ev)
        k_describe = _kernels(lambda: lbd.describe_lines_pyramid(imgs[1], detector=detector))
        k_match = _kernels(lambda: lbd.match_lines(descs[0]["bdesc"], descs[0]["valid"], descs[1]["bdesc"],
                                                   descs[1]["valid"]))
        np_descs = [{k: d[k].cpu().numpy() for k in ("lines", "valid", "octave")} for d in descs]
        np_matches = [(m.cpu().numpy(), dd.cpu().numpy()) for m, dd in matches]
        fig = line_figures(np_descs, np_matches, rgbd)
        ref = LINE_REFERENCE[detector]
        log(f"[lines] {detector}: {len(imgs)} frames {W}x{H}, {LINE_OCTAVES} octaves x {LINE_MAX} lines, LBD + "
            f"match_lines between consecutive frames: valid lines per octave (median) {fig['valid_per_octave']} "
            f"(JAX {ref['valid_per_octave']}); matches per pair (median) {fig['matches_per_pair']} (JAX "
            f"{ref['matches_per_pair']}); {fig['matches']} matches, {100 * fig['agree']:.1f}% agree with the truth "
            f"motion within {LINE_AGREE_PX} px (JAX {ref['agree']})")
        log(f"[lines] {detector}: per frame (median, CUDA events) detection {det_ms:.2f} ms, LBD {lbd_ms:.2f} ms, "
            f"matching {match_ms:.3f} ms; {len(imgs) / wall:.2f} frames/s of the whole loop (host clock); "
            f"{k_describe} kernel launches per describe_lines_pyramid call, {k_match} per match_lines call "
            f"(torch.profiler); EDT launches {launches}")
        assert launches == 0, f"{launches} EDT launches on the line path"
        assert fig["valid_per_octave"][0] > 0 and fig["matches"] > 0, fig
        if ref["agree"] is not None:
            assert fig["agree"] >= ref["agree"] - LINE_AGREE_SLACK, (fig["agree"], ref["agree"])


def pnp_scene(seed=0, n=80, n_out=12):
    """tests/test_torch_initializer_pnp.py's PnP problem (the pose from the
    port's se3_exp): world points, noisy pixels with n_out outliers, the
    valid mask, K and the true Tcw."""
    from cube_slam_tpu_torch.utils import geometry as geo

    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], 1)
    T = geo.se3_exp(torch.tensor([0.05, -0.1, 0.02, 0.3, -0.1, 0.2])).numpy()
    Xc = Xw @ T[:3, :3].T + T[:3, 3]
    uv = Xc @ K.T
    uv = uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.3, (n, 2))
    uv[:n_out] += rng.uniform(30, 80, (n_out, 2))
    valid = np.ones(n, bool)
    valid[-5:] = False
    return Xw.astype(np.float32), uv.astype(np.float32), valid, K, T


def _line_sets_matched(a, b, tol):
    """How many of segments `a` a greedy one-to-one match finds in `b`
    within `tol` px (endpoint max-norm)."""
    used, n = set(), 0
    for s_ in a:
        d = np.abs(b - s_).max(axis=1) if len(b) else np.zeros(0)
        d[list(used)] = np.inf
        if len(d) and d.min() <= tol:
            used.add(int(np.argmin(d)))
            n += 1
    return n


def _fit_inputs(lsd, detector, img, octave):
    """The arguments that detect_lines / detect_edlines hand
    _fit_lines_from_support for `img` at `octave`'s length threshold."""
    seen = []
    real = lsd._fit_lines_from_support

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    lsd._fit_lines_from_support = spy
    try:
        detect = {"lsd": lsd.detect_lines, "edline": lsd.detect_edlines}[detector]
        detect(img, min_length=15.0 / 2.0 ** octave, max_lines=LINE_MAX)
    finally:
        lsd._fit_lines_from_support = real
    return seen[0]


def phase14c_lines_card_vs_cpu(dev, rgbd, edges):
    """Slice 7's functions on the card twice and on the CPU."""
    from cube_slam_tpu_torch.ops import distance_transform as dt
    from cube_slam_tpu_torch.ops import lbd, lsd
    from cube_slam_tpu_torch.slam import pnp

    frames = rgbd[0]
    t = lambda x, d: torch.as_tensor(np.ascontiguousarray(x), device=d)  # noqa: E731
    gaps = dict(fdesc=0.0, untied_bits=0, tied_bits=0)
    sets = {k: dict(cpu=0, card=0, matched=0, missing=[]) for k in ("end to end", "on the CPU's support")}
    angles = [0, 0]
    repeat = True

    def compare(kind, a, b, where):
        n = _line_sets_matched(a, b, LINE_SET_TOL)
        c = sets[kind]
        c["cpu"] += len(a)
        c["card"] += len(b)
        c["matched"] += n
        if n < len(a):
            c["missing"].append(where)

    for detector in LINE_DETECTORS:
        prev = None
        for f in LINE_SMALL_FRAMES:
            img = frames[f][0]
            out = _card_cpu(lambda d: [v for k, v in sorted(lsd.detect_lines_pyramid(t(img, d), detector=detector).items())
                                       if k != "octave_images"], dev)
            (lb, lo, o, v) = out[2]  # lines_base, lines_octave, octave, valid
            repeat &= _same(out[0], out[1])
            pyr_imgs = lsd.detect_lines_pyramid(t(img, "cpu"), detector=detector)["octave_images"]
            for o_ in range(LINE_OCTAVES):
                sl = slice(o_ * LINE_MAX, (o_ + 1) * LINE_MAX)
                compare("end to end", lb[sl][v[sl]], out[0][0][sl][out[0][3][sl]], (detector, f, o_))
                # the fit on the CPU's support (active pixels, angles, magnitudes) on both devices
                args, kw = _fit_inputs(lsd, detector, pyr_imgs[o_], o_)
                fit = _card_cpu(lambda d: list(lsd._fit_lines_from_support(
                    *[t(x.numpy(), d) if torch.is_tensor(x) else x for x in args], **kw)), dev)
                repeat &= _same(fit[0], fit[1])
                compare("on the CPU's support", fit[2][0][fit[2][1]], fit[0][0][fit[0][1]], (detector, f, o_))
                angle = _card_cpu(lambda d: lsd._lsd_gradients(t(pyr_imgs[o_].numpy(), d))[3], dev)
                active = args[0].numpy()
                angles[0] += int(np.sum((angle[0] != angle[2]) & active))
                angles[1] += int(active.sum())
            # descriptors of the CPU's lines on both devices, octave by octave as describe_lines_pyramid does
            pyr_imgs = lsd.detect_lines_pyramid(t(img, "cpu"), detector=detector)["octave_images"]
            desc = _card_cpu(lambda d: [x for o_ in range(LINE_OCTAVES) for x in lbd.lbd_descriptors(
                t(pyr_imgs[o_].numpy(), d), t(lo[o_ * LINE_MAX:(o_ + 1) * LINE_MAX], d),
                t(v[o_ * LINE_MAX:(o_ + 1) * LINE_MAX], d))], dev)
            repeat &= _same(desc[0], desc[1])
            for o_ in range(LINE_OCTAVES):
                fk, bk, fc, bc = desc[0][2 * o_], desc[0][2 * o_ + 1], desc[2][2 * o_], desc[2][2 * o_ + 1]
                gaps["fdesc"] = max(gaps["fdesc"], float(np.abs(fk - fc).max()))
                flip = _bits(bk) != _bits(bc)
                tie = np.abs(fc[:, lbd._PAIR_A] - fc[:, lbd._PAIR_B]) <= FDESC_TOL
                gaps["untied_bits"] += int(np.sum(flip & ~tie))
                gaps["tied_bits"] += int(np.sum(flip & tie))
            words = np.concatenate([desc[2][1], desc[2][3]])
            if prev is not None:
                m = _card_cpu(lambda d: list(lbd.match_lines(t(prev[0], d), t(prev[1], d), t(words, d), t(v, d))), dev)
                repeat &= _same(m[0], m[1])
                assert _same(m[0], m[2]), "match_lines differs card vs CPU on the same words"
            prev = (words, v)
    log(f"[lines-small] frames {list(LINE_SMALL_FRAMES)}, LSD and EDLine pyramids card vs CPU: "
        + "; ".join(f"{k} the card finds {c['matched']} of the CPU's {c['cpu']} valid lines within {LINE_SET_TOL} px "
                    f"({c['card']} on the card; (detector, frame, octave) with a line missing: {c['missing']})"
                    for k, c in sets.items())
        + f" (bound: {LINE_MATCH_SHARE} of them); {angles[0]} of {angles[1]} support pixels have a level-line angle "
        f"(atan2) that rounds differently on the card")
    log(f"[lines-small] LBD on the CPU's lines within {gaps['fdesc']:.3g} (bound "
        f"{FDESC_TOL}), {gaps['tied_bits']} bits flipped at near-ties and {gaps['untied_bits']} elsewhere (must be 0); "
        f"match_lines equal on the same words")
    assert all(c["matched"] >= LINE_MATCH_SHARE * c["cpu"] for c in sets.values()), sets
    assert gaps["fdesc"] <= FDESC_TOL and gaps["untied_bits"] == 0, gaps

    e = edges.reshape(-1, *edges.shape[-2:]).cpu().numpy()
    ch = _card_cpu(lambda d: [dt.chamfer_l2_3x3(t(m, d)) for m in e], dev)
    repeat &= _same(ch[0], ch[1])
    assert _same(ch[0], ch[2]), "chamfer_l2_3x3 differs card vs CPU"
    Xw, uv, valid, K, T = pnp_scene()
    samples = pnp.make_pnp_samples(valid, n_ransac=128, seed=5, k=6)
    pr = _card_cpu(lambda d: list(pnp.pnp_ransac_dlt(t(Xw, d), t(uv, d), t(valid, d), t(K, d), t(samples, d))), dev)
    repeat &= _same(pr[0], pr[1])
    tcw_gap = float(np.abs(pr[0][0] - pr[2][0]).max())
    log(f"[lines-small] chamfer_l2_3x3 on the detector's {len(e)} edge map(s) {e.shape[1:]}: card == CPU "
        f"(torch.equal); pnp_ransac_dlt (128 six-point samples): inliers {int(pr[0][2])} / {int(pr[2][2])}, same "
        f"mask {_same(pr[0][1], pr[2][1])}, Tcw within {tcw_gap:.3g} (bound {PNP_TCW_TOL}), {np.abs(pr[0][0] - T).max():.3g} "
        f"from the truth; two card runs bit-identical: {repeat}")
    assert _same(pr[0][1], pr[2][1]) and tcw_gap <= PNP_TCW_TOL
    assert repeat, "two card runs of slice 7's functions differ"


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    dev = timed("phase 0", phase0_device)
    timed("phase 1", phase1_build)
    max_err = timed("phase 2", phase2_edt, dev)
    seq = synth_sequence(SLICE_FRAMES, SLICE_WH)
    edt, edges = timed("phase 3", phase3_detector, dev, seq)  # the EDT at the main path's own input
    launches = timed("phase 4", phase4_slice, dev, seq)
    timed("phase 5", phase5_small_reference, dev)
    timed("phase 6", phase6_tracker, dev, seq)
    timed("phase 7", phase7_tracker_card_vs_cpu, dev)
    launches_objects = timed("phase 8", phase8_object_tracker, dev, seq)
    timed("phase 9", phase9_object_card_vs_cpu, dev)
    trk, launches_loop = timed("phase 10 A", phase10a_loop_run, dev)
    timed("phase 10 B", phase10b_injected_loop, trk)
    timed("phase 10 C", phase10c_loop_card_vs_cpu, dev)
    rgbd, stereo = timed("phase 11 inputs", depth_sequences)
    timed("phase 11 A", phase11a_rgbd, dev, rgbd)
    timed("phase 11 B", phase11b_stereo, dev, stereo)
    timed("phase 11 C", phase11c_depth_card_vs_cpu, dev)
    t12 = time.perf_counter()
    kitti = kitti_inputs(stereo)
    timed("phase 12 A", phase12a_kitti_mono, dev, kitti)
    timed("phase 12 B", phase12b_kitti_stereo, dev, kitti)
    timed("phase 12 C", phase12c_kitti_card_vs_cpu, dev)
    log(f"[time] phase 12: {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    dyn_kitti, dyn_rgbd = timed("phase 13 inputs", dynamic_inputs, stereo, seq)
    timed("phase 13 A", phase13a_dynamic_kitti, dev, dyn_kitti)
    calls = timed("phase 13 B", phase13b_dynamic_rgbd, dev, dyn_rgbd)
    timed("phase 13 C functions", phase13c_functions, dev, dyn_rgbd[0], calls)
    timed("phase 13 C gates", phase13c_gates, dev)
    log(f"[time] phase 13: {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    timed("phase 14 A", phase14a_lines, dev, rgbd)
    timed("phase 14 C", phase14c_lines_card_vs_cpu, dev, rgbd, edges)
    log(f"[time] phase 14: {time.perf_counter() - t14:.1f} s")
    log(f"[time] all phases: {time.perf_counter() - t_start:.1f} s (limit 1200 s)")

    log(json.dumps({"kernels": [{
        "name": "edt_l2",
        "route": "cuda",
        "source": "cube_slam_tpu_torch/csrc/edt.cu",
        "replaces": "cube_slam_tpu/ops/pallas_kernels.py:27",
        "launches": launches,
        "launches_object_tracker": launches_objects,
        "launches_loop": launches_loop,
        "max_abs_err": max_err,
        "ms": edt["ms"],
        "plain_ms": edt["plain_ms"],
        "bound_ms": edt["bound_ms"],
        "bound_by": edt["bound_by"],
        "library_ms": None,  # no single PyTorch call computes an exact EDT
        "bound_share": edt["bound_share"],
        "device_ms": edt["device_ms"],
        "brute_force_ms": edt["brute_force_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
