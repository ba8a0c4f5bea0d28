"""Shared helpers of the tests that hold cube_slam_tpu_torch against
cube_slam_tpu on the CPU (not collected: the name has no test_ prefix).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy and are compared with a tolerance each test states.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

from cube_slam_tpu_torch.utils.synth import DRIFTED_LOOP_K as LOOP_K  # noqa: F401
from cube_slam_tpu_torch.utils.synth import DRIFTED_LOOP_N_KF as LOOP_N_KF  # noqa: F401
from cube_slam_tpu_torch.utils.synth import build_drifted_loop  # noqa: F401

# tier-1 runs pytest-xdist with several workers: keep each one's torch small
torch.set_num_threads(2)

# the constructed drifted loop of tests/test_loop_system.py
# (synth.build_drifted_loop: 14 keyframes, 640x480, LOOP_K)
LOOP_CONFIG = dict(loop_min_gap_kfs=10, loop_covis_theta=30, loop_global_ba=True, max_kf=16, max_mp=2048)

# TUM-cabinet intrinsics (main_obj.cpp:346-349) at half resolution, for the
# 320x240 renders the CPU tests use
K_HALF = np.array([[535.4, 0.0, 320.1], [0.0, 539.2, 247.6], [0.0, 0.0, 1.0]])
K_HALF[:2] *= 0.5


def rng(seed):
    return np.random.default_rng(seed)


def to_np(x):
    """A JAX array, a tensor, a tuple of them or a NamedTuple -> numpy."""
    if isinstance(x, (tuple, list)):
        return type(x)(*[to_np(v) for v in x]) if hasattr(x, "_fields") else type(x)(to_np(v) for v in x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_both(jax_fn, torch_fn, *np_args):
    """Call the JAX function on jnp arrays and its port on CPU tensors made
    from the same numpy inputs; return both results as numpy."""
    import jax.numpy as jnp

    j = jax_fn(*[jnp.asarray(a) for a in np_args])
    t = torch_fn(*[torch.as_tensor(np.asarray(a)) for a in np_args])
    return to_np(j), to_np(t)


def assert_close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


def room_scene():
    """The box scene of the online demo (box on the floor, 3.2 m ahead)."""
    from cube_slam_tpu_torch.utils import synth

    return synth.RoomScene(seed=3, box_center=[0.0, 3.2, 0.45], box_half=[0.6, 0.4, 0.45])


def synth_sequence(n_frames, wh=(320, 240), K=None):
    """The synthetic stand-in for the cabinet sequence (duck-typed for
    ObjectSlamDemo.run_online in both packages)."""
    from cube_slam_tpu_torch.utils import synth

    return synth.SynthSequence(n_frames, K=K_HALF if K is None else K, wh=wh, scene=room_scene())


# Gate A of the tracker slice: the tracker's test scene at video rate with
# enough parallax between frames to initialize (320x240, uint8 frames)
GATE_A_K = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]], dtype=np.float32)
GATE_A_CONFIG = dict(n_features=600, n_levels=3, max_kf=24, max_mp=4096,
                     min_init_kps=80, min_init_matches=80, enable_loop_closing=False)


def gate_a_sequence(n=14):
    """(frames, truth Twc): RoomScene(seed=2) along camera_path(14)."""
    from cube_slam_tpu_torch.utils import synth

    scene = synth.RoomScene(seed=2)
    poses = synth.camera_path(n)
    frames = [np.clip(scene.render(poses[i], GATE_A_K, wh=(320, 240)), 0, 255).astype(np.uint8)
              for i in range(n)]
    return frames, poses


def sync_fold_jax_tracker(cfg):
    """The JAX MonocularTracker with its local-BA fold forced synchronous:
    its own fold polls the device and lands a frame earlier or later by
    timing, which changes the map. The port's CPU fold is always ready, so
    this is the run it is held against."""
    from cube_slam_tpu.slam import system as jsys

    return sync_fold(jsys.MonocularTracker)(GATE_A_K, (320, 240), jsys.TrackerConfig(**cfg))


def sync_fold(cls):
    """A subclass of either package's tracker class `cls` whose local-BA
    fold is forced synchronous."""

    class SyncFold(cls):
        def _apply_pending_map(self, only_if_ready=False):
            return super()._apply_pending_map(only_if_ready=False)

    return SyncFold


def carry_tracker(jtrk, device="cpu"):
    """A port MonocularTracker in the state of a JAX one: its map (through
    state.map_state_from_arrays), pose, motion model, reference keyframe,
    last frame with its kp->map-point table, keyframe database and the
    device visibility counters. Any in-flight local BA of the JAX tracker
    must have been folded. A JAX RgbdTracker or StereoTracker becomes the
    port's class of the same name, with its depth range, first pose,
    baseline and pending depth image."""
    from cube_slam_tpu.slam import dynamic as jdyn
    from cube_slam_tpu.slam import system as jsys
    from cube_slam_tpu_torch.slam import system as tsys

    if isinstance(jtrk, jdyn.DynamicRgbdTracker):
        return carry_dynamic_rgbd_tracker(jtrk, device)
    cfg = tsys.TrackerConfig(**vars(jtrk.cfg))
    if not isinstance(jtrk, jsys.RgbdTracker):
        return _carry_base(tsys.MonocularTracker(jtrk.K, jtrk.img_wh, cfg, device=device), jtrk, device)
    if isinstance(jtrk, jsys.StereoTracker):
        t = tsys.StereoTracker(jtrk.K, jtrk.img_wh, jtrk.baseline, cfg, depth_max=jtrk.depth_max, device=device)
    else:
        t = tsys.RgbdTracker(jtrk.K, jtrk.img_wh, cfg, depth_max=jtrk.depth_max, device=device)
    t.init_Tcw = jtrk.init_Tcw.copy()
    t._pending_depth = _copy(jtrk._pending_depth)
    return _carry_base(t, jtrk, device)


# The object gate: the orbit of the room box at 320x240 (uint8 frames), the
# truth box as the 2D box and the JAX package's LSD lines, through the
# ObjectSlamTracker configuration of tests/test_objects_live_e2e.py over 24
# frames, ground_Twc0 = the first pose
OBJECT_GATE_CONFIG = dict(n_features=800, n_levels=3, max_kf=24, max_mp=4096, min_init_kps=80,
                          min_init_matches=80, match_radius_motion=20.0, enable_loop_closing=False)


def object_gate_sequence(n=24):
    """(frames, boxes (1, 4) or None per frame, JAX LSD lines per frame,
    truth Twc, scene)."""
    import jax.numpy as jnp

    from cube_slam_tpu.ops import lsd as jlsd
    from cube_slam_tpu_torch.utils import synth

    scene = room_scene()
    poses = synth.camera_path(40, kind="orbit", target=[0.0, 3.2, 0.6])[:n]
    frames, boxes, lines = [], [], []
    for P in poses:
        g = np.clip(scene.render(P, GATE_A_K, wh=(320, 240)), 0, 255).astype(np.uint8)
        ln, lv = jlsd.detect_lines(jnp.asarray(g, dtype=jnp.float32), min_length=15.0, max_lines=128)
        bb = scene.box_bbox_2d(P, GATE_A_K, wh=(320, 240))
        frames.append(g)
        boxes.append(None if bb is None else bb[None, :])
        lines.append(np.array(ln)[np.array(lv)])
    return frames, boxes, lines, poses, scene


def sync_fold_jax_object_tracker(ground_Twc0, cfg=None, base=None):
    """The JAX ObjectSlamTracker (or the subclass `base` of it) with its
    local-BA fold forced synchronous, on the object gate's camera."""
    from cube_slam_tpu.slam import system as jsys

    return sync_fold(base or jsys.ObjectSlamTracker)(GATE_A_K, (320, 240),
                                                     jsys.TrackerConfig(**(cfg or OBJECT_GATE_CONFIG)),
                                                     ground_Twc0=ground_Twc0)


def carry_object_tracker(jtrk, device="cpu"):
    """A port ObjectSlamTracker in the state of a JAX one: everything
    carry_tracker carries, plus the object manager (ObjectManager.load_state),
    the ground anchoring and its estimator, the scale flag and the pending
    frame observations."""
    from cube_slam_tpu_torch.slam import system as tsys

    cfg = tsys.TrackerConfig(**vars(jtrk.cfg))
    t = tsys.ObjectSlamTracker(jtrk.K, jtrk.img_wh, cfg, ground_Twc0=jtrk.ground_align,
                               camera_object_weight=jtrk.camera_object_weight, device=device)
    _carry_base(t, jtrk, device)
    t.objects.load_state(vars(jtrk.objects))
    for name in ("ground_align", "mono_scale_initialized", "_world_is_ground", "_pending_obs"):
        setattr(t, name, _copy(getattr(jtrk, name)))
    if jtrk._ground_est is None:
        t._ground_est = None
    else:
        t._ground_est.filtered_height = jtrk._ground_est.filtered_height
        t._ground_est.kf_counter = jtrk._ground_est.kf_counter
    return t


# The KITTI gates: tests/test_kitti_mode.py:37's monocular scene and
# tests/test_rgbd_stereo.py:71's stereo scene (320x240, float renders), the
# scene's box as the offline cuboid, init_to_ground = the first truth pose.
# Their scenes, configuration, bounds and file comparison are chip_smoke.py's
# (phase 12C runs the same gates on the card).
KITTI_HALF = cs.KITTI_GATE_HALF
KITTI_BASELINE = cs.KITTI_GATE_BASELINE
KITTI_STEREO_DEPTH_MAX = 15.0
object_bootstrap = cs.object_bootstrap


def kitti_mono_sequence():
    """(frames, truth Twc, offline rows, scene) of the monocular KITTI gate
    (chip_smoke.kitti_gate_scene("mono"))."""
    left, _, poses, rows, scene = cs.kitti_gate_scene("mono")
    return left, poses, rows, scene


def kitti_stereo_sequence():
    """((left, right) per frame, truth Twc, offline rows, scene) of the
    stereo KITTI gate (chip_smoke.kitti_gate_scene("stereo"))."""
    left, right, poses, rows, scene = cs.kitti_gate_scene("stereo")
    return list(zip(left, right)), poses, rows, scene


def kitti_mono_tracker(pkg, offline, init_to_ground, device=None, **kw):
    """The gate's KittiMonoTracker of either package (`pkg` is a package's
    slam module: it reads pkg.kitti, pkg.system, pkg.ground), its local-BA
    fold forced synchronous."""
    dev = {} if device is None else dict(device=device)
    return sync_fold(pkg.kitti.KittiMonoTracker)(
        GATE_A_K, (320, 240), offline, init_to_ground, use_truth_trackid=True, car_prior=KITTI_HALF,
        **kitti_entry_config(pkg, "mono"), **dev, **kw)


def kitti_stereo_tracker(pkg, offline, init_to_ground, device=None):
    """The stereo gate's KittiStereoTracker of either package, its local-BA
    fold forced synchronous."""
    dev = {} if device is None else dict(device=device)
    return sync_fold(pkg.kitti.KittiStereoTracker)(
        GATE_A_K, (320, 240), KITTI_BASELINE, offline, init_to_ground, car_prior=tuple(KITTI_HALF),
        depth_max=KITTI_STEREO_DEPTH_MAX, **kitti_entry_config(pkg, "stereo"), **dev)


# The KITTI entry points' sequences, as a KITTI folder stores them (uint8
# PNGs, read back as float32 grey levels): the mono gate's 14 frames and the
# stereo gate's 10 pairs with their rows, through the trackers that
# run_kitti_sequence / run_kitti_stereo_sequence build with the gates'
# tracker (and ground) configuration, the default car prior and depth range;
# the mono tracker bootstraps from the object's depth, as two-view
# initialization never succeeds on the mono gate's scene here.
def kitti_entry_sequence(kind):
    """(frames or (left, right) pairs as float32 grey levels, truth Twc,
    offline rows, scene) of an entry point's sequence."""
    left, right, poses, rows, scene = cs.kitti_gate_scene(kind)
    if kind == "stereo":
        return [(cs.kitti_grey(a), cs.kitti_grey(b)) for a, b in zip(left, right)], poses, rows, scene
    return [cs.kitti_grey(f) for f in left], poses, rows, scene


def kitti_entry_config(pkg, kind):
    """The keyword arguments the tests hand the entry point of `kind`."""
    return cs.kitti_gate_kwargs(pkg.system, pkg.ground, kind)


def kitti_entry_tracker(pkg, kind, rows, init_to_ground, times, device=None):
    """The tracker the entry point of `kind` builds from those arguments
    (the swapped class: fold-synchronous, and for mono the object
    bootstrap)."""
    dev = {} if device is None else dict(device=device)
    if kind == "stereo":
        return sync_fold(pkg.kitti.KittiStereoTracker)(GATE_A_K, (320, 240), KITTI_BASELINE, rows, init_to_ground,
                                                       use_truth_trackid=True, **kitti_entry_config(pkg, kind), **dev)
    return object_bootstrap(sync_fold(pkg.kitti.KittiMonoTracker))(
        GATE_A_K, (320, 240), rows, init_to_ground, use_truth_trackid=True, frame_stamps=times,
        **kitti_entry_config(pkg, kind), **dev)


def carry_kitti_tracker(jtrk, device="cpu"):
    """A port KittiMonoTracker or KittiStereoTracker in the state of a JAX
    one: everything carry_tracker carries, plus the offline rows, the
    object manager (ObjectManager.load_state) and, for the monocular
    tracker, the ground estimator's state, the applied anchor scales, the
    recovery count, the scale flag and the pending first-frame depth."""
    from cube_slam_tpu.slam import kitti as jk
    from cube_slam_tpu_torch.slam import ground as tground
    from cube_slam_tpu_torch.slam import kitti as tk
    from cube_slam_tpu_torch.slam import system as tsys

    cfg = tsys.TrackerConfig(**vars(jtrk.cfg))
    common = dict(config=cfg, use_truth_trackid=jtrk.use_truth_trackid, car_prior=jtrk.car_prior,
                  camera_object_weight=jtrk.camera_object_weight, device=device)
    if isinstance(jtrk, jk.KittiStereoTracker):
        t = tk.KittiStereoTracker(jtrk.K, jtrk.img_wh, jtrk.baseline, jtrk.offline, jtrk.init_to_ground,
                                  depth_max=jtrk.depth_max, **common)
        t.init_Tcw = jtrk.init_Tcw.copy()
        t._pending_depth = _copy(jtrk._pending_depth)
    else:
        t = tk.KittiMonoTracker(jtrk.K, jtrk.img_wh, jtrk.offline, jtrk.init_to_ground,
                                ground_cfg=tground.GroundConfig(**vars(jtrk.ground.cfg)),
                                cam_ground_normal=jtrk.cam_ground_normal,
                                firstframe_depth_init=jtrk.firstframe_depth_init, frame_stamps=jtrk.frame_stamps,
                                first_depth=_copy(jtrk.first_depth), **common)
        t.ground.filtered_height = jtrk.ground.filtered_height
        t.ground.kf_counter = jtrk.ground.kf_counter
        t._anchor_scales = list(jtrk._anchor_scales)
        for name in ("mono_scale_initialized", "n_scale_recoveries"):
            setattr(t, name, getattr(jtrk, name))
        if jtrk.dynamic is not None:
            t.dynamic = carry_dynamic_manager(jtrk.dynamic, device)
    _carry_base(t, jtrk, device)
    t.objects.load_state(vars(jtrk.objects))
    return t


def carry_dynamic_manager(jmgr, device="cpu"):
    """A port DynamicObjectManager in the state of a JAX one
    (DynamicObjectManager.load_state): its chains (points, liveness, object
    coordinates, spawn keyframes, per-keyframe snapshots, poses, stamps,
    frames and boxes, velocity and its history), the previous frame and
    detections, and its settings."""
    from cube_slam_tpu_torch.slam import dynamic as tdyn

    t = tdyn.DynamicObjectManager(device=device)
    t.load_state({k: v for k, v in vars(jmgr).items() if k != "device"})
    return t


def carry_dynamic_rgbd_tracker(jtrk, device="cpu"):
    """A port DynamicRgbdTracker in the state of a JAX one: its inner RGBD
    tracker as carry_tracker carries one, its manager
    (carry_dynamic_manager), the pending detections and the anchor cap."""
    from cube_slam_tpu_torch.slam import dynamic as tdyn
    from cube_slam_tpu_torch.slam import system as tsys

    ji = jtrk._impl
    t = tdyn.DynamicRgbdTracker(ji.K, ji.img_wh, tsys.TrackerConfig(**vars(ji.cfg)), depth_max=ji.depth_max,
                                manager=carry_dynamic_manager(jtrk.dynamic, device),
                                static_anchor_cap=jtrk.static_anchor_cap, device=device)
    t._impl.init_Tcw = ji.init_Tcw.copy()
    t._impl._pending_depth = _copy(ji._pending_depth)
    _carry_base(t._impl, ji, device)
    t._pending_dyn = [tdyn.DynamicDetection(**{k: _copy(v) for k, v in vars(d).items()}) for d in jtrk._pending_dyn]
    return t


def _carry_base(t, jtrk, device):
    from cube_slam_tpu_torch.slam import loop_closing as tlc
    from cube_slam_tpu_torch.slam import state as tstate

    assert jtrk._pending_ba is None and jtrk._pending is None
    t.map = tstate.map_state_from_arrays(vars(jtrk.map))
    for name in ("state", "last_Tcw", "velocity", "frame_id", "last_kf_frame_id", "ref_kf",
                 "tracked_inliers", "_last_rel"):
        setattr(t, name, _copy(getattr(jtrk, name)))
    t.trajectory = [(f, None if T is None else T.copy()) for f, T in jtrk.trajectory]
    t._traj_rel = [(f, r, rf, T.copy()) for f, r, rf, T in jtrk._traj_rel]
    lf = jtrk.last_frame
    t.last_frame = tstate.FrameFeatures(xy=lf.xy.copy(), level=lf.level.copy(), angle=lf.angle.copy(),
                                        desc=lf.desc.copy(), valid=lf.valid.copy(), mp=lf.mp.copy())
    db = tlc.LoopDetector(min_gap_kfs=jtrk.loop_detector.min_gap_kfs)
    db.signatures = {k: v.copy() for k, v in jtrk.loop_detector.signatures.items()}
    db._order = dict(jtrk.loop_detector._order)
    db._n_added = jtrk.loop_detector._n_added
    t.loop_detector = db
    if jtrk._mirror.vis_acc is not None:
        t._vis_acc = torch.as_tensor(np.array(jtrk._mirror.vis_acc), device=device)
        t._found_acc = torch.as_tensor(np.array(jtrk._mirror.found_acc), device=device)
    return t


def _copy(v):
    return v.copy() if isinstance(v, np.ndarray) else v


# The dynamic gates: the moving box of tests/test_dynamic_tracker.py (RGBD,
# instance masks, KLT) and tests/test_kitti_dynamic.py (monocular KITTI,
# offline rows, first-frame depth bootstrap), 12 frames 320x240; their
# scene, configuration and bounds are chip_smoke.py's (phase 13C runs the
# same gates on the card).
DYNAMIC_GATE_CONFIG = cs.DYNAMIC_GATE_CONFIG
DYNAMIC_GATE_RGBD_DEPTH_MAX = cs.DYNAMIC_GATE_RGBD_DEPTH_MAX
DYNAMIC_GATE_TID = cs.DYNAMIC_GATE_TID
DYNAMIC_GATE_HALF = cs.DYNAMIC_GATE_HALF
dynamic_gate = cs.dynamic_gate_scene
dynamic_gate_dets = cs.moving_box_dets


def dynamic_rgbd_tracker(dyn, g, device=None, manager=None):
    """The RGBD gate's DynamicRgbdTracker of either package (`dyn` is the
    package's slam.dynamic module), its inner tracker's local-BA fold
    forced synchronous."""
    import importlib

    system = importlib.import_module(dyn.__name__.rsplit(".", 1)[0] + ".system")
    kw = {} if device is None else dict(device=device)
    t = dyn.DynamicRgbdTracker(GATE_A_K, (320, 240), system.TrackerConfig(**DYNAMIC_GATE_CONFIG),
                               depth_max=DYNAMIC_GATE_RGBD_DEPTH_MAX, manager=manager, ground_Twc0=g["poses"][0], **kw)
    t._impl.__class__ = sync_fold(type(t._impl))
    return t


def dynamic_kitti_tracker(kitti, g, device=None, **kw):
    """The mono dynamic gate's KittiMonoTracker(dynamic=True) of either
    package (`kitti` is the package's slam.kitti module): the offline rows,
    the box's half extents as the car prior, frame 0's rendered depth as
    the bootstrap, its local-BA fold forced synchronous."""
    dev = {} if device is None else dict(device=device)
    return sync_fold(kitti.KittiMonoTracker)(
        GATE_A_K, (320, 240), cs.moving_box_rows(g, DYNAMIC_GATE_TID), g["poses"][0],
        config=kitti.TrackerConfig(**DYNAMIC_GATE_CONFIG), use_truth_trackid=True, car_prior=DYNAMIC_GATE_HALF,
        dynamic=True, first_depth=g["depths"][0], **dev, **kw)
