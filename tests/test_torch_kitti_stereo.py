"""The stereo KITTI tracker and the two KITTI entry points of
cube_slam_tpu_torch (slam/kitti.py: KittiStereoTracker,
run_kitti_sequence, run_kitti_stereo_sequence) against the JAX package on
the CPU, every JAX tracker with its local-BA fold forced synchronous.

The stereo gate is tests/test_rgbd_stereo.py:71's scene (RoomScene seed 5,
the box as offline cuboid with tracklet 4, 10 pairs 320x240, baseline
0.12 m, 600 features x 3 levels, depth_max 15 m). The entry points read a
KITTI odometry folder written here with PIL (image_0/, image_1/, times.txt,
pred_3d_obj_matched_tracked_txt/) through each package's KittiSequence and
write the trajectory and cuboid files under output_prefix."""

import os

import numpy as np
import pytest
import torch_parity_utils as tpu

import cube_slam_tpu.slam as jslam
import cube_slam_tpu.slam.ground  # noqa: F401
import cube_slam_tpu_torch.slam as tslam
import cube_slam_tpu_torch.slam.ground  # noqa: F401
from cube_slam_tpu.slam import kitti as jk
from cube_slam_tpu.utils import io as jio
from cube_slam_tpu_torch.slam import kitti as tk
from cube_slam_tpu_torch.utils import io as tio

# The stereo gate, port against JAX's run: the radius of JAX's 1-ulp
# spread, the largest gap of any of its 24 perturbed runs from its
# unperturbed one (tools/kitti_gate_spread.py --gate stereo --at
# keyframes): final-trajectory Tcw entries 0.1816, the tracklet-4
# landmark's centre 1.0007 m and its half-scale (which the object BA's gauge
# step rescales) 0.3354. Every run tracks all frames and makes 3 keyframes
# (observed on this CPU). The port measured 0.0545, 0.3308 m and 0.0869.
STEREO_POSE_TOL, STEREO_LANDMARK_TOL, STEREO_SCALE_TOL = 0.182, 1.001, 0.336


def _stereo_outcome(trk):
    traj = trk.final_trajectory()
    st = trk.objects.store
    o = trk.objects.trackletid_to_landmark.get(4, -1)
    return dict(tracked=[f for f, T in traj if T is not None], Tcw={f: T for f, T in traj if T is not None},
                kf_frames=sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids()), landmark=o,
                pose=None if o < 0 else st.pose[o].copy(), scale=None if o < 0 else st.scale[o].copy(),
                fix=o >= 0 and bool(st.fix_scale[o]))


@pytest.fixture(scope="module")
def stereo_gate():
    pairs, poses, offline, _ = tpu.kitti_stereo_sequence()
    out = {}
    for name, pkg, kw in (("jax", jslam, {}), ("port", tslam, dict(device="cpu"))):
        trk = tpu.kitti_stereo_tracker(pkg, offline, poses[0], **kw)
        for left, right in pairs:
            trk.track(left, right)
        trk.flush()
        out[name] = _stereo_outcome(trk)
    return out


def test_stereo_gate_frames_and_keyframes(stereo_gate):
    """The same tracked frames (at least 70% of the 10, the JAX test's
    share) and as many keyframes: every one of JAX's 24 perturbed runs
    (and of the port's 12) tracks the same frames with the same keyframe
    count. The keyframes' frames, which 1-ulp perturbations move in JAX
    too, are not compared."""
    j, p = stereo_gate["jax"], stereo_gate["port"]
    assert len(j["tracked"]) >= 7
    assert p["tracked"] == j["tracked"]
    assert len(p["kf_frames"]) == len(j["kf_frames"]), (p["kf_frames"], j["kf_frames"])


def test_stereo_gate_poses(stereo_gate):
    """Every final-trajectory pose within STEREO_POSE_TOL of JAX's (Tcw
    entries; the baseline fixes the scale, so no alignment)."""
    j, p = stereo_gate["jax"], stereo_gate["port"]
    gap = max(float(np.abs(p["Tcw"][f] - j["Tcw"][f]).max()) for f in j["tracked"])
    assert gap <= STEREO_POSE_TOL, gap


def test_stereo_gate_landmark(stereo_gate):
    """Tracklet 4's landmark: live and fixed-scale in both, its centre
    within STEREO_LANDMARK_TOL of JAX's, its half-scale within
    STEREO_SCALE_TOL (the gauge step rescales it in both packages)."""
    j, p = stereo_gate["jax"], stereo_gate["port"]
    assert j["landmark"] >= 0 and p["landmark"] == j["landmark"] and p["fix"] and j["fix"]
    assert np.linalg.norm(p["pose"][:3, 3] - j["pose"][:3, 3]) <= STEREO_LANDMARK_TOL
    assert np.abs(p["scale"] - j["scale"]).max() <= STEREO_SCALE_TOL


def _write_folder(root, left, right, rows):
    """A KITTI odometry folder: image_0/ (and image_1/) PNGs, times.txt and
    the per-frame 13-column cuboid rows with tracklet ids."""
    from PIL import Image

    os.makedirs(os.path.join(root, "image_0"))
    os.makedirs(os.path.join(root, "pred_3d_obj_matched_tracked_txt"))
    if right is not None:
        os.makedirs(os.path.join(root, "image_1"))
    for i, img in enumerate(left):
        Image.fromarray(np.clip(np.round(img), 0, 255).astype(np.uint8)).save(
            os.path.join(root, "image_0", "%06d.png" % i))
        if right is not None:
            Image.fromarray(np.clip(np.round(right[i]), 0, 255).astype(np.uint8)).save(
                os.path.join(root, "image_1", "%06d.png" % i))
        np.savetxt(os.path.join(root, "pred_3d_obj_matched_tracked_txt", "%04d_3d_cuboids.txt" % i), rows[i])
    np.savetxt(os.path.join(root, "times.txt"), 0.1 * np.arange(len(left)))


def _folder(root, kind):
    frames, poses, rows, _ = tpu.kitti_entry_sequence(kind)
    if kind == "stereo":
        _write_folder(root, [a for a, _ in frames], [b for _, b in frames], rows)
    else:
        _write_folder(root, frames, None, rows)
    return poses


def _files(prefix):
    return {ext: np.loadtxt(f"{prefix}_{ext}.txt", ndmin=2) for ext in ("tum", "kitti", "cuboids")}


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_entry_points_write_the_same_files(tmp_path, monkeypatch, kind):
    """run_kitti_sequence / run_kitti_stereo_sequence of both packages on
    the same KITTI folder, each tracker class swapped for its
    fold-synchronous subclass (mono: bootstrapping from the object's
    depth): both sequences read the same frames, times and rows; the
    trackers track the same frames, make no ground recovery, the same
    first anchor, keyframe and anchor counts and second anchor within
    chip_smoke.KITTI_ENTRY_BOUNDS[kind]; the TUM, KITTI and cuboid files
    hold the same rows, within those bounds (chip_smoke.kitti_file_gaps).
    The bounds are JAX's own 1-ulp spread about its run (its radius), and
    chip_smoke.py's phase 12C holds the card to them against the CPU."""
    root = str(tmp_path / "seq")
    poses = _folder(root, kind)
    bound = tpu.cs.KITTI_ENTRY_BOUNDS[kind]
    out = {}
    for name, mod, io in (("jax", jk, jio), ("port", tk, tio)):
        seq = io.KittiSequence(root, K=tpu.GATE_A_K)
        prefix = str(tmp_path / name)
        pkg = jslam if name == "jax" else tslam
        kw = dict(tpu.kitti_entry_config(pkg, kind), output_prefix=prefix,
                  **({} if name == "jax" else {"device": "cpu"}))
        if kind == "mono":
            monkeypatch.setattr(mod, "KittiMonoTracker", tpu.object_bootstrap(tpu.sync_fold(mod.KittiMonoTracker)))
            trk = mod.run_kitti_sequence(seq, poses[0], **kw)
        else:
            monkeypatch.setattr(mod, "KittiStereoTracker", tpu.sync_fold(mod.KittiStereoTracker))
            trk = mod.run_kitti_stereo_sequence(seq, poses[0], tpu.KITTI_BASELINE, **kw)
        out[name] = (seq, trk, _files(prefix))
    (sj, tj, fj), (sp, tp, fp) = out["jax"], out["port"]
    assert np.array_equal(sp.times, sj.times) and sp.num_frames == sj.num_frames == len(poses)
    assert all(np.array_equal(a, b) for a, b in zip(sp.offline_cuboids(True), sj.offline_cuboids(True)))
    assert np.array_equal(sp.gray(3), sj.gray(3))
    tracked = [f for f, T in tj.final_trajectory() if T is not None]
    assert len(tracked) >= 7 and [f for f, T in tp.final_trajectory() if T is not None] == tracked
    assert fj["tum"].shape == (len(tracked), 8) and fj["kitti"].shape == (len(tracked), 12)
    assert fj["cuboids"].shape == (1, 8)
    kj = sorted(int(tj.map.kf_frame_id[k]) for k in tj.map.kf_ids())
    kp = sorted(int(tp.map.kf_frame_id[k]) for k in tp.map.kf_ids())
    assert abs(len(kp) - len(kj)) <= bound["keyframes"], (kp, kj)
    aj, ap = list(getattr(tj, "_anchor_scales", [])), list(getattr(tp, "_anchor_scales", []))
    assert abs(len(ap) - len(aj)) <= bound["anchors"] and ap[:1] == aj[:1], (ap, aj)
    if len(aj) > 1:
        assert abs(ap[1] / aj[1] - 1.0) <= bound["anchor"], (ap, aj)
    assert getattr(tp, "n_scale_recoveries", 0) == getattr(tj, "n_scale_recoveries", 0)
    gaps = tpu.cs.kitti_file_gaps(fp, fj)
    for k, v in gaps.items():
        assert bound[k] is None or v <= bound[k], (k, v, bound[k])
