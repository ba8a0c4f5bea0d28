"""The port's example scripts (cube_slam_tpu_torch/examples/) run on the CPU
on small synthetic inputs and write the artifacts the JAX package's
examples/*.py write. The reference's data folders are absent, so the
cabinet sequence and the detector frame are rendered into a temporary
folder in the layout utils/io reads (io.REFERENCE_DATA and
io.REFERENCE_DETECT3D_DATA point there), and the KITTI runs read a KITTI
odometry folder written with PIL."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_kitti_stereo import _folder
from test_torch_lsd_lines import ENDPOINT_TOL, _match

from cube_slam_tpu.ops import lsd as jlsd
from cube_slam_tpu_torch.examples import (detect_lines, run_cuboid_detection, run_kitti_slam,
                                          run_kitti_stereo_slam, run_mono_slam, run_object_slam_demo,
                                          run_synthetic_object_slam)
from cube_slam_tpu_torch.utils import io, synth

CABINET_FRAMES = 3


def _save_rgb(path, gray):
    from PIL import Image

    g = np.clip(np.round(gray), 0, 255).astype(np.uint8)
    Image.fromarray(np.stack([g] * 3, axis=-1)).save(path, quality=95)


def _quat(R):
    """Rotation matrix -> (qx, qy, qz, qw), w > 0 (R close to a rotation)."""
    w = np.sqrt(max(1.0 + np.trace(R), 1e-12)) / 2.0
    return np.array([(R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w), (R[1, 0] - R[0, 1]) / (4 * w), w])


def _tum_rows(poses):
    return np.array([np.concatenate([[0.1 * i], T[:3, 3], _quat(T[:3, :3])]) for i, T in enumerate(poses)])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference data root: object_slam/data with CABINET_FRAMES frames of
    the synthetic orbit at the cabinet's 640x480 camera (truth and "pop"
    poses, the true box as the offline cuboid rows and the YOLO boxes) and
    detect_3d_cuboid/data with one frame and its LSD edge txt."""
    root = tmp_path_factory.mktemp("reference")
    data = root / "object_slam" / "data"
    for sub in ("raw_imgs", "filter_2d_obj_txts"):
        (data / sub).mkdir(parents=True)
    seq = synth.SynthSequence(CABINET_FRAMES, K=io.CabinetSequence.K)
    np.savetxt(data / "truth_cam_poses.txt", _tum_rows(seq.poses))
    np.savetxt(data / "pop_cam_poses_saved.txt", _tum_rows(seq.poses))
    box_T, half = seq.scene.box_pose_scale()
    yaw = np.arctan2(box_T[1, 0], box_T[0, 0])
    np.savetxt(data / "detect_cuboids_saved.txt",
               [[f, *box_T[:3, 3], yaw, *half, 0.1] for f in range(CABINET_FRAMES)])
    for f in range(CABINET_FRAMES):
        _save_rgb(data / "raw_imgs" / ("%04d_rgb_raw.jpg" % f), seq.gray(f))
        boxes = seq.yolo_boxes(f)
        boxes[:, :2] += 1.0  # the files carry matlab's 1-based corners
        np.savetxt(data / "filter_2d_obj_txts" / ("%04d_yolo2_0.15.txt" % f), boxes)

    det = root / "detect_3d_cuboid" / "data"
    (det / "edge_detection" / "LSD").mkdir(parents=True)
    gray = seq.gray(1)
    _save_rgb(det / "0000_rgb_raw.jpg", gray)
    lines, valid = jlsd.detect_lines(jnp.asarray(gray), min_length=15.0, max_lines=128)
    np.savetxt(det / "edge_detection" / "LSD" / "0000_edge.txt", np.asarray(lines)[np.asarray(valid)])
    return root


@pytest.fixture
def at_reference(reference, monkeypatch):
    monkeypatch.setattr(io, "REFERENCE_DATA", str(reference / "object_slam" / "data"))
    monkeypatch.setattr(io, "REFERENCE_DETECT3D_DATA", str(reference / "detect_3d_cuboid" / "data"))
    return reference


def _files(out):
    return sorted(os.listdir(out))


def test_detect_lines_example_matches_jax_lines(at_reference, tmp_path):
    """On an image path, with --lbd: the lines (as sets, within
    ENDPOINT_TOL px) JAX's detect_lines gives on the same grey image, and
    JAX's artifacts; without an image it reads the reference frame."""
    image = str(at_reference / "object_slam" / "data" / "raw_imgs" / "0000_rgb_raw.jpg")
    out = tmp_path / "a"
    detect_lines.main([image, "--out", str(out), "--lbd", "--max-lines", "128", "--device", "cpu"])
    assert _files(out) == ["lbd_float.txt", "lines.png", "lines.txt"]
    got = np.loadtxt(out / "lines.txt", ndmin=2)
    gray = io.rgb_to_gray(io.load_image(image))
    lj, vj = jlsd.detect_lines(jnp.asarray(gray), min_length=15.0, max_lines=128)
    ref = np.asarray(lj)[np.asarray(vj)]
    assert len(got) == len(ref) > 10 and _match(ref, got) < ENDPOINT_TOL + 1e-3  # the txt keeps 3 decimals
    desc = np.loadtxt(out / "lbd_float.txt", ndmin=2)
    assert desc.shape == (len(got), 72) and np.allclose(np.linalg.norm(desc, axis=1), 1.0, atol=1e-5)
    detect_lines.main(["--out", str(tmp_path / "b"), "--device", "cpu"])
    assert _files(tmp_path / "b") == ["lines.png", "lines.txt"]


@pytest.mark.parametrize("live", [False, True])
def test_run_cuboid_detection_example(at_reference, tmp_path, capsys, live):
    run_cuboid_detection.main(["--out", str(tmp_path)] + (["--live-lines"] if live else []) + ["--device", "cpu"])
    assert _files(tmp_path) == ["cuboid_overlay.png"]
    assert "steady detect" in capsys.readouterr().out


@pytest.mark.parametrize("online", [False, True])
def test_run_object_slam_demo_example(at_reference, tmp_path, capsys, online):
    run_object_slam_demo.main(["--out", str(tmp_path)] + (["--online"] if online else []) + ["--device", "cpu"])
    assert _files(tmp_path) == ["map_topdown.png", "trajectory_tum.txt"]
    assert np.loadtxt(tmp_path / "trajectory_tum.txt", ndmin=2).shape == (CABINET_FRAMES, 8)
    assert "ATE" in capsys.readouterr().out


@pytest.mark.parametrize("objects", [False, True])
def test_run_mono_slam_example(at_reference, tmp_path, objects):
    run_mono_slam.main(["--out", str(tmp_path), "--frames", str(CABINET_FRAMES), "--device", "cpu"]
                       + (["--objects"] if objects else []))
    files = _files(tmp_path)
    assert {"map.npz", "map_topdown.png", "trajectory_tum.txt"} <= set(files)
    assert set(files) <= {"cuboids.txt", "map.npz", "map_topdown.png", "trajectory_tum.txt"}


def test_run_synthetic_object_slam_example(tmp_path, capsys):
    """Eight frames of the orbit (each a large step): the tracker
    initializes and scales the map from the object; the map is drawn, with
    both ATEs printed, exactly when more than 5 frames were tracked, as in
    the JAX script."""
    run_synthetic_object_slam.main(["--frames", "8", "--out", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    n = int(out.split("tracked ")[1].split("/")[0])
    assert n >= 2 and "mono scale from object: True" in out
    assert ("ATE metric" in out) == (n > 5) == (_files(tmp_path) == ["map_topdown.png"])


@pytest.mark.parametrize("kind", ["mono", "stereo"])
def test_run_kitti_examples(tmp_path, kind):
    """The KITTI gate's folder (tests/test_torch_kitti_stereo.py), its
    camera: TUM, KITTI and cuboid files under the prefix."""
    root = str(tmp_path / "seq")
    _folder(root, kind)
    prefix = str(tmp_path / "out" / "run")
    argv = [root, "--fx", "320", "--fy", "320", "--cx", "160", "--cy", "120", "--max-frames", "6",
            "--out", prefix, "--device", "cpu"]
    if kind == "mono":
        run_kitti_slam.main(argv + ["--cam-height", "1.4"])
    else:
        run_kitti_stereo_slam.main(argv + ["--baseline", "0.12"])
    assert _files(tmp_path / "out") == ["run_cuboids.txt", "run_kitti.txt", "run_tum.txt"]
