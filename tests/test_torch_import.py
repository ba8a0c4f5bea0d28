"""cube_slam_tpu_torch stands alone: importing it pulls in neither JAX nor
the JAX package, nor triton; it builds nothing at import; and it never falls
back silently to the CPU."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cube_slam_tpu_torch
from cube_slam_tpu_torch.device import require_cuda
from cube_slam_tpu_torch.ops import distance_transform as tdt
from cube_slam_tpu_torch.ops import hopper_kernels as hk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(cube_slam_tpu_torch.__path__, "cube_slam_tpu_torch."))


SLICE2 = ["ops.orb", "ops.matching", "utils.profiler", "slam.state", "graph.ba",
          "slam.initializer", "slam.pnp", "slam.tracking", "slam.loop_closing", "slam.system"]
SLICE3 = ["ops.ransac", "slam.ground", "slam.kitti", "slam.objects", "graph.object_ba"]
SLICE4 = ["slam.sim3", "slam.loop_closing", "utils.serialization"]
SLICE5A = ["ops.stereo", "slam.system"]
SLICE5B = ["slam.kitti"]
SLICE6 = ["ops.klt", "graph.dynamic_ba", "slam.dynamic"]
SLICE8 = ["parallel.mesh", "parallel.sharded_lm", "parallel.sharded_ba", "parallel.sharded_detector",
          "slam.object_slam", "slam.system"]
SLICE7 = ["ops.lbd", "ops.lsd", "ops.distance_transform", "slam.pnp", "config", "viz.drawing"] + [
    "examples." + name for name in ("detect_lines", "run_cuboid_detection", "run_object_slam_demo", "run_mono_slam",
                                    "run_synthetic_object_slam", "run_kitti_slam", "run_kitti_stereo_slam")]


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "cube_slam_tpu_torch.models.detector" in mods and len(mods) >= 26
    assert not {"cube_slam_tpu_torch." + m
                for m in SLICE2 + SLICE3 + SLICE4 + SLICE5A + SLICE5B + SLICE6 + SLICE7 + SLICE8} - set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'cube_slam_tpu', 'triton'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("module", SLICE4 + SLICE5A + SLICE5B + SLICE6 + SLICE7 + SLICE8[:4])
def test_loop_slice_module_imports_alone_without_jax(module):
    """Each module of the loop-closing slice, of the depth inputs, of the
    KITTI trackers, of the dynamic objects, of the line features,
    presets, drawing and examples, and of multi-device (parallel/),
    imported alone in a fresh interpreter,
    pulls in neither JAX nor the JAX package, nor PIL (the card's machine
    has none: drawing and the examples import it when they draw or read)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('cube_slam_tpu_torch.{module}')\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'cube_slam_tpu', 'triton', 'PIL')))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        require_cuda()


def test_tracker_on_cuda_raises_without_a_card():
    """The tracker runs where it is told; asked for the card where there is
    none, it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cube_slam_tpu_torch.slam.system import MonocularTracker, TrackerConfig

    with pytest.raises((RuntimeError, AssertionError)):
        MonocularTracker(np.eye(3), (320, 240), TrackerConfig(enable_loop_closing=False), device="cuda")


def _entry_point(name):
    """Each entry point built with no device argument."""
    from cube_slam_tpu_torch.models.detector import CuboidDetector
    from cube_slam_tpu_torch.slam.dynamic import DynamicObjectManager, DynamicRgbdTracker, track_dynamic_object
    from cube_slam_tpu_torch.slam.kitti import KittiMonoTracker, KittiStereoTracker
    from cube_slam_tpu_torch.slam.object_slam import ObjectSlamDemo, optimize_graph
    from cube_slam_tpu_torch.slam.system import (MonocularTracker, ObjectSlamTracker, RgbdTracker, StereoTracker,
                                                 TrackerConfig)

    if name == "ObjectSlamDemo":
        return ObjectSlamDemo(max_frames=8)
    if name == "MonocularTracker":
        return MonocularTracker(np.eye(3), (320, 240), TrackerConfig())
    if name == "ObjectSlamTracker":
        return ObjectSlamTracker(np.eye(3), (320, 240), TrackerConfig())
    if name == "RgbdTracker":
        return RgbdTracker(np.eye(3), (320, 240), TrackerConfig(), depth_max=8.0, init_Twc=np.eye(4))
    if name == "StereoTracker":
        return StereoTracker(np.eye(3), (320, 240), 0.12, TrackerConfig(), depth_max=20.0)
    if name == "KittiMonoTracker":
        return KittiMonoTracker(np.eye(3), (320, 240), [], np.eye(4), TrackerConfig())
    if name == "KittiMonoTracker(dynamic=True)":
        return KittiMonoTracker(np.eye(3), (320, 240), [], np.eye(4), TrackerConfig(), dynamic=True).dynamic
    if name == "DynamicRgbdTracker":
        return DynamicRgbdTracker(np.eye(3), (320, 240), TrackerConfig(), depth_max=8.0)
    if name == "DynamicObjectManager":
        return DynamicObjectManager()
    if name == "track_dynamic_object":
        # the smallest call: one 32x32 frame with no object pixels, which
        # runs Harris and the triangulation and then finds too few points
        f = np.zeros((32, 32), np.float32)
        eye = np.eye(4)[None]
        return track_dynamic_object([f], [f > 0], eye, [0.0], eye, np.ones(3), np.eye(3), max_pts=4)
    if name == "KittiStereoTracker":
        return KittiStereoTracker(np.eye(3), (320, 240), 0.54, [], np.eye(4), TrackerConfig())
    if name == "CuboidDetector":
        return CuboidDetector()
    if name == "CuboidDetector.from_config":
        return CuboidDetector.from_config({"max_lines": 16})
    F = 2
    eye = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    return optimize_graph(eye, eye[0], np.ones(3, np.float32), eye, np.ones((F, 3), np.float32),
                          np.ones(F, np.float32), np.ones(F, bool), eye, F, num_iters=1, max_frames=F)


@pytest.mark.parametrize("name", ["ObjectSlamDemo", "MonocularTracker", "ObjectSlamTracker", "RgbdTracker",
                                  "StereoTracker", "KittiMonoTracker", "KittiStereoTracker", "CuboidDetector",
                                  "CuboidDetector.from_config", "optimize_graph", "KittiMonoTracker(dynamic=True)",
                                  "DynamicRgbdTracker", "DynamicObjectManager", "track_dynamic_object"])
def test_entry_points_default_to_the_card(name):
    """Without a device the entry points run on the card: where there is
    one they land on it, and where there is none they raise instead of
    running on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _entry_point(name)
        return
    if name == "track_dynamic_object":  # it ran on the card up to its own check
        with pytest.raises(RuntimeError, match="too few dynamic point observations"):
            _entry_point(name)
        return
    built = _entry_point(name)
    where = built[0].device if name == "optimize_graph" else built.device
    assert where.type == "cuda"


def test_cpu_edt_takes_plain_path():
    """A CPU tensor, batched or a single map, takes the plain version and
    launches nothing."""
    m = torch.rand(2, 17, 23, generator=torch.Generator().manual_seed(0)) < 0.1
    before = hk.edt_launches
    assert torch.equal(hk.edt_l2(m), tdt.edt_l2(m))
    assert torch.equal(hk.edt_l2(m[0]), tdt.edt_l2(m)[0])
    assert hk.edt_launches == before


SHARDED_ENTRY_POINTS = ("make_mesh", "optimize_graph_sharded", "sharded_local_ba", "detect_lattice_sharded")


def _sharded_call(name, mesh, inp):
    """One sharded entry point with no device argument: the device type of
    what it returns (make_mesh: its mesh's)."""
    from torch_parity_utils import cs

    from cube_slam_tpu_torch.parallel.mesh import make_mesh
    from cube_slam_tpu_torch.parallel.sharded_ba import sharded_local_ba
    from cube_slam_tpu_torch.parallel.sharded_detector import detect_lattice_sharded
    from cube_slam_tpu_torch.slam.object_slam import optimize_graph_sharded

    if name == "make_mesh":
        return make_mesh().device_type
    if name == "optimize_graph_sharded":
        return optimize_graph_sharded(mesh, *[inp[f"lm.{k}"] for k in cs.GRAPH_ARGS], num_iters=1)[0].device.type
    if name == "sharded_local_ba":
        return sharded_local_ba(mesh, *[inp[f"ba.{k}"] for k in cs.BA_ARGS], num_iters=1)[0].device.type
    return detect_lattice_sharded(mesh, cs._kernel_args(inp, "cpu"))[1].device.type


@pytest.mark.parametrize("name", SHARDED_ENTRY_POINTS)
def test_sharded_entry_points_default_to_the_card(name):
    """make_mesh and the three sharded entry points run on the card without
    a device argument: with one, over the one-rank NCCL mesh make_mesh()
    builds; without one, each raises by itself (no gloo, no CPU)."""
    import torch.distributed as dist
    from torch_parity_utils import parallel_inputs

    from cube_slam_tpu_torch.parallel.mesh import make_mesh

    inp = parallel_inputs()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _sharded_call(name, None, inp)
        assert not dist.is_initialized()
        return
    try:
        mesh = make_mesh()
        assert dist.get_backend(mesh.get_group()) == "nccl"
        assert _sharded_call(name, mesh, inp) == "cuda"
    finally:
        dist.destroy_process_group()
