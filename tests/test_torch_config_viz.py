"""cube_slam_tpu_torch config.py and viz/drawing.py against the JAX
package's host copies: the presets and overrides as dicts, and the drawn
images pixel for pixel (the same PIL calls, so any difference is a bug)."""

import numpy as np
import pytest
import torch

from cube_slam_tpu import config as jcfg
from cube_slam_tpu.viz import drawing as jdraw
from cube_slam_tpu_torch import config as tcfg
from cube_slam_tpu_torch.viz import drawing as tdraw


@pytest.mark.parametrize("preset", ["tum_cabinet_config", "kitti_config"])
def test_presets_equal_jax(preset):
    j, t = getattr(jcfg, preset)(), getattr(tcfg, preset)()
    assert t.to_dict() == j.to_dict()
    np.testing.assert_array_equal(t.camera.K, j.camera.K)


def test_from_overrides_equal_jax_and_unknown_keys_raise():
    over = {"camera.fx": 700.0, "orb.n_levels": 4, "objects.whether_dynamic_object": True,
            "ground.enabled": True}
    assert tcfg.SlamConfig.from_overrides(**over).to_dict() == jcfg.SlamConfig.from_overrides(**over).to_dict()
    # an unknown key in a known section, and a key naming no section
    for bad in ({"camera.focal": 1.0}, {"orb.nfeatures": 10}, {"parallel_mapping": True}):
        with pytest.raises(KeyError):
            jcfg.SlamConfig.from_overrides(**bad)
        with pytest.raises(KeyError):
            tcfg.SlamConfig.from_overrides(**bad)
    # an unknown section
    with pytest.raises(AttributeError):
        jcfg.SlamConfig.from_overrides(**{"lidar.range": 1.0})
    with pytest.raises(AttributeError):
        tcfg.SlamConfig.from_overrides(**{"lidar.range": 1.0})


def _scene():
    r = np.random.default_rng(0)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pose = np.eye(4)
    pose[:3, 3] = [0.2, 0.1, 4.0]
    scale = np.array([0.6, 0.4, 0.45])
    Tcw = np.eye(4)
    est = np.tile(np.eye(4), (12, 1, 1))
    est[:, 0, 3] = np.linspace(0, 2, 12)
    est[:, 1, 3] = np.sin(np.linspace(0, 2, 12))
    truth = est.copy()
    truth[:, :2, 3] += r.normal(0, 0.05, (12, 2))
    track = np.tile(np.eye(4), (6, 1, 1))
    track[:, 0, 3] = np.linspace(1, 2, 6)
    return dict(img=r.uniform(0, 255, (240, 320)).astype(np.float32), K=K, pose=pose, scale=scale, Tcw=Tcw,
                kp=r.uniform(0, 300, (40, 2)), tracked=r.uniform(size=40) < 0.5, est=est, truth=truth,
                points=r.uniform(-1, 3, (50, 3)), bbox=np.array([[40.0, 30.0, 100.0, 80.0]]),
                track=[(track, scale)])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_drawing_equals_jax_pixel_for_pixel(as_tensor):
    """draw_frame (keypoints, a (2, 8) and an (8, 2) wireframe, boxes, the
    status text), draw_map_topdown (trajectories, points, a cuboid, a
    dynamic track) and cuboid_corners_2d_from_pose; the port also takes
    tensors."""
    s = _scene()
    cv = (lambda x: torch.as_tensor(x)) if as_tensor else (lambda x: x)  # noqa: E731
    cj = jdraw.cuboid_corners_2d_from_pose(s["pose"], s["scale"], s["Tcw"], s["K"])
    ct = tdraw.cuboid_corners_2d_from_pose(cv(s["pose"]), cv(s["scale"]), cv(s["Tcw"]), cv(s["K"]))
    np.testing.assert_array_equal(ct, cj)
    assert tdraw.CUBOID_EDGES == jdraw.CUBOID_EDGES

    kw = dict(kp_xy=s["kp"], kp_tracked=s["tracked"], cuboid_corners_2d=[cj, cj.T + 5.0], bboxes=s["bbox"],
              status_text="TRACKING | KFs 3")
    fj = np.asarray(jdraw.draw_frame(s["img"], **kw))
    ft = np.asarray(tdraw.draw_frame(cv(s["img"]), **{k: v if isinstance(v, (str, list)) else cv(v)
                                                       for k, v in kw.items()}))
    assert ft.shape == (240, 320, 3) and np.array_equal(ft, fj)

    mj = np.asarray(jdraw.draw_map_topdown(est_Twc=s["est"], truth_Twc=s["truth"], points=s["points"],
                                           cuboids=[(s["pose"], s["scale"])], dynamic_tracks=s["track"], size=200))
    mt = np.asarray(tdraw.draw_map_topdown(est_Twc=cv(s["est"]), truth_Twc=cv(s["truth"]), points=cv(s["points"]),
                                           cuboids=[(cv(s["pose"]), cv(s["scale"]))],
                                           dynamic_tracks=[(cv(p), cv(sc)) for p, sc in s["track"]], size=200))
    assert mt.shape == (200, 200, 3) and np.array_equal(mt, mj) and (mt != mt[0, 0]).any()


def test_empty_map_is_blank_in_both():
    assert np.array_equal(np.asarray(tdraw.draw_map_topdown(size=64)), np.asarray(jdraw.draw_map_topdown(size=64)))
