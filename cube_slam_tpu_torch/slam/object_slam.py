"""Cube-only object SLAM demo pipeline — parity with object_slam/.

PyTorch counterpart of cube_slam_tpu/slam/object_slam.py: a re-design of
`incremental_build_graph` (object_slam/src/main_obj.cpp:344-592), a
sequential loop where each frame adds one camera vertex, one camera-cuboid
edge (if a cuboid was detected) and one odometry edge, then re-optimizes the
WHOLE graph with 5 LM iterations (main_obj.cpp:561-562).

The graph lives in fixed-capacity padded tensors (poses (F, 4, 4), per-frame
cuboid measurements, odometry chain) and each frame's `graph.optimize(5)` is
one LM solve with masks selecting the active prefix. Measurements come
either from offline txt cuboids (whether_read_offline_cuboidtxt analog,
main_obj.cpp:476-497) or from the live detector (models/detector.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..graph import factors
from ..graph.lm import lm_optimize
from ..models import cuboid as cb
from ..utils import geometry as geo
from ..utils import io as io_utils
from ..utils import np_geometry as np_geo


def _t(x, device, dtype=torch.float32):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def optimize_graph(
    tcw,            # (F, 4, 4) current world->camera estimates
    cube_pose,      # (4, 4) cuboid pose (object->world)
    cube_scale,     # (3,)
    meas_pose,      # (F, 4, 4) per-frame cuboid measurement (camera frame)
    meas_scale,     # (F, 3)
    meas_quality,   # (F,)
    has_obs,        # (F,) bool
    odom,           # (F, 4, 4) measured motion (f-1 -> f), Tcw convention
    frame_count,    # int: frames currently in the graph
    num_iters: int,
    max_frames: int,
    device=None,
):
    """One `graph.optimize(num_iters)` call over the active prefix.

    Inputs may be numpy arrays or tensors; they are placed on `device`
    (default: the device of `tcw` if it is a tensor, else the card).
    Returns tensors (tcw, cube_pose, cube_scale, chi2)."""
    device = resolve(tcw.device if device is None and torch.is_tensor(tcw) else device)
    tcw = _t(tcw, device)
    cube_pose = _t(cube_pose, device)
    cube_scale = _t(cube_scale, device)
    meas_pose = _t(meas_pose, device)
    meas_scale = _t(meas_scale, device)
    meas_quality = _t(meas_quality, device)
    has_obs = _t(has_obs, device, torch.bool)
    odom = _t(odom, device)
    frame_count = int(frame_count)

    F = max_frames
    idx = torch.arange(F, device=device)
    frame_active = idx < frame_count
    obs_active = frame_active & has_obs
    odom_active = (idx >= 1) & frame_active

    dim = F * 6 + 9

    def retract(params, dx):
        tcw_c, cpose, cscale = params
        dxc = dx[: F * 6].reshape(F, 6)
        new_tcw = geo.se3_exp(dxc) @ tcw_c  # left-multiplicative (g2o VertexSE3Expmap)
        cub = cb.exp_update(cb.Cuboid(cpose, cscale), dx[F * 6:])
        return new_tcw, cub.pose, cub.scale

    sqrt_info = factors.quality_to_sqrt_info(meas_quality)  # (F,)
    meas = cb.Cuboid(meas_pose, meas_scale)

    def residual(params):
        tcw_c, cpose, cscale = params
        r_cube = factors.se3_cuboid_error(
            cb.Cuboid(cpose.expand(F, 4, 4), cscale.expand(F, 3)),
            tcw_c,
            meas,
            sqrt_info[:, None],
            obs_active,
        )  # (F, 9)
        prev = torch.roll(tcw_c, 1, dims=0)
        r_odom = factors.se3_odometry_error(prev, tcw_c, odom, 1.0, odom_active)  # (F, 6)
        return torch.cat([r_cube.reshape(-1), r_odom.reshape(-1)])

    cam_mask = torch.repeat_interleave(frame_active & (idx > 0), 6)  # frame 0 fixed
    cube_mask = torch.full((9,), frame_count > 0, dtype=torch.bool, device=device)
    param_mask = torch.cat([cam_mask, cube_mask])

    res = lm_optimize(
        residual,
        retract,
        (tcw, cube_pose, cube_scale),
        dim=dim,
        num_iters=num_iters,
        param_mask=param_mask,
    )
    new_tcw, new_cpose, new_cscale = res.params
    return new_tcw, new_cpose, new_cscale, res.chi2


@dataclass
class DemoResult:
    est_Twc: np.ndarray            # (N, 4, 4) optimized camera poses
    cube_pose_history: np.ndarray  # (N, 4, 4) cuboid pose after each frame
    cube_scale_history: np.ndarray # (N, 3)
    raw_cube_world: np.ndarray     # (N, 4, 4) raw detection lifted to world
    raw_cube_valid: np.ndarray     # (N,)
    chi2_history: np.ndarray       # (N,)


class ObjectSlamDemo:
    """Host loop of the incremental demo graph (main_obj.cpp:344-592).

    `stage_seconds` collects per-frame host-clock times of the stages
    ("lines", "detect", "lm"); each stage ends in a device-to-host read of
    its result, so the times cover the device work without extra syncs."""

    def __init__(self, max_frames=64, num_lm_iters=5, device=None):
        self.max_frames = max_frames
        self.num_lm_iters = num_lm_iters
        self.device = resolve(device)
        self.stage_seconds = {"lines": [], "detect": [], "lm": []}

    def run_offline(self, seq: io_utils.CabinetSequence | None = None):
        """Offline mode (online_detect_mode=false): cuboid measurements from
        detect_cuboids_saved.txt in the local ground frame, transformed into
        each frame's pop camera pose (main_obj.cpp:476-497)."""
        seq = seq or io_utils.CabinetSequence()
        N = seq.num_frames
        meas = []
        row_id = 0
        for f in range(N):
            if row_id < len(seq.offline_cuboids) and int(seq.offline_cuboids[row_id][0]) == f:
                r = seq.offline_cuboids[row_id]
                pose_g, scale = np_geo.minimal9_to_pose_scale(
                    [r[1], r[2], r[3], 0.0, 0.0, r[4], r[5], r[6], r[7]]
                )
                local_pose = np_geo.inv_T(seq.init_Twc(f)) @ pose_g
                quality = (1.0 - r[8] + 0.5) / 2.0
                meas.append((local_pose.astype(np.float32), scale.astype(np.float32), quality))
                row_id += 1
            else:
                meas.append(None)
        first_truth_Twc = seq.truth_Twc(0)
        return self._run(meas, first_truth_Twc, N)

    def run_online(self, seq=None, max_lines=128):
        """Online mode (online_detect_mode=true, main_obj.cpp:421-474): per
        frame run the line detector (ops/lsd.py, standing in for line_lbd's
        LSD) + the fused cuboid detector, sampling camera roll/pitch around
        the first truth pose after frame 0.

        `seq` is any object with `K`, `num_frames`, `gray(f)`,
        `yolo_boxes(f)` and `truth_Twc(f)` (default: the cabinet data)."""
        from ..models.detector import CuboidDetector
        from ..ops import lsd as lsd_ops

        seq = seq or io_utils.CabinetSequence()
        N = seq.num_frames
        first_truth_Twc = seq.truth_Twc(0)

        det = CuboidDetector(device=self.device)
        det.set_calibration(seq.K)
        det.whether_sample_bbox_height = False
        det.nominal_skew_ratio = 2.0

        meas = [None] * N
        # camera pose used for detection: frame 0 uses its own estimate; later
        # frames sample roll/pitch around the FIRST truth pose
        # (main_obj.cpp:442-446). We replicate by tracking the running
        # estimate only for frame 0 (= first truth pose anyway).
        for f in range(N):
            boxes = seq.yolo_boxes(f)
            if boxes.size == 0:
                continue
            gray = seq.gray(f)
            t0 = time.perf_counter()
            lines, lvalid = lsd_ops.detect_lines(
                torch.as_tensor(gray, dtype=torch.float32, device=self.device),
                min_length=15.0, max_lines=max_lines,
            )
            lines_np = lines.cpu().numpy()[lvalid.cpu().numpy()]
            t1 = time.perf_counter()
            det.whether_sample_cam_roll_pitch = f != 0
            Twc_det = first_truth_Twc
            props = det.detect_cuboid(gray, Twc_det, boxes[:1, :4], lines_np)
            self.stage_seconds["lines"].append(t1 - t0)
            self.stage_seconds["detect"].append(time.perf_counter() - t1)
            if not props or not props[0]:
                continue
            p = props[0][0]
            pose_g, scale = np_geo.minimal9_to_pose_scale(
                [p.pos[0], p.pos[1], p.pos[2], 0.0, 0.0, p.rotY, p.scale[0], p.scale[1], p.scale[2]]
            )
            if det.whether_sample_cam_roll_pitch:
                # correct camera frame for the sampled roll/pitch
                # (main_obj.cpp:463-471)
                r0, p0, y0 = np_geo.rot_to_euler_zyx(Twc_det[:3, :3])
                R_new = np_geo.euler_zyx_to_rot(
                    r0 + p.camera_roll_delta, p0 + p.camera_pitch_delta, y0
                )
                Twc_new = np_geo.make_T(R_new, Twc_det[:3, 3])
            else:
                Twc_new = Twc_det
            local_pose = np_geo.inv_T(Twc_new) @ pose_g
            quality = (1.0 - p.normalized_error + 0.5) / 2.0
            meas[f] = (local_pose.astype(np.float32), scale.astype(np.float32), quality)
        return self._run(meas, first_truth_Twc, N)

    def run_with_measurements(self, meas, first_truth_Twc):
        """meas: list (per frame) of None or (local_pose (4,4), scale (3,),
        quality) camera-frame cuboid measurements."""
        return self._run(meas, first_truth_Twc, len(meas))

    def _run(self, meas, first_truth_Twc, N):
        F = self.max_frames
        if N > F:
            raise ValueError(f"{N} frames exceed the graph capacity max_frames={F}")
        if meas[0] is None:
            raise ValueError("the cuboid vertex is initialised from a frame-0 observation")
        tcw = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
        meas_pose = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
        meas_scale = np.zeros((F, 3), dtype=np.float32)
        meas_quality = np.zeros((F,), dtype=np.float32)
        has_obs = np.zeros((F,), dtype=bool)
        odom = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))

        cube_pose = np.eye(4, dtype=np.float32)
        cube_scale = np.zeros(3, dtype=np.float32)

        est_Twc_hist = np.zeros((N, 4, 4))
        cube_pose_hist = np.zeros((N, 4, 4))
        cube_scale_hist = np.zeros((N, 3))
        raw_cube_world = np.tile(np.eye(4), (N, 1, 1))
        raw_cube_valid = np.zeros(N, dtype=bool)
        chi2_hist = np.zeros(N)

        first_Twc = np.asarray(first_truth_Twc, dtype=np.float32)

        for f in range(N):
            # constant-velocity pose prediction (main_obj.cpp:394-408)
            if f == 0:
                curr_Twc = first_Twc
                odom_f = np.eye(4, dtype=np.float32)
            else:
                prev_tcw = tcw[f - 1]
                if f > 1:
                    odom_f = prev_tcw @ np.linalg.inv(tcw[f - 2])
                else:
                    odom_f = np.eye(4, dtype=np.float32)
                curr_Twc = np.linalg.inv(odom_f @ prev_tcw)
            tcw[f] = np.linalg.inv(curr_Twc)
            odom[f] = odom_f

            if meas[f] is not None:
                mp, ms, q = meas[f]
                meas_pose[f] = mp
                meas_scale[f] = ms
                meas_quality[f] = q
                has_obs[f] = True

            # cuboid vertex init at frame 0 (main_obj.cpp:510-518)
            if f == 0:
                cube_pose = (curr_Twc @ meas_pose[0]).astype(np.float32)
                cube_scale = meas_scale[0].copy()

            t0 = time.perf_counter()
            out = optimize_graph(
                tcw, cube_pose, cube_scale, meas_pose, meas_scale, meas_quality,
                has_obs, odom, f + 1,
                num_iters=self.num_lm_iters, max_frames=F, device=self.device,
            )
            tcw_t, cube_pose_t, cube_scale_t, chi2 = out
            tcw = tcw_t.cpu().numpy()
            cube_pose = cube_pose_t.cpu().numpy()
            cube_scale = cube_scale_t.cpu().numpy()
            chi2_hist[f] = float(chi2)
            self.stage_seconds["lm"].append(time.perf_counter() - t0)

            est_Twc_hist[f] = np.linalg.inv(tcw[f])
            cube_pose_hist[f] = cube_pose
            cube_scale_hist[f] = cube_scale
            if meas[f] is not None:
                raw_cube_world[f] = np.linalg.inv(tcw[f]) @ meas_pose[f]
                raw_cube_valid[f] = True

        # final pose history re-read (reference re-reads vertices each frame;
        # we report the final optimized trajectory)
        for f in range(N):
            est_Twc_hist[f] = np.linalg.inv(tcw[f])

        return DemoResult(
            est_Twc=est_Twc_hist,
            cube_pose_history=cube_pose_hist,
            cube_scale_history=cube_scale_hist,
            raw_cube_world=raw_cube_world,
            raw_cube_valid=raw_cube_valid,
            chi2_history=chi2_hist,
        )


def evaluate_ate(est_Twc, truth_Twc):
    """Absolute trajectory error (translation RMSE), no alignment — the demo
    anchors frame 0 at the truth pose (main_obj.cpp:379-380)."""
    est_t = est_Twc[:, :3, 3]
    tru_t = truth_Twc[:, :3, 3]
    d = est_t - tru_t
    return float(np.sqrt((d * d).sum(axis=1).mean()))
