"""Trajectory writers + map checkpointing.

numpy copy of cube_slam_tpu/utils/serialization.py: it writes the same text
and the same npz fields, so a map saved by one package loads in the other.
Trajectory writers are parity features (System::SaveTrajectoryTUM /
SaveKeyFrameTrajectoryTUM / SaveTrajectoryKITTI, System.cc:301-463 and the
cuboid dumps, Tracking_util.cc:71-206). Map checkpoint/resume is a NEW
capability — the reference left it as a TODO (System.h:103-105 SaveMap/
LoadMap); here the whole MapState + ObjectStore round-trips through one
compressed npz.
"""

from __future__ import annotations

import numpy as np

from ..utils import np_geometry as np_geo


def save_trajectory_tum(path, stamps, poses_Tcw):
    """TUM format: `stamp x y z qx qy qz qw` of camera-to-world
    (System::SaveTrajectoryTUM, System.cc:301-364)."""
    with open(path, "w") as f:
        for stamp, Tcw in zip(stamps, poses_Tcw):
            if Tcw is None:
                continue
            Twc = np_geo.inv_T(np.asarray(Tcw, dtype=np.float64))
            q = np_geo.rot_to_quat(Twc[:3, :3])  # [w x y z]
            t = Twc[:3, 3]
            f.write(
                f"{stamp:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def save_trajectory_kitti(path, poses_Tcw):
    """KITTI format: 12 numbers per row, row-major 3x4 of Twc
    (System::SaveTrajectoryKITTI, System.cc:403-463)."""
    with open(path, "w") as f:
        for Tcw in poses_Tcw:
            if Tcw is None:
                continue
            Twc = np_geo.inv_T(np.asarray(Tcw, dtype=np.float64))
            row = Twc[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_cuboids_txt(path, obj_store, dynamic_manager=None):
    """Optimized global cuboids: `id x y z yaw l w h` per landmark
    (SaveOptimizedCuboidsToTxt analog, Tracking_util.cc:71-206).

    When a DynamicObjectManager is given, two sibling files are written
    mirroring the reference's per-KF dumps (Tracking_util.cc:112-206):
    `<path w/o ext>_dynamic.txt` — `tracklet kf_frame_id x y z yaw` per
    (object, keyframe) pose — and `<path w/o ext>_velocity.txt` —
    `tracklet kf_frame_id v steer` velocity history rows."""
    with open(path, "w") as f:
        for o in np.where(obj_store.valid)[0]:
            pose = obj_store.pose[o].astype(np.float64)
            r, p, y = np_geo.rot_to_euler_zyx(pose[:3, :3])
            t = pose[:3, 3]
            s = obj_store.scale[o]
            f.write(
                f"{o} {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {y:.4f} "
                f"{s[0]:.4f} {s[1]:.4f} {s[2]:.4f}\n"
            )
    if dynamic_manager is None:
        return
    stem = path[:-4] if path.endswith(".txt") else path
    with open(stem + "_dynamic.txt", "w") as f:
        for tid in sorted(dynamic_manager.chains):
            ch = dynamic_manager.chains[tid]
            for k in sorted(ch.kf_pose, key=lambda k: ch.kf_frame.get(k, k)):
                pose = ch.kf_pose[k].astype(np.float64)
                _, _, y = np_geo.rot_to_euler_zyx(pose[:3, :3])
                t = pose[:3, 3]
                fid = ch.kf_frame.get(k, -1)
                f.write(f"{tid} {fid} {t[0]:.4f} {t[1]:.4f} {t[2]:.4f} "
                        f"{y:.4f}\n")
    with open(stem + "_velocity.txt", "w") as f:
        for tid in sorted(dynamic_manager.chains):
            ch = dynamic_manager.chains[tid]
            for k, v in ch.velocity_history:
                fid = ch.kf_frame.get(k, -1)
                f.write(f"{tid} {fid} {v[0]:.4f} {v[1]:.4f}\n")


# ---------------------------------------------------------------------------
# checkpoint / resume (new capability)
# ---------------------------------------------------------------------------

_MAP_FIELDS = [
    "kf_tcw", "kf_valid", "kf_frame_id", "kf_kp_xy", "kf_kp_level",
    "kf_kp_angle", "kf_kp_desc", "kf_kp_valid", "kf_kp_mp",
    "mp_pos", "mp_valid", "mp_desc", "mp_normal", "mp_min_dist",
    "mp_max_dist", "mp_level", "mp_nobs", "mp_visible", "mp_found",
    "mp_first_kf", "mp_best_obj",
]
_OBJ_FIELDS = ["pose", "scale", "valid", "n_obs", "quality", "fix_scale"]


def save_map(path, map_state, obj_store=None):
    data = {f"map_{k}": getattr(map_state, k) for k in _MAP_FIELDS}
    data["caps"] = np.array([map_state.max_kf, map_state.max_mp, map_state.n_kp])
    if obj_store is not None:
        data.update({f"obj_{k}": getattr(obj_store, k) for k in _OBJ_FIELDS})
        data["obj_cap"] = np.array([obj_store.max_obj])
    np.savez_compressed(path, **data)


def load_map(path):
    """Returns (MapState, ObjectStore or None)."""
    from ..slam.objects import ObjectStore
    from ..slam.state import MapState

    z = np.load(path, allow_pickle=False)
    caps = z["caps"]
    m = MapState(max_kf=int(caps[0]), max_mp=int(caps[1]), n_kp=int(caps[2]))
    for k in _MAP_FIELDS:
        getattr(m, k)[...] = z[f"map_{k}"]
    store = None
    if "obj_cap" in z:
        store = ObjectStore(max_obj=int(z["obj_cap"][0]))
        for k in _OBJ_FIELDS:
            getattr(store, k)[...] = z[f"obj_{k}"]
    return m, store
