"""SLAM map state — fixed-capacity arrays instead of pointer graphs.

numpy copy of cube_slam_tpu/slam/state.py (MapState is host bookkeeping in
both packages); FrameFeatures holds tensors instead of jax arrays, and
`map_state_from_arrays` fills a map from the JAX package's map arrays.

The reference's Map/KeyFrame/MapPoint classes (orb_object_slam/src/{Map,
KeyFrame,MapPoint}.cc) are mutex-guarded pointer webs. Here the map is a
set of preallocated numpy arrays on the host (the bookkeeping side) whose
slices are shipped to the device per step. Associations are integer id arrays (-1 = none), mirroring
the reference's mvpMapPoints / mObservations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class MapState:
    """Host-side map store (numpy). Capacities are hard bounds; slots are
    recycled via valid masks (MapPoint::SetBadFlag analog)."""

    max_kf: int = 128
    max_mp: int = 16384
    n_kp: int = 512  # keypoints per keyframe (padded)

    def __post_init__(self):
        K, P, N = self.max_kf, self.max_mp, self.n_kp
        self.kf_tcw = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        self.kf_valid = np.zeros(K, dtype=bool)
        self.kf_frame_id = np.full(K, -1, dtype=np.int64)
        self.kf_kp_xy = np.zeros((K, N, 2), dtype=np.float32)
        self.kf_kp_level = np.zeros((K, N), dtype=np.int32)
        self.kf_kp_angle = np.zeros((K, N), dtype=np.float32)
        self.kf_kp_desc = np.zeros((K, N, 8), dtype=np.uint32)
        self.kf_kp_valid = np.zeros((K, N), dtype=bool)
        self.kf_kp_mp = np.full((K, N), -1, dtype=np.int32)
        # depth measurement per keypoint (RGBD/stereo paths; 0 = none)
        self.kf_kp_depth = np.zeros((K, N), dtype=np.float32)

        self.mp_pos = np.zeros((P, 3), dtype=np.float32)
        self.mp_valid = np.zeros(P, dtype=bool)
        self.mp_desc = np.zeros((P, 8), dtype=np.uint32)
        self.mp_normal = np.zeros((P, 3), dtype=np.float32)
        self.mp_min_dist = np.zeros(P, dtype=np.float32)
        self.mp_max_dist = np.full(P, 1e9, dtype=np.float32)
        self.mp_level = np.zeros(P, dtype=np.int32)  # reference octave
        self.mp_nobs = np.zeros(P, dtype=np.int32)
        self.mp_visible = np.zeros(P, dtype=np.int32)  # TrackLocalMap counters
        self.mp_found = np.zeros(P, dtype=np.int32)
        self.mp_first_kf = np.full(P, -1, dtype=np.int32)
        # keyframe-sequence number at creation (mnFirstKFid analog): drives
        # the probation window of MapPointCulling — the found-ratio test
        # applies ONLY to recently created points (LocalMapping.cc:249-318
        # iterates mlpRecentAddedMapPoints, not the whole map)
        self.mp_birth = np.zeros(P, dtype=np.int64)
        self.kf_seq = 0  # monotonically increasing keyframe counter
        # object association votes (MapPoint.h:125-141): best object per point
        self.mp_best_obj = np.full(P, -1, dtype=np.int32)

    # -- slot management ---------------------------------------------------
    def alloc_kf(self):
        """Index of a free keyframe slot, or -1 when capacity is exhausted
        (callers evict or cull — never crash mid-run)."""
        free = np.where(~self.kf_valid)[0]
        if not len(free):
            return -1
        self.kf_seq += 1
        return int(free[0])

    def alloc_mps(self, count):
        """Up to `count` free map-point slots. May return FEWER near
        capacity — callers must size their writes by len() of the result
        (graceful degradation instead of a mid-run RuntimeError).
        Allocated slots are stamped with the current keyframe sequence
        (creation time for the culling probation window)."""
        free = np.where(~self.mp_valid)[0][:count]
        self.mp_birth[free] = self.kf_seq
        return free

    def erase_kf(self, k):
        """Remove a keyframe (KeyFrame::SetBadFlag analog): detach its
        observations, decrement map-point counts, and erase points left
        with no observers."""
        mp = self.kf_kp_mp[k]
        ids = np.unique(mp[mp >= 0])
        self.mp_nobs[ids] -= 1
        self.kf_kp_mp[k][:] = -1
        self.kf_kp_valid[k][:] = False
        self.kf_valid[k] = False
        self.kf_frame_id[k] = -1
        orphan = ids[(self.mp_nobs[ids] <= 0) & self.mp_valid[ids]]
        if len(orphan):
            self.erase_mp(orphan)

    def clear(self):
        """Map::clear analog — wipe everything (System/Tracking Reset)."""
        self.__post_init__()

    def kf_ids(self):
        return np.where(self.kf_valid)[0]

    def mp_ids(self):
        return np.where(self.mp_valid)[0]

    # -- derived quantities --------------------------------------------------
    def covisibility_counts(self, kf_id):
        """Shared-map-point counts between kf_id and every other KF
        (KeyFrame::UpdateConnections analog, computed on demand).

        Vectorized: membership mask over map-point ids, then one (K, N)
        reduction — no Python set intersections (scales to max_kf x n_kp)."""
        mps = self.kf_kp_mp[kf_id]
        mine = np.zeros(self.max_mp, dtype=bool)
        mine[mps[mps >= 0]] = True
        owned = (self.kf_kp_mp >= 0) & mine[np.clip(self.kf_kp_mp, 0, None)]
        counts = (owned & self.kf_valid[:, None]).sum(axis=1).astype(np.int32)
        counts[kf_id] = 0
        return counts

    def covisibility_matrix(self):
        """(max_kf, max_kf) shared-map-point counts between all KF pairs —
        one ownership matmul (essential-graph edge weights)."""
        own = np.zeros((self.max_kf, self.max_mp), dtype=np.float32)
        kf_i, kp_i = np.where(self.kf_valid[:, None] & (self.kf_kp_mp >= 0))
        own[kf_i, self.kf_kp_mp[kf_i, kp_i]] = 1.0
        counts = (own @ own.T).astype(np.int32)
        np.fill_diagonal(counts, 0)
        return counts

    def erase_mp(self, ids):
        self.mp_valid[ids] = False
        # detach from keyframes
        mask = np.isin(self.kf_kp_mp, ids)
        self.kf_kp_mp[mask] = -1

    def replace_mp(self, old, new):
        """MapPoint::Replace analog: every observation of `old` re-points to
        `new`; `old` is invalidated."""
        if old == new:
            return
        self.kf_kp_mp[self.kf_kp_mp == old] = new
        self.mp_nobs[new] += self.mp_nobs[old]
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_valid[old] = False

    def observations_of(self, mp_sel):
        """(kf_idx, kp_idx, mp_idx) arrays for all observations of the
        selected map-point ids (for BA edge lists)."""
        sel = np.zeros(self.max_mp, dtype=bool)
        sel[mp_sel] = True
        kf_idx, kp_idx = np.where(
            self.kf_valid[:, None] & (self.kf_kp_mp >= 0) & sel[np.clip(self.kf_kp_mp, 0, None)]
        )
        mp_idx = self.kf_kp_mp[kf_idx, kp_idx]
        return kf_idx, kp_idx, mp_idx


def map_state_from_arrays(arrays):
    """A MapState filled from a dict of map arrays (the attributes of the
    JAX package's MapState, as numpy: `vars(jax_map)`), so a map built by
    one package can be carried into the other. Capacities come from the
    arrays' shapes; `kf_seq` may ride along as an entry."""
    arrays = dict(arrays)
    m = MapState(max_kf=int(arrays["kf_tcw"].shape[0]), max_mp=int(arrays["mp_pos"].shape[0]),
                 n_kp=int(arrays["kf_kp_xy"].shape[1]))
    for name, value in arrays.items():
        if name in ("max_kf", "max_mp", "n_kp"):
            continue
        if name == "kf_seq":
            m.kf_seq = int(value)
            continue
        ref = getattr(m, name)
        value = np.asarray(value)
        if value.shape != ref.shape:
            raise ValueError(f"{name}: shape {value.shape}, expected {ref.shape}")
        setattr(m, name, value.astype(ref.dtype, copy=True))
    return m


class FrameFeatures:
    """Per-frame extracted features (host mirror of Frame.cc fields).

    `dev` optionally holds the device tensors from extraction
    (xy/desc/level/valid/angle and the (N, 13) float "packed" bundle of
    orb.pack_features) so per-frame steps can consume them without
    re-uploading.

    The host arrays are LAZY: when constructed device-first (the tracking
    path), xy/level/angle/desc/valid come to the host on first access, in
    ONE `.cpu()` of the packed bundle; only initialization, rescue paths and
    keyframe creation read them. Host descriptors are uint32 words, as in
    the JAX package; on the device they are int32 with the same bits."""

    def __init__(self, xy=None, level=None, angle=None, desc=None,
                 valid=None, mp=None, dev=None, n_kp=None):
        self._xy = xy
        self._level = level
        self._angle = angle
        self._desc = desc
        self._valid = valid
        self.dev = dev
        if n_kp is None:
            if valid is not None:
                n_kp = len(valid)
            elif dev is not None:
                n_kp = int(dev["valid"].shape[0])
        self.n_kp = n_kp
        self._mp = (np.full(n_kp, -1, dtype=np.int32) if mp is None else mp)
        # device-resident association table; host .mp reads it lazily
        self._mp_dev = None

    def _materialize(self):
        """Bring the packed feature bundle to the host (one transfer;
        descriptors ride as bit-identical float columns)."""
        packed = self.dev["packed"].cpu().numpy()
        self._xy = np.ascontiguousarray(packed[:, 0:2])
        self._level = packed[:, 2].astype(np.int32)
        self._angle = packed[:, 3].copy()
        self._valid = packed[:, 4] > 0.5
        self._desc = np.ascontiguousarray(packed[:, 5:13]).view(np.uint32)

    def _get(self, name):
        v = getattr(self, "_" + name)
        if v is None:
            self._materialize()
            v = getattr(self, "_" + name)
        return v

    xy = property(lambda s: s._get("xy"),
                  lambda s, v: setattr(s, "_xy", v))
    level = property(lambda s: s._get("level"),
                     lambda s, v: setattr(s, "_level", v))
    angle = property(lambda s: s._get("angle"),
                     lambda s, v: setattr(s, "_angle", v))
    desc = property(lambda s: s._get("desc"),
                    lambda s, v: setattr(s, "_desc", v))
    valid = property(lambda s: s._get("valid"),
                     lambda s, v: setattr(s, "_valid", v))

    def restrict_valid(self, valid):
        """Replace the keypoint validity mask (host bool (N,)) in every copy
        a later step reads: the host array (the bundle is brought to the
        host first, so a later lazy read cannot restore the old mask), the
        device `valid` and the packed bundle's column 4."""
        valid = np.asarray(valid, dtype=bool)
        self._get("xy")
        self._valid = valid.copy()
        if self.dev is not None:
            v = torch.as_tensor(valid, device=self.dev["valid"].device)
            dev = dict(self.dev, valid=v)
            if "packed" in dev:
                packed = dev["packed"].clone()
                packed[:, 4] = v.to(packed.dtype)
                dev["packed"] = packed
            self.dev = dev

    def set_mp_dev(self, kp_mp_dev):
        """Keep the kp->map-point table on the device; host .mp reads it on
        demand (keyframe creation / rescue paths)."""
        self._mp_dev = kp_mp_dev
        self._mp = None

    @property
    def mp(self):
        if self._mp is None:
            self._mp = (self._mp_dev.cpu().numpy().astype(np.int32) if self._mp_dev is not None
                        else np.full(self.n_kp, -1, dtype=np.int32))
        return self._mp

    @mp.setter
    def mp(self, v):
        self._mp = v
        self._mp_dev = None
