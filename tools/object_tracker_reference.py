#!/usr/bin/env python3
"""Run the JAX package's ObjectSlamTracker over the synthetic orbit that
chip_smoke.py's phase 8 gives the port, on the CPU, and print its outcome as
one JSON line: the reference for the port's numbers there.

    JAX_PLATFORMS=cpu python tools/object_tracker_reference.py [--frames 58] [--wh 640 480] [--prefix N]

Setup as phase 8: `SynthSequence` (room box at [0, 3.2, 0.45]) with the
TUM-cabinet intrinsics scaled to the width, the TUM-cabinet tracker preset
(1500 features x 8 levels, loop closing off), ground_Twc0 = the first truth
pose, the truth box as the 2D box, and the JAX package's LSD lines
(min_length 15, max_lines 128) on each frame. The local-BA fold is forced
synchronous, as in the port's tests. `--prefix N` tracks only the first N
frames of the orbit, as phase 8 does (chip_smoke.OBJECT_FRAMES). Times are
host seconds on the CPU and say nothing of any device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=58)
    ap.add_argument("--wh", type=int, nargs=2, default=(640, 480))
    ap.add_argument("--prefix", type=int, default=None, help="track only the first N frames of the orbit")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cube_slam_tpu.models import cuboid as cb
    from cube_slam_tpu.ops import lsd
    from cube_slam_tpu.slam import system as jsys
    from cube_slam_tpu.slam.tracking import evaluate_ate_scaled
    from cube_slam_tpu.utils import io
    from cube_slam_tpu_torch.utils import synth  # numpy only; the JAX package has no SynthSequence

    wh = tuple(args.wh)
    K = io.CabinetSequence.K.copy()
    if wh != (640, 480):
        K[:2] *= wh[0] / 640.0
    seq = synth.SynthSequence(args.frames, K=K, wh=wh)

    class SyncFold(jsys.ObjectSlamTracker):
        def _apply_pending_map(self, only_if_ready=False):
            return super()._apply_pending_map(only_if_ready=False)

    cfg = jsys.TrackerConfig(n_features=1500, n_levels=8, enable_loop_closing=False)
    trk = SyncFold(seq.K, wh, cfg, ground_Twc0=seq.truth_Twc(0))
    N = args.prefix or seq.num_frames
    init, promoted, t0 = None, set(), time.perf_counter()
    for f in range(N):
        g = seq.gray(f)
        ln, lv = lsd.detect_lines(jnp.asarray(g, dtype=jnp.float32), min_length=15.0, max_lines=128)
        boxes = seq.yolo_boxes(f)
        out = trk.track(g, bboxes_2d=boxes[:, :4] if len(boxes) else None,
                        lines=np.array(ln)[np.array(lv)])
        if out is not None and init is None:
            init = f
        promoted |= {(int(o), int(trk.objects.store.gen[o])) for o in np.where(trk.objects.store.valid)[0]}
        print(f"frame {f}: {trk.state}, keyframes {int(trk.map.kf_valid.sum())}, "
              f"landmarks {int(trk.objects.store.valid.sum())}", file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0
    truth = [seq.truth_Twc(f) for f in range(N)]

    def ate(traj):
        est = [(f, np.linalg.inv(T)) for f, T in traj if T is not None]
        return evaluate_ate_scaled(np.stack([T for _, T in est]), np.stack([truth[f] for f, _ in est]))

    traj = trk.final_trajectory()
    box_T, box_half = seq.scene.box_pose_scale()
    truth_cub = cb.Cuboid(jnp.asarray(box_T, dtype=jnp.float32), jnp.asarray(box_half, dtype=jnp.float32))
    st = trk.objects.store
    landmarks = []
    for o in np.where(st.valid)[0]:
        err = np.asarray(cb.min_log_error(cb.Cuboid(jnp.asarray(st.pose[o]), jnp.asarray(st.scale[o])), truth_cub))
        landmarks.append(dict(slot=int(o), centre=st.pose[o][:3, 3].tolist(), scale=st.scale[o].tolist(),
                              centre_err_m=float(np.linalg.norm(st.pose[o][:3, 3] - box_T[:3, 3])),
                              min_log_error_norm=float(np.linalg.norm(err))))
    print(json.dumps(dict(
        frames=N, wh=list(wh), init_frame=init,
        tracked=sum(1 for _, T in traj if T is not None),
        keyframes=int(trk.map.kf_valid.sum()), map_points=int(trk.map.mp_valid.sum()),
        landmarks_alive=len(landmarks), landmarks_promoted=len(promoted),
        mono_scale_initialized=bool(trk.mono_scale_initialized), landmark=landmarks,
        ate_final_m=ate(traj), ate_tracked_m=ate(trk.trajectory), cpu_seconds=wall)))


if __name__ == "__main__":
    main()
