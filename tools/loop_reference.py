#!/usr/bin/env python3
"""Run the JAX package's ObjectSlamTracker with loop closing over the
sequence that chip_smoke.py's phase 10A gives the port, then phase 10B's
drift injection and loop closure on the revisit keyframe, on the CPU; print
the outcome as one JSON line: the reference for the port's numbers there.

    JAX_PLATFORMS=cpu python tools/loop_reference.py [--wh 640 480]

Setup as phase 10: chip_smoke.loop_sequence (the 61-frame there-and-back
orbit of tests/test_full_system.py over the synthetic room box, TUM-cabinet
intrinsics scaled to the width), chip_smoke.loop_config (1500 features x 8
levels, loop closing with its global BA, candidates 6 keyframes apart),
ground_Twc0 = the first truth pose, the truth box as the 2D box and the JAX
package's LSD lines; then chip_smoke.inject_loop_drift and
_try_close_loop on the revisit keyframe it picks. The local-BA fold is forced
synchronous, as in the port's tests. Times are host seconds on the CPU and
say nothing of any device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--wh", type=int, nargs=2, default=(640, 480))
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import chip_smoke as cs
    from cube_slam_tpu.ops import lsd
    from cube_slam_tpu.slam import loop_closing as lc
    from cube_slam_tpu.slam import system as jsys
    from cube_slam_tpu.slam.tracking import evaluate_ate_scaled

    seq = cs.loop_sequence(wh=tuple(args.wh))
    N = seq.num_frames

    class SyncFold(jsys.ObjectSlamTracker):
        def _apply_pending_map(self, only_if_ready=False):
            return super()._apply_pending_map(only_if_ready=False)

    trk = SyncFold(seq.K, seq.wh, cs.loop_config(jsys.TrackerConfig), ground_Twc0=seq.truth_Twc(0))
    with cs.LoopClosures(trk, lc) as closures:
        init, promoted, t0 = None, set(), time.perf_counter()
        for f in range(N):
            g = seq.gray(f)
            ln, lv = lsd.detect_lines(jnp.asarray(g, dtype=jnp.float32), min_length=15.0, max_lines=128)
            boxes = seq.yolo_boxes(f)
            out = trk.track(g, bboxes_2d=boxes[:, :4] if len(boxes) else None, lines=np.array(ln)[np.array(lv)])
            if out is not None and init is None:
                init = f
            promoted |= {(int(o), int(trk.objects.store.gen[o])) for o in np.where(trk.objects.store.valid)[0]}
            print(f"frame {f}: {trk.state}, keyframes {int(trk.map.kf_valid.sum())}, loops {trk.loops_closed}, "
                  f"landmarks {int(trk.objects.store.valid.sum())}", file=sys.stderr, flush=True)
        wall = time.perf_counter() - t0
        truth = [seq.truth_Twc(f) for f in range(N)]
        traj = trk.final_trajectory()
        est = [(f, np.linalg.inv(T)) for f, T in traj if T is not None]
        ate = evaluate_ate_scaled(np.stack([T for _, T in est]), np.stack([truth[f] for f, _ in est]))
        st = trk.objects.store
        box_T, _ = seq.scene.box_pose_scale()
        landmarks = [dict(slot=int(o), centre=st.pose[o][:3, 3].tolist(), scale=st.scale[o].tolist(),
                          centre_err_m=float(np.linalg.norm(st.pose[o][:3, 3] - box_T[:3, 3])))
                     for o in np.where(st.valid)[0]]
        result = dict(frames=N, wh=list(seq.wh), init_frame=init, tracked=len(est),
                      keyframes=int(trk.map.kf_valid.sum()), map_points=int(trk.map.mp_valid.sum()),
                      landmarks_alive=len(landmarks), landmarks_promoted=len(promoted), landmark=landmarks,
                      mono_scale_initialized=bool(trk.mono_scale_initialized), loops_closed=trk.loops_closed,
                      closures=list(closures.rows), ate_final_m=ate, cpu_seconds=wall)

        inj = cs.inject_loop_drift(trk)
        k_rev = inj["k_rev"]
        before, n_closures = trk.loops_closed, len(closures.rows)
        trk.frame_id += 1
        trk.last_Tcw = trk.map.kf_tcw[k_rev].copy()
        trk._try_close_loop(k_rev, trk.map.covisibility_counts(k_rev))
        result["drift"] = dict(keyframes=len(inj["kfs"]), revisit=int(k_rev), partner=int(inj["partner"]),
                               shared=inj["shared"], duplicates=inj["n_dups"], cross_duplicates=inj["n_cross"],
                               closed=trk.loops_closed > before,
                               closure=closures.rows[-1] if len(closures.rows) > n_closures else None,
                               kf_ate_drifted_m=inj["ate_drifted"], kf_ate_closed_m=inj["kf_ate"](),
                               landmark_err_drifted_m=inj["obj_err_drifted"], landmark_err_closed_m=inj["obj_err"](),
                               trajectory_ate_drifted_m=inj["traj_ate_drifted"],
                               trajectory_ate_closed_m=inj["traj_ate"]())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
