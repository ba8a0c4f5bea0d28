"""The KITTI gates in the JAX package under 1-ulp perturbations and in the
port: the source of the bounds of tests/test_torch_kitti.py,
tests/test_torch_kitti_stereo.py and chip_smoke.py's phase 12C.

    JAX_PLATFORMS=cpu python tools/kitti_gate_spread.py [--gate mono|stereo|mono-entry|stereo-entry]
        [--bootstrap object|depth] [--perturbations 12] [--at init|keyframes] [--from-frame F]
        [--perturb-port] [--steps] [--frames]

The mono gate (torch_parity_utils.kitti_mono_sequence: tests/test_kitti_mode.py:37's
scene, 14 frames 320x240, the box as offline cuboid with tracklet 7, the
car prior = the box's half extents, ground recovery every 3 keyframes)
runs through the JAX KittiMonoTracker with its local-BA fold forced
synchronous: once as it is, and once for each 1-ulp perturbation of its
state right after each initialization (`perturbations`): every map point
up or down, every keyframe translation up or down, and seeded draws moving
each map point coordinate up, down or not. With `--at keyframes` the same
perturbation is applied again after every keyframe step, as the port's
rounding differs from JAX's at every step, not only at the start; with
`--perturb-port` the port's runs are perturbed instead, each still set
against JAX's unperturbed run. Two-view initialization never succeeds on
this scene (tests/test_kitti_mode.py fails with "nothing tracked" on the
CPU), so the map is bootstrapped from the first frame: from the object's
ray-cuboid depth (`--bootstrap object`, firstframe_depth_init) or from the
rendered depth of frame 0 (`--bootstrap depth`, first_depth). The port
runs the same frames from scratch, and carried from JAX's unperturbed
state at its last initialization (torch_parity_utils.carry_kitti_tracker).
With `--from-frame F` the perturbations (and the port's carry) happen just
before frame F instead: the spread of the rest of the run from JAX's state
there.

`--gate stereo` does the same for the stereo gate
(torch_parity_utils.kitti_stereo_sequence: tests/test_rgbd_stereo.py:71's
scene, 10 pairs, tracklet 4), which needs no bootstrap and has no anchor.
`--gate mono-entry` / `stereo-entry` do it for the runs that the tests
and phase 12C make through the two entry points
(torch_parity_utils.kitti_entry_sequence and kitti_entry_tracker: the
gates' frames as uint8 PNGs give them back, the default car prior and
depth range; mono with the object-depth bootstrap).

For each run it prints the tracked frames, the keyframes' frames, the
applied anchor scales, the ground recoveries, the largest difference of a
final-trajectory pose (Tcw entries, and rotation entries alone) and of a
camera centre from the unperturbed JAX run's on the frames both tracked,
the landmark's distance from JAX's, its yaw's difference (as the cuboid
file writes it, modulo the half turn that maps a cuboid onto itself) and
its half-scale, and the unaligned metric ATE. Its last line is the
spread's radius, per quantity the largest gap of a perturbed run from the
unperturbed one (the bound of a comparison with JAX's run), and its
diameter, the largest gap between any two of the runs.

`--steps` (the mono gate, object bootstrap) goes one keyframe step at a
time: at each keyframe of JAX's unperturbed run the step
(_create_keyframe: the plain keyframe step, the anchor, the offline
objects, the object BA and the ground recovery) runs from JAX's state in
JAX, in the port carried from that state, and in copies of JAX's state
under the first 8 perturbations; each prints its largest differences from
JAX's step in the landmark's pose entries and half-scale, the keyframe
poses, the map points and the relative anchor scale. `--frames` does the
same for every frame: from JAX's state just before it, the port and 8
perturbed copies track that frame, and each prints its gaps from JAX's
step in the pose returned, the motion model, the keyframe decision, the
anchors, the tracked inliers and the associations handed to the next
frame (from which the device tracker state re-seeds).

Each takes 2-10 minutes on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch_parity_utils as tpu  # noqa: E402

from cube_slam_tpu_torch.utils import np_geometry as np_geo  # noqa: E402

import cube_slam_tpu.slam as jslam  # noqa: E402
import cube_slam_tpu.slam.ground  # noqa: E402,F401
import cube_slam_tpu.slam.kitti  # noqa: E402,F401
import cube_slam_tpu_torch.slam as tslam  # noqa: E402
import cube_slam_tpu_torch.slam.ground  # noqa: E402,F401
import cube_slam_tpu_torch.slam.kitti  # noqa: E402,F401

FIXED = ["map points +1 ulp", "map points -1 ulp", "keyframe translations +1 ulp", "keyframe translations -1 ulp"]


def perturbations(n):
    """The first n perturbations: the four fixed ones, then seeded draws."""
    return (FIXED + [f"random map point coordinates, seed {s}" for s in range(max(n - len(FIXED), 0))])[:n]


def perturb(trk, kind):
    m = trk.map
    ids = np.where(m.mp_valid)[0]
    if kind.startswith("map points"):
        m.mp_pos[ids] = np.nextafter(m.mp_pos[ids], np.float32(np.inf if "+" in kind else -np.inf))
    elif kind.startswith("keyframe"):
        k = m.kf_ids()
        t = m.kf_tcw[k, :3, 3]
        m.kf_tcw[k, :3, 3] = np.nextafter(t, np.float32(np.inf if "+" in kind else -np.inf))
    else:
        step = np.random.default_rng(int(kind.rsplit(" ", 1)[1])).integers(-1, 2, size=(len(ids), 3))
        p = m.mp_pos[ids]
        m.mp_pos[ids] = np.where(step > 0, np.nextafter(p, np.float32(np.inf)),
                                 np.where(step < 0, np.nextafter(p, np.float32(-np.inf)), p))
    trk._bump_map()


def bootstrap_kw(kind, scene, poses):
    if kind == "object":
        return dict(firstframe_depth_init=True)
    return dict(first_depth=scene.render(poses[0], tpu.GATE_A_K, wh=(320, 240), return_depth=True)[1])


def outcome(trk, poses, T_obj, tid=7):
    traj = trk.final_trajectory()
    st = trk.objects.store
    o = trk.objects.trackletid_to_landmark.get(tid, -1)
    entries = [(f, T) for f, T in traj if T is not None]
    G = poses[entries[0][0]] @ np.asarray(entries[0][1], dtype=np.float64) if entries else np.eye(4)
    errs = [np.linalg.norm((G @ np.linalg.inv(np.asarray(T, dtype=np.float64)))[:3, 3] - poses[f][:3, 3])
            for f, T in entries[1:]]
    lm = None if o < 0 or not st.valid[o] else st.pose[o][:3, 3].astype(np.float64)
    yaw = None if lm is None else float(np_geo.rot_to_euler_zyx(st.pose[o][:3, :3].astype(np.float64))[2])
    return dict(tracked=[f for f, _ in entries],
                kf_frames=sorted(int(trk.map.kf_frame_id[k]) for k in trk.map.kf_ids()),
                anchors=[float(s) for s in getattr(trk, "_anchor_scales", [])],
                recoveries=int(getattr(trk, "n_scale_recoveries", 0)),
                Tcw={f: np.asarray(T, dtype=np.float64) for f, T in entries}, landmark=lm,
                landmark_scale=None if lm is None else st.scale[o].tolist(), landmark_yaw=yaw,
                landmark_to_truth_m=None if lm is None else float(np.linalg.norm((G @ np.append(lm, 1.0))[:3]
                                                                                  - T_obj[:3, 3])),
                metric_ate_m=float(np.sqrt(np.mean(np.square(errs)))) if errs else None)


def run(trk, frames, on_init=None, on_keyframe=None, before=None, start=0):
    """Track `frames` (numbered from `start`); `on_init(trk, f)` runs after
    each initialization, `on_keyframe(trk, f)` after each frame that made a
    keyframe (its local BA folded first), `before = (F, hook)` calls
    hook(trk, F) just before frame F (the fold applied first). Returns the
    initialization frames."""
    init_frames = []
    for f, args in enumerate(frames, start):
        if before is not None and f == before[0]:
            trk._apply_pending_map()
            before[1](trk, f)
        was = trk.state
        trk.track(*(args if isinstance(args, tuple) else (args,)))
        if was == "NOT_INITIALIZED" and trk.state == "OK":
            init_frames.append(f)
            if on_init is not None:
                on_init(trk, f)
        elif on_keyframe is not None and trk.state == "OK" and trk.last_kf_frame_id == f:
            trk._apply_pending_map()
            on_keyframe(trk, f)
    trk.flush()
    return init_frames


def gaps(out, ref):
    """How far two runs' outcomes are apart."""
    common = [f for f in out["tracked"] if f in ref["Tcw"]]
    lm = (None if out["landmark"] is None or ref["landmark"] is None
          else float(np.linalg.norm(out["landmark"] - ref["landmark"])))
    a, b = out["anchors"], ref["anchors"]
    return dict(
        tracked=int(out["tracked"] != ref["tracked"]), keyframes=abs(len(out["kf_frames"]) - len(ref["kf_frames"])),
        anchors=abs(len(a) - len(b)), anchor=abs(a[1] / b[1] - 1.0) if len(a) > 1 and len(b) > 1 else 0.0,
        later_anchors=max((abs(x / y - 1.0) for x, y in zip(a[2:], b[2:])), default=0.0),
        recoveries=abs(out["recoveries"] - ref["recoveries"]),
        pose=max((float(np.abs(out["Tcw"][f] - ref["Tcw"][f]).max()) for f in common), default=0.0),
        rotation=max((float(np.abs(out["Tcw"][f][:3, :3] - ref["Tcw"][f][:3, :3]).max()) for f in common),
                     default=0.0),
        centre=max((float(np.linalg.norm(np.linalg.inv(out["Tcw"][f])[:3, 3] - np.linalg.inv(ref["Tcw"][f])[:3, 3]))
                    for f in common), default=0.0),
        landmark=lm,
        # modulo pi: the half turn about the box's up axis maps it onto itself
        yaw=None if lm is None else float(abs((out["landmark_yaw"] - ref["landmark_yaw"] + np.pi / 2) % np.pi
                                              - np.pi / 2)),
        scale=None if lm is None else float(np.abs(np.subtract(out["landmark_scale"], ref["landmark_scale"])).max()))


def radius(outs):
    """The largest gap of any of `outs[1:]` from `outs[0]` (the unperturbed
    JAX run), per quantity: how far the perturbed runs land from it, the
    bound of a comparison with that run."""
    worst = {}
    for out in outs[1:]:
        for k, v in gaps(out, outs[0]).items():
            if v is not None:
                worst[k] = max(worst.get(k, 0.0), v)
    return worst


def diameter(outs):
    """The largest gap between any two of `outs`, per quantity: how far
    apart two runs of the spread can land (another build of either package
    lands its unperturbed run anywhere in it)."""
    worst = {}
    for i in range(len(outs)):
        for j in range(i):
            for k, v in gaps(outs[i], outs[j]).items():
                if v is not None:
                    worst[k] = max(worst.get(k, 0.0), v)
    return worst


def report(name, out, ref):
    row = dict(run=name, tracked=out["tracked"], kf_frames=out["kf_frames"], anchors=out["anchors"],
               recoveries=out["recoveries"], gap_to_jax=gaps(out, ref), landmark_scale=out["landmark_scale"],
               landmark_to_truth_m=out["landmark_to_truth_m"], metric_ate_m=out["metric_ate_m"])
    print(json.dumps(row), flush=True)
    return row


def _step_outcome(t):
    st = t.objects.store
    return st.pose.copy(), st.scale.copy(), t.map.kf_tcw.copy(), t.map.mp_pos.copy(), list(t._anchor_scales)


def _step_gaps(a, b):
    anchor = abs(a[4][-1] / b[4][-1] - 1.0) if a[4] and b[4] and len(a[4]) == len(b[4]) else None
    return dict(landmark_pose=float(np.abs(a[0] - b[0]).max()), landmark_scale=float(np.abs(a[1] - b[1]).max()),
                kf_tcw=float(np.abs(a[2] - b[2]).max()), mp_pos=float(np.abs(a[3] - b[3]).max()),
                anchors=[len(a[4]), len(b[4])], anchor_rel=anchor)


def steps(n_perturb):
    """Each keyframe step of the object-bootstrap gate from JAX's state: the
    port's and the perturbed JAX copies' differences from JAX's step."""
    from cube_slam_tpu.slam import kitti as jk
    from cube_slam_tpu.slam import state as jstate
    from cube_slam_tpu_torch.slam import state as tstate

    fields = ("xy", "level", "angle", "desc", "valid")
    base = tpu.sync_fold(jk.KittiMonoTracker)

    class Hooked(base):
        def _create_keyframe(self, feats, fid=None):
            self._apply_pending_map()
            h = {k: getattr(feats, k).copy() for k in fields}
            mp = feats.mp.copy()
            port = tpu.carry_kitti_tracker(self)
            copies = []
            for kind in perturbations(n_perturb):
                c = copy.deepcopy(self)
                c.__class__ = base
                perturb(c, kind)
                copies.append((kind, c))
            port._create_keyframe(tstate.FrameFeatures(**{k: v.copy() for k, v in h.items()}, mp=mp.copy()), fid=fid)
            super()._create_keyframe(feats, fid=fid)
            ref = _step_outcome(self)
            print(json.dumps(dict(step=fid, run="port", **_step_gaps(_step_outcome(port), ref))), flush=True)
            for kind, c in copies:
                base._create_keyframe(c, jstate.FrameFeatures(**{k: v.copy() for k, v in h.items()}, mp=mp.copy()),
                                      fid=fid)
                print(json.dumps(dict(step=fid, run=f"jax, {kind}", **_step_gaps(_step_outcome(c), ref))), flush=True)

    frames, poses, offline, _ = tpu.kitti_mono_sequence()
    J = tpu.kitti_mono_tracker(jslam, offline, poses[0], firstframe_depth_init=True)
    J.__class__ = Hooked
    for gray in frames:
        J.track(gray)


def _frame_outcome(t, out):
    return dict(Tcw=None if out is None else np.asarray(out, dtype=np.float64),
                velocity=t.velocity.astype(np.float64), keyframe=t.last_kf_frame_id, anchors=len(t._anchor_scales),
                inliers=int(t.tracked_inliers), assoc=0 if t.last_frame is None else int((t.last_frame.mp >= 0).sum()))


def _frame_gaps(a, b):
    both = a["Tcw"] is not None and b["Tcw"] is not None
    return dict(tracked=int((a["Tcw"] is None) != (b["Tcw"] is None)), keyframe=int(a["keyframe"] != b["keyframe"]),
                anchors=abs(a["anchors"] - b["anchors"]),
                pose=float(np.abs(a["Tcw"] - b["Tcw"]).max()) if both else None,
                velocity=float(np.abs(a["velocity"] - b["velocity"]).max()),
                inliers=abs(a["inliers"] - b["inliers"]), assoc=abs(a["assoc"] - b["assoc"]))


def frames_mode(n_perturb):
    """Each frame of the object-bootstrap gate from JAX's state just before
    it: the port carried from that state, and copies of it under the first
    `n_perturb` perturbations; their gaps from JAX's own step of that frame
    in the pose it returns, the motion model, the keyframe decision, the
    anchors, the tracked inliers and the associations it hands the next
    frame (the device state re-seeds from those three)."""
    frames, poses, offline, _ = tpu.kitti_mono_sequence()
    J = tpu.kitti_mono_tracker(jslam, offline, poses[0], firstframe_depth_init=True)
    for f, gray in enumerate(frames):
        J._apply_pending_map()
        if J.state == "OK":
            snap = copy.deepcopy(J)
            port = tpu.carry_kitti_tracker(snap)
            port.__class__ = tpu.sync_fold(type(port))
            ref = _frame_outcome(J, J.track(gray))
            print(json.dumps(dict(frame=f, run="port", **_frame_gaps(_frame_outcome(port, port.track(gray)), ref))),
                  flush=True)
            for kind in perturbations(n_perturb):
                c = copy.deepcopy(snap)
                perturb(c, kind)
                print(json.dumps(dict(frame=f, run=f"jax, {kind}", **_frame_gaps(_frame_outcome(c, c.track(gray)), ref))),
                      flush=True)
        else:
            J.track(gray)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", choices=["mono", "stereo", "mono-entry", "stereo-entry"], default="mono")
    ap.add_argument("--bootstrap", choices=["object", "depth"], default="object", help="the mono gate's")
    ap.add_argument("--perturbations", type=int, default=12)
    ap.add_argument("--at", choices=["init", "keyframes"], default="init",
                    help="perturb after each initialization, or also after each keyframe step")
    ap.add_argument("--perturb-port", action="store_true",
                    help="perturb the port's runs instead of JAX's (each still against JAX's unperturbed run)")
    ap.add_argument("--from-frame", type=int, default=None,
                    help="perturb just before this frame instead of after each initialization")
    ap.add_argument("--steps", action="store_true", help="only the keyframe steps, 8 perturbations each")
    ap.add_argument("--frames", action="store_true", help="only the per-frame steps, 8 perturbations each")
    args = ap.parse_args()
    if args.steps:
        steps(8)
        return
    if args.frames:
        frames_mode(8)
        return

    if args.gate == "stereo":
        frames, poses, offline, scene = tpu.kitti_stereo_sequence()
        tid = 4

        def make(pkg, **kw):
            return tpu.kitti_stereo_tracker(pkg, offline, poses[0], **kw)
    elif args.gate.endswith("-entry"):
        entry = args.gate.split("-")[0]
        frames, poses, offline, scene = tpu.kitti_entry_sequence(entry)
        tid = 4 if entry == "stereo" else 7
        times = 0.1 * np.arange(len(frames))

        def make(pkg, **kw):
            return tpu.kitti_entry_tracker(pkg, entry, offline, poses[0], times, **kw)
    else:
        frames, poses, offline, scene = tpu.kitti_mono_sequence()
        tid = 7

        def make(pkg, **kw):
            return tpu.kitti_mono_tracker(pkg, offline, poses[0], **bootstrap_kw(args.bootstrap, scene, poses), **kw)
    T_obj, _ = scene.box_pose_scale()
    J = make(jslam)
    snaps = {}
    F = args.from_frame
    carry = lambda t, f: snaps.__setitem__(f, (tpu.carry_kitti_tracker(t), f))  # noqa: E731
    inits = run(J, frames, on_init=None if F is not None else carry, before=None if F is None else (F, carry))
    ref = outcome(J, poses, T_obj, tid)
    report("jax", ref, ref)
    outs = [ref]
    for kind in perturbations(args.perturbations):
        Jp = make(tslam, device="cpu") if args.perturb_port else make(jslam)
        hook = lambda t, f, kind=kind: perturb(t, kind)  # noqa: E731
        after_kf = hook if args.at == "keyframes" else None
        if F is None:
            run(Jp, frames, on_init=hook, on_keyframe=after_kf)
        else:
            run(Jp, frames, on_keyframe=lambda t, f: after_kf and f >= F and after_kf(t, f), before=(F, hook))
        outs.append(outcome(Jp, poses, T_obj, tid))
        report(("port, " if args.perturb_port else "jax, ") + kind
               + ("" if F is None else f", before frame {F}")
               + (", at every keyframe" if args.at == "keyframes" else ""),
               outs[-1], ref)
    P = make(tslam, device="cpu")
    run(P, frames)
    report("port", outcome(P, poses, T_obj, tid), ref)
    # the port carried from JAX's state at its last initialization (or just
    # before frame F)
    Pc, f0 = snaps[inits[-1] if F is None else F]
    Pc.__class__ = tpu.sync_fold(type(Pc))
    if F is None:
        run(Pc, frames[f0 + 1:], start=f0 + 1)
        report(f"port carried at frame {f0}", outcome(Pc, poses, T_obj, tid), ref)
    else:
        run(Pc, frames[F:], start=F)
        report(f"port carried before frame {F}", outcome(Pc, poses, T_obj, tid), ref)
    print(json.dumps(dict(radius=radius(outs), diameter=diameter(outs), runs=len(outs))), flush=True)


if __name__ == "__main__":
    main()
