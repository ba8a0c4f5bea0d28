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

The dynamic gates (`--gate dynamic-rgbd|dynamic-kitti|dynamic-kitti-entry`,
torch_parity_utils.dynamic_gate: the moving box of
tests/test_dynamic_tracker.py and tests/test_kitti_dynamic.py, 12 frames
320x240) run the same way: JAX's DynamicRgbdTracker or
KittiMonoTracker(dynamic=True) (its fold forced synchronous) once as it is
and once per perturbation, then the port from scratch. dynamic-kitti-entry
is the run phase 13C makes through run_kitti_sequence(dynamic=True): the
frames as uint8 grey levels, 0.1 s apart, the bootstrap from frame 0's
depth and the box's half extents as the car prior. Each run
prints its tracked frames and keyframes, the largest gaps from JAX's
unperturbed run in the cameras (centres in the truth world, rotation
entries) and in the object (its per-keyframe positions on the keyframes
both runs hold, the speed, the steering angle, the median position error
against the truth and the displacement over the observed span), and the
last line the radius and diameter. With `--steps` a dynamic gate goes one
dynamic BA at a time instead: at each run_dynamic_ba of JAX's run, the
port carried from JAX's state and 24 copies of JAX's state with the
chains' per-keyframe translations, velocities and the keyframe
translations moved by up to 1 ulp take the same step; each prints its
gaps from JAX's step in the cameras, the object poses, the speed, the
steering angle and the final cost (relative), and the last line the
radius over all steps. `--two-stage` takes the RGBD gate's final JAX
manager and map and solves one dynamic BA with the point edges on
(ba_pt_obj_cam: the two-stage solve with chi-square pruning) at point-edge
capacities 1024, 40 and 20, in JAX, in the port carried from that state,
and in 32 copies perturbed as `--steps` perturbs; gaps in the cameras, the
object's points in the world (gauge-free), its motion since its first
keyframe and its velocity. `--kf-steps` does the same for the whole keyframe
step of the dynamic tracker (_create_keyframe: the static keyframe step and
its local BA, then the manager's keyframe snapshot and dynamic BA), from
JAX's state at each keyframe in the port (torch_parity_utils.carry_tracker
/ carry_kitti_tracker) and in 16 copies with the map points, the keyframe
translations, the chains' per-keyframe translations and velocities moved
by up to 1 ulp; gaps in the keyframe poses, the map points (the largest,
the median and the 90th percentile over the points both keep), the
object's per-keyframe poses and its velocity.

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


DYNAMIC_GATES = ("dynamic-rgbd", "dynamic-kitti", "dynamic-kitti-entry")


def dynamic_tracker(gate, pkg, g, device=None, manager=None):
    """The dynamic gate's tracker of the package whose slam module is
    `pkg` (its fold forced synchronous) and the per-frame track() inputs."""
    import importlib

    dyn = importlib.import_module(pkg.__name__ + ".dynamic")
    kitti = importlib.import_module(pkg.__name__ + ".kitti")
    if gate == "dynamic-rgbd":
        t = tpu.dynamic_rgbd_tracker(dyn, g, device=device, manager=manager)
        dets = tpu.dynamic_gate_dets(g, dyn.DynamicDetection)
        return t, [(f, d, x) for f, d, x in zip(g["frames"], g["depths"], dets)]
    kw = {} if manager is None else dict(dyn_manager=manager)
    t = tpu.dynamic_kitti_tracker(kitti, g, device=device, **kw)
    if gate == "dynamic-kitti-entry":
        t.frame_stamps = 0.1 * np.arange(len(g["frames"]))
        return t, [(tpu.cs.kitti_grey(f),) for f in g["frames"]]
    return t, [(f,) for f in g["frames"]]


def dynamic_outcome(trk, g, gate):
    """A dynamic gate run's outcome: tracked frames, keyframes' frames,
    camera centres and rotations (truth world), and the object: its
    per-keyframe positions by frame, velocity, median position error and
    displacement over the observed span."""
    tid = 0 if gate == "dynamic-rgbd" else tpu.DYNAMIC_GATE_TID
    W = np.eye(4) if gate == "dynamic-rgbd" else g["poses"][0]
    entries = [(f, np.asarray(T, dtype=np.float64)) for f, T in trk.final_trajectory() if T is not None]
    Twc = {f: W @ np.linalg.inv(T) for f, T in entries}
    m = trk.map
    out = dict(tracked=[f for f, _ in entries], kf_frames=sorted(int(m.kf_frame_id[k]) for k in m.kf_ids()),
               Twc=Twc, obj={}, velocity=None, median_err=None, disp=None,
               metric_ate_m=float(np.sqrt(np.mean([np.sum((Twc[f][:3, 3] - g["poses"][f][:3, 3]) ** 2)
                                                   for f in Twc]))))
    ch = trk.dynamic.chains.get(tid)
    if ch is not None and ch.kf_pose:
        out["obj"] = {int(m.kf_frame_id[k]): p[:3, 3].astype(np.float64) for k, p in ch.kf_pose.items()}
        out["velocity"] = ch.velocity.astype(np.float64)
        out["median_err"] = float(np.median([np.linalg.norm(p - g["true_obj"][f][:3, 3])
                                             for f, p in out["obj"].items()]))
        f0, f1 = min(out["obj"]), max(out["obj"])
        out["disp"] = out["obj"][f1] - out["obj"][f0]
    return out


def dynamic_gaps(out, ref):
    common = [f for f in out["Twc"] if f in ref["Twc"]]
    objs = [f for f in out["obj"] if f in ref["obj"]]
    have = out["velocity"] is not None and ref["velocity"] is not None
    return dict(
        tracked=int(out["tracked"] != ref["tracked"]), keyframes=abs(len(out["kf_frames"]) - len(ref["kf_frames"])),
        centre=max((float(np.linalg.norm(out["Twc"][f][:3, 3] - ref["Twc"][f][:3, 3])) for f in common), default=0.0),
        rotation=max((float(np.abs(out["Twc"][f][:3, :3] - ref["Twc"][f][:3, :3]).max()) for f in common),
                     default=0.0),
        object=max((float(np.linalg.norm(out["obj"][f] - ref["obj"][f])) for f in objs), default=0.0),
        object_kfs=abs(len(out["obj"]) - len(ref["obj"])),
        speed=abs(out["velocity"][0] - ref["velocity"][0]) if have else None,
        steer=abs(out["velocity"][1] - ref["velocity"][1]) if have else None,
        median_err=abs(out["median_err"] - ref["median_err"]) if have else None,
        disp=float(np.abs(out["disp"] - ref["disp"]).max()) if have else None,
        metric_ate=abs(out["metric_ate_m"] - ref["metric_ate_m"]))


def _worst(pairs):
    worst = {}
    for a, b in pairs:
        for k, v in dynamic_gaps(a, b).items():
            if v is not None:
                worst[k] = max(worst.get(k, 0.0), float(v))
    return worst


def dynamic_report(name, out, ref):
    print(json.dumps(dict(run=name, tracked=out["tracked"], kf_frames=out["kf_frames"],
                          velocity=None if out["velocity"] is None else out["velocity"].tolist(),
                          median_err=out["median_err"], metric_ate_m=out["metric_ate_m"],
                          gap_to_jax=dynamic_gaps(out, ref))), flush=True)


def dynamic_spread(gate, n_perturb, at):
    """The whole dynamic gate: JAX unperturbed, JAX perturbed, the port."""
    g = tpu.dynamic_gate()
    outs = []
    for i, kind in enumerate([None] + perturbations(n_perturb)):
        J, inputs = dynamic_tracker(gate, jslam, g)
        hook = None if kind is None else (lambda t, f, kind=kind: perturb(t, kind))
        _run_dynamic(J, inputs, hook, at)
        outs.append(dynamic_outcome(J, g, gate))
        dynamic_report("jax" if kind is None else f"jax, {kind}" + (", at every keyframe" if at == "keyframes" else ""),
                       outs[-1], outs[0])
    P, inputs = dynamic_tracker(gate, tslam, g, device="cpu")
    _run_dynamic(P, inputs, None, at)
    dynamic_report("port", dynamic_outcome(P, g, gate), outs[0])
    print(json.dumps(dict(radius=_worst((o, outs[0]) for o in outs[1:]),
                          diameter=_worst((outs[i], outs[j]) for i in range(len(outs)) for j in range(i)),
                          runs=len(outs))), flush=True)


def _run_dynamic(trk, inputs, hook, at):
    """Track `inputs`; hook(trk, f) after the initialization and, with
    at == "keyframes", after each keyframe step (its fold applied first)."""
    for f, args in enumerate(inputs):
        was = trk.state
        trk.track(*args)
        if hook is None:
            continue
        if was == "NOT_INITIALIZED" and trk.state == "OK":
            hook(trk, f)
        elif at == "keyframes" and trk.state == "OK" and trk.last_kf_frame_id == f:
            trk._apply_pending_map()
            hook(trk, f)
    trk.flush()


def _nudge(a, r):
    step = r.integers(-1, 2, size=a.shape)
    return np.where(step > 0, np.nextafter(a, np.float32(np.inf)),
                    np.where(step < 0, np.nextafter(a, np.float32(-np.inf)), a)).astype(np.float32)


def dynamic_steps(gate, n_perturb):
    """Each dynamic BA of JAX's run on the gate: JAX's step, the port's from
    the carried state and n_perturb 1-ulp perturbed JAX copies."""
    from cube_slam_tpu.slam import dynamic as jdyn
    from cube_slam_tpu_torch.slam import dynamic as tdyn
    from cube_slam_tpu_torch.slam import state as tstate

    costs = {}

    def capture(mod, key):
        orig = mod.dynamic_object_ba

        def wrapped(*a, **k):
            out = orig(*a, **k)
            costs[key] = float(out[4])
            return out
        mod.dynamic_object_ba = wrapped

    capture(jdyn, "jax")
    capture(tdyn, "port")

    def state(mgr, m):
        return (m.kf_tcw.copy(), {tid: ({k: v.copy() for k, v in ch.kf_pose.items()}, ch.velocity.copy())
                                  for tid, ch in mgr.chains.items()})

    def gaps_of(a, b, ca, cb):
        pose = [np.abs(a[1][t][0][k] - b[1][t][0][k]).max() for t in a[1] for k in a[1][t][0]]
        return dict(cam=float(np.abs(a[0] - b[0]).max()), pose=float(max(pose, default=0.0)),
                    speed=float(max((abs(a[1][t][1][0] - b[1][t][1][0]) for t in a[1]), default=0.0)),
                    steer=float(max((abs(a[1][t][1][1] - b[1][t][1][1]) for t in a[1]), default=0.0)),
                    cost_rel=abs(ca / cb - 1.0) if cb else 0.0)

    worst_jax, worst_port = {}, {}

    class Rec(jdyn.DynamicObjectManager):
        def run_dynamic_ba(self, m, K, static_edges_fn=None):
            perturbed = []
            for s in range(n_perturb):
                c, mc = copy.deepcopy(self), copy.deepcopy(m)
                r = np.random.default_rng(s)
                for ch in c.chains.values():
                    for k, p in ch.kf_pose.items():
                        p[:3, 3] = _nudge(p[:3, 3], r)
                    ch.velocity = _nudge(ch.velocity, r)
                k = mc.kf_ids()
                mc.kf_tcw[k, :3, 3] = _nudge(mc.kf_tcw[k, :3, 3], r)
                w = jdyn.DynamicObjectManager.run_dynamic_ba(c, mc, K,
                                                             static_edges_fn=lambda w: jdyn.static_anchor_edges(mc, w))
                perturbed.append((w, state(c, mc), costs.pop("jax", 0.0)))
            port, pm = tpu.carry_dynamic_manager(self), tstate.map_state_from_arrays(vars(m))
            wp = port.run_dynamic_ba(pm, K, static_edges_fn=lambda w: tdyn.static_anchor_edges(pm, w))
            w = super().run_dynamic_ba(m, K, static_edges_fn=static_edges_fn)
            if w is None:
                return w
            ref, cref = state(self, m), costs.pop("jax")
            gp = gaps_of(state(port, pm), ref, costs.pop("port"), cref)
            gj = [gaps_of(st, ref, c, cref) for ww, st, c in perturbed if ww == w]
            for d, gs in ((worst_port, [gp]), (worst_jax, gj)):
                for gg in gs:
                    for kk, v in gg.items():
                        d[kk] = max(d.get(kk, 0.0), v)
            print(json.dumps(dict(step=int(m.kf_frame_id[w[-1]]), same_window=wp == w, port=gp,
                                  jax_radius={kk: max(gg[kk] for gg in gj) for kk in gp})), flush=True)
            return w

    g = tpu.dynamic_gate()
    J, inputs = dynamic_tracker(gate, jslam, g, manager=Rec(**({} if gate == "dynamic-rgbd"
                                                               else dict(world_T_slam=g["poses"][0]))))
    for args in inputs:
        J.track(*args)
    print(json.dumps(dict(steps_radius=worst_jax, port_worst=worst_port)), flush=True)


def _copy_dynamic(trk, gate, g):
    """A deep copy of a JAX dynamic gate tracker. DynamicRgbdTracker's inner
    class closes over its own outer tracker, so its copy is a new tracker
    given copies of the state."""
    if gate != "dynamic-rgbd":
        return copy.deepcopy(trk)
    c, _ = dynamic_tracker(gate, jslam, g)
    c._impl.__dict__.update(copy.deepcopy(trk._impl.__dict__))
    c.dynamic = copy.deepcopy(trk.dynamic)
    c._pending_dyn = trk._pending_dyn
    return c


def dynamic_kf_steps(gate, n_perturb):
    """Each keyframe step of JAX's dynamic tracker from its state: the
    port's and the perturbed JAX copies' gaps from JAX's step."""
    from cube_slam_tpu.slam import state as jstate
    from cube_slam_tpu_torch.slam import state as tstate

    fields = ("xy", "level", "angle", "desc", "valid")

    def state(t):
        mgr = t.dynamic
        return (t.map.kf_tcw.copy(), t.map.mp_pos.copy(), t.map.mp_valid.copy(),
                {tid: ({k: v.copy() for k, v in ch.kf_pose.items()}, ch.velocity.copy())
                 for tid, ch in mgr.chains.items()})

    def gaps_of(a, b):
        pose = [np.abs(a[3][t][0][k] - b[3][t][0][k]).max() for t in b[3] for k in b[3][t][0] if k in a[3][t][0]]
        vel = [np.abs(a[3][t][1] - b[3][t][1]) for t in b[3]]
        both = a[2] & b[2]
        mp = np.abs(a[1] - b[1])[both].max(axis=1) if both.any() else np.zeros(1)
        return dict(kf_tcw=float(np.abs(a[0] - b[0]).max()), mp_pos=float(mp.max()),
                    mp_pos_median=float(np.median(mp)), mp_pos_p90=float(np.percentile(mp, 90)),
                    mp_valid=int((a[2] != b[2]).sum()), obj_pose=float(max(pose, default=0.0)),
                    speed=float(max((v[0] for v in vel), default=0.0)),
                    steer=float(max((v[1] for v in vel), default=0.0)))

    worst_jax, worst_port = {}, {}

    def hooked(base):
        class Hooked(base):
            def _create_keyframe(self, feats, fid=None):
                trk = outer[0]
                h = {k: getattr(feats, k).copy() for k in fields}
                mp = feats.mp.copy()
                port = tpu.carry_kitti_tracker(trk) if gate != "dynamic-rgbd" else tpu.carry_tracker(trk)
                port_impl = port._impl if gate == "dynamic-rgbd" else port
                port_impl.__class__ = tpu.sync_fold(type(port_impl))
                copies = []
                for s_ in range(n_perturb):
                    c = _copy_dynamic(trk, gate, g)
                    r = np.random.default_rng(s_)
                    m = c.map
                    ids = np.where(m.mp_valid)[0]
                    m.mp_pos[ids] = _nudge(m.mp_pos[ids], r)
                    k = m.kf_ids()
                    m.kf_tcw[k, :3, 3] = _nudge(m.kf_tcw[k, :3, 3], r)
                    for ch in c.dynamic.chains.values():
                        for kk, p in ch.kf_pose.items():
                            p[:3, 3] = _nudge(p[:3, 3], r)
                        ch.velocity = _nudge(ch.velocity, r)
                    c._bump_map()
                    copies.append(c)
                port_impl._create_keyframe(tstate.FrameFeatures(**{k: v.copy() for k, v in h.items()}, mp=mp.copy()),
                                           fid=fid)
                super()._create_keyframe(feats, fid=fid)
                ref = state(trk)
                gp = gaps_of(state(port), ref)
                gj = []
                for c in copies:
                    f_c = jstate.FrameFeatures(**{k: v.copy() for k, v in h.items()}, mp=mp.copy())
                    if gate == "dynamic-rgbd":
                        c._impl._create_keyframe(f_c, fid=fid)  # its own class: the step of its own manager
                    else:
                        base._create_keyframe(c, f_c, fid=fid)
                    gj.append(gaps_of(state(c), ref))
                for d, gs in ((worst_port, [gp]), (worst_jax, gj)):
                    for gg in gs:
                        for kk, v in gg.items():
                            d[kk] = max(d.get(kk, 0), v)
                print(json.dumps(dict(step=fid, port=gp, jax_radius={kk: max(gg[kk] for gg in gj) for kk in gp})),
                      flush=True)
        return Hooked

    g = tpu.dynamic_gate()
    outer = []
    J, inputs = dynamic_tracker(gate, jslam, g)
    outer.append(J)
    if gate == "dynamic-rgbd":
        base = type(J._impl)
        J._impl.__class__ = hooked(base)
    else:
        base = type(J)
        J.__class__ = hooked(base)
    for args in inputs:
        J.track(*args)
    print(json.dumps(dict(kf_steps_radius=worst_jax, port_worst=worst_port)), flush=True)


def two_stage_state(mgr, m):
    """The gauge-free outcome of a dynamic BA: keyframe poses, each chain's
    points with object coordinates in the world at each keyframe, its
    motion since its first keyframe, and its velocity."""
    out = {}
    for tid, ch in mgr.chains.items():
        ks = sorted(ch.kf_pose)
        pts = ch.local[ch.has_local]
        out[tid] = ({k: pts @ ch.kf_pose[k][:3, :3].T + ch.kf_pose[k][:3, 3] for k in ks},
                    {k: ch.kf_pose[k][:3, 3] - ch.kf_pose[ks[0]][:3, 3] for k in ks}, ch.velocity.copy())
    return m.kf_tcw.copy(), out


def two_stage_gaps(a, b):
    (ta, ca), (tb, cb) = a, b
    return dict(cam=float(np.abs(ta - tb).max()),
                world=float(max(np.abs(ca[t][0][k] - cb[t][0][k]).max() for t in cb for k in cb[t][0])),
                motion=float(max(np.abs(ca[t][1][k] - cb[t][1][k]).max() for t in cb for k in cb[t][1])),
                speed=float(max(abs(ca[t][2][0] - cb[t][2][0]) for t in cb)),
                steer=float(max(abs(ca[t][2][1] - cb[t][2][1]) for t in cb)))


def dynamic_two_stage(n_perturb):
    """One dynamic BA with point edges from the RGBD gate's final state."""
    from cube_slam_tpu.slam import dynamic as jdyn
    from cube_slam_tpu_torch.slam import dynamic as tdyn
    from cube_slam_tpu_torch.slam import state as tstate

    g = tpu.dynamic_gate()
    J, inputs = dynamic_tracker("dynamic-rgbd", jslam, g)
    for args in inputs:
        J.track(*args)
    J._apply_pending_map()
    radius = {}
    for cap in (1024, 40, 20):
        base = copy.deepcopy(J.dynamic)
        base.ba_pt_obj_cam, base.max_dp_edges = True, cap

        def solve(mgr, m, fn):
            mgr.run_dynamic_ba(m, J.K, static_edges_fn=lambda w: fn(m, w))
            return two_stage_state(mgr, m)

        ref = solve(copy.deepcopy(base), copy.deepcopy(J.map), jdyn.static_anchor_edges)
        port = solve(tpu.carry_dynamic_manager(base), tstate.map_state_from_arrays(vars(J.map)),
                     tdyn.static_anchor_edges)
        gj = []
        for s_ in range(n_perturb):
            c, mc = copy.deepcopy(base), copy.deepcopy(J.map)
            r = np.random.default_rng(s_)
            for ch in c.chains.values():
                for k, p in ch.kf_pose.items():
                    p[:3, 3] = _nudge(p[:3, 3], r)
                ch.velocity = _nudge(ch.velocity, r)
            k = mc.kf_ids()
            mc.kf_tcw[k, :3, 3] = _nudge(mc.kf_tcw[k, :3, 3], r)
            gj.append(two_stage_gaps(solve(c, mc, jdyn.static_anchor_edges), ref))
        rad = {kk: max(gg[kk] for gg in gj) for kk in gj[0]}
        for kk, v in rad.items():
            radius[kk] = max(radius.get(kk, 0.0), v)
        print(json.dumps(dict(cap=cap, port=two_stage_gaps(port, ref), jax_radius=rad)), flush=True)
    print(json.dumps(dict(two_stage_radius=radius)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gate", choices=["mono", "stereo", "mono-entry", "stereo-entry", *DYNAMIC_GATES],
                    default="mono")
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
    ap.add_argument("--kf-steps", action="store_true", help="a dynamic gate's keyframe steps, 16 perturbations each")
    ap.add_argument("--two-stage", action="store_true",
                    help="the RGBD gate's final dynamic BA with point edges on, 32 perturbations")
    args = ap.parse_args()
    if args.gate in DYNAMIC_GATES:
        if args.two_stage:
            dynamic_two_stage(32)
        elif args.kf_steps:
            dynamic_kf_steps(args.gate, 16)
        elif args.steps:
            dynamic_steps(args.gate, 24)
        else:
            dynamic_spread(args.gate, args.perturbations, args.at)
        return
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
