"""The step-level comparisons on hand-made inputs: the plain object BA
reaches the optimum of a small problem, where the port's object BA reads
sound and a state left unchanged reads 1; the EDT comparison is exact."""

import math

import numpy as np
import pytest
import torch

from portbench.checks import _sample, edt_err, oba_excess
from portbench.reference import edt
from portbench.reference import object_ba as ref


def _problem(seed=0, noise=0.5):
    """Four cameras about a box, 60 points on and around it, one object with
    a box edge per camera; measurements from the true state plus pixel
    noise, the start perturbed."""
    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], dtype=np.float32)
    Tcw = []
    for i in range(4):
        a = -0.3 + 0.2 * i
        R = np.array([[math.cos(a), 0, -math.sin(a)], [0, 1, 0], [math.sin(a), 0, math.cos(a)]])
        c = np.array([3 * math.sin(a), 0.0, -3 * math.cos(a)])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, -R @ c
        Tcw.append(T)
    Tcw = np.array(Tcw)
    pts = rng.uniform(-0.8, 0.8, (60, 3))
    pose, scale = np.eye(4), np.array([0.5, 0.4, 0.3])
    obs_kf, obs_pt, obs_uv = [], [], []
    for k in range(4):
        pc = pts @ Tcw[k, :3, :3].T + Tcw[k, :3, 3]
        uv = (pc @ K.T)[:, :2] / pc[:, 2:]
        obs_kf += [k] * 60
        obs_pt += list(range(60))
        obs_uv.append(uv + rng.normal(0, noise, uv.shape))
    t = lambda x, d=torch.float32: torch.as_tensor(np.asarray(x), dtype=d)  # noqa: E731
    tp = {n: t(v) for n, v in (("kf_tcw", Tcw), ("pts", pts), ("obj_pose", pose[None]), ("obj_scale", scale[None]))}
    box = ref.box_of(tp["obj_pose"][0].double(), tp["obj_scale"][0].double(), tp["kf_tcw"].double(), t(K).double(),
                     ref.Arith())
    start = dict(tp)
    start["kf_tcw"] = tp["kf_tcw"].clone()
    start["kf_tcw"][1:, :3, 3] += t(rng.normal(0, 0.03, (3, 3)))
    start["pts"] = tp["pts"] + t(rng.normal(0, 0.03, (60, 3)))
    start["obj_pose"] = tp["obj_pose"].clone()
    start["obj_pose"][0, :3, 3] += 0.05
    start["obj_scale"] = tp["obj_scale"] * 1.1
    E, B = 240, 4
    return dict(start, K=t(K), obs_kf=t(obs_kf, torch.int32), obs_pt=t(obs_pt, torch.int32),
                obs_uv=t(np.concatenate(obs_uv)), obs_si=torch.ones(E), obs_valid=torch.ones(E, dtype=torch.bool),
                box_kf=t(range(4), torch.int32), box_obj=torch.zeros(B, dtype=torch.int32),
                box_meas=box.float() + t(rng.normal(0, 1.0, (B, 4))), box_si=torch.full((B,), 0.5),
                box_valid=torch.ones(B, dtype=torch.bool), po_obj=torch.zeros(60, dtype=torch.int32),
                po_pt=t(range(60), torch.int32), po_si=torch.ones(60), po_valid=torch.ones(60, dtype=torch.bool),
                kf_fixed=t([True, False, False, False], torch.bool), pt_valid=torch.ones(60, dtype=torch.bool),
                obj_valid=torch.ones(1, dtype=torch.bool), obj_fix_scale=torch.zeros(1, dtype=torch.bool),
                meas_kf=t(range(4), torch.int32), meas_obj=torch.zeros(4, dtype=torch.int32),
                meas_pose=t(Tcw @ pose), meas_scale=t(np.repeat(scale[None], 4, axis=0)), meas_si=torch.ones(4),
                meas_valid=torch.ones(4, dtype=torch.bool))


@pytest.fixture(scope="module")
def problem():
    args = _problem()
    return args, ref.solve(args, "float64")


def test_the_reference_reaches_the_optimum(problem):
    args, opt = problem
    pr, state, cost, _ = opt
    start = float(pr.cost(pr.state0, pr.obs_valid, pr.box_valid))
    assert float(cost) < 0.5 * start
    assert oba_excess.excess(ref.costs(args, state, opt)) == pytest.approx(0.0, abs=1e-12)
    assert oba_excess.excess(ref.costs(args, pr.state0, opt)) > 1.0


def test_the_ports_object_ba_reads_sound_and_a_lower_precision_does_not(problem):
    from cube_slam_tpu_torch.graph import object_ba

    args, opt = problem
    port = object_ba.local_ba_objects_two_stage(**args)[:4]
    sound = oba_excess.excess(ref.costs(args, port, opt))
    tf32 = oba_excess.excess(ref.costs(args, ref.solve(args, "tf32")[1], opt))
    assert abs(sound) < 1e-5 and tf32 > 100 * abs(sound)


def test_the_edt_comparison_is_exact():
    from cube_slam_tpu_torch.ops import distance_transform as dt

    g = torch.Generator().manual_seed(0)
    e = torch.rand((2, 48, 64), generator=g) > 0.995
    e[1] = False
    assert edt_err.gap(e, dt.edt_l2(e)) == 0.0
    wrong = dt.edt_l2(e).clone()
    wrong[0, 5, 5] += 1.0
    assert edt_err.gap(e, wrong) >= 1.0
    far = torch.zeros((1, 200, 300), dtype=torch.bool)
    far[0, 0, 0] = True
    bf = torch.sqrt(edt.squared(far, torch.bfloat16).to(torch.float32))
    assert edt_err.gap(far, bf) > 1.0


def test_the_sample_holds_the_largest_call():
    for seed in (0, 1, 2**31 + 5):
        pick = _sample.pick(seed, [3, 9, 1, 4, 2], 3, salt=1)
        assert 1 in pick and len(pick) == 3 and pick == sorted(set(pick))
    assert _sample.pick(0, [], 3, salt=1) == [] and _sample.pick(0, [5], 3, salt=1) == [0]
