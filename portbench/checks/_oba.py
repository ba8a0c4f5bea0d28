"""What the object BA's checks share: the recorder of the port's calls in
the window and, for a sample of them, the float64 costs that
reference/object_ba.py works out."""

import inspect
import sys

from ..reference import object_ba as ref
from . import _sample

PROBE = "object_ba"
SAMPLE = 5


def install(port, calls):
    """Record each call's arguments (by name) and its final state; returns
    the function that takes the recorder off."""
    from cube_slam_tpu_torch.graph import object_ba

    orig = object_ba.local_ba_objects_two_stage
    sig = inspect.signature(orig)

    def recorded(*a, **k):
        # copies: the tracker writes into host arrays that a CPU tensor of
        # the call may share
        args = {n: v.clone() if hasattr(v, "clone") else v for n, v in sig.bind(*a, **k).arguments.items()}
        out = orig(*a, **k)
        calls.append((args, tuple(x.clone() for x in out[:4])))
        return out

    object_ba.local_ba_objects_two_stage = recorded
    return lambda: setattr(object_ba, "local_ba_objects_two_stage", orig)


def size(args):
    return int(len(args["obs_kf"]))


def sampled_costs(run):
    """ref.costs of each sampled call (up to SAMPLE drawn from the seed, the
    largest among them), worked out once per run; None without a call."""
    if PROBE not in run.cache:
        calls = run.calls.get(PROBE) or []
        out = []
        for i in _sample.pick(run.seed, [size(a) for a, _ in calls], SAMPLE, salt=1):
            args, state = calls[i]
            c = ref.costs(args, state)
            out.append(c)
            print(f"[object_ba] call {i} of {len(calls)}: {size(args)} reprojection edges, costs {c}", file=sys.stderr)
        run.cache[PROBE] = out or None
    return run.cache[PROBE]
