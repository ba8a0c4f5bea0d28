"""oba_excess (share of the cost): the object BA's solves in the window
(graph/object_ba.py::local_ba_objects_two_stage, the port's own inputs to
each call recorded as it made them) against the plain float64 solve of
reference/object_ba.py on the same inputs: per call, the float64
reprojection cost of the program's final state over the reference
optimum's, less one, both over the reference's second-stage edges. Up to 5
calls drawn from the seed, the largest among them (checks/_oba.py); their
median, and 0 where the program ends below the optimum.

A solve that reached the optimum in float32 reads a few millionths on
nearly every call; one whose projections or normal equations lost
precision (TF32) stops short by a fortieth or more on every call that
moves. The reprojection family holds the cameras and points of the window,
and its cost is free of the solve's scale. The box and point-cuboid
families are left out: started far from their minimum, they end in
different minima at float32, at TF32 and at float64 on the same inputs,
and on a few calls that pulls the cameras too (PERF.md); the median keeps
one such call from deciding. A window without an object BA reads inf: the
cell exists for it."""

import math
import statistics

from . import _oba
from ._oba import PROBE, install  # noqa: F401


def excess(c, family="reproj"):
    prog, opt = c["program"][family], c["optimum"][family]
    if not (math.isfinite(prog) and opt > 0 and math.isfinite(opt)):
        return float("inf")
    return prog / opt - 1.0


def read(run):
    costs = _oba.sampled_costs(run)
    return max(0.0, statistics.median(excess(c) for c in costs)) if costs else float("inf")
