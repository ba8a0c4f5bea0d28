"""edt_err (squared pixels): the detector's distance maps in the window
(ops/hopper_kernels.py::edt_l2, the CUDA kernel of csrc/edt.cu, each call's
edge maps recorded as it made them) against reference/edt.py's exact
brute-force transform of the same maps: the largest gap between the
program's distance squared and rounded to a whole number and the exact
squared distance, over every pixel (a map without an edge has to read
sqrt(1e9) everywhere). Exact: the limit is 0. Up to SAMPLE calls drawn from
the seed, the largest among them; the worst. A window without a call reads
inf: the cell exists for it."""

import sys

import torch

from ..reference import edt
from . import _sample

PROBE = "edt"
SAMPLE = 3


def install(port, calls):
    hk = port["hopper_kernels"]
    orig = hk.edt_l2

    def recorded(edges):
        out = orig(edges)
        calls.append((edges, out))
        return out

    hk.edt_l2 = recorded
    return lambda: setattr(hk, "edt_l2", orig)


def gap(edges, out):
    """The largest gap of one call's output against the exact transform."""
    want = edt.squared(edges)
    out = torch.as_tensor(out).reshape(want.shape).double()
    none = (want == edt.NO_EDGE_SQ).flatten(1).all(dim=1)
    g = torch.abs(torch.round(out * out) - want.double()).flatten(1).amax(dim=1)
    empty = torch.abs(out - float(torch.sqrt(torch.tensor(edt.NO_EDGE_SQ, dtype=torch.float32)))).flatten(1).amax(dim=1)
    return float(torch.where(none, empty, g).max())


def read(run):
    calls = run.calls.get(PROBE) or []
    if not calls:
        return float("inf")
    worst = 0.0
    for i in _sample.pick(run.seed, [int(e.numel()) for e, _ in calls], SAMPLE, salt=2):
        v = gap(*calls[i])
        print(f"[edt_err] call {i} of {len(calls)}: {tuple(calls[i][0].shape)}, {v!r}", file=sys.stderr)
        worst = max(worst, v)
    return worst
