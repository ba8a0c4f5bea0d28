"""line_err (share of lines): on frames of the window drawn from the seed,
the lines the tracker was handed against the plain reference detector's
(reference/lsd.py, float64) on the same image: the larger of the share of
the program's segments with no reference segment within TOL_PX at both
ends and the share of the reference's with no program segment; the worst
frame."""

import numpy as np

from ..reference import lsd

TOL_PX = 0.05
SAMPLE = 12


def unmatched(a, b, tol=TOL_PX):
    """Share of the rows of `a` with no row of `b` within `tol` in every
    coordinate."""
    if len(a) == 0:
        return 0.0
    if len(b) == 0:
        return 1.0
    gap = np.abs(np.asarray(a)[:, None, :] - np.asarray(b)[None, :, :]).max(axis=-1)
    return float((gap.min(axis=1) > tol).mean())


def read(run):
    frames = [r for r in run.frames if "lines" in r.made]
    if not frames:
        return float("inf")
    rng = np.random.default_rng(run.seed % (2**62))
    pick = rng.choice(len(frames), size=min(SAMPLE, len(frames)), replace=False)
    lc = run.cell.config["lines"]
    worst = 0.0
    for i in sorted(pick):
        r = frames[i]
        ref = lsd.detect_lines(run.eps[r.pool].frames[r.index].astype(np.float64), min_length=float(lc["min_length"]),
                               max_lines=int(lc["max_lines"]))
        worst = max(worst, unmatched(r.made["lines"], ref), unmatched(ref, r.made["lines"]))
    return worst
