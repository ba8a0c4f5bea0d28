"""The comparison that decides `correct` calls each control and every
planted fault wrong, and a sound run right: whole runs of the harness on
the CPU (its look for a card skipped) at a size a test can hold, the
320x240 room of tests/data/ (the port's object gate), one episode."""

import contextlib
import json
import os
import time

import pytest
import torch

from portbench import control, drive, harness

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SEED = 3
CELL = "small_room.objects"
# the noise draw the runs play: its one object BA lowers the reprojection
# cost by 0.9% (draw 0's by 0.015%, too little for a fault of the BA to
# show at this size)
DRAW = 3


@pytest.fixture(scope="module")
def port():
    return drive.port_modules()


def _run(port, tracker_hook=None, lines_fn=None, context=contextlib.nullcontext):
    with open(os.path.join(DATA, "bench.json")) as f:
        cell = harness.load_cell(CELL, bench=json.load(f), base=DATA)
    if lines_fn == "control":
        lines_fn = control.reference_lines_fn(cell.config)
    elif lines_fn == "altered":
        lines_fn = control.lines_altered(drive.port_lines_fn(port, cell.config))
    with context():
        result, _ = harness.run_cell(cell, SEED, None, 0, torch.device("cpu"), time.perf_counter(), lines_fn=lines_fn,
                                     tracker_hook=tracker_hook, render_workers=0, warm=False, draws=[DRAW])
    return result


# (case, how the run is broken, the checks one of which has to fail). A
# frame is one request on one device: no batch of requests and no exchange
# between chips can be left out; the object BA's batch of reprojection edges
# can.
FAULTS = [
    ("control_tracker", dict(context=control.pose_refinement_cut), ("motion_err",)),
    ("control_lines", dict(lines_fn="control"), ("line_err",)),
    ("control_object_ba", dict(context=control.reference_object_ba), ("oba_excess",)),
    ("control_edt", dict(context=control.reference_edt), ("edt_err",)),
    ("state_unchanged", dict(tracker_hook=control.state_unchanged), ("motion_err",)),
    ("object_ba_unchanged", dict(context=control.object_ba_unchanged), ("oba_excess",)),
    ("object_ba_half_edges", dict(context=control.object_ba_half_edges), ("oba_excess",)),
    ("pose_altered", dict(tracker_hook=control.pose_altered), ("motion_err",)),
    ("lines_altered", dict(lines_fn="altered"), ("line_err",)),
    ("object_ba_altered", dict(context=control.object_ba_altered), ("oba_excess",)),
    ("edt_altered", dict(context=control.edt_altered), ("edt_err",)),
]


def test_a_sound_run_is_correct(port):
    result = _run(port)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("case, how, check", FAULTS, ids=[f[0] for f in FAULTS])
def test_the_control_and_each_fault_are_wrong(case, how, check, port):
    result = _run(port, **how)
    assert not result["correct"]
    assert any(not result["checks"][c]["value"] <= result["checks"][c]["limit"] for c in check), result["checks"]
