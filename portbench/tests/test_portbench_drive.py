"""The system under test as the harness builds and drives it: a tracker is
held to the configuration's ORB where it states one and must run none where
it states none (CubeSLAM's cube-only mode), and a whole run of the harness
drives a tracker without ORB to a well-formed result line, handing the
window's drained spans to the Run."""

import json
import time
import types

import numpy as np
import pytest
import torch

from portbench import drive, harness, trace
from portbench.traffic import episode

ORB = {"n_features": 1500, "n_levels": 8, "scale_factor": 1.2, "ini_th_fast": 20.0, "min_th_fast": 7.0}


def _orb_tracker(**over):
    cfg = dict(n_features=1500, n_levels=8, scale_factor=1.2, ini_th=20.0, min_th=7.0)
    cfg.update(over)
    return types.SimpleNamespace(orb_cfg=types.SimpleNamespace(**cfg))


def _build(monkeypatch, trk, cfg):
    monkeypatch.setattr(drive, "entry", lambda name: types.SimpleNamespace(build=lambda port, cfg, ep, device: trk))
    return drive.build_tracker(None, cfg, {"entry": "stub"}, None, "cpu")


# (configuration's orb, tracker, whether it builds)
CASES = [
    ("orb_matching", ORB, _orb_tracker(), True),
    ("orb_mismatched", ORB, _orb_tracker(n_features=1000), False),
    ("no_orb_no_orb_cfg", None, types.SimpleNamespace(), True),
    ("no_orb_orb_cfg_none", None, types.SimpleNamespace(orb_cfg=None), True),
    ("no_orb_orb_tracker", None, _orb_tracker(), False),
    ("orb_tracker_without_orb", ORB, types.SimpleNamespace(), False),
]


@pytest.mark.parametrize("case, orb, trk, builds", CASES, ids=[c[0] for c in CASES])
def test_build_tracker_holds_the_tracker_to_the_configurations_orb(monkeypatch, case, orb, trk, builds):
    cfg = {} if orb is None else {"orb": dict(orb)}
    if builds:
        assert _build(monkeypatch, trk, cfg) is trk
    else:
        with pytest.raises(RuntimeError):
            _build(monkeypatch, trk, cfg)


class _CubeOnly:
    """A tracker that runs no ORB: each frame inside the port's `frame`
    span, initialized at frame 1, a keyframe there, the identity pose on."""

    def __init__(self, profiler):
        self.profiler, self.state, self.last_kf_frame_id, self.poses = profiler, "NOT_INITIALIZED", -1, []

    def track(self, gray):
        f = len(self.poses)
        with self.profiler.frame(f):
            if f == 0:
                self.poses.append(None)
                return None
            if self.state != "OK":
                self.state, self.last_kf_frame_id = "OK", f
            self.poses.append(np.eye(4))
            return self.poses[-1]

    def final_trajectory(self):
        return list(enumerate(self.poses))


CONFIG = {"name": "tiny_room",
          "camera": {"fx": 64.0, "fy": 64.0, "cx": 32.0, "cy": 24.0, "wh": [64, 48], "noise_sigma": 1.0},
          "scene": {"texture_seed": 3, "frames": 4, "target": [0.0, 3.2, 0.6], "box_center": [0.0, 3.2, 0.45],
                    "box_half": [0.6, 0.4, 0.45], "box_yaw": 0.0},
          "runs": {"objects": {"entry": "cube_only", "native": []}}}
BENCH = {"workloads": [{"name": "tiny_room.objects", "config": "tiny_room", "traffic": "objects", "chips": 1}],
         "end_to_end": [{"name": "frames_per_s", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}],
         "per_layer": [{"name": "host_syncs_per_frame", "unit": "syncs/frame"}, {"name": "track_ms", "unit": "ms/frame"}]}


class _NoStretch:
    """StretchControl on the CPU: no profiled stretch (torch.profiler's
    device trace needs a card)."""

    edt_pixels = []

    def __init__(self, *args):
        pass

    def before_episode(self, e):
        pass

    def after_frame(self, rec, trk):
        pass

    def stop(self):
        pass

    def read(self):
        return None


@pytest.fixture
def tiny_cell(tmp_path, monkeypatch):
    for sub, name, data in (("configs", "tiny_room", CONFIG),
                            ("workloads", "tiny_room.objects",
                             {"episodes": 1, "limits": {}, "trace": {"from_frame": 1, "max_frames": 2}})):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / f"{name}.json").write_text(json.dumps(data))
    monkeypatch.setattr(episode, "FRAME_CACHE", str(tmp_path / "_frames"))
    entry = types.SimpleNamespace(build=lambda port, cfg, ep, device: _CubeOnly(port["profiler"]), Feed=drive.GrayFeed)
    monkeypatch.setattr(drive, "entry", lambda name: entry)
    monkeypatch.setattr(trace, "StretchControl", _NoStretch)
    return harness.load_cell("tiny_room.objects", bench=BENCH, base=str(tmp_path))


def _run(cell, trace_on):
    return harness.run_cell(cell, 2**31 + 17, None, trace_on, torch.device("cpu"), time.perf_counter(),
                            render_workers=0, warm=True)


def test_the_harness_drives_a_tracker_without_orb(tiny_cell):
    result, run = _run(tiny_cell, 0)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] == 4 and line["failed"] == 0 and line["checks"] == {}
    assert set(line["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(m["value"] > 0 and m["unit"] for m in line["metrics"].values())
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    assert [r.kind for r in run.frames] == ["before_init", "init", "tracked", "tracked"]
    assert [e.frames_run for e in run.episodes] == [4]


def test_the_run_carries_the_windows_drained_spans(tiny_cell):
    prof = drive.port_modules()["profiler"]
    result, run = _run(tiny_cell, 1)
    # the window's four frames; the warm-up's were drained and dropped before it
    assert [(s.name, s.frame) for s in run.spans] == [("frame", f) for f in range(4)]
    assert all(s.end is not None for s in run.spans) and prof.drain() == []
    assert [r.spans["frame"][1] for r in run.frames] == [1, 1, 1, 1]
    assert set(result["metrics"]) == {"host_syncs_per_frame", "track_ms"}
    assert result["metrics"]["host_syncs_per_frame"] == {"value": 0.0, "unit": "syncs/frame"}   # no sync counter on the CPU
