"""Structured per-frame metrics (the observability channel the reference
spreads over cout/ROS logging — here one JSONL record per tracked frame).
A copy of cube_slam_tpu/utils/metrics.py (pure Python).

The tracker appends a record each frame when a `MetricsRecorder` is
attached (`tracker.metrics = MetricsRecorder()`); `dump_jsonl` writes the
whole run for offline analysis, `summary` gives aggregate run statistics.
Records carry tracking state, inlier counts, map sizes, and wall time, so
a production run can be monitored/diagnosed without re-running.
"""

from __future__ import annotations

import json


class MetricsRecorder:
    def __init__(self):
        self.records = []

    def add(self, **fields):
        self.records.append(fields)

    def dump_jsonl(self, path):
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r) + "\n")

    def summary(self):
        """Aggregates: frames, tracked fraction, mean inliers/frame-time,
        keyframe count at the end, state transitions."""
        n = len(self.records)
        if n == 0:
            return {}
        tracked = [r for r in self.records if r.get("state") == "OK"]
        mean = lambda k, rows: (sum(r[k] for r in rows) / len(rows)
                                if rows else 0.0)
        transitions = sum(
            1 for a, b in zip(self.records, self.records[1:])
            if a.get("state") != b.get("state"))
        return {
            "frames": n,
            "tracked_frac": len(tracked) / n,
            "mean_inliers": mean("inliers", tracked),
            "mean_frame_ms": mean("frame_ms", self.records),
            "final_keyframes": self.records[-1].get("n_kf", 0),
            "final_map_points": self.records[-1].get("n_mp", 0),
            "state_transitions": transitions,
        }
