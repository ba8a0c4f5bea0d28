"""track_device_ms (ms/frame): device busy time of what the tracker's
per-frame step launched inside the port's span track.dispatch (step_frame
queued on the device), per frame of the profiled stretch."""

from .. import spans


def read(run):
    return spans.device_ms_per_frame(run, "track.dispatch")
