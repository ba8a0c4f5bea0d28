"""lsd_device_ms (ms/frame): device busy time of what the port's line
detection launched inside its span lsd.detect, per frame of the profiled
stretch; nothing where the cell detects no lines."""

from .. import spans


def read(run):
    return spans.device_ms_per_frame(run, "lsd.detect")
