"""host_syncs_per_frame (syncs/frame): the port's counter `sync` (every
synchronizing device-to-host operation it made, counted on the innermost
open span), summed over a frame's spans, per frame outside the profiled
stretch."""

from .. import spans


def read(run):
    return spans.per_frame_counts(run, spans.SYNC)
