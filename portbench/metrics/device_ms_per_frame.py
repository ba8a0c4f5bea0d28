"""device_ms_per_frame (ms/frame): the card's busy time over the whole
window of a `--trace 0` run (the union of its operations' intervals in a
device-only trace, trace.WindowTrace) per frame completed in it: the card
time a frame costs, and so how many camera streams one card can serve. The
port launches some 16,000 small operations a frame, so it falls with each
launch a change removes."""


def read(run):
    done = sum(1 for r in run.frames if r.kind != "raised")
    if run.device_busy_s is None or not done:
        return None
    return 1e3 * run.device_busy_s / done
