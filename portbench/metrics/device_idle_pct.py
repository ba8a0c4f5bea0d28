"""device_idle_pct (%): the share of the profiled stretch in which the card
ran no kernel, copy or set: 100 x (1 - the union of the device's intervals
/ the stretch's wall time)."""


def union_s(intervals_ns):
    """Seconds covered by the union of (start, end) intervals in ns."""
    total, end = 0, None
    for a, b in sorted(intervals_ns):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total * 1e-9


def read(run):
    st = run.trace
    if st is None or st.wall_s <= 0 or not st.device:
        return None
    return 100.0 * (1.0 - union_s([(a, b) for _, a, b in st.device]) / st.wall_s)
