"""edt_roofline_pct (%): the EDT kernel's share of its roofline in the
profiled stretch. The least time an exact EDT of B x H x W masks can take
is its bytes, 1 read and 4 written per pixel, at the H100's 3.35 TB/s (its
~20 operations per pixel at 67 TFLOP/s take less); the device time is that
of the kernel's two passes, edt_column_pass and edt_row_pass, from the
trace. None where the stretch launched no EDT."""

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
BYTES_PER_PIXEL = 5


def read(run):
    st = run.trace
    if st is None or not run.edt_pixels:
        return None
    device_s = sum(b - a for name, a, b in st.device if "edt_column_pass" in name or "edt_row_pass" in name) * 1e-9
    if device_s <= 0:
        return None
    bound_s = BYTES_PER_PIXEL * sum(run.edt_pixels) / HBM_BYTES_PER_S
    return 100.0 * bound_s / device_s
