"""cube_slam_tpu_torch ops/image.py (Canny) and the plain distance
transform (ops/distance_transform.py) against the JAX package, including its
Pallas EDT kernel run in TPU interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_parity_utils import K_HALF, rng, room_scene

from cube_slam_tpu.ops import distance_transform as jdt
from cube_slam_tpu.ops import image as jim
from cube_slam_tpu.ops import pallas_kernels as jpk
from cube_slam_tpu_torch.ops import distance_transform as tdt
from cube_slam_tpu_torch.ops import image as tim
from cube_slam_tpu_torch.utils import synth


def _frame():
    """A 320x240 render of the box scene, rounded to integer grey levels."""
    Twc = synth.camera_path(3, kind="orbit", target=[0.0, 3.2, 0.6])[1]
    return np.round(room_scene().render(Twc, K_HALF, wh=(320, 240))).astype(np.float32)


def _masks():
    r = rng(0)
    return {
        "37x131": r.uniform(size=(37, 131)) < 0.05,
        "240x320": r.uniform(size=(240, 320)) < 0.01,
        "all_false": np.zeros((24, 40), dtype=bool),
        "all_true": np.ones((24, 40), dtype=bool),
    }


def test_canny_equal_to_jax():
    """Integer grey levels make Sobel exact, so NMS and hysteresis maps must
    be identical, not merely close."""
    img = _frame()
    sj, wj = jim.canny_nms(jnp.asarray(img))
    st, wt = tim.canny_nms(torch.as_tensor(img))
    assert np.array_equal(np.asarray(sj), st.numpy())
    assert np.array_equal(np.asarray(wj), wt.numpy())
    assert st.sum() > 100  # the frame has edges to compare
    ej = jim.canny_hysteresis(sj, wj)
    et = tim.canny_hysteresis(st, wt)
    assert np.array_equal(np.asarray(ej), et.numpy())
    dxj, dyj = jim.sobel(jnp.asarray(img))
    dxt, dyt = tim.sobel(torch.as_tensor(img))
    assert np.array_equal(np.asarray(dxj), dxt.numpy()) and np.array_equal(np.asarray(dyj), dyt.numpy())


def test_hysteresis_batch_and_cap():
    """A batch runs to each map's fixpoint; the step cap bounds the growth
    exactly as the JAX while_loop's does."""
    img = _frame()
    st, wt = tim.canny_nms(torch.as_tensor(img))
    rect = torch.zeros_like(st)
    rect[40:200, 60:260] = True
    batch = tim.canny_hysteresis(torch.stack([st, st & rect]), torch.stack([wt, wt & rect]))
    assert torch.equal(batch[0], tim.canny_hysteresis(st, wt))
    assert torch.equal(batch[1], tim.canny_hysteresis(st & rect, wt & rect))
    for cap in (1, 3, 17):
        j = jim.canny_hysteresis(jnp.asarray(st.numpy()), jnp.asarray(wt.numpy()), max_iters=cap)
        t = tim.canny_hysteresis(st, wt, max_iters=cap)
        assert np.array_equal(np.asarray(j), t.numpy()), cap


@pytest.mark.parametrize("name", list(_masks()))
def test_plain_edt_bit_identical_to_pallas_kernel(name):
    """Every EDT candidate is an exact float32 sum and min is exact, so the
    port's plain EDT must reproduce the TPU kernel's bits."""
    m = _masks()[name]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jpk.edt_l2_pallas(jnp.asarray(m)))
    out = tdt.edt_l2(torch.as_tensor(m)).numpy()
    assert out.dtype == np.float32 and np.array_equal(ref, out)


@pytest.mark.parametrize("name", list(_masks()))
def test_plain_edt_bit_identical_to_xla_edt(name):
    m = _masks()[name]
    ref = np.asarray(jdt.edt_l2(jnp.asarray(m)))
    out = tdt.edt_l2(torch.as_tensor(m)).numpy()
    assert np.array_equal(ref, out)
    if name == "all_false":
        assert np.all(out == np.float32(np.sqrt(np.float32(1e9))))
    if name == "all_true":
        assert np.all(out == 0.0)


def _round_once_to_f32(n: int) -> np.float32:
    """A non-negative integer rounded once to float32 (to nearest, ties to
    even)."""
    e = n.bit_length() - 24
    if e <= 0:
        return np.float32(n)
    q, r = divmod(n, 1 << e)
    if r > 1 << (e - 1) or (r == 1 << (e - 1) and q & 1):
        q += 1
    return np.float32(q << e)


def test_fma_form_of_the_row_pass_is_exact():
    """The CUDA row pass evaluates each candidate as fmaf(d, d, g²), the
    exact d·d + g² rounded once to float32; the plain version adds float32
    d² to g² in float32. They agree when d² is an exact float32, which the
    kernel's width limit (hopper_kernels._MAX_W = 4096) keeps. Checked over
    every g² the column pass gives for maps up to 4096 rows (k² for
    k <= 4096, and 1e9² for an empty column) and every d <= 4096."""
    d = np.arange(4097, dtype=np.int64)
    d2 = torch.as_tensor(d.astype(np.float32)) ** 2  # the plain version's (x - u)²
    for k0 in range(0, 4097, 512):
        k = np.arange(k0, min(k0 + 512, 4097), dtype=np.int64)
        g = torch.as_tensor(k.astype(np.float32))
        plain = ((g * g)[:, None] + d2[None, :]).numpy()
        exact = k[:, None] ** 2 + d[None, :] ** 2  # < 2^53: exact as float64
        assert np.array_equal(plain, exact.astype(np.float64).astype(np.float32)), k0
    g_empty = torch.tensor(1e9, dtype=torch.float32)
    g2 = g_empty * g_empty
    plain = (g2 + d2).numpy()
    exact = [_round_once_to_f32(int(g2.item()) + int(v) ** 2) for v in d]
    assert np.array_equal(plain, np.array(exact, dtype=np.float32))
    assert _round_once_to_f32(2 ** 24 + 1) == 2 ** 24 and _round_once_to_f32(2 ** 24 + 3) == 2 ** 24 + 4


def test_edt_batched_equals_per_map():
    r = rng(1)
    m = torch.as_tensor(r.uniform(size=(3, 29, 53)) < np.array([0.0, 0.02, 0.3])[:, None, None])
    out = tdt.edt_l2(m)
    for b in range(3):
        assert torch.equal(out[b], tdt.edt_l2(m[b]))
    assert torch.equal(tdt.vertical_dist(m)[1], tdt.vertical_dist(m[1:2])[0])


@pytest.mark.parametrize("name", list(_masks()) + ["canny"])
def test_chamfer_bit_identical_to_jax(name):
    """OpenCV's 3x3 chamfer: every value is a float32 chain of adds of the
    same constants and mins in the same row order, and the in-row cummin is
    exact, so the port gives JAX's bits. Random, ragged, empty and full
    masks, and the Canny edges of a render."""
    if name == "canny":
        m = tim.canny(torch.as_tensor(_frame())).numpy()
    else:
        m = _masks()[name]
    ref = np.asarray(jdt.chamfer_l2_3x3(jnp.asarray(m)))
    out = tdt.chamfer_l2_3x3(torch.as_tensor(m)).numpy()
    assert out.dtype == np.float32 and np.array_equal(ref, out)
    if name == "all_true":
        assert not out.any()
    if name == "all_false":
        assert np.all(out == np.float32(1e9))
    if name in ("240x320", "canny"):  # an approximate L2: within 9% of the exact EDT (OpenCV's bound)
        exact = tdt.edt_l2(torch.as_tensor(m)).numpy()
        assert np.all(np.abs(out - exact) <= 0.09 * exact + 1e-4)
