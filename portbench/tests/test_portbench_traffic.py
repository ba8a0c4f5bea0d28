"""The frozen generator: one frame per configuration at seed 0 is pinned
by its hash, so that any change to the traffic shows; the seed draws the
camera's noise and nothing else."""

import hashlib
import json
import os

import numpy as np
import pytest

from portbench.traffic import episode

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME0 = {
    "tum_cabinet": "3c4837c65a445120e34548dabf7a127d9e3bc4dcf6b2068cd7e3b0ae092d0591",
    "kitti_mono": "fea077b3cc20a7477e0a2749ee9bd257d9332c1682cce99c4a9f2a43410a8b73",
}


@pytest.fixture(autouse=True)
def frame_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(episode, "FRAME_CACHE", str(tmp_path / "_frames"))
    return tmp_path / "_frames"


def _cfg(name, wh=None, frames=None):
    with open(os.path.join(BENCH_DIR, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    if wh:
        s = wh[0] / cfg["camera"]["wh"][0]
        cfg["camera"].update(fx=cfg["camera"]["fx"] * s, fy=cfg["camera"]["fy"] * s, cx=cfg["camera"]["cx"] * s,
                             cy=cfg["camera"]["cy"] * s, wh=list(wh))
    if frames:
        cfg["scene"]["frames"] = frames
    return cfg


@pytest.mark.parametrize("name", sorted(FRAME0))
def test_frame_zero_at_seed_zero_is_pinned(name):
    cfg = _cfg(name, frames=1)
    ep = episode.make_episode(cfg, 0, workers=0)
    img = ep.frames[0]
    assert img.dtype == np.uint8 and img.shape == tuple(reversed(cfg["camera"]["wh"]))
    assert hashlib.sha256(img.tobytes()).hexdigest() == FRAME0[name]
    assert ep.boxes[0] is not None


def test_seeds_draw_the_noise_and_nothing_else(frame_cache):
    cfg = _cfg("tum_cabinet", wh=(160, 120), frames=3)
    a = episode.make_episode(cfg, 0, workers=0)
    assert len(os.listdir(frame_cache)) == 1  # the noiseless frames, kept for the next run
    b = episode.make_episode(cfg, 2**31 + 11, workers=0)
    c = episode.make_episode(cfg, 2**31 + 11, workers=2)
    assert np.array_equal(a.truth_Twc, b.truth_Twc)
    assert all(np.array_equal(x, y) for x, y in zip(a.boxes, b.boxes))
    assert not np.array_equal(a.frames[0], b.frames[0])
    noise = a.frames[0].astype(float) - b.frames[0].astype(float)
    assert 1.0 < noise.std() < 2.0  # two draws of sigma 1, rounded
    assert all(np.array_equal(x, y) for x, y in zip(b.frames, c.frames))


def test_offline_rows_put_the_box_in_the_first_cameras_ground_frame():
    cfg = _cfg("kitti_mono", wh=(310, 94), frames=2)
    ep = episode.make_episode(cfg, 0, workers=0)
    rows = ep.offline_rows()
    assert len(rows) == 2 and all(r.shape[1] == 13 for r in rows)
    # the local ground frame of the first camera is the world here
    assert np.allclose(rows[0][0, :3], ep.box_T[:3, 3])
    assert rows[0][0, 12] == 1.0
