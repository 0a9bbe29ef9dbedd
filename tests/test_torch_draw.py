"""The port's debug drawing helpers and dataset registry (utils/draw.py,
dataset/train_dataset.py) against nero_tpu's on seeded inputs: the same
arrays (uint8 images, equal to the bit; the port rebuilds matplotlib's jet
table in numpy) and the same lengths and items."""
import numpy as np
import pytest

from nero_tpu.dataset import train_dataset as JD
from nero_tpu.utils import draw as J
from nero_tpu_torch.dataset import train_dataset as TD
from nero_tpu_torch.utils import draw as T


def _rng():
    return np.random.default_rng(11)


def test_jet_colormap_and_depth_colors():
    rng = _rng()
    vals = np.concatenate([rng.uniform(-0.3, 1.3, 5000), [0.0, 1.0, np.nan, 1 / 256, 0.5]])
    assert np.array_equal(T.jet_colormap(vals), J.jet_colormap(vals))
    depth = rng.uniform(0.5, 3.0, (24, 32))
    mask = rng.uniform(size=(24, 32)) > 0.3
    assert np.array_equal(T.depth_to_color(depth, mask), J.depth_to_color(depth, mask))
    assert np.array_equal(T.depth_to_color(depth), J.depth_to_color(depth))


def test_points_lines_and_epipolar_lines():
    rng = _rng()
    img = rng.integers(0, 255, (40, 50, 3), dtype=np.uint8)
    pts = rng.integers(-3, 53, (30, 2))
    assert np.array_equal(T.draw_points(img, pts, radius=2), J.draw_points(img, pts, radius=2))
    for p0, p1 in [((0, 0), (49, 39)), ((-5, 10), (60, 12.5)), ((20, 5), (20, 35))]:
        assert np.array_equal(T.draw_line(img, p0, p1), J.draw_line(img, p0, p1))
    for _ in range(5):
        F = rng.standard_normal((3, 3))
        p = rng.uniform(0, 40, 2)
        assert np.array_equal(T.draw_epipolar_line(img, F, p), J.draw_epipolar_line(img, F, p))


def test_correspondences():
    rng = _rng()
    img0 = rng.integers(0, 255, (30, 20, 3), dtype=np.uint8)
    img1 = rng.integers(0, 255, (36, 24, 3), dtype=np.uint8)
    p0, p1 = rng.uniform(0, 19, (8, 2)), rng.uniform(0, 23, (8, 2))
    np.random.seed(3)
    want = J.draw_correspondences(img0, img1, p0, p1)
    np.random.seed(3)
    assert np.array_equal(T.draw_correspondences(img0, img1, p0, p1), want)


@pytest.mark.parametrize("is_train", [True, False])
def test_dummy_dataset(is_train):
    cfg = {"database_name": "proc/sphere/32_6"}
    t, j = TD.name2dataset["dummy"](cfg, is_train), JD.name2dataset["dummy"](cfg, is_train)
    assert len(t) == len(j)
    assert t[3] == j[3] == {"index": 3}
    t.reset()
    assert TD.dummy_collate_fn([t[1], t[2]]) == JD.dummy_collate_fn([j[1], j[2]])
    assert set(TD.name2dataset) == set(JD.name2dataset)
