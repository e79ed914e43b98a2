"""The port's PNG reader and named test images (``lmc_atomi_torch/utils/
png.py``, ``utils/images.py``) against the JAX package's: the decode byte
for byte on the bundled photographs and on written PNGs of every scanline
filter and channel count (the encoder of ``tests/test_png.py``), and the
five images equal at several sizes, with the golden statistics of
``tests/test_png.py``."""
import functools
from pathlib import Path

import numpy as np
import pytest

from lmc_atomi_torch.utils import images as t_images
from lmc_atomi_torch.utils import png as t_png
from lmc_atomi_tpu.utils import images as j_images
from lmc_atomi_tpu.utils import png as j_png
from tests.test_png import _encode_png

ROOT = Path(__file__).resolve().parents[1]
ASSETS = sorted(str(p) for p in (ROOT / "assets").glob("*.png"))


@pytest.fixture(scope="module", autouse=True)
def decode_once():
    """Each package decodes each file once in this module (the photographs
    take seconds in pure numpy): ``read_png`` cached by path in both, which
    their ``read_png_gray`` and named images call."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_png, "read_png", functools.lru_cache(t_png.read_png))
        mp.setattr(j_png, "read_png", functools.lru_cache(j_png.read_png))
        yield


@pytest.mark.parametrize("path", ASSETS, ids=lambda p: Path(p).name)
def test_assets_decode_byte_for_byte(path):
    got, want = t_png.read_png(path), j_png.read_png(path)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    gray_t, gray_j = t_png.read_png_gray(path), j_png.read_png_gray(path)
    assert gray_t.dtype == gray_j.dtype == np.float32
    np.testing.assert_array_equal(gray_t, gray_j)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_written_png_decodes_as_jax(tmp_path, filter_type, channels):
    rng = np.random.default_rng(filter_type * 10 + channels)
    shape = (23, 31) if channels == 1 else (23, 31, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "t.png"
    p.write_bytes(_encode_png(img, filter_type))
    got = t_png.read_png(str(p))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, j_png.read_png(str(p)))
    np.testing.assert_array_equal(t_png.read_png_gray(str(p)), j_png.read_png_gray(str(p)))


def test_png_errors(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        t_png.read_png(str(p))


@pytest.mark.parametrize("name", ["phantom", "einstein", "hopper", "mri", "terrain"])
def test_named_images_equal_jax(name):
    for n in (17, 64, 256):
        got = t_images.load_image(name, n)
        want = j_images.load_image(name, n)
        assert got.dtype == want.dtype == np.float32 and got.shape == (n, n)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_images.load_image(name, n, np.float64),
                                      j_images.load_image(name, n, np.float64))


@pytest.mark.parametrize("name, n, mean, std", [
    ("einstein", 512, 123.31, 48.54),
    ("hopper", 512, 81.39, 70.36),
    ("mri", 256, 45.84, 65.84),
])
def test_photographs_golden_statistics(name, n, mean, std):
    img = t_images.load_image(name, n)
    assert img.shape == (n, n) and 0.0 <= img.min() and img.max() <= 255.0
    assert abs(float(img.mean()) - mean) < 1.0
    assert abs(float(img.std()) - std) < 1.0


def test_load_image_errors():
    with pytest.raises(ValueError, match="cannot crop"):
        t_images.load_image("mri", 512)
    with pytest.raises(ValueError, match="unknown test image"):
        t_images.load_image("camera", 64)
