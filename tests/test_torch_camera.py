"""The port's camera and resampling against the JAX package's (OpenCV), on
the CPU.

``artdeco_tpu_torch/dataio/camera.py`` and ``dataio/resample.py`` compute
without OpenCV what ``artdeco_tpu/dataio/camera.py`` asks of cv2 5.0.
Tolerances (the measured gaps in brackets):

* ``K_best``, ``K_slam``, ``K_map`` and the sizes: equal (float32).
* The undistortion maps: within 1e-3 px [0: equal].
* The undistorted (remapped) uint8 image: equal [equal].
* ``to_slam`` by INTER_AREA (640x480 -> 512, 200x150 -> 128, 1920x1080 ->
  512) and ``to_map`` by INTER_AREA (factors 2, 1.5 and 4): equal [equal].
* ``to_slam`` by INTER_CUBIC (300x200 -> 512): within one level (2/255)
  on at most 1e-4 of the values, equal elsewhere [at most 4e-5 off by
  one level; OpenCV 5.0 rounds its own way at near-ties].
"""

import types

import numpy as np
import pytest

from artdeco_tpu.dataio.camera import PinholeCamera as JPinholeCamera
from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu_torch.dataio import resample
from artdeco_tpu_torch.dataio.camera import PinholeCamera
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.dataio.image_io import read_png

TUM_CALIB = [517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


def _frame(h, w, seed=0):
    """Smooth structure plus noise: both flat and busy regions."""
    rng = np.random.RandomState(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    img = np.stack([127 + 100 * np.sin(u / 9.0), 127 + 100 * np.cos(v / 7.0),
                    127 + 60 * np.sin((u + v) / 5.0)], -1)
    return np.clip(img + rng.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _cameras(size, ds, w, h, calib, **kw):
    return PinholeCamera(size, ds, w, h, calib, **kw), JPinholeCamera(size, ds, w, h, calib, **kw)


def _same_geometry(cam, jcam):
    for name in ("H_slam", "W_slam", "H_map", "W_map", "scale_slam_w", "scale_slam_h",
                 "half_crop_w", "half_crop_h", "target_size", "W_original", "H_original"):
        assert getattr(cam, name) == getattr(jcam, name), name
    for name in ("K_best", "K_slam", "K_map"):
        a, b = getattr(cam, name), getattr(jcam, name)
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("size,ds,w,h,calib", [
    (512, 1.0, 640, 480, TUM_CALIB),                                   # TUM fr1, 5 terms
    (512, 2.0, 640, 480, [500.0, 501.0, 322.0, 236.0, -0.1, 0.01, 0.0, 0.0]),  # OPENCV
    (512, 1.5, 1920, 1080, [1500.0, 1500.0, 960.0, 540.0, 0.05, -0.02, 0.001, -0.001]),
    (128, 4.0, 200, 150, [160.0, 160.0, 100.0, 75.0, -0.2, 0.0, 0.0, 0.0]),  # SIMPLE_RADIAL
])
def test_undistortion_matches_opencv(size, ds, w, h, calib):
    cam, jcam = _cameras(size, ds, w, h, calib)
    _same_geometry(cam, jcam)
    assert cam.mapx is not None and jcam.mapx is not None
    for a, b in ((cam.mapx, jcam.mapx), (cam.mapy, jcam.mapy)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    img = _frame(h, w)
    np.testing.assert_array_equal(cam._undistort(img), jcam._undistort(img))
    np.testing.assert_array_equal(cam.to_slam(img), jcam.to_slam(img))
    np.testing.assert_array_equal(cam.to_map(img), jcam.to_map(img))


@pytest.mark.parametrize("w,h,size,ds", [
    (640, 480, 512, 2.0), (200, 150, 128, 1.5), (1920, 1080, 512, 4.0), (512, 384, 512, 1.0),
])
def test_area_resampling_matches_opencv(w, h, size, ds):
    """Zero distortion: no remap; INTER_AREA for the SLAM stream (or only
    the crop at the target size) and the map stream, bit for bit."""
    cam, jcam = _cameras(size, ds, w, h, [0.8 * w, 0.8 * w, w / 2, h / 2])
    _same_geometry(cam, jcam)
    assert cam.mapx is None and jcam.mapx is None
    for seed in (0, 1):
        img = _frame(h, w, seed)
        np.testing.assert_array_equal(cam.to_slam(img), jcam.to_slam(img))
        np.testing.assert_array_equal(cam.to_map(img), jcam.to_map(img))
    # float frames go through uint8 for the SLAM stream and stay float for the map
    f = _frame(h, w).astype(np.float32) / 255.0
    np.testing.assert_array_equal(cam.to_slam(f), jcam.to_slam(f))
    np.testing.assert_array_equal(cam.to_map(f), jcam.to_map(f))


def test_cubic_resampling_matches_opencv():
    """300x200 -> 512: INTER_CUBIC enlarges the SLAM image."""
    cam, jcam = _cameras(512, 1.0, 300, 200, [240.0, 240.0, 150.0, 100.0])
    _same_geometry(cam, jcam)
    off = 0
    for seed in (0, 1, 2):
        img = _frame(200, 300, seed)
        a, b = cam.to_slam(img), jcam.to_slam(img)
        d = np.abs(a - b)
        assert d.max() <= 2.0 / 255 + 1e-6
        off += int((d > 0).sum())
    assert off <= 1e-4 * 3 * a.size, off


def test_resample_functions_match_cv2():
    """``resample`` against cv2 directly: INTER_AREA of uint8 and float32
    at integer and fractional scales, INTER_CUBIC of uint8."""
    cv2 = pytest.importorskip("cv2")
    img = _frame(96, 130, 3)
    for dw, dh in ((65, 48), (43, 32), (100, 70), (26, 24)):
        np.testing.assert_array_equal(resample.resize_area(img, dw, dh),
                                      cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA))
        f = img.astype(np.float32) / 255.0
        np.testing.assert_array_equal(resample.resize_area(f, dw, dh),
                                      cv2.resize(f, (dw, dh), interpolation=cv2.INTER_AREA))
    a = resample.resize_cubic(img, 260, 192)
    b = cv2.resize(img, (260, 192), interpolation=cv2.INTER_CUBIC)
    assert np.abs(a.astype(int) - b).max() <= 1 and np.mean(a != b) <= 1e-4


@pytest.mark.parametrize("w,h,max_size_slam", [(512, 384, 512), (640, 480, 512)])
def test_optimize_focal_keeps_the_raw_intrinsics(w, h, max_size_slam):
    """Fault 1: under ``--optimize_focal`` the JAX camera keeps the raw K
    (no optimal new camera matrix); the port's did not have the switch and
    tracked 0.42 % off at 512x384."""
    args = types.SimpleNamespace(test_hold=8, max_size_slam=max_size_slam, optimize_focal=True)
    ds = SyntheticDataset(args, n_frames=2, width=w, height=h)
    jds = JSyntheticDataset(types.SimpleNamespace(**vars(args)), n_frames=2, width=w, height=h)
    for name in ("K_slam", "K_map"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), err_msg=name)
    assert ds.K_slam[0, 0] == np.float32(0.8 * w * max_size_slam / max(w, h))
    cam, jcam = _cameras(512, 2.0, 640, 480, TUM_CALIB, optimize_focal=True)
    _same_geometry(cam, jcam)
    assert cam.mapx is None and jcam.mapx is None


def _png_bytes(rows: np.ndarray, filters) -> bytes:
    """An 8-bit RGB PNG of ``rows`` (H, W, 3) with the given filter type
    per row (the encoder side of the five PNG filters)."""
    import struct
    import zlib

    h, w, _ = rows.shape
    x = rows.reshape(h, w * 3).astype(np.int64)
    raw = b""
    for y in range(h):
        ft, cur = filters[y % len(filters)], x[y]
        prior = x[y - 1] if y else np.zeros_like(cur)
        a = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        c = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if ft == 0:
            f = cur
        elif ft == 1:
            f = cur - a
        elif ft == 2:
            f = cur - prior
        elif ft == 3:
            f = cur - (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            f = cur - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        raw += bytes([ft]) + (f & 255).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decoder_undoes_every_filter(tmp_path):
    """The numpy PNG decoder (used where the native loader cannot be
    built) on rows of each filter type, and on a PNG cv2 wrote."""
    img = _frame(24, 20, 4)
    p = tmp_path / "filters.png"
    p.write_bytes(_png_bytes(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(read_png(str(p)), img)
    cv2 = pytest.importorskip("cv2")
    q = str(tmp_path / "cv2.png")
    cv2.imwrite(q, cv2.cvtColor(_frame(48, 64), cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(read_png(q), cv2.cvtColor(cv2.imread(q), cv2.COLOR_BGR2RGB))
