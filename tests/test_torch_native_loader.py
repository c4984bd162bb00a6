"""The port's native loader against the JAX package's, on the CPU.

Both bind ``native/artdeco_io.cpp`` through ctypes: the JAX package builds
it into ``native/``, the port into ``build/native/``.  Decoded images and
the prefetcher's SLAM and map tensors must be bitwise equal; the port's
decoding of frames (``image_io.load_image``, the datasets' ``_load_image``)
must give the JAX package's cv2 bytes (PNG: equal; JPEG: a mean absolute
difference under 3 levels, ``tests/test_native_loader.py``'s bound, as
the system libjpeg need not round as OpenCV's libjpeg-turbo does).
Skipped, as the JAX test is, only where g++ or the codec headers are
missing.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from artdeco_tpu.dataio.camera import PinholeCamera as JPinholeCamera
from artdeco_tpu.runtime import native_loader as jnative
from artdeco_tpu_torch.dataio.camera import PinholeCamera
from artdeco_tpu_torch.dataio.image_io import load_image, read_png
from artdeco_tpu_torch.runtime import native_loader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not native_loader.native_available(),
    reason=f"native toolchain missing: {native_loader.missing_toolchain()}")


@pytest.fixture(scope="module")
def image_paths(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths = []
    u, v = np.meshgrid(np.arange(96), np.arange(64))
    for i in range(6):
        img = np.stack([127 + 100 * np.sin((u + 10 * i) / 9.0), 127 + 100 * np.cos(v / 7.0),
                        rng.randint(0, 255, (64, 96))], axis=-1).astype(np.uint8)
        p = str(d / (f"f_{i:03d}.png" if i % 2 == 0 else f"f_{i:03d}.jpg"))
        cv2.imwrite(p, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        paths.append(p)
    return paths


def test_decode_matches_jax(image_paths):
    cv2 = pytest.importorskip("cv2")
    for p in image_paths:
        got = native_loader.decode_image(p)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jnative.decode_image(p))
        np.testing.assert_array_equal(load_image(p), got)
        ref = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        if p.endswith(".png"):
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(read_png(p), ref)
        else:
            assert np.abs(got.astype(int) - ref.astype(int)).mean() < 3.0
    with pytest.raises(FileNotFoundError):
        load_image(image_paths[0] + ".missing")
    with pytest.raises(IOError):
        native_loader.decode_image(image_paths[0] + ".missing")


@pytest.mark.parametrize("downsample", [2.0, 1.5])
def test_prefetcher_matches_jax(image_paths, downsample):
    """The same frames through both packages' prefetchers: SLAM and map
    tensors bitwise equal, in order, at an integer and a fractional map
    factor."""
    kw = dict(target_size_slam=64, downsample_map=downsample, W_original=96, H_original=64,
              calib_parameter=[80.0, 80.0, 48.0, 32.0])
    cam, jcam = PinholeCamera(**kw), JPinholeCamera(**kw)
    pf = native_loader.NativePrefetcher(image_paths, cam, ring_size=3, n_threads=2)
    jpf = jnative.NativePrefetcher(image_paths, jcam, ring_size=3, n_threads=2)
    try:
        for p in image_paths:
            slam, mp = pf.get()
            jslam, jmp = jpf.get()
            assert slam.shape == (3, cam.H_slam, cam.W_slam)
            assert mp.shape == (3, cam.H_map, cam.W_map)
            np.testing.assert_array_equal(slam, jslam)
            np.testing.assert_array_equal(mp, jmp)
            # the native filters are not OpenCV's: the JAX test's bounds
            img = load_image(p)
            assert np.abs(slam - cam.to_slam(img)).mean() < 0.05, p
            assert np.abs(mp - cam.to_map(img)).mean() < 0.03, p
    finally:
        pf.close()
        jpf.close()


def test_build_lands_under_build_and_a_broken_build_raises(tmp_path, monkeypatch):
    """The library lives under ``build/native/``; the compiler is pointed
    at ``native/`` only to read the source; a source that does not compile
    raises with the compiler's output."""
    lib = native_loader.build_native()
    assert os.path.realpath(lib).startswith(os.path.join(os.path.realpath(REPO), "build") + os.sep)
    assert os.path.isfile(lib)

    seen = []
    real_run = subprocess.run

    def record(cmd, *a, **k):
        seen.append(list(cmd))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(native_loader.subprocess, "run", record)
    out = str(tmp_path / "lib" / "libartdeco_io.so")
    assert native_loader.build_native(force=True, out=out) == out and os.path.isfile(out)
    native_dir = os.path.join(os.path.realpath(REPO), "native")
    assert [a for a in seen[0] if os.path.realpath(a).startswith(native_dir)] == [
        native_loader.SRC]

    broken = tmp_path / "broken.cpp"
    shutil.copy(native_loader.SRC, broken)
    broken.write_text(broken.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="error"):
        native_loader.build_native(src=str(broken), out=str(tmp_path / "broken.so"))
    assert not os.path.exists(tmp_path / "broken.so")
