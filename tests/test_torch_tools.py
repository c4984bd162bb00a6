"""The port's data-preparation tools and evaluation scripts
(``artdeco_tpu_torch/scripts/``) against the JAX package's ``scripts/`` on
the same temporary inputs, with OpenCV on the JAX side only.

The JAX scripts run in one subprocess (each as ``__main__`` with its own
argv); the port's in this process through ``main(argv)``.  Tolerances:
none but for ``img2vid``.  Bitwise: ``rectify_tum``'s RGBA frames and
masks (compared as decoded pixels: the zlib streams may differ from
OpenCV's), the alpha-0 and alpha-1 camera matrices, the reflected-border
remap, the ``fx`` form of INTER_AREA (``downsampleImage``).  Equal text:
``rectify_tum``'s ``calib.yaml`` and stdout, ``img_summary``'s CSV,
``train_eval_all --dry_run``'s commands and the shell scripts' argv but
for the entry point and the results folder's name.  ``img2vid`` writes
Motion JPEG where the JAX script writes ``mp4v``: each sample decodes
within one level of OpenCV's quality-50 JPEG of the frame on at most
``LEVEL_SHARE`` of the values.
"""

import contextlib
import io
import json
import os
import stat
import struct
import subprocess
import sys

import cv2
import numpy as np
import pytest

from artdeco_tpu_torch.dataio import camera, resample
from artdeco_tpu_torch.dataio.image_io import image_size, read_png
from artdeco_tpu_torch.dataio.video import read_mp4_samples
from artdeco_tpu_torch.mapper.scene_io import write_png
from artdeco_tpu_torch.scripts import (downsampleImage, img2vid, img_summary, rectify_tum,
                                       train_eval_all)
from torch_parity import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(REPO, "artdeco_tpu_torch", "scripts")
LEVEL_SHARE = 1e-3
TUM = list(rectify_tum.TUM_CALIB)
# (h, w, factor): where the fx form of INTER_AREA departs from the dsize form
DOWNSAMPLE = [(481, 641, 2.0), (480, 640, 3.0), (479, 639, 1.5)]

# the JAX scripts, each run as __main__ with its argv, in one process
JAX_RUNNER = r"""
import contextlib, io, json, os, runpy, sys
sys.path.insert(0, {repo!r})
out = {{}}
for key, name, argv in json.loads(sys.argv[1]):
    buf = io.StringIO()
    sys.argv = [name] + argv
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join({repo!r}, "scripts", name + ".py"), run_name="__main__")
    out[key] = buf.getvalue()
print("@@" + json.dumps(out))
"""


def _smooth(rng, h, w):
    """A uint8 image with edges and gradients (random noise would test the
    same arithmetic but no realistic content)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([127 + 100 * np.sin(x / (7 + 3 * c) + y / (11 + c) + c) for c in range(3)], -1)
    img += 20 * rng.randn(h, w, 3)
    img[(x // 16 + y // 16) % 2 == 0] *= 0.6
    return np.clip(img, 0, 255).astype(np.uint8)


def _exif_jpeg(rgb, orientation):
    """A JPEG of ``rgb`` with an Exif APP1 segment holding ``orientation``."""
    ok, buf = cv2.imencode(".jpg", rgb[..., ::-1])
    assert ok
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 274, 3, 1, orientation, 0) + struct.pack("<I", 0))
    app1 = b"Exif\x00\x00" + tiff
    b = buf.tobytes()
    return b[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + b[2:]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Seeded inputs, one copy for each package where a script writes into
    its input: TUM ``rgb/`` folders (64x48 for the three calibrations of
    record, 640x480 for fr1_desk), the downsampling sizes, the image
    formats of ``img_summary``, img2vid's frames, and a BASE_DIR for the
    shell scripts."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.RandomState(0)
    for side in ("jax", "port"):
        for size, scenes, n in (("small", TUM, 3), ("full", TUM[:1], 2)):
            h, w = (48, 64) if size == "small" else (480, 640)
            for scene in scenes:
                d = root / side / size / scene / "rgb"
                os.makedirs(d)
                for i in range(n):
                    r = np.random.RandomState(i)
                    write_png(str(d / f"{1305031102.175304 + i / 30:.6f}.png"), _smooth(r, h, w))
    for h, w, f in DOWNSAMPLE:
        d = root / "down" / f"{w}x{h}"
        os.makedirs(d)
        cv2.imwrite(str(d / "a.png"), _smooth(rng, h, w))
    summ = root / "summary"
    img = _smooth(rng, 30, 50)
    for sub, name, kw in (("png", "a.png", ()), ("jpg", "a.jpg", ()), ("bmp", "a.bmp", ()),
                          ("tif", "a.tif", ()), ("tiff", "a.tiff", ()),
                          ("webp_lossy", "a.webp", (cv2.IMWRITE_WEBP_QUALITY, 50)),
                          ("webp_lossless", "a.webp", (cv2.IMWRITE_WEBP_QUALITY, 101))):
        os.makedirs(summ / sub)
        cv2.imwrite(str(summ / sub / name), img, list(kw))
        cv2.imwrite(str(summ / sub / ("b" + name[1:])), img[:20])
    os.makedirs(summ / "grey" / "nested")
    cv2.imwrite(str(summ / "grey" / "nested" / "g.png"), img[..., 0])
    os.makedirs(summ / "exif")
    with open(summ / "exif" / "o6.jpg", "wb") as fh:
        fh.write(_exif_jpeg(img, 6))
    os.makedirs(summ / "empty")
    frames = root / "frames"
    os.makedirs(frames)
    for i in range(4):
        write_png(str(frames / f"{i:03d}.png"), _smooth(np.random.RandomState(10 + i), 48, 64))
    base = root / "base"
    os.makedirs(base / "scene_a" / "images")
    os.makedirs(base / "scene_b" / "rgb")
    write_png(str(base / "scene_a" / "images" / "000.png"), img)
    return root


def _port(module, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module.main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(inputs):
    """Each call's (JAX stdout, port stdout); the outputs stay under
    ``inputs/{jax,port}``."""
    r = str(inputs)

    def calls(side):
        out = [(f"rectify {size}", "rectify_tum",
                ["--base_dir", f"{r}/{side}/{size}", "--scenes"] + scenes + ["TUM/unknown"])
               for size, scenes in (("small", TUM), ("full", TUM[:1]))]
        out += [(f"down {w}x{h}", "downsampleImage",
                 [f"{r}/down/{w}x{h}", "-o", f"{r}/{side}/down/{w}x{h}", "--factor", str(f)])
                for h, w, f in DOWNSAMPLE]
        subs = sorted(os.listdir(f"{r}/summary"))
        out.append(("summary", "img_summary",
                    [f"{r}/summary/{s}" for s in subs] + [f"{r}/summary/missing"]))
        out.append(("video", "img2vid", [f"{r}/frames", "-o", f"{r}/{side}/frames.mp4",
                                         "--fps", "24"]))
        out.append(("matrix", "train_eval_all",
                    ["--data_root", f"{r}/data", "--save_root", f"{r}/results", "--extra",
                     "--oracle --seq_length 40", "--dry_run"]))
        return out

    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", JAX_RUNNER.format(repo=REPO),
                          json.dumps(calls("jax"))], cwd=r, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    jax_out = json.loads(res.stdout.split("@@", 1)[1])
    modules = dict(rectify_tum=rectify_tum, downsampleImage=downsampleImage,
                   img_summary=img_summary, img2vid=img2vid, train_eval_all=train_eval_all)
    return {key: (jax_out[key], _port(modules[name], argv)) for key, name, argv in calls("port")}


# -- the camera matrix, the remap and INTER_AREA ------------------------------

@pytest.mark.parametrize("scene", TUM)
@pytest.mark.parametrize("alpha", [0, 1, 0.3])
def test_optimal_new_camera_matrix_alpha(scene, alpha):
    p = rectify_tum.TUM_CALIB[scene]
    K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
    d = np.asarray(p[4:], np.float64)
    for w, h in ((640, 480), (64, 48)):
        want = cv2.getOptimalNewCameraMatrix(K, d, (w, h), alpha, (w, h),
                                             centerPrincipalPoint=True)[0]
        np.testing.assert_array_equal(camera.optimal_new_camera_matrix(K, d, w, h, alpha), want)


@pytest.mark.parametrize("channels", [1, 3])
def test_remap_reflect_matches_cv2(channels):
    """BORDER_REFLECT on rectify_tum's maps (fr1_desk, alpha 1) and on maps
    that reach several image widths outside, where the reflection repeats."""
    rng = np.random.RandomState(channels)
    p = rectify_tum.TUM_CALIB[TUM[0]]
    for h, w in ((480, 640), (48, 64)):
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.randint(0, 256, shape).astype(np.uint8)
        K_in, d, K_out = rectify_tum.rectified_K(p, h, w)
        maps = cv2.initUndistortRectifyMap(K_in, d, None, K_out, (w, h), cv2.CV_32FC2)[0]
        mx, my = camera.undistort_maps(K_in, d, K_out, w, h)
        np.testing.assert_array_equal(np.stack([mx, my], -1), maps)
        np.testing.assert_array_equal(
            resample.remap_bilinear(img, mx, my, border="reflect"),
            cv2.remap(img, maps, None, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT))
        np.testing.assert_array_equal(resample.remap_bilinear(img, mx, my),
                                      cv2.remap(img, maps, None, cv2.INTER_LINEAR))
    img = rng.randint(0, 256, (37, 53) + (() if channels == 1 else (channels,))).astype(np.uint8)
    mx = (rng.rand(40, 60) * 400 - 200).astype(np.float32)
    my = (rng.rand(40, 60) * 300 - 150).astype(np.float32)
    np.testing.assert_array_equal(
        resample.remap_bilinear(img, mx, my, border="reflect"),
        cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT))
    f = img.astype(np.float32) / 255
    np.testing.assert_array_equal(
        resample.remap_bilinear(f, mx, my, border="reflect"),
        cv2.remap(f, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT))
    with pytest.raises(ValueError, match="border"):
        resample.remap_bilinear(img, mx, my, border="replicate")


@pytest.mark.parametrize("h,w,factor", DOWNSAMPLE + [(483, 643, 2.0), (485, 643, 3.0),
                                                     (54, 63, 4.0), (7, 9, 2.0),
                                                     (100, 130, 1.7)])
def test_resize_area_scale_matches_cv2(h, w, factor):
    """The fx form, uint8 and float32: the three sizes where the dsize form
    is off by tens of levels, and integer scales whose last blocks pass the
    image's edge (643 / 2 rounds up to 322, 54 / 4 to 14)."""
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = cv2.resize(img, (0, 0), fx=1 / factor, fy=1 / factor, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resample.resize_area_scale(img, 1 / factor, 1 / factor), want)
    f = img.astype(np.float32) / 255
    np.testing.assert_array_equal(
        resample.resize_area_scale(f, 1 / factor, 1 / factor),
        cv2.resize(f, (0, 0), fx=1 / factor, fy=1 / factor, interpolation=cv2.INTER_AREA))
    # the dsize form at the same size is the data path's, and stays so
    dh, dw = want.shape[:2]
    np.testing.assert_array_equal(resample.resize_area(img, dw, dh),
                                  cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA))


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_write_png_grey_rgb_rgba(tmp_path, channels):
    rng = np.random.RandomState(5)
    shape = (21, 34) if channels is None else (21, 34, channels)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels == 3:
        got = got[..., ::-1]
    elif channels == 4:
        got = got[..., [2, 1, 0, 3]]
    np.testing.assert_array_equal(got, img)
    rgb = read_png(path)
    np.testing.assert_array_equal(rgb, np.repeat(img[..., None], 3, 2) if channels is None
                                  else img[..., :3])
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, img.astype(np.float32))


# -- the scripts against the JAX ones -------------------------------------------

@pytest.mark.parametrize("size", ["small", "full"])
def test_rectify_tum_matches_jax(inputs, runs, size):
    jtxt, txt = runs[f"rectify {size}"]
    assert txt.replace(str(inputs / "port"), "D") == jtxt.replace(str(inputs / "jax"), "D")
    scenes = TUM if size == "small" else TUM[:1]
    for scene in scenes:
        jd, pd = inputs / "jax" / size / scene, inputs / "port" / size / scene
        names = sorted(os.listdir(jd / "images"))
        assert names and names == sorted(os.listdir(pd / "images"))
        for name in names:
            want = cv2.imread(str(jd / "images" / name), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(pd / "images" / name), cv2.IMREAD_UNCHANGED)
            assert want.shape[2] == 4
            np.testing.assert_array_equal(got, want)
            stem = os.path.splitext(name)[0] + ".png"
            np.testing.assert_array_equal(
                cv2.imread(str(pd / "masks" / stem), cv2.IMREAD_UNCHANGED),
                cv2.imread(str(jd / "masks" / stem), cv2.IMREAD_UNCHANGED))
        with open(jd / "calib.yaml") as a, open(pd / "calib.yaml") as b:
            assert a.read() == b.read()
    if size == "full":
        # fr1_desk at 640x480: the alpha-1 focal of record, and a border of
        # invalid pixels
        with open(inputs / "port" / "full" / TUM[0] / "calib.yaml") as f:
            assert f.read().startswith("fx: 500.087452\nfy: 500.087452\ncx: 319.500000\n")
        mask = cv2.imread(str(inputs / "port" / "full" / TUM[0] / "masks" / names[0]),
                          cv2.IMREAD_UNCHANGED)
        assert 0 < np.sum(mask == 0) < mask.size // 4


@pytest.mark.parametrize("h,w,factor", DOWNSAMPLE)
def test_downsample_image_matches_jax(inputs, runs, h, w, factor):
    jtxt, txt = runs[f"down {w}x{h}"]
    assert txt == jtxt == "done\n"
    want = cv2.imread(str(inputs / "jax" / "down" / f"{w}x{h}" / "a.png"))
    got = read_png(str(inputs / "port" / "down" / f"{w}x{h}" / "a.png"))
    assert got.shape == want.shape == (int(np.rint(h / factor)), int(np.rint(w / factor)), 3)
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_downsample_image_refuses_jpeg_output(tmp_path):
    cv2.imwrite(str(tmp_path / "a.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="quality 95"):
        downsampleImage.main([str(tmp_path), "-o", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")


def test_img_summary_matches_jax(runs):
    jtxt, txt = runs["summary"]
    assert txt == jtxt
    assert "exif,1,30x50\n" in txt and "webp_lossy,2,50x30\n" in txt and "empty,0,\n" in txt


def test_img_summary_raises_on_a_malformed_header(tmp_path):
    """The JAX script prints an empty size where ``cv2.imread`` fails; the
    port raises."""
    os.makedirs(tmp_path / "bad")
    with open(tmp_path / "bad" / "a.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"\x00" * 4)
    with pytest.raises(ValueError, match="a.png"):
        img_summary.main([str(tmp_path / "bad")])


def test_image_size_formats(inputs):
    summ = inputs / "summary"
    for sub in sorted(os.listdir(summ)):
        for dirpath, _, files in os.walk(summ / sub):
            for f in files:
                im = cv2.imread(os.path.join(dirpath, f))
                assert image_size(os.path.join(dirpath, f)) == (im.shape[1], im.shape[0]), f



def test_jpeg_size_reads_baseline_only_unless_asked(tmp_path):
    """``jpeg_size`` checks that a sample is the baseline (SOF0) JPEG that
    ``encode_jpeg`` writes; ``image_size`` reads any start-of-frame marker."""
    from artdeco_tpu_torch.dataio.jpeg import SOF_MARKERS, encode_jpeg, jpeg_size

    img = np.random.RandomState(0).randint(0, 256, (10, 20, 3)).astype(np.uint8)
    assert jpeg_size(encode_jpeg(img)) == (20, 10)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok and b"\xff\xc2" in buf.tobytes()
    with pytest.raises(ValueError, match="0xc0"):
        jpeg_size(buf.tobytes())
    assert jpeg_size(buf.tobytes(), SOF_MARKERS) == (20, 10)
    buf.tofile(str(tmp_path / "p.jpg"))
    assert image_size(str(tmp_path / "p.jpg")) == (20, 10)

def test_img2vid_writes_motion_jpeg(inputs, runs):
    jtxt, txt = runs["video"]
    assert txt.replace(str(inputs / "port"), "D") == jtxt.replace(str(inputs / "jax"), "D")
    assert os.path.getsize(inputs / "jax" / "frames.mp4") > 0
    mp4 = read_mp4_samples(str(inputs / "port" / "frames.mp4"))
    names = sorted(os.listdir(inputs / "frames"))
    assert (mp4["kind"], mp4["width"], mp4["height"], mp4["fps"]) == ("jpeg", 64, 48, 24.0)
    assert len(mp4["samples"]) == len(names) == 4
    for name, sample in zip(names, mp4["samples"]):
        bgr = cv2.imread(str(inputs / "frames" / name))
        ok, ref = cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 50])
        got = cv2.imdecode(np.frombuffer(sample, np.uint8), cv2.IMREAD_COLOR).astype(int)
        d = np.abs(got - cv2.imdecode(ref, cv2.IMREAD_COLOR))
        assert d.max() <= 1 and np.mean(d > 0) <= LEVEL_SHARE


def test_img2vid_raises_on_a_frame_of_another_size(tmp_path):
    write_png(str(tmp_path / "0.png"), np.zeros((8, 8, 3), np.uint8))
    write_png(str(tmp_path / "1.png"), np.zeros((8, 6, 3), np.uint8))
    with pytest.raises(ValueError, match="1.png"):
        img2vid.main([str(tmp_path), "-o", str(tmp_path / "a.mp4")])


def test_train_eval_all_dry_run_matches_jax(runs):
    jtxt, txt = runs["matrix"]
    lines = txt.splitlines()
    assert len(lines) == 9 and all(" -m artdeco_tpu_torch.run_system -s " in ln for ln in lines)
    assert txt.replace(" -m artdeco_tpu_torch.run_system ", " run_system.py ") == jtxt


def test_train_eval_all_runs_every_scene_and_fails_on_a_failed_run(tmp_path, monkeypatch):
    """Every scene runs, as in the JAX script; a failed run makes the script
    exit 1 naming it (the JAX script ignores the exit codes)."""
    log = tmp_path / "argv.txt"
    fake = tmp_path / "fake_python"
    fake.write_text(f'#!/bin/bash\necho "$*" >> {log}\n[[ "$*" != *xyz* ]]\n')
    fake.chmod(0o755)
    monkeypatch.setattr(sys, "executable", str(fake))
    with pytest.raises(SystemExit, match=r"tum/rgbd_dataset_freiburg2_xyz \(exit 1\)"):
        with contextlib.redirect_stdout(io.StringIO()):
            train_eval_all.main(["--data_root", str(tmp_path / "d"), "--datasets", "tum",
                                 "--save_root", str(tmp_path / "r")])
    ran = log.read_text().splitlines()
    assert len(ran) == 3 and all(a.startswith("-m artdeco_tpu_torch.run_system -s ")
                                 for a in ran)


FAKE_PYTHON = """#!/bin/bash
# records its argv and writes the run's metadata, as run_system would
printf '%s\\n' "$*" >> "$ARGV_LOG"
dst=""
while [[ $# -gt 0 ]]; do
    if [[ "$1" == "-m" && "$2" != artdeco_tpu_torch.* ]]; then dst="$2"; fi
    shift
done
mkdir -p "$dst" && echo '{}' > "$dst/run_metadata.json"
"""


@pytest.mark.parametrize("kind", ["rigid", "norigid"])
def test_debug_scripts_match_jax(inputs, tmp_path, kind):
    """The JAX and port scripts against a fake ``python`` on PATH that records
    its argv: the same argv but for the entry point and the results folder,
    the same messages, and a second run skips the scene."""
    name = f"run_debug_{kind}transform.sh"
    port_sh = os.path.join(PORT_SCRIPTS, name)
    assert os.stat(port_sh).st_mode & stat.S_IXUSR
    bindir = tmp_path / "bin"
    os.makedirs(bindir)
    (bindir / "python").write_text(FAKE_PYTHON)
    (bindir / "python").chmod(0o755)
    out = {}
    for side, script in (("jax", os.path.join(REPO, "scripts", name)), ("port", port_sh)):
        log = tmp_path / f"{side}.log"
        env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}", ARGV_LOG=str(log),
                   BASE_DIR=str(inputs / "base"), RESULT_DIR=str(tmp_path / "results"))
        first = subprocess.run([script], cwd=str(tmp_path), env=env, capture_output=True,
                               text=True, timeout=60)
        second = subprocess.run([script], cwd=str(tmp_path), env=env, capture_output=True,
                                text=True, timeout=60)
        assert first.returncode == second.returncode == 0, first.stderr + second.stderr
        out[side] = (first.stdout, second.stdout, log.read_text())
    folder = f"artdeco-tpu-{kind}transform"
    port_folder = f"artdeco-tpu-torch-{kind}transform"

    def as_jax(text):
        return (text.replace("-m artdeco_tpu_torch.run_system", "run_system.py")
                .replace(port_folder, folder))

    for got, want in zip(out["port"], out["jax"]):
        assert as_jax(got) == want
    first, second, argv = out["port"]
    assert argv.count("\n") == 1 and port_folder in argv
    assert "No images/ in" in first and "scene_b" in first
    assert f"{port_folder} contains results" in second
    assert os.path.isfile(tmp_path / "results" / "scene_a" / folder / "run_metadata.json")
