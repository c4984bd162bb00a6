"""The port's real-image data path against the JAX package's, on the CPU.

The image-folder, TUM and COLMAP datasets (``load_dataset``), the
auto-calibration that replaces a guessed focal, a short on-disk stream
through ``System.run`` with both loaders, and the batch harness
``eval_scenes``.  Frames are PNGs of the synthetic plane stream, so the
port (libpng through the native loader, or numpy + zlib) and the JAX
package (cv2) decode the same bytes.  Tolerances (measured gaps in
brackets):

* names, timestamps, test split, sizes, ``K_slam``/``K_map``: equal;
  ``Twc_gt``: equal, NaN where a TUM frame has no ground truth within
  0.05 s; frames and their ``to_slam``/``to_map``: equal.
* the recalibrated focal on a plane's pointmap: within 1e-3 px of JAX's
  [equal], no warning.
* the stream (16 frames, 160x120, SLAM 128x96, map 80x60 by INTER_AREA at
  2, ``tests/test_torch_system.py``'s settings and mapper seeding): the
  same keyframes and 0 lost; keyframe poses and every frame's pose within
  1e-4 [equal] with either loader; test PSNR within 0.1 dB of JAX's with
  the Python loader [equal to 4 digits], and within 0.3 dB with the
  native one, whose map images are its own unrounded area averages
  [0.04 dB].
"""

import contextlib
import importlib.util
import io
import os
import sys
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from artdeco_tpu.dataio import dataset as JD
from artdeco_tpu.mapper.scene_io import write_colmap_model
from artdeco_tpu.models.oracle import OracleRunner as JOracleRunner
from artdeco_tpu.runtime.system import System as JSystem
from artdeco_tpu.utils.config import load_config as jload_config
from artdeco_tpu_torch import eval_scenes
from artdeco_tpu_torch.dataio import dataset as D
from artdeco_tpu_torch.dataio.tum_io import save_tum_trajectory
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.scene_io import write_png
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime import native_loader
from artdeco_tpu_torch.runtime.system import System, make_native_prefetcher, stream_slam_images
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from test_system import _args
from test_torch_system import SIZES, _config
from torch_parity import CPU, JaxKeyChain, jax_scene_state, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N = 160, 120, 16


def _stream():
    return D.SyntheticDataset(_args(), n_frames=N, width=W, height=H)


def _write_folder(root, gt=True, calib=True):
    """The synthetic stream as a self-captured folder: images/*.png, a
    TUM-format groundtruth.txt and a calibration YAML of its intrinsics."""
    syn = _stream()
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(N):
        write_png(os.path.join(root, "images", syn.image_name_list[i]), syn[i][0])
    if gt:
        save_tum_trajectory(os.path.join(root, "groundtruth.txt"), syn.timestamp, syn.Twc_gt)
    path = os.path.join(root, "calib.yaml")
    if calib:
        with open(path, "w") as f:
            yaml.safe_dump({"width": W, "height": H,
                            "calibration": [0.8 * W, 0.8 * W, W / 2, H / 2]}, f)
    return path


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    return root, _write_folder(root)


@pytest.fixture(scope="module")
def tum(tmp_path_factory):
    """TUM layout: rgb/<ts>.png listed in rgb.txt at 30 Hz; ground truth at
    100 Hz with a gap that leaves frames 5-7 unassociated."""
    root = str(tmp_path_factory.mktemp("tum"))
    syn = _stream()
    os.makedirs(os.path.join(root, "rgb"))
    ts = 1305031102.175304 + np.arange(N) / 30.0
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n")
        for i in range(N):
            rel = f"rgb/{ts[i]:.6f}.png"
            write_png(os.path.join(root, rel), syn[i][0])
            f.write(f"{ts[i]:.6f} {rel}\n")
    gts = ts[0] - 0.02 + np.arange(0, N / 30.0 + 0.05, 0.01)
    keep = ~((gts > ts[5] - 0.06) & (gts < ts[7] + 0.06))
    poses = np.zeros((len(gts), 7))
    poses[:, 0] = 0.02 * 30.0 * (gts - ts[0])
    poses[:, 6] = 1.0
    save_tum_trajectory(os.path.join(root, "groundtruth.txt"), gts[keep], poses[keep])
    return root


def _colmap(root, model_id, params):
    syn = _stream()
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    images = {}
    for i in range(N):
        write_png(os.path.join(root, "images", syn.image_name_list[i]), syn[i][0])
        if i % 5 == 3:
            continue            # an image the model does not hold: no pose
        ang = 0.05 * i
        images[i + 1] = dict(qvec=[np.cos(ang / 2), 0.0, np.sin(ang / 2), 0.0],
                             tvec=[0.1 * i, -0.02 * i, 0.3], camera_id=1,
                             name=syn.image_name_list[i])
    write_colmap_model(os.path.join(root, "sparse", "0"),
                       {1: dict(model_id=model_id, width=W, height=H, params=params)}, images)
    return root


def _same_dataset(ds, jds, frames=(0, 5, N - 1)):
    assert type(ds).__name__ == type(jds).__name__
    for name in ("H", "W", "H_slam", "W_slam", "H_map", "W_map", "image_name_list",
                 "timestamp", "infos", "calib_is_guess", "downsampling"):
        assert getattr(ds, name) == getattr(jds, name), name
    assert [os.path.relpath(p, ds.image_dir) for p in ds.image_paths] == [
        os.path.relpath(p, jds.image_dir) for p in jds.image_paths]
    for name in ("K_slam", "K_map"):
        a, b = getattr(ds, name), getattr(jds, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if jds.Twc_gt is None:
        assert ds.Twc_gt is None
    else:
        np.testing.assert_array_equal(ds.Twc_gt, jds.Twc_gt)
    for i in frames:
        if i >= len(jds):
            continue
        img, info = ds[i]
        # what the JAX package's __getitem__ gives (it fails on TUM frames)
        jimg = jds._load_image(jds.image_paths[i])
        jinfo = dict(jds.infos[jds.image_name_list[i]])
        if jds.Twc_gt is not None:
            jinfo["Twc_gt"] = jds.Twc_gt[i]
        np.testing.assert_array_equal(img, jimg)
        if "Twc_gt" in jinfo:
            np.testing.assert_array_equal(info.pop("Twc_gt"), jinfo.pop("Twc_gt"))
        assert info == jinfo
        np.testing.assert_array_equal(ds.transform.to_slam(img), jds.transform.to_slam(jimg))
        np.testing.assert_array_equal(ds.transform.to_map(img), jds.transform.to_map(jimg))


def _both(**kw):
    args = _args(**kw)
    return D.load_dataset(args), JD.load_dataset(types.SimpleNamespace(**vars(args)))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(calib=None),                                   # the 0.7 * W guess
    dict(calib=None, init_fov=70.0),
    dict(calib=None, init_focal=100.0, max_size_slam=160, downsampling=1.0),
    dict(image_sampling=2, start_at=1, end_at=1),
    dict(start_at=3, seq_length=5, test_hold=2),
    dict(optimize_focal=True, downsampling=1.5),
])
def test_self_captured_matches_jax(folder, kw):
    root, calib = folder
    kw = dict(dict(dataset_name="selfCaptured", source_path=root, calib=calib), **kw)
    ds, jds = _both(**kw)
    assert ds.calib_is_guess == (kw["calib"] is None and "init_fov" not in kw
                                 and "init_focal" not in kw)
    _same_dataset(ds, jds)


def test_self_captured_without_ground_truth(tmp_path):
    root = str(tmp_path)
    calib = _write_folder(root, gt=False)
    ds, jds = _both(dataset_name="selfCaptured", source_path=root, calib=calib)
    assert ds.Twc_gt is None
    _same_dataset(ds, jds)


@pytest.mark.parametrize("kw", [dict(), dict(start_at=2, image_sampling=3)])
def test_tum_matches_jax(tum, kw):
    ds, jds = _both(dataset_name="tum", source_path=tum, **kw)
    assert np.isnan(ds.Twc_gt).any() and np.isfinite(ds.Twc_gt).any()
    # the JAX package keys a frame's info by its listed name "rgb/<ts>.png"
    # and looks it up by the basename
    with pytest.raises(KeyError):
        jds[0]
    _same_dataset(ds, jds)


@pytest.mark.parametrize("name,model_id,params", [
    ("colmap", 1, [128.0, 130.0, 80.0, 60.0]),                           # PINHOLE
    ("colmap", 4, [128.0, 128.0, 79.0, 61.0, -0.05, 0.01, 0.001, 0.0]),  # OPENCV
    ("selfCaptured", 0, [128.0, 80.0, 60.0]),    # SIMPLE_PINHOLE, auto-detected
])
def test_colmap_matches_jax(tmp_path, name, model_id, params):
    root = _colmap(str(tmp_path), model_id, params)
    ds, jds = _both(dataset_name=name, source_path=root, calib=None)
    assert isinstance(ds, D.ColmapDataset)
    assert (ds.transform.mapx is not None) == (model_id == 4)
    assert np.isnan(ds.Twc_gt).any()
    _same_dataset(ds, jds)


def test_without_the_native_loader(folder, tmp_path, monkeypatch):
    """A machine without the codec headers (the card's): the Python loader
    runs, PNG frames decode by numpy + zlib to the same bytes, and a JPEG
    raises with the compiler's reason."""
    cv2 = pytest.importorskip("cv2")
    why = "<stdin>:3:10: fatal error: jpeglib.h: No such file or directory"
    monkeypatch.setattr(native_loader, "_missing", why)
    root, calib = folder
    ds, jds = _both(dataset_name="selfCaptured", source_path=root, calib=calib)
    assert make_native_prefetcher(ds) is None
    _same_dataset(ds, jds)
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        D.BaseDataset._load_image(jpg)


class _PlaneRunner:
    """A model stand-in whose mono pointmap is a fronto-parallel plane seen
    with the focal ``f`` (SLAM pixels)."""

    def __init__(self, h, w, f, torch_out):
        u, v = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
        z = np.float32(2.0)
        X = np.stack([(u - (w - 1) / 2) / f * z, (v - (h - 1) / 2) / f * z,
                      np.full_like(u, z)], -1).reshape(1, h * w, 3)
        self.X = np.concatenate([X, X]).astype(np.float32)
        self.C = np.ones((2, h * w, 1), np.float32)
        self.torch_out = torch_out
        self.device = CPU

    def inference_mono(self, img):
        if self.torch_out:
            return torch.as_tensor(self.X), torch.as_tensor(self.C), None, None
        return jnp.asarray(self.X), jnp.asarray(self.C), None, None


def test_auto_calibration_recalibrates_the_guess(tmp_path):
    """Fault 2: a folder without intrinsics gets the 0.7 * W guess; the
    focal estimated from the first frame's pointmap replaces it, as in the
    JAX package.  The port's camera used to lack ``scale_slam_w`` and its
    datasets ``recalibrate_focal``, and the error became a warning."""
    root = str(tmp_path)
    _write_folder(root, calib=False)
    ds, jds = _both(dataset_name="selfCaptured", source_path=root, calib=None)
    assert ds.calib_is_guess and jds.calib_is_guess
    f_true = 90.0
    args = types.SimpleNamespace(auto_calib=True)
    JSystem._maybe_auto_calibrate(args, jds, _PlaneRunner(ds.H_slam, ds.W_slam, f_true, False))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = System._maybe_auto_calibrate(args, ds,
                                           _PlaneRunner(ds.H_slam, ds.W_slam, f_true, True))
    assert out["applied"] and out["guess"] == pytest.approx(0.7 * W, rel=0.02)
    assert abs(ds.K_slam[0, 0] - jds.K_slam[0, 0]) <= 1e-3
    assert ds.K_slam[0, 0] == pytest.approx(f_true, rel=0.02)
    np.testing.assert_allclose(ds.K_map, jds.K_map, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(out["K_slam"], ds.K_slam)


# ---------------------------------------------------------------------------
# the stream through System.run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ran(folder, tmp_path_factory):
    root, calib = folder
    kw = dict(dataset_name="selfCaptured", source_path=root, calib=calib)
    jargs = _args(**kw)
    jds = JD.load_dataset(jargs)
    jcfg = _config(jload_config)
    jrunner = JOracleRunner((jds.H_slam, jds.W_slam), jds.K_slam, jcfg["matching"])
    for i in range(len(jds)):
        T = np.ones(8, np.float32)
        T[:7] = jds.Twc_gt[i]
        jrunner.register(jds.transform.to_slam(jds[i][0]), i, T)
    jsys = JSystem(jargs, jcfg, jds, jrunner, mapper_cfg=JMapperConfig(**SIZES))
    state = jax_scene_state(jsys.scene_model)
    jsys.run(progress=False, use_native_loader=False)
    out = {"jax": (jsys, jsys.save(str(tmp_path_factory.mktemp("jax"))))}
    for native in (False, True):
        args = _args(**kw)
        ds = D.load_dataset(args)
        cfg = _config(load_config)
        runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=CPU)
        for i, slam in enumerate(stream_slam_images(ds, native)):
            T = np.ones(8, np.float32)
            T[:7] = ds.Twc_gt[i]
            runner.register(slam, i, T)
        sys_ = System(args, cfg, ds, runner, mapper_cfg=MapperConfig(**SIZES), device=CPU,
                      noise=JaxKeyChain(0))
        sys_.scene_model.load_state(scene_state_from_numpy(state, CPU))
        sys_.run(progress=False, use_native_loader=native)
        out[native] = (sys_, sys_.save(str(tmp_path_factory.mktemp(f"port{int(native)}"))))
    return out


@pytest.mark.parametrize("native", [False, True])
def test_stream_from_disk_matches_jax(ran, native):
    if native and not native_loader.native_available():
        pytest.skip(f"native toolchain missing: {native_loader.missing_toolchain()}")
    jsys, jmeta = ran["jax"]
    tsys, tmeta = ran[native]
    assert tsys.loader == ("native" if native else "python")
    assert tsys.n_frames == jsys.n_frames == N
    assert tsys.frontend.lost_number == jsys.frontend.lost_number == 0
    n_kf = len(tsys.keyframes)
    assert n_kf == len(jsys.keyframes) >= 1
    np.testing.assert_array_equal(tsys.keyframes.dataset_idx[:n_kf],
                                  jsys.keyframes.dataset_idx[:n_kf])
    np.testing.assert_allclose(tsys.keyframes.T_WC[:n_kf], jsys.keyframes.T_WC[:n_kf],
                               atol=1e-4)
    est, jest = tsys.frontend.estimated_trajectory(), jsys.frontend.estimated_trajectory()
    assert est.shape == jest.shape and len(est) > 4
    np.testing.assert_allclose(est, jest, atol=1e-4)
    ate = tmeta["trajectory"]["APE"]["rmse"]
    assert abs(ate - jmeta["trajectory"]["APE"]["rmse"]) <= 1e-4 and ate < 0.03
    assert tsys.mapper_index == jsys.mapper_index >= 1
    tm, jm = tmeta["metrics"], jmeta["metrics"]
    assert tm["n_test_frames"] == jm["n_test_frames"] >= 1
    assert abs(tm["PSNR"] - jm["PSNR"]) < (0.3 if native else 0.1), (tm["PSNR"], jm["PSNR"])
    # the mapper trained on the native loader's map images, not re-decoded frames
    assert (tsys.mapper.decode_s[1] == 0) == native


# ---------------------------------------------------------------------------
# eval_scenes
# ---------------------------------------------------------------------------

def _root_harness(monkeypatch):
    spec = importlib.util.spec_from_file_location("root_eval_scenes",
                                                  os.path.join(REPO, "eval_scenes.py"))
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)     # its dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


def test_eval_scenes_matches_the_root_harness(tmp_path, monkeypatch):
    ref = _root_harness(monkeypatch)
    assert list(eval_scenes.SETUPS) == list(ref.SETUPS)
    args = types.SimpleNamespace(images_dir="imgs", config="config/base.yaml", calib="c.yaml",
                                 downsampling=2.0, test_hold=30, extra="--seq_length 9")
    for name, setup in eval_scenes.SETUPS.items():
        got = eval_scenes.build_cmd("py", "/data/s", setup, args, tmp_path)
        want = ref.build_cmd("py", "/data/s", ref.SETUPS[name], args, tmp_path)
        assert got[:3] == ["py", "-m", "artdeco_tpu_torch.run_system"]
        assert want[:2] == ["py", "run_system.py"] and got[3:] == want[2:], name

    argv = ["--scenes", "/data/a", "/data/b/", "--setups", "onthefly", "oracle", "--dry_run",
            "--save_root", str(tmp_path / "r")]
    printed = []
    for main in (lambda: eval_scenes.main(argv), ref.main):
        monkeypatch.setattr(sys, "argv", ["eval_scenes.py"] + argv)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        printed.append(buf.getvalue().replace(" -m artdeco_tpu_torch.run_system ",
                                              " run_system.py "))
    assert printed[0] == printed[1] and printed[0].count("+ ") == 4
