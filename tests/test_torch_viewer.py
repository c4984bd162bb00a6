"""The port's viewers (``artdeco_tpu_torch/runtime/{gaussianviewer,
webviewer,websocket}.py``, ``scene_io.load_scene_for_viewing``,
``dataio/jpeg.py``, ``dataio/video.py``) against the JAX package's, on the
CPU.

The scene is ``tests/test_webviewer.py``'s 64x48 plane, densified by the
JAX mapper; the port's ``SceneModel`` takes its state through
``state_io.scene_state_from_numpy``.  Tolerances:
- the JPEG encoder: the bytes of ``cv2.imencode(".jpg", bgr,
  [IMWRITE_JPEG_QUALITY, q])`` (OpenCV 5.0, libjpeg-turbo);
- a loaded scene: every slab field equal to the JAX package's; its render
  within 1e-5 of JAX's render of it (``test_torch_splat.py``'s
  render_core tolerance) and within ``LOADED_TOL`` of the port's live
  render with ``d_max`` lifted (the baked scale passes through log, exp
  and sigmoid(20) = 1 in float32);
- the turntable and the web replies: the uint8 frames equal JAX's but for
  one level where the float frames straddle a level (``LEVEL_SHARE`` of
  the values at most); a JPEG of frames that close decodes within
  ``JPEG_TOL`` of JAX's;
- the MP4: 8 samples, each the JPEG of its frame, and OpenCV's FFmpeg
  decodes each within ``VIDEO_TOL`` (mean absolute level) of its frame.
"""

import dataclasses
import http.client
import json
import os
import threading
import time
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import websockets.exceptions
from websockets.sync.client import connect

from artdeco_tpu.mapper import scene_io as jio
from artdeco_tpu.mapper import scene_model as JS
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu.mapper.keyframe import make_host_keyframe
from artdeco_tpu.runtime.gaussianviewer import GaussianViewer as JGaussianViewer
from artdeco_tpu.runtime.webviewer import WebViewer as JWebViewer
from artdeco_tpu_torch.dataio import jpeg
from artdeco_tpu_torch.dataio.image_io import read_png
from artdeco_tpu_torch.dataio.video import read_mp4_samples
from artdeco_tpu_torch.mapper import keyframe as KF
from artdeco_tpu_torch.mapper import scene_io as tio
from artdeco_tpu_torch.mapper import scene_model as TS
from artdeco_tpu_torch.mapper.config import MapperConfig
from artdeco_tpu_torch.mapper.state_io import scene_state_from_numpy
from artdeco_tpu_torch.runtime import websocket
from artdeco_tpu_torch.runtime.gaussianviewer import GaussianViewer, render_view
from artdeco_tpu_torch.runtime.webviewer import STATIC_DIR, WebViewer, serve_static_page
from torch_parity import CPU, jax_scene_state, n, torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48
K = [[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]]
SIZES = dict(capacity=2048, cluster_capacity=512, voxel_table_size=2048, new_budget=512,
             keyframe_capacity=16, sh_degree=1, local_feat_dim=8, global_feat_dim=8,
             pyr_levels=1, gs_add_ratio=1.0, init_proba_scaler=4.0)
LOADED_TOL = 1e-6
LEVEL_SHARE = 1e-3
JPEG_TOL = 2.0
VIDEO_TOL = 3.0


def _keyframe_inputs():
    rng = np.random.RandomState(0)
    img = rng.rand(3, H, W).astype(np.float32)
    depth = 2.0 + 0.2 * rng.rand(H, W).astype(np.float32)
    u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pts = np.stack([(u - W / 2) / 60.0 * depth, (v - H / 2) / 60.0 * depth, depth],
                   axis=-1).astype(np.float32)
    return img, pts


@pytest.fixture(scope="module")
def scenes():
    """(the JAX SceneModel, the port's with its state)."""
    img, pts = _keyframe_inputs()
    jsm = JS.SceneModel(W, H, K, JMapperConfig(**SIZES), seed=0)
    kf = make_host_keyframe(index=0, global_frame_id=0, image=img, point_map=pts,
                            point_conf=np.ones((H, W), np.float32), is_test=False,
                            is_slam_keyframe=True, pyr_levels=1, image_name="kf0",
                            timestamp=0.0)
    jsm.add_keyframe(kf, np.eye(4, dtype=np.float32))
    jsm.add_new_gaussians()
    sm = TS.SceneModel(W, H, K, MapperConfig(**SIZES), device=CPU)
    sm.add_keyframe(KF.make_device_keyframe(0, 0, img, pts, np.ones((H, W), np.float32),
                                            False, True, CPU, pyr_levels=1), np.eye(4))
    sm.load_state(scene_state_from_numpy(jax_scene_state(jsm), CPU))
    assert sm.n_active_gaussians > 100
    return jsm, sm


def _frames_close(a: np.ndarray, b: np.ndarray, what: str) -> None:
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max() <= 1, f"{what}: off by {d.max()} levels"
    assert np.mean(d > 0) <= LEVEL_SHARE, f"{what}: {np.mean(d > 0):.2e} of values off"


def _decode(buf: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


# ---------------------------------------------------------------------------
# the JPEG encoder
# ---------------------------------------------------------------------------

def _cv2_jpeg(rgb: np.ndarray) -> bytes:
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, 50])
    assert ok
    return buf.tobytes()


def _smooth(h, w, seed=0):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 37.0 + y / 53.0), 128 + 90 * np.cos(y / 29.0),
                    (x + 2 * y) % 256], -1)
    return np.clip(img + rng.randint(-6, 7, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("case", ["noise_37x53", "noise_9x7", "noise_16x16", "flat_48x64",
                                  "smooth_90x120", "extremes_17x33"])
def test_encode_jpeg_is_opencvs_bytes(case):
    """Edge replication (37x53, 9x7, 17x33: dummy blocks in the last MCU
    row and column), one whole MCU, a flat image, a smooth one, and
    samples at 0 and 255 (the largest coefficients)."""
    rng = np.random.RandomState(1)
    img = {"noise_9x7": lambda: rng.randint(0, 256, (9, 7, 3), np.uint8),
           "noise_16x16": lambda: rng.randint(0, 256, (16, 16, 3), np.uint8),
           "flat_48x64": lambda: np.full((48, 64, 3), 77, np.uint8),
           "smooth_90x120": lambda: _smooth(90, 120),
           "extremes_17x33": lambda: 255 * rng.randint(0, 2, (17, 33, 3)).astype(np.uint8)}.get(
        case, lambda: rng.randint(0, 256, (37, 53, 3), np.uint8))()
    buf = jpeg.encode_jpeg(img)
    assert buf == _cv2_jpeg(img)
    assert jpeg.jpeg_size(buf) == (img.shape[1], img.shape[0])


def test_encode_jpeg_rendered_frame_and_960x540(scenes):
    _, sm = scenes
    frame = GaussianViewer(sm, 88, 66).render_pose(np.eye(4, dtype=np.float32))
    assert jpeg.encode_jpeg(frame) == _cv2_jpeg(frame)
    big = _smooth(540, 960, seed=2)
    jpeg.encode_jpeg(big)
    t0 = time.perf_counter()
    buf = jpeg.encode_jpeg(big)
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"encode_jpeg 960x540: {ms:.1f} ms on this CPU, {len(buf)} bytes")
    assert buf == _cv2_jpeg(big)
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(big.astype(np.float32))


# ---------------------------------------------------------------------------
# loading a saved scene
# ---------------------------------------------------------------------------

def _save_run(sm, root, meta: bool = True):
    os.makedirs(root / "point_clouds", exist_ok=True)
    tio.save_gaussian_ply(str(root / "point_clouds" / "gs.ply"), sm)
    if meta:
        with open(root / "metadata.json", "w") as f:
            json.dump({"config": {"width": W, "height": H, "sh_degree": 1, "f": sm.f}}, f)
    return str(root)


def _jax_render(vs, Rt, w, h):
    f = vs.f * h / vs.height
    pkg = JS.render_core(vs.slab, vs.gfeat.val, vs.mlp, jnp.asarray(Rt), jnp.eye(3, 4),
                         jnp.asarray([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]]), w, h,
                         jnp.zeros(3), vs.cfg.sh_degree, vs.cfg.low_pass_filter_eps,
                         vs.cfg.cluster_capacity)
    return np.asarray(pkg["render"])


def test_load_scene_for_viewing_matches_jax_and_the_live_render(scenes, tmp_path):
    jsm, sm = scenes
    run = _save_run(sm, tmp_path)
    jio.save_gaussian_ply(str(tmp_path / "jax_gs.ply"), jsm)
    with open(tmp_path / "jax_gs.ply", "rb") as a, open(tmp_path / "point_clouds" / "gs.ply",
                                                        "rb") as b:
        assert a.read() == b.read()
    jvs = jio.load_scene_for_viewing(run)
    vs = tio.load_scene_for_viewing(run, device=CPU)
    assert (vs.width, vs.height, vs.f) == (jvs.width, jvs.height, jvs.f) == (W, H, sm.f)
    assert vs.cfg.sh_degree == jvs.cfg.sh_degree == 1
    for f in dataclasses.fields(vs.slab):
        np.testing.assert_array_equal(n(getattr(vs.slab, f.name)),
                                      np.asarray(getattr(jvs.slab, f.name)), err_msg=f.name)
    for k in ("w1", "b1", "w2", "b2"):
        np.testing.assert_array_equal(n(getattr(vs.mlp, k)), np.asarray(getattr(jvs.mlp, k)))
    Rt = np.eye(4, dtype=np.float32)
    loaded = n(render_view(vs, Rt, W, H)["render"])
    jloaded = _jax_render(jvs, Rt, W, H)
    np.testing.assert_allclose(loaded, jloaded, atol=1e-5)
    live = n(render_view(sm, Rt, W, H, slab=dataclasses.replace(
        sm.slab, d_max=torch.full_like(sm.slab.d_max, 1e10)))["render"])
    jlive = _jax_render(types.SimpleNamespace(
        slab=dataclasses.replace(jsm.slab, d_max=jnp.full_like(jsm.slab.d_max, 1e10)),
        gfeat=jsm.gfeat, mlp=jsm.mlp, cfg=jsm.cfg, f=jsm.f, height=H), Rt, W, H)
    print(f"loaded vs live {np.abs(loaded - live).max():.3g} (JAX's: "
          f"{np.abs(jloaded - jlive).max():.3g}), loaded vs JAX's loaded "
          f"{np.abs(loaded - jloaded).max():.3g}")
    assert loaded.max() > 0.1
    np.testing.assert_allclose(loaded, live, atol=LOADED_TOL)


def test_load_scene_fallbacks(scenes, tmp_path):
    """Without metadata: 640x360 and f 500 (or ``focal``); a PLY whose
    f_rest width fits no SH degree keeps the slab's zeros, in both."""
    _, sm = scenes
    run = _save_run(sm, tmp_path, meta=False)
    vs = tio.load_scene_for_viewing(run, focal=321.0, device=CPU)
    jvs = jio.load_scene_for_viewing(run, focal=321.0)
    assert (vs.width, vs.height, vs.f) == (jvs.width, jvs.height, jvs.f) == (640, 360, 321.0)
    assert tio.load_scene_for_viewing(run, device=CPU).f == 500.0

    fields = tio.read_gaussian_ply(os.path.join(run, "point_clouds", "gs.ply"))
    m = len(fields["xyz"])
    cols = {"x": fields["xyz"][:, 0], "y": fields["xyz"][:, 1], "z": fields["xyz"][:, 2]}
    cols.update({f"f_dc_{i}": fields["f_dc"][:, 0, i] for i in range(3)})
    cols.update({f"f_rest_{i}": np.full(m, 0.5, np.float32) for i in range(12)})
    cols["opacity"] = fields["opacity"][:, 0]
    cols.update({f"scale_{i}": fields["scaling"][:, i] for i in range(3)})
    cols.update({f"rotation_{i}": fields["rotation"][:, i] for i in range(4)})
    odd = str(tmp_path / "odd.ply")
    tio.write_ply(odd, [(k, "f4") for k in cols], list(cols.values()))
    vs = tio.load_scene_for_viewing(odd, device=CPU)
    jvs = jio.load_scene_for_viewing(odd)
    assert vs.cfg.sh_degree == jvs.cfg.sh_degree == 1       # round(sqrt(5)) - 1
    assert float(vs.slab.f_rest.abs().max()) == 0.0
    for f in dataclasses.fields(vs.slab):
        np.testing.assert_array_equal(n(getattr(vs.slab, f.name)),
                                      np.asarray(getattr(jvs.slab, f.name)), err_msg=f.name)
    with pytest.raises(FileNotFoundError):
        tio.load_scene_for_viewing(str(tmp_path / "nothing"), device=CPU)


# ---------------------------------------------------------------------------
# the headless viewer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["splat", "depth", "alpha"])
def test_turntable_matches_jax(scenes, mode):
    jsm, sm = scenes
    want = JGaussianViewer(jsm, 80, 60).turntable(8, mode)
    viewer = GaussianViewer(sm, 80, 60)
    got = viewer.turntable(8, mode)
    assert viewer.renders == 8 and len(got) == 8
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (60, 80, 3) and a.dtype == np.uint8
        _frames_close(a, b, f"{mode} frame {i}")
    print(f"{mode}: values a level off JAX's {max(np.mean(a != b) for a, b in zip(got, want)):.3g}")
    assert max(int(fr.max()) for fr in got) > 50
    with pytest.raises(ValueError):
        viewer.render_pose(np.eye(4), "ellipsoid")


def test_export_turntable_png_and_mp4(scenes, tmp_path):
    _, sm = scenes
    viewer = GaussianViewer(sm, 80, 60)
    frames = viewer.turntable(8, "splat")
    vid = viewer.export_turntable(str(tmp_path), n_frames=8, mode="splat")
    assert vid == str(tmp_path / "turntable_splat.mp4")
    for i, fr in enumerate(frames):
        path = str(tmp_path / f"splat_{i:04d}.png")
        np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], fr)
        np.testing.assert_array_equal(read_png(path), fr)
    mp4 = read_mp4_samples(vid)
    assert (mp4["kind"], mp4["width"], mp4["height"], mp4["fps"]) == ("jpeg", 80, 60, 30.0)
    assert [s == jpeg.encode_jpeg(fr) for s, fr in zip(mp4["samples"], frames)] == [True] * 8
    cap = cv2.VideoCapture(vid)
    try:
        assert cap.get(cv2.CAP_PROP_FPS) == 30.0
        decoded = []
        while True:
            ok, fr = cap.read()
            if not ok:
                break
            decoded.append(fr[..., ::-1])
    finally:
        cap.release()
    assert len(decoded) == 8
    errs = [np.abs(fr.astype(float) - want).mean() for fr, want in zip(decoded, frames)]
    print(f"MP4 frames decoded by FFmpeg: mean error {max(errs):.3g} levels at most")
    assert max(errs) <= VIDEO_TOL
    assert {"render", "copy", "png", "jpeg"} <= set(viewer.timers)


# ---------------------------------------------------------------------------
# the web viewer
# ---------------------------------------------------------------------------

def _request(mode="splat", snap=False, res=(64, 48)):
    pose = np.eye(4)
    pose[:3, 1] *= -1          # the client's Y-up convention (the server flips back)
    pose[:3, 2] *= -1
    pose[:3, 3] = [0.05, -0.02, -0.1]
    return dict(res_x=res[0], res_y=res[1], pose=pose.T.flatten().tolist(),
                snapToLast=snap, mode=mode, state="play")


def test_state_header_matches_jax(scenes):
    jsm, sm = scenes
    assert json.loads(WebViewer(sm)._state_header()) == json.loads(
        JWebViewer(jsm)._state_header())
    # no keyframe yet: the same header without n_keyframes
    empty = TS.SceneModel(W, H, K, MapperConfig(**SIZES), device=CPU)
    jempty = JS.SceneModel(W, H, K, JMapperConfig(**SIZES), seed=0)
    got = WebViewer(empty)._state_header()
    assert got == JWebViewer(jempty)._state_header()
    assert "n_keyframes" not in json.loads(got)


@pytest.mark.parametrize("mode,snap", [("splat", False), ("depth", False),
                                       ("ellipsoid", False), ("splat", True)])
def test_render_reply_matches_jax(scenes, mode, snap):
    jsm, sm = scenes
    data = _request(mode, snap, res=(160, 120))
    want = JWebViewer(jsm)._render_reply(data)
    viewer = WebViewer(sm)
    got = viewer._render_reply(data)
    print(f"{mode} snap={snap}: JAX's bytes {got == want}")
    assert viewer.renders == 1
    assert jpeg.jpeg_size(got) == jpeg.jpeg_size(want) == (80, 60)
    a, b = _decode(got), _decode(want)
    assert a.max() > 30
    assert np.abs(a.astype(float) - b).max() <= JPEG_TOL


def _start_viewer(sm):
    viewer = WebViewer(sm, ip="127.0.0.1", port=0)
    viewer.start_background()
    assert viewer.port > 0
    return viewer


def test_webviewer_over_a_socket(scenes):
    """A websockets client: header as text, reply as binary JPEG, a
    request over 125 bytes (16-bit length), the close handshake, a second
    client after the first, and a failed reply closing with 1011."""
    _, sm = scenes
    viewer = _start_viewer(sm)
    url = f"ws://127.0.0.1:{viewer.port}"
    try:
        with connect(url, max_size=None, compression=None) as ws:
            header = ws.recv()
            assert isinstance(header, str) and json.loads(header)["n_keyframes"] == 1
            msg = json.dumps(_request("splat", res=(320, 240)))
            assert len(msg) > 125
            ws.send(msg)
            reply = ws.recv()
            assert isinstance(reply, bytes) and jpeg.jpeg_size(reply) == (160, 120)
            assert isinstance(ws.recv(), str)       # the next turn's header
            assert viewer.num_clients == 1
        deadline = time.time() + 10
        while viewer.num_clients and time.time() < deadline:
            time.sleep(0.01)
        assert viewer.num_clients == 0
        with connect(url, max_size=None, compression=None) as ws:
            ws.recv()
            ws.send(json.dumps(_request("depth")))
            assert jpeg.jpeg_size(ws.recv()) == (32, 24)
            ws.recv()
            ws.send(json.dumps({"pose": [], "state": "play"}))       # no res_x
            with pytest.raises(websockets.exceptions.ConnectionClosedError) as err:
                ws.recv()
            assert err.value.rcvd.code == 1011
        assert viewer.failures == 1 and viewer.renders == 2
    finally:
        viewer.shutdown()


def test_launch_counts_from_many_threads():
    """The kernel wrappers count launches from several host threads
    (tracking, the mapper's worker, the web viewer): no update is lost."""
    import sys

    from artdeco_tpu_torch import kernels

    def wrapper():
        pass

    wrapper.launches = 0

    def work():
        for _ in range(2000):
            kernels.count_launch(wrapper)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(th.is_alive() for th in threads)
    assert wrapper.launches == 16 * 2000


def _echo(ws):
    try:
        while True:
            ws.send(ws.recv())
    except websocket.ConnectionClosed as e:
        _echo.closed.append(e.code)


def test_websocket_frames_and_close_handshake():
    """16- and 64-bit lengths both ways, a fragmented message, ping/pong,
    and the close handshake, against the websockets client."""
    _echo.closed = []
    server = websocket.Server(_echo, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with connect(f"ws://127.0.0.1:{server.port}", max_size=None,
                     compression=None) as ws:
            for msg in ("x" * 200, os.urandom(300), os.urandom(70000), "short"):
                ws.send(msg)
                assert ws.recv() == msg
            ws.send([b"ab", b"cd" * 40000, b"ef"])                   # fragmented
            assert ws.recv() == b"ab" + b"cd" * 40000 + b"ef"
            assert ws.ping(b"hi").wait(5)
        deadline = time.time() + 5
        while not _echo.closed and time.time() < deadline:
            time.sleep(0.01)
        assert _echo.closed == [1000]
    finally:
        server.shutdown()
        thread.join(timeout=5)
    assert not thread.is_alive()
    assert websocket.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_static_page(tmp_path):
    with open(os.path.join(STATIC_DIR, "index.html"), "rb") as f:
        ours = f.read()
    with open(os.path.join(REPO, "artdeco_tpu", "runtime", "webviewer_static",
                           "index.html"), "rb") as f:
        assert ours == f.read()
    httpd = serve_static_page("127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=10)
        conn.request("GET", "/")
        res = conn.getresponse()
        assert res.status == 200 and res.read() == ours
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# run_system --viewer_mode web
# ---------------------------------------------------------------------------

def _poll(port: int, stop: threading.Event, seen: list):
    """A client that asks for renders until ``stop``; reconnects while the
    server is not up yet."""
    while not stop.is_set():
        try:
            with connect(f"ws://127.0.0.1:{port}", max_size=None, compression=None,
                         open_timeout=5) as ws:
                while not stop.is_set():
                    ws.recv()
                    ws.send(json.dumps(_request("splat", res=(128, 96))))
                    seen.append(len(ws.recv()))
        except (OSError, websockets.exceptions.WebSocketException):
            time.sleep(0.05)


def test_run_system_viewer_mode_web(monkeypatch, tmp_path):
    """``run_system --viewer_mode web --oracle`` on a 128x96 stream with a
    polling client: it completes and its poses and PSNR are bitwise the
    same run's without the viewer."""
    import socket

    from artdeco_tpu_torch import run_system
    from artdeco_tpu_torch.runtime import system as tsystem

    ran = []
    save = tsystem.System.save
    monkeypatch.setattr(tsystem.System, "save",
                        lambda self, out: (ran.append(self), save(self, out))[1])
    for _ in range(100):          # the WebSocket's port and the page's, next to it
        with socket.socket() as a, socket.socket() as b:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            try:
                b.bind(("127.0.0.1", port + 1))
                break
            except OSError:
                continue
    argv = ["-s", "synthetic://", "-d", "synthetic", "--oracle", "--device", "cpu",
            "--max_size_slam", "128", "--downsampling", "2.5", "--test_hold", "4",
            "--num_key_iterations", "2", "--sh_degree", "1", "--local_feat_dim", "8",
            "--global_feat_dim", "8", "--pyr_levels", "1", "--retrieval_checkpoint_path", ""]
    plain = run_system.main(argv + ["-m", str(tmp_path / "plain")])
    stop, seen = threading.Event(), []
    client = threading.Thread(target=_poll, args=(port, stop, seen), daemon=True)
    client.start()
    try:
        web = run_system.main(argv + ["-m", str(tmp_path / "web"), "--viewer_mode", "web",
                                      "--ip", "127.0.0.1", "--port", str(port)])
    finally:
        stop.set()
        client.join(timeout=30)
    assert not client.is_alive()
    a, b = ran
    assert b.viewer is not None and b.viewer.failures == 0
    assert len(seen) >= 1 and b.viewer.renders >= len(seen)
    np.testing.assert_array_equal(b.frontend.estimated_trajectory(),
                                  a.frontend.estimated_trajectory())
    assert b.keyframes.dataset_idx[:len(b.keyframes)].tolist() == \
        a.keyframes.dataset_idx[:len(a.keyframes)].tolist()
    assert web["metrics"]["PSNR"] == plain["metrics"]["PSNR"]
    assert web["n_frames"] == plain["n_frames"] == 30
