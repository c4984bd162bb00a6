"""Web viewer: JPEG renders streamed over a WebSocket, and the static page.

Port of ``artdeco_tpu/runtime/webviewer.py`` with the same protocol: for
each client turn the server sends a JSON state header (trainer state, the
keyframe centres' bounds, the mean pose), receives the client's camera
state, renders at half the requested size (at least 16) and replies with
a JPEG at quality 50 (``dataio.jpeg.encode_jpeg``, OpenCV's bytes).  The
modes are splat, depth (inverse depth over its 99th percentile) and
ellipsoid (opaque Gaussians of flat DC colour).  The WebSocket server is
``runtime.websocket`` (standard library only) and the page is this
package's own copy of the JAX package's ``webviewer_static/index.html``.

The viewer renders on its server's thread while ``System`` trains on
another: a reply reads the scene's ``slab``, ``gfeat.val``, ``mlp`` and
``pool`` once, which ``SceneModel`` replaces by assignment, so one reply
sees one state, and it only reads.  One client is served at a time, as in
the JAX package.  A reply that fails is logged with its traceback, counted
in ``failures`` and closes the connection with code 1011; the JAX package
dropped the client silently.  ``renders`` counts the renders (one K1 launch
each on the card), and ``timers`` the seconds of each stage ("render",
"copy", "jpeg", "send"; ``sync_timing`` as in ``gaussianviewer``).
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import os
import threading
import traceback
from functools import partial

import numpy as np
import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.runtime import websocket
from artdeco_tpu_torch.runtime.gaussianviewer import render_view

STATIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "webviewer_static")


class WebViewer(trace.Timed):
    def __init__(self, scene_model, ip: str = "0.0.0.0", port: int = 6009):
        self.timers = trace.Timers()
        self.ip = ip
        self.port = port
        self.num_clients = 0
        self.scene_model = scene_model
        self.state = "stop"
        self.trainer_state = "training"
        self.renders = 0
        self.failures = 0
        self._one_client = threading.Lock()
        self._server = None

    # -- render one client request -----------------------------------------
    def _render_reply(self, data: dict) -> bytes:
        from artdeco_tpu_torch.dataio.jpeg import encode_jpeg
        from artdeco_tpu_torch.mapper import keyframe as KFmod

        sm = self.scene_model
        slab, gfeat, mlp, pool = sm.slab, sm.gfeat.val, sm.mlp, sm.pool
        n_kf = len(sm.keyframes)
        dev = slab.xyz.device
        res_x = max(int(data["res_x"]) // 2, 16)
        res_y = max(int(data["res_y"]) // 2, 16)
        if data.get("snapToLast") and n_kf:
            viewmat = KFmod.get_Rt(pool, n_kf - 1)
        else:
            pose = np.asarray(data["pose"], np.float32).reshape(4, 4).T.copy()
            pose[:3, 1] *= -1
            pose[:3, 2] *= -1
            viewmat = np.linalg.inv(pose)
        mode = data.get("mode", "splat")
        if mode == "ellipsoid":
            slab = dataclasses.replace(slab, opacity=torch.full_like(slab.opacity, 6.0),
                                       f_rest=torch.zeros_like(slab.f_rest))
        with self.timers.span("render", dev):
            pkg = render_view(sm, viewmat, res_x, res_y, slab=slab, gfeat=gfeat, mlp=mlp)
            self.renders += 1
        with self.timers.span("copy", dev):
            src = pkg["invdepth"][0] if mode == "depth" else torch.clamp(pkg["render"], 0, 1)
            host = src.cpu().numpy()
        with self.timers.span("jpeg"):
            if mode == "depth":
                hi = max(float(np.percentile(host, 99.0)), 1e-6)
                img = np.clip(host / hi, 0.0, 1.0)
                arr = (np.stack([img] * 3, axis=-1) * 255).astype(np.uint8)
            else:
                arr = (host.transpose(1, 2, 0) * 255).astype(np.uint8)
            return encode_jpeg(np.ascontiguousarray(arr))

    def _state_header(self) -> str:
        from artdeco_tpu_torch.mapper import keyframe as KFmod

        sm = self.scene_model
        n = len(sm.keyframes)
        if n == 0:
            return json.dumps({"trainer_state": self.trainer_state, "max_pos": [0.0] * 3,
                               "min_pos": [0.0] * 3,
                               "mean_pose": np.eye(4).flatten().tolist()})
        Rts = KFmod.get_all_Rt(sm.pool).cpu().numpy()
        centres = np.stack([-Rts[i, :3, :3].T @ Rts[i, :3, 3] for i in range(n)])
        centres[:, 1] *= -1
        centres[:, 2] *= -1
        mean_pose = np.linalg.inv(Rts[n // 2])
        mean_pose[:3, 1] *= -1
        mean_pose[:3, 2] *= -1
        return json.dumps({"trainer_state": self.trainer_state,
                           "max_pos": centres.max(0).tolist(),
                           "min_pos": centres.min(0).tolist(),
                           "mean_pose": mean_pose.flatten().tolist(), "n_keyframes": n})

    # -- the WebSocket loop ------------------------------------------------------
    def _client_loop(self, ws):
        with self._one_client:
            self.num_clients += 1
            try:
                self._serve_client(ws)
            finally:
                self.num_clients -= 1

    def _serve_client(self, ws) -> None:
        while True:
            try:
                ws.send(self._state_header())
                data = json.loads(ws.recv())
            except websocket.ConnectionClosed:
                return
            self.state = data.get("state", "stop")
            try:
                reply = self._render_reply(data)
            except Exception:
                # the boundary of the client: report, close, keep serving
                self.failures += 1
                traceback.print_exc()
                ws.close(1011, "render failed")
                return
            try:
                with self.timers.span("send"):
                    ws.send(reply)
            except websocket.ConnectionClosed:
                return

    def _bind(self) -> websocket.Server:
        self._server = websocket.Server(self._client_loop, self.ip, self.port)
        self.port = self._server.port               # the one taken, for a port of 0
        return self._server

    def run(self):
        """Serve in this thread until ``shutdown``."""
        with self._bind() as server:
            server.serve_forever()

    def start_background(self):
        """Bind here (an address in use raises here) and serve on a daemon
        thread."""
        t = threading.Thread(target=self._bind().serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        """Stop serving and close any open connection."""
        if self._server is not None:
            self._server.shutdown()


def serve_static_page(ip: str, port: int, directory: str = STATIC_DIR):
    """The viewer page over HTTP on a daemon thread; returns the server
    (``shutdown()`` stops it)."""
    handler = partial(http.server.SimpleHTTPRequestHandler, directory=directory)
    httpd = http.server.ThreadingHTTPServer((ip, port), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd
