"""Driver: the relocalization query the Backend makes, verified by Pi3.

Set-up draws the mix's stream and one retrieval feature a frame (the
shape of MASt3R's encoder tokens, from the seed) on the device, builds the
program's retrieval database as ``System`` builds it
(``build_retrieval_database`` with ``accurate_loop_closure``: ASMK on the
host, and the Pi3 accurate matcher over a ``KeyframeStore``, Pi3's weights
drawn on the device from the seed by ``random_pi3``), registers the mix's
first ``keyframes`` frames as keyframes (``update(add_after_query=True)``,
as the Backend adds a keyframe; the codebook bootstrap and any Pi3 runs it
triggers fall here), and runs the warm-up queries.

A request is the query ``Backend.relocalization`` makes for a lost frame
(``vslam/backend.py``): the frame is appended to the keyframe store,
``RetrievalDatabase.update(feat, add_after_query=False, k, min_thresh)``
runs, and the frame is popped again.  With the matcher set, the database
always takes ``_accurate_loop_closure``: Pi3 jointly over the 23 most
similar keyframes and the query (padded to ``MAX_WINDOW_NUMBER`` = 24, so
every request does the same device work) at the configuration's
resolution, then ``match_pi3`` of each candidate's points to the query's
and the ranking by valid fraction.  A request's time runs from handing the
query over to ``update``'s return (the fractions come to the host).
Closed loop: the next query goes in when the last returns.

The check draws ``check_requests`` requests of the window from the seed
(reservoir sampling) and keeps what the timed path produced for them (by
reference, through forward hooks): the 24 resized inputs Pi3 took, its
encoder's tokens, the heads' input, its points, confidences and camera
poses, and the matches and validity ``match_pi3`` returned.  Once the
window has closed and the program is freed, the plain float32 Pi3
(``reference/pi3_plain.py``, TF32 off) recomputes the outputs from those
inputs and the same weights, and its decoder recomputes the decoder's
update from the program's own encoder tokens; the plain cascade
(``reference/cascade_plain.py``, without descriptors) matches the
program's own points as the matcher paired them, and its matches are
compared with the program's on every pixel.

The control (``check(control=True)``): the plain Pi3 with its trunk's
operands rounded to float8 e4m3 (below the program's bfloat16 trunk), and
the plain cascade on the program's points rounded to bfloat16 (below its
float32 iter_proj), each in the program's place.
"""

from __future__ import annotations

import contextlib
import sys
import time
import types

import numpy as np
import torch

from benchmark.drivers.mast3r_step import match_disagreement, rel_err
from benchmark.harness import Window, log, sync
from benchmark.reference import cascade_plain, pi3_plain
from benchmark.traffic import stream

OUT_KEYS = ("points", "conf", "camera_poses")
# Random weights and LayerScale 0.01 leave the decoder's part of the points
# and confidences below the bfloat16 trunk's rounding, so the check judges
# the decoder's update to its tokens on its own (``decoder_update``).


def judge(out: dict, ref: dict) -> dict:
    """The widest gaps of the decoder's update, the points, confidences and
    camera poses ([R | t] of every frame), each against the reference's
    spread."""
    return {"pi3_decoder_err": rel_err(out["update"], ref["update"]),
            "pi3_points_err": rel_err(out["points"], ref["points"]),
            "pi3_conf_err": rel_err(out["conf"], ref["conf"]),
            "pi3_pose_err": rel_err(out["camera_poses"][..., :3, :],
                                    ref["camera_poses"][..., :3, :])}


def cascade_on(cfg: dict, points: torch.Tensor, n_real: int, low: bool = False) -> tuple:
    """The plain descriptor-free cascade as the matcher runs it on one
    request's points (1, N, H, W, 3): every row but the last against the
    query's, row ``n_real - 1``; ``low``: the points rounded to bfloat16
    first.  Returns (idx (N - 1, H*W), valid (N - 1, H*W))."""
    X = points[0]
    if low:
        X = X.to(torch.bfloat16).float()
    rows = X[:X.shape[0] - 1]
    q = X[n_real - 1].expand_as(rows)
    idx, valid = cascade_plain.match(dict(cfg, radius=0), rows, q, None, None)
    return idx, valid[..., 0]


def keep_outputs(model, put) -> list:
    """Hooks on a Pi3 (the program's or the plain one: the same module
    names) that ``put`` its input images and outputs, its encoder's patch
    tokens and the heads' input (the decoder's last two blocks' outputs,
    registers first).  Returns the hooks' handles."""
    def forward(mod, args, kwargs, out):
        put("imgs", args[0] if args else kwargs["imgs"])
        put("out", {k: out[k] for k in OUT_KEYS})

    return [model.register_forward_hook(forward, with_kwargs=True),
            model.encoder.register_forward_hook(lambda mod, args, out: put("enc", out)),
            model.point_decoder.register_forward_pre_hook(
                lambda mod, args: put("heads_in", args[0]))]


def decoder_update(register_token, enc, heads_in) -> torch.Tensor:
    """The decoder's change to its tokens: the heads' input less the
    decoder's input (the register tokens, then the encoder's patch tokens),
    which the heads' input holds twice, once a block."""
    bn, r = enc.shape[0], register_token.shape[2]
    x = torch.cat([register_token.reshape(1, r, -1).expand(bn, r, -1).float(), enc.float()],
                  dim=1)
    return heads_in.float() - torch.cat([x, x], dim=-1)


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        t0 = time.perf_counter()
        from artdeco_tpu_torch.models import pi3 as P
        from artdeco_tpu_torch.vslam import accurate_lc
        from artdeco_tpu_torch.vslam.backend import host_tokens
        from artdeco_tpu_torch.vslam.frame import Frame
        from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
        from artdeco_tpu_torch.vslam.retrieval import build_retrieval_database

        self.setup_split = {"imports": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.device, self.tracer, self.config, self.mix, self.seed = (device, tracer, config,
                                                                      mix, seed)
        self.Frame, self.host_tokens = Frame, host_tokens
        self.rc = config["retrieval"]
        self.widths = pi3_plain.widths_from(config["model"])
        self.n_kf = int(mix["keyframes"])
        n = self.n_kf + int(mix["warmup_frames"]) + int(mix["window_frames_max"])
        poses = stream.trajectory(mix, seed, n)
        self.frames_u8 = stream.frames(mix, seed, poses, device, host=False,
                                       batch=max(1, 8_000_000 // (mix["width"] * mix["height"])))
        g = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63) + 1)
        self.feats = torch.randn((n, *config["retrieval_features"]), generator=g,
                                 device=device)
        self.T = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=torch.float32, device=device)
        self.setup_split["generate"] = time.perf_counter() - t0

        # the database as System builds it, Pi3's weights drawn from the seed
        t0 = time.perf_counter()
        self.store = KeyframeStore(int(mix["height"]), int(mix["width"]),
                                   buffer=self.n_kf + 1, device=device)
        load, made = P.load_pi3_apply, []

        def load_seeded(*a, **k):
            k["generator"] = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
            made.append(load(*a, **k))
            return made[-1]

        P.load_pi3_apply = load_seeded
        try:
            with contextlib.redirect_stdout(sys.stderr):
                self.db = build_retrieval_database(types.SimpleNamespace(**config["args"]),
                                                   config, self.store)
        finally:
            P.load_pi3_apply = load
        if len(made) != 1:
            raise RuntimeError("build_retrieval_database did not load Pi3 once")
        self.pi3, resize_hw = made[0]
        self._check_widths(self.pi3.model.cfg, resize_hw)
        self.matcher = self.db.accurate_matcher
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # what the timed path produces for a request, kept by reference
        self.last: dict = {}
        keep_outputs(self.pi3.model, lambda k, v: self.last.__setitem__(k, v))
        self._accurate_lc = accurate_lc
        self._match_pi3 = match_pi3 = accurate_lc.match_pi3

        def match_kept(*a, **k):
            idx, valid = match_pi3(*a, **k)
            self.last.setdefault("matches", []).append((idx, valid))
            return idx, valid

        accurate_lc.match_pi3 = match_kept

        def matcher_kept(candidate_ids, query_id):
            fracs = self.matcher(candidate_ids, query_id)
            self.last["n_real"] = len(candidate_ids) + 1
            self.last["fracs"] = fracs
            return fracs

        self.db.accurate_matcher = matcher_kept
        self.setup_split["weights"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(self.n_kf):
            self.store.append(self._frame(i))
            self.db.update(host_tokens(self.feats[i:i + 1]), add_after_query=True,
                           k=self.rc["k"], min_thresh=self.rc["min_thresh"])
        sync(device)
        self.setup_pi3_runs = self.matcher.calls
        self.setup_split["register"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.i, self.queries = self.n_kf, 0
        for _ in range(int(mix["warmup_frames"])):
            self._query()
        sync(device)
        self.setup_split["warmup"] = time.perf_counter() - t0
        log(f"set-up: {self.n_kf} keyframes registered with {self.setup_pi3_runs} Pi3 runs, "
            f"{int(mix['warmup_frames'])} warm-up queries")
        self.extra = {"hw": tuple(resize_hw), "setup_pi3_runs": self.setup_pi3_runs}

    def _check_widths(self, cfg, resize_hw) -> None:
        """The program's Pi3 has the configuration's widths, precision and
        resolution: the reference is built from the configuration."""
        got = {k: getattr(cfg, k) for k in self.config["model"]}
        if (got != self.config["model"]
                or cfg.compute_dtype != getattr(torch, self.config["compute_dtype"])
                or list(resize_hw) != list(self.config["resize_hw"])):
            raise RuntimeError(f"the program's Pi3 ({got}, {cfg.compute_dtype}, {resize_hw}) "
                               "is not the configuration's")

    def _frame(self, i: int):
        """Stream frame i as a keyframe: (3, H, W) in [-1, 1] on the device."""
        img = self.frames_u8[i].permute(2, 0, 1).float().div_(127.5).sub_(1.0)
        return self.Frame(img=img, T_WC=self.T, X_canon=None, C=None, N=None, frame_id=i,
                          frame_time=float(i))

    def _query(self):
        """The next stream frame's relocalization query.  Returns (t_ask,
        t_end, what the timed path produced) or None when the stream has
        run out."""
        if self.i >= len(self.frames_u8):
            return None
        frame, feat = self._frame(self.i), self.feats[self.i:self.i + 1]
        self.last = {}
        t0 = time.perf_counter()
        with self.tracer.annotate("bench:query"):
            self.store.append(frame)
            self.db.update(self.host_tokens(feat), add_after_query=False, k=self.rc["k"],
                           min_thresh=self.rc["min_thresh"])
            self.store.pop_last()
        t_end = time.perf_counter()
        if "fracs" not in self.last:
            raise RuntimeError("the query did not reach the accurate matcher")
        self.i += 1
        self.queries += 1
        return t0, t_end, self.last

    def counters(self) -> dict:
        return {"frames": self.queries, "pi3_calls": self.matcher.calls}

    def run_window(self, seconds: float) -> Window:
        dev, tr = self.device, self.tracer
        if dev.type == "cuda":
            self.extra["memory_setup_peak"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        if tr.on:
            self.pi3.sync_timing = True
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF, 11])
        k = int(self.config["check_requests"])
        self.sample: dict = {}
        seen = 0
        lat, attempted, exhausted = [], 0, False
        t_open = time.perf_counter()
        t_close = t_open + seconds
        tr.open(t_open, seconds, self.counters())
        while True:
            now = time.perf_counter()
            if now >= t_close:
                break
            tr.before_frame(now, self.counters, dev)
            i = self.i
            r = self._query()
            if r is None:
                exhausted = True
                break
            attempted += 1
            t_ask, t_end, kept = r
            if t_end <= t_close:
                lat.append(t_end - t_ask)
                # reservoir sampling: a uniform sample of k finished requests
                seen += 1
                if len(self.sample) < k:
                    self.sample[i] = kept
                else:
                    j = int(rng.integers(seen))
                    if j < k:
                        del self.sample[sorted(self.sample)[j]]
                        self.sample[i] = kept
            tr.after_frame(self.counters, dev)
        tr.close(self.counters(), self.counters, dev)
        return Window(seconds=seconds, latencies=lat, attempted=attempted,
                      failed=int(exhausted), exhausted=exhausted)

    def finish(self) -> None:
        sync(self.device)
        if self.device.type == "cuda":
            win_peak = torch.cuda.max_memory_allocated(self.device)
            self.extra["memory_window_peak"] = win_peak
            self.extra["memory_peak_bytes"] = max(win_peak, self.extra["memory_setup_peak"])

    def release(self) -> None:
        """Free the program but its weights, which the reference loads."""
        self._accurate_lc.match_pi3 = self._match_pi3
        self.sd = self.pi3.model.state_dict()
        del self.db, self.matcher, self.pi3, self.store, self.frames_u8, self.feats, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def reference_outputs(self, trunk_quant=None) -> dict:
        """The plain Pi3's outputs for every sampled request, from its
        inputs and the weights alone, and its decoder's update from the
        program's own encoder tokens, so that the encoder's rounding does
        not reach the decoder's comparison (``trunk_quant="fp8"``: the
        control's)."""
        dev = self.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = pi3_plain.build(self.widths, self.sd, dev, trunk_quant)
        kept: dict = {}
        keep_outputs(model, kept.__setitem__)
        p = self.widths.patch_size
        outs = {}
        with torch.no_grad():
            for i in sorted(self.sample):
                imgs, enc = self.sample[i]["imgs"], self.sample[i]["enc"]
                model(imgs)
                _, n, _, h, w = imgs.shape
                heads_in, _ = model.decode(enc.float(), 1, n, h // p, w // p)
                outs[i] = dict(kept["out"], update=decoder_update(
                    self.sd["register_token"], enc, heads_in))
        del model, kept
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return outs

    def check(self, control: bool = False) -> dict:
        """The worst of each number over the sampled requests: the
        program's outputs, or (``control``) the control's in their place,
        with the program's numbers logged as readings."""
        ref = self.reference_outputs()
        prog = {i: dict(s["out"], update=decoder_update(self.sd["register_token"], s["enc"],
                                                         s["heads_in"]))
                for i, s in self.sample.items()}
        worst = self._judge(ref, prog, False)
        if not control:
            return worst
        log("program's numbers (readings of this control run): "
            + ", ".join(f"{k} {v!r}" for k, v in worst.items()))
        return self._judge(ref, self.reference_outputs("fp8"), True)

    def _judge(self, ref: dict, outputs: dict, low: bool) -> dict:
        cfg = self.config["matching"]
        worst: dict = {}
        for i, out in outputs.items():
            nums = judge(out, ref[i])
            prog = self.sample[i]
            idx = torch.cat([m[0] for m in prog["matches"]])
            valid = torch.cat([m[1] for m in prog["matches"]])
            with torch.no_grad():
                plain = cascade_on(cfg, prog["out"]["points"], prog["n_real"])
                mine = (cascade_on(cfg, prog["out"]["points"], prog["n_real"], low=True) if low
                        else (idx, valid))
            nums["lc_match_diff"] = match_disagreement(*mine, *plain)
            n = prog["n_real"] - 1
            frac_gap = float(np.abs(np.asarray(prog["fracs"])
                                    - plain[1][:n].double().mean(dim=1).cpu().numpy()).max())
            log(f"request {i}: fractions {min(prog['fracs']):.4f}..{max(prog['fracs']):.4f}, "
                f"widest gap to the plain cascade's {frac_gap:.3g}")
            for name, v in nums.items():
                worst[name] = max(worst.get(name, 0.0), v)
        if not worst:
            raise RuntimeError("no request of the window finished: nothing to check")
        return worst
