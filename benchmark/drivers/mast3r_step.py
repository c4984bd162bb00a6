"""Driver: the model-driven tracker's per-frame model step.

The program's ``Mast3rRunner`` on weights the benchmark draws on the device
from the seed (``reference.mast3r_plain.draw_state_dict``; the same state
dict builds the reference).  Each frame is matched into the current
keyframe as ``vslam/frontend.py`` does it:
``match_asymmetric(frame, keyframe, idx_i2j_init=<the last frame's
matches>, embeddings_j=<the keyframe's cached encoder tokens>)``: one encode
of the frame, both decoders and heads, and the matching cascade (iter_proj
and K3).  Every ``keyframe_every``-th frame becomes the keyframe: its
tokens (returned by that call) are cached and the warm start is dropped.
A frame's time runs from handing it over to its matches being on the
device (a synchronisation ends each frame, as the tracker's one pull
does).

The check draws a sample of the window's frames from the seed (reservoir
sampling over the frames whose result returned inside it) and keeps their
outputs on the device, with the descriptors of both views (the heads'
``desc``, which ``match_asymmetric`` does not return, kept from the
runner's ``decode`` as it hands them to the cascade) and the warm start the
call was given.  Once the window has closed and the program is freed, the
plain float32 MASt3R (TF32 off) recomputes each sampled frame from the
images and the weights alone, following the same keyframe schedule from
the sample's keyframe, and the tokens and heads are compared.  The plain
cascade then runs on the program's own heads and warm start, and its
matches are compared with the program's on every pixel: random weights
give pointmaps on which iter_proj from the reference's own heads lands
elsewhere for most pixels, so the cascade is judged on its inputs as the
program had them.

The control (``check(control=True)``): the plain MASt3R with its trunk's
operands rounded to float8 e4m3 (below the program's bfloat16 trunk) for
the tokens and heads, and the plain cascade on bfloat16 pointmaps and
float8 descriptors (below its float32 iter_proj and bfloat16 refine) for
the matches, each in the program's place.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import Window, log, sync
from benchmark.reference import cascade_plain, mast3r_plain
from benchmark.traffic import stream

OUT_KEYS = ("idx", "valid", "Xii", "Cii", "Qii", "Xji", "Cji", "Qji", "feat")
LOW = {"X": torch.bfloat16, "D": torch.float8_e4m3fn}    # the cascade's control


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """The widest gap max |a - b| against the reference's spread (its
    standard deviation over all elements)."""
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).abs().max() / b.std())


def match_disagreement(idx_a, valid_a, idx_b, valid_b) -> float:
    """The share of all pixels whose match differs: matched to another
    pixel (iter_proj's projection where the match is invalid, the refined
    match where it is valid), or valid on one side only."""
    va, vb = valid_a.flatten().bool(), valid_b.flatten().bool()
    diff = (va != vb) | (idx_a.flatten() != idx_b.flatten())
    return float(diff.double().mean())


def judge(prog: dict, ref: dict) -> dict:
    """The numbers compared for one frame: the widest gaps of the encoder
    tokens and of the heads' points, confidences, descriptors and
    descriptor confidences of both views, each against the reference's
    spread; the share of matches that differ from the reference's own."""
    def both(k):
        return max(rel_err(prog[k + "ii"], ref[k + "ii"]), rel_err(prog[k + "ji"], ref[k + "ji"]))

    return {
        "tokens_err": rel_err(prog["feat"], ref["feat"]),
        "pts3d_err": both("X"),
        "conf_err": both("C"),
        "desc_err": both("D"),
        "desc_conf_err": both("Q"),
        "match_diff": match_disagreement(prog["idx"], prog["valid"], ref["idx"], ref["valid"]),
    }


def cascade_on(cfg: dict, out: dict, hw: tuple, low: bool = False) -> tuple:
    """The plain cascade on a frame's heads and warm start as the program
    had them; ``low``: pointmaps and descriptors rounded to LOW first."""
    H, W = hw

    def view(x, key, c):
        x = x.reshape(1, H, W, c)
        return x.to(LOW[key]).float() if low else x

    X11, X21 = view(out["Xii"], "X", 3), view(out["Xji"], "X", 3)
    D11 = view(out["Dii"], "D", out["Dii"].shape[-1])
    D21 = view(out["Dji"], "D", out["Dji"].shape[-1])
    init = out["idx_init"]
    return cascade_plain.match(cfg, X11, X21, D11, D21,
                               idx_init=None if init is None else init.reshape(1, H * W))


def schedule(i: int, every: int) -> tuple:
    """Frame i's keyframe and the frames its warm start runs through: frame
    0 is the first keyframe; frames after keyframe k match into k, the first
    of them from no warm start, each later one from its predecessor's
    matches."""
    kf = every * ((i - 1) // every)
    return kf, list(range(kf + 1, i + 1))


class Driver:
    def __init__(self, config: dict, mix: dict, seed: int, device, tracer):
        t0 = time.perf_counter()
        from artdeco_tpu_torch.models.mast3r import MASt3RConfig
        from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner

        self.setup_split = {"imports": time.perf_counter() - t0}
        t0 = time.perf_counter()
        self.device, self.tracer, self.config, self.mix, self.seed = (device, tracer, config,
                                                                      mix, seed)
        self.every = int(mix["keyframe_every"])
        self.widths = mast3r_plain.widths_from(config["model"])
        n = int(mix["warmup_frames"]) + int(mix["window_frames_max"])
        poses = stream.trajectory(mix, seed, n)
        self.frames_u8 = stream.frames(mix, seed, poses, device, host=False,
                                       batch=max(1, 8_000_000 // (mix["width"] * mix["height"])))
        self.setup_split["generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd = mast3r_plain.draw_state_dict(self.widths, seed, device)
        cfg = MASt3RConfig(**{**config["model"],
                              "dpt_layer_dims": tuple(config["model"]["dpt_layer_dims"]),
                              "compute_dtype": getattr(torch, config["compute_dtype"])})
        self.runner = Mast3rRunner.create(cfg, match_cfg=config["matching"], state_dict=sd,
                                          device=device)
        del sd
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the runner's encode and decode, which match_asymmetric calls
        # through the instance: profiler ranges around both, and decode's
        # last heads kept (the check reads their descriptors)
        self.heads = None
        encode, decode = self.runner.encode_image, self.runner.decode

        def encode_ranged(*a, **k):
            with tracer.annotate("bench:encode"):
                return encode(*a, **k)

        def decode_kept(*a, **k):
            with tracer.annotate("bench:decode"):
                self.heads = decode(*a, **k)
            return self.heads

        self.runner.encode_image, self.runner.decode = encode_ranged, decode_kept
        self.setup_split["weights"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.i = 0
        self.kf_img = self.kf_emb = self.idx_init = None
        for _ in range(int(mix["warmup_frames"])):
            self._frame()
        sync(device)
        self.setup_split["warmup"] = time.perf_counter() - t0
        self.extra = {"hw": (mix["height"], mix["width"])}

    def image(self, i: int) -> torch.Tensor:
        """Frame i as the model takes it: (3, H, W) float32 in [-1, 1]."""
        return self.frames_u8[i].permute(2, 0, 1).float().div_(127.5).sub_(1.0)

    def _frame(self):
        """Frame self.i's model step.  Returns (t_ask, t_end, outputs) or
        None when the stream has run out."""
        if self.i >= len(self.frames_u8):
            return None
        img = self.image(self.i)
        t0 = time.perf_counter()
        out = None
        if self.i == 0:
            self.kf_emb = self.runner.encode_image(img[None])
            self.kf_img = img
        else:
            init = self.idx_init
            with self.tracer.annotate("bench:match"):
                res = self.runner.match_asymmetric(img, self.kf_img, idx_i2j_init=init,
                                                   embeddings_j=self.kf_emb)
            if self.heads is None:
                raise RuntimeError("match_asymmetric did not call the runner's decode: the "
                                   "check reads the descriptors from it")
            out = dict(zip(OUT_KEYS, res[:9]), idx_init=init,
                       Dii=self.heads[0]["desc"], Dji=self.heads[1]["desc"])
            self.idx_init = out["idx"]
            if self.i % self.every == 0:
                self.kf_emb, self.kf_img, self.idx_init = (res[8], res[9]), img, None
        sync(self.device)
        t_end = time.perf_counter()
        self.i += 1
        return t0, t_end, out

    def counters(self) -> dict:
        return {"frames": self.i}

    def run_window(self, seconds: float) -> Window:
        dev, tr = self.device, self.tracer
        if dev.type == "cuda":
            self.extra["memory_setup_peak"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        rng = np.random.default_rng([self.seed & 0xFFFFFFFF, (self.seed >> 32) & 0xFFFFFFFF, 7])
        k = int(self.config["check_frames"])
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
            r = self._frame()
            if r is None:
                exhausted = True
                break
            attempted += 1
            t_ask, t_end, out = r
            if t_end <= t_close:
                lat.append(t_end - t_ask)
                if out is not None:
                    # reservoir sampling: a uniform sample of k finished frames
                    seen += 1
                    if len(self.sample) < k:
                        self.sample[i] = out
                    else:
                        j = int(rng.integers(seen))
                        if j < k:
                            del self.sample[sorted(self.sample)[j]]
                            self.sample[i] = out
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
        del self.runner, self.kf_emb, self.kf_img, self.idx_init, self.heads
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------------
    def reference_outputs(self, trunk_quant=None) -> dict:
        """The plain model's and cascade's outputs for every sampled frame
        (``trunk_quant="fp8"``: the control's), from the images and weights
        alone."""
        dev = self.device
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        sd = mast3r_plain.draw_state_dict(self.widths, self.seed, dev)
        model = mast3r_plain.build(self.widths, sd, dev, trunk_quant)
        del sd
        H, W = int(self.mix["height"]), int(self.mix["width"])
        hw = H * W
        outs = {}
        with torch.no_grad():
            for i in sorted(self.sample):
                kf, chain = schedule(i, self.every)
                emb_kf = model.encode(self.image(kf)[None])
                idx = None
                for f in chain:
                    feat, pos = model.encode(self.image(f)[None])
                    r11, r21 = model.pair(feat, pos, emb_kf[0], emb_kf[1], (H, W))
                    idx, valid = cascade_plain.match(self.config["matching"], r11["pts3d"],
                                                     r21["pts3d"], r11["desc"], r21["desc"],
                                                     idx_init=idx)
                outs[i] = {"idx": idx, "valid": valid, "feat": feat,
                           "Xii": r11["pts3d"].reshape(hw, 3), "Cii": r11["conf"].reshape(hw, 1),
                           "Qii": r11["desc_conf"].reshape(hw, 1), "Dii": r11["desc"],
                           "Xji": r21["pts3d"].reshape(hw, 3), "Cji": r21["conf"].reshape(hw, 1),
                           "Qji": r21["desc_conf"].reshape(hw, 1), "Dji": r21["desc"]}
        return outs

    def check(self, control: bool = False) -> dict:
        """The worst of each number over the sampled frames: the program's
        outputs, or (``control``) the control's in their place, with the
        program's numbers logged as readings."""
        ref = self.reference_outputs()
        worst = self._judge(ref, self.sample, False)
        if not control:
            return worst
        log("program's numbers (readings of this control run): "
            + ", ".join(f"{k} {v!r}" for k, v in worst.items()))
        return self._judge(ref, self.reference_outputs("fp8"), True)

    def _judge(self, ref: dict, outputs: dict, low: bool) -> dict:
        hw = (int(self.mix["height"]), int(self.mix["width"]))
        worst: dict = {}
        for i, out in outputs.items():
            nums = judge(out, ref[i])
            prog = self.sample[i]
            with torch.no_grad():
                plain = cascade_on(self.config["matching"], prog, hw)
                mine = (cascade_on(self.config["matching"], prog, hw, low=True) if low
                        else (prog["idx"], prog["valid"]))
            nums["cascade_diff"] = match_disagreement(*mine, *plain)
            for name, v in nums.items():
                worst[name] = max(worst.get(name, 0.0), v)
        if not worst:
            raise RuntimeError("no frame of the window finished: nothing to check")
        log("valid matches of the sampled frames: "
            + ", ".join(f"{i}: {float(o['valid'].float().mean()):.4f}" for i, o in outputs.items()))
        return worst
