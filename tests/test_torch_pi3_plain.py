"""The port's Pi3 against the benchmark's plain float32 reference
(``benchmark/reference/pi3_plain.py``) on one seeded state dict, and the
relocalization query through the retrieval database, at
``tiny_pi3_config``, on the CPU.

Tolerances, each as a share of the reference output's largest magnitude
(the measured gaps in brackets):

- float32: ``points``, ``local_points``, ``conf`` and ``camera_poses``
  within 1e-5 [4.6e-7: the same operations in another order]; the
  decoder's update to its tokens (the heads' input less the decoder's
  input, which the cell's check judges) within 1e-4 [4.5e-5]: it is the
  difference of two float32 tensors about a hundred times its size, so
  their rounding reads a hundred times larger in it.
- bfloat16 trunk: the outputs within 5e-3 [2.1e-3, on ``conf``] and the
  update within 1e-2 [3.6e-3]: bfloat16 keeps 8 significant bits, a
  rounding of 3.9e-3 of each operand of the trunk's products.
- The global blocks run frame-locally (a planted fault) move the update by
  0.117 of its magnitude, over ten times the bfloat16 tolerance; the points
  move by 2.4e-6 only, since LayerScale 0.01 keeps the decoder's part of
  the outputs small on random weights.
- The query's fractions within 4e-3 (63 of 15,680 pixels) of the accurate
  matcher's ``match_pi3`` run on the plain reference's points [1.3e-3, 20
  pixels]: the bfloat16 trunk's points move iter_proj's convergence test
  or the distance filter on a few pixels.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from artdeco_tpu_torch import trace
from artdeco_tpu_torch.models import pi3 as TP
from artdeco_tpu_torch.ops.matching import match_pi3
from artdeco_tpu_torch.vslam.backend import host_tokens
from artdeco_tpu_torch.vslam.frame import Frame
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore
from artdeco_tpu_torch.vslam.retrieval import build_retrieval_database

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.drivers.pi3_reloc import decoder_update, keep_outputs  # noqa: E402
from benchmark.reference import pi3_plain  # noqa: E402
from benchmark.tests.test_pi3_cell import TINY_PI3, plant  # noqa: E402

MATCH = dict(max_iter=10, lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=0.1,
             radius=4, dilation_max=5)
RETRIEVAL = {"k": 3, "min_thresh": 5e-3, "accurate_min": 0.15}
BF16_TOL = {"points": 5e-3, "local_points": 5e-3, "conf": 5e-3, "camera_poses": 5e-3,
            "update": 1e-2}


@pytest.fixture(autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model(dtype):
    cfg = TP.tiny_pi3_config(compute_dtype=dtype)
    return TP.random_pi3(cfg, torch.Generator().manual_seed(5), "cpu").eval()


def _outputs(model, register_token, imgs) -> dict:
    """A Pi3's outputs and decoder update (the cell's hooks)."""
    kept: dict = {}
    hooks = keep_outputs(model, kept.__setitem__)
    try:
        with torch.no_grad():
            out = model(imgs)
    finally:
        for h in hooks:
            h.remove()
    return dict({k: out[k] for k in ("points", "local_points", "conf", "camera_poses")},
                update=decoder_update(register_token, kept["enc"], kept["heads_in"]))


def _gaps(got: dict, want: dict) -> dict:
    return {k: float((got[k].float() - want[k]).abs().max() / want[k].abs().max())
            for k in want}


def _reference(model, imgs) -> dict:
    sd = model.state_dict()
    ref = pi3_plain.build(pi3_plain.widths_from(TINY_PI3), sd, "cpu")
    return _outputs(ref, sd["register_token"], imgs)


IMGS = torch.rand(1, 3, 3, 56, 70, generator=torch.Generator().manual_seed(1))


def test_port_matches_plain_reference_in_float32():
    model = _model(torch.float32)
    gaps = _gaps(_outputs(model, model.register_token.detach(), IMGS), _reference(model, IMGS))
    assert max(v for k, v in gaps.items() if k != "update") < 1e-5, gaps
    assert gaps["update"] < 1e-4, gaps


def test_port_bf16_trunk_within_its_tolerance():
    model = _model(torch.bfloat16)
    gaps = _gaps(_outputs(model, model.register_token.detach(), IMGS), _reference(model, IMGS))
    assert all(gaps[k] < BF16_TOL[k] for k in BF16_TOL), gaps


def test_frame_local_global_blocks_exceed_the_bf16_tolerance(monkeypatch):
    model = _model(torch.float32)
    ref = _reference(model, IMGS)
    calls = []
    plant(monkeypatch, "global_local", calls)
    gaps = _gaps(_outputs(model, model.register_token.detach(), IMGS), ref)
    assert calls and gaps["update"] > 10 * BF16_TOL["update"], gaps


@pytest.fixture(scope="module")
def query():
    """The relocalization query as the Backend makes it, on the tiny Pi3
    that ``build_retrieval_database`` loads: 4 keyframes registered, the
    query appended, ``update(add_after_query=False)``, the query popped."""
    h, w = 48, 64
    args = types.SimpleNamespace(accurate_loop_closure=True, model_size="tiny",
                                 retrieval_checkpoint_path="", pi3_checkpoint_path="")
    store = KeyframeStore(h, w, buffer=8, device="cpu")
    db = build_retrieval_database(args, {"retrieval": RETRIEVAL, "matching": MATCH}, store)
    runner = db.accurate_matcher.pi3
    kept: dict = {}
    keep_outputs(runner.model, kept.__setitem__)
    inner, seen = db.accurate_matcher, {}

    def matcher(cand, q):
        seen["cand"], seen["fracs"] = list(cand), inner(cand, q)
        return seen["fracs"]

    db.accurate_matcher = matcher
    g = torch.Generator().manual_seed(7)
    T = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=torch.float32)
    imgs = torch.rand(5, 3, h, w, generator=g) * 2 - 1
    feats = torch.randn(5, 1, 48, 64, generator=g)
    for i in range(4):
        store.append(Frame(img=imgs[i], T_WC=T, X_canon=None, C=None, N=None, frame_id=i))
        db.update(host_tokens(feats[i]), add_after_query=True, k=3, min_thresh=5e-3)
    store.append(Frame(img=imgs[4], T_WC=T, X_canon=None, C=None, N=None, frame_id=4))
    calls = inner.calls
    db.update(host_tokens(feats[4]), add_after_query=False, k=3, min_thresh=5e-3)
    store.pop_last()
    assert inner.calls == calls + 1 and len(store) == 4
    last = [e for e in trace.events() if e.name == "lc.match" and e.stream == inner.stream.id]
    request = (last[-1].stream, last[-1].request)
    return types.SimpleNamespace(runner=runner, kept=kept, seen=seen, request=request)


def test_reloc_query_fractions_match_the_plain_reference_points(query):
    sd = query.runner.model.state_dict()
    ref = pi3_plain.build(pi3_plain.widths_from(TINY_PI3), sd, "cpu")
    with torch.no_grad():
        points = ref(query.kept["imgs"])["points"][0]
    n_real = len(query.seen["cand"]) + 1
    rows = points[:points.shape[0] - 1]
    _, valid = match_pi3(MATCH, rows, points[n_real - 1].expand_as(rows))
    want = valid.float().mean(dim=1)[:n_real - 1].numpy()
    assert query.kept["imgs"].shape == (1, 24, 3, 112, 140)
    np.testing.assert_allclose(query.seen["fracs"], want, rtol=0, atol=4e-3)


def test_reloc_query_records_pi3_spans_under_one_request(query):
    """One request holds pi3.encode, pi3.decode with a pi3.global a global
    block inside it, pi3.heads, lc.match and the count of 24 frames."""
    ev = [e for e in trace.events() if (e.stream, e.request) == query.request]
    names = [e.name for e in ev if e.kind == "span"]
    n_global = TP.tiny_pi3_config().dec_depth // 2
    assert sorted(names) == sorted(["pi3.encode", "pi3.decode", "pi3.heads", "lc.match"]
                                   + ["pi3.global"] * n_global), names
    decode = next(e for e in ev if e.name == "pi3.decode")
    assert all(e.parent == decode.seq for e in ev if e.name == "pi3.global")
    assert [e.n for e in ev if e.kind == "count" and e.name == "pi3.frames"] == [24]
    assert query.runner.timers["pi3.global"][1] >= n_global
