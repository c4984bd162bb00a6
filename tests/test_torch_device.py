"""The port's entry points run on the card unless the caller asks for the CPU.

Each of ``MapperStage``, ``SceneModel``, ``Frontend``, ``OracleRunner``,
``KeyframeStore``, ``System``, ``Backend``, ``FactorGraph`` and
``Mast3rRunner`` takes
``device=None`` and resolves it through
``device.require_cuda``: with no CUDA device present and no device passed,
it raises that function's error (there is no CPU fallback); a device that
is passed is used as it is.
"""

import os
import types

import pytest
import torch

from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper.scene_model import SceneModel
from artdeco_tpu_torch.models.mast3r import tiny_config
from artdeco_tpu_torch.models.mast3r_infer import Mast3rRunner
from artdeco_tpu_torch.models.oracle import OracleRunner
from artdeco_tpu_torch.runtime.system import MapperStage, System
from artdeco_tpu_torch.utils.config import load_config
from artdeco_tpu_torch.vslam.backend import Backend
from artdeco_tpu_torch.vslam.frontend import Frontend
from artdeco_tpu_torch.vslam.global_opt import FactorGraph
from artdeco_tpu_torch.vslam.keyframes import KeyframeStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _entry_points():
    """Constructors of the five entry points at a tiny size, each taking
    ``**device_kw``."""
    ds = SyntheticDataset(types.SimpleNamespace(test_hold=-1, max_size_slam=64),
                          n_frames=2, width=64, height=48)
    cfg = load_config(os.path.join(ROOT, "config", "base.yaml"))
    cpu = torch.device("cpu")
    store = KeyframeStore(ds.H_slam, ds.W_slam, ds.K_slam, buffer=4, device=cpu)
    runner = OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam, cfg["matching"], device=cpu)
    return {
        "MapperStage": lambda **kw: MapperStage(ds, **kw),
        "SceneModel": lambda **kw: SceneModel(ds.W_map, ds.H_map, ds.K_map, **kw),
        "Frontend": lambda **kw: Frontend(types.SimpleNamespace(), cfg, ds, store, runner,
                                          **kw),
        "OracleRunner": lambda **kw: OracleRunner((ds.H_slam, ds.W_slam), ds.K_slam,
                                                  cfg["matching"], **kw),
        "KeyframeStore": lambda **kw: KeyframeStore(ds.H_slam, ds.W_slam, ds.K_slam,
                                                    buffer=4, **kw),
        "System": lambda **kw: System(types.SimpleNamespace(retrieval_checkpoint_path=""),
                                      cfg, ds, runner, **kw),
        "Backend": lambda **kw: Backend(types.SimpleNamespace(), cfg, ds, store, runner,
                                        **kw),
        "FactorGraph": lambda **kw: FactorGraph(cfg, runner, store, ds.K_slam,
                                                (ds.H_slam, ds.W_slam), **kw),
        "Mast3rRunner": lambda **kw: Mast3rRunner.create(tiny_config(), **kw),
    }


ENTRY_POINTS = ["MapperStage", "SceneModel", "Frontend", "OracleRunner", "KeyframeStore",
                "System", "Backend", "FactorGraph", "Mast3rRunner"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        make()
    obj = make(device=torch.device("cpu"))
    assert obj.device == torch.device("cpu")
