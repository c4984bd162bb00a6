"""The port's host-side inputs against the JAX package's, on the CPU.

``MapperConfig`` and ``SyntheticDataset`` are host-only in both packages;
the port has its own copies so that it never imports the JAX package.
These checks hold the copies to the originals exactly: same fields and
defaults, same frames, poses, test split and intrinsics at both
resolutions.
"""

import types

import numpy as np
import pytest

from artdeco_tpu.dataio.dataset import SyntheticDataset as JSyntheticDataset
from artdeco_tpu.mapper.config import MapperConfig as JMapperConfig
from artdeco_tpu_torch.dataio.dataset import SyntheticDataset
from artdeco_tpu_torch.mapper.config import MapperConfig


def test_mapper_config_matches_jax():
    assert MapperConfig._fields == JMapperConfig._fields
    assert MapperConfig._field_defaults == JMapperConfig._field_defaults
    assert MapperConfig.__annotations__ == JMapperConfig.__annotations__


@pytest.mark.parametrize("width,height,max_size_slam,test_hold", [
    (64, 48, 64, 2), (512, 384, 512, 8), (320, 240, 512, -1), (200, 300, 128, 3),
])
def test_synthetic_dataset_matches_jax(width, height, max_size_slam, test_hold):
    args = types.SimpleNamespace(test_hold=test_hold, max_size_slam=max_size_slam)
    ds = SyntheticDataset(args, n_frames=5, width=width, height=height)
    jds = JSyntheticDataset(args, n_frames=5, width=width, height=height)
    for name in ("H", "W", "H_slam", "W_slam", "H_map", "W_map", "image_name_list",
                 "timestamp", "infos"):
        assert getattr(ds, name) == getattr(jds, name), name
    assert len(ds) == len(jds)
    for name in ("K_slam", "K_map", "Twc_gt"):
        a, b = getattr(ds, name), getattr(jds, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for i in (0, 3):
        img, info = ds[i]
        jimg, jinfo = jds[i]
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(info.pop("Twc_gt"), jinfo.pop("Twc_gt"))
        assert info == jinfo
        m, jm = ds.transform.to_map(img), jds.transform.to_map(jimg)
        assert m.dtype == jm.dtype == np.float32
        np.testing.assert_array_equal(m, jm)
