"""artdeco_tpu_torch — the PyTorch/CUDA port of ``artdeco_tpu``.

The file layout mirrors ``artdeco_tpu/`` file for file, so each module names
the JAX module it is checked against.  This package imports ``torch`` and
never ``jax``, nor the JAX package: its host-side inputs
(``mapper/config.py`` ``MapperConfig``, ``dataio/dataset.py``
``SyntheticDataset``) are its own copies, held to the originals by the
parity tests.

Ported so far: the whole single-host system (``runtime/system.System``,
entry point ``run_system``), driven by MASt3R (``models/mast3r.py``,
``models/mast3r_infer.py``) with Pi3 accurate loop closure
(``models/pi3.py``, ``vslam/accurate_lc.py``) or by the oracle runner: the
tracking frontend with the matching cascade and the refine kernel
(``csrc/refine.cu``), the backend (``vslam/backend.py``,
``vslam/global_opt.py``, ``vslam/retrieval.py``), and the online mapper
(``mapper/``) with its rasterizer (``ops/splat/``), the tile compositor as
hand-written CUDA kernels (``csrc/composite.cu``) and LPIPS
(``eval/lpips.py``); and the multi-device path (``parallel/``:
keyframe-data-parallel mapper training, row-strip renders, the
edge-sharded GN, ``--n_devices``), one controller over a mesh of devices.
"""

__version__ = "0.1.0"
