"""artdeco_tpu_torch — the PyTorch/CUDA port of ``artdeco_tpu``.

The file layout mirrors ``artdeco_tpu/`` file for file, so each module names
the JAX module it is checked against.  This package imports ``torch`` and
never ``jax``, nor the JAX package: its host-side inputs
(``mapper/config.py`` ``MapperConfig``, ``dataio/dataset.py``
``SyntheticDataset``) are its own copies, held to the originals by the
parity tests.

Ported so far: the online mapper (``mapper/``), its rasterizer
(``ops/splat/``) with the tile compositor as hand-written CUDA kernels
(``csrc/composite.cu``), and the mapper half of the runtime
(``runtime/system.MapperStage``).
"""

__version__ = "0.1.0"
