from artdeco_tpu_torch.ops.splat.api import RasterMeta, rasterization  # noqa: F401
from artdeco_tpu_torch.ops.splat.sh import num_sh_bases, rgb_to_sh, sh_to_color  # noqa: F401
