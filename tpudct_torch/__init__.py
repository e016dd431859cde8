"""tpudct_torch — the blockwise approximate-DCT image codec on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper.

A port of the ``tpudct`` package (JAX/Pallas on a TPU), which stays beside
it as the reference.  Same ``CodecConfig``, same pipeline names, same
value chain; this package imports torch and numpy, never JAX.

Public API
----------
- constants:  T (Haweel approximate DCT), Q (JPEG luminance), BLOCK_SIZE
- config:     CodecConfig
- models:     get_pipeline("cublas" | "batched" | "cublas2" | "fast" | "hp")
- ops:        blockify / deblockify / dct2 / idct2 / quantize / dequantize
- parallel:   band_mesh / grid_mesh, shard_* and the sharded steps, the rings
- files:      utils.serialize (.tdc/.tdcc), utils.imageio; the CLI,
              python -m tpudct_torch {run,encode,decode,inspect}
"""

from tpudct_torch.constants import BLOCK_SIZE, T, Q, haweel_integer_core, haweel_row_norms
from tpudct_torch.config import CodecConfig
from tpudct_torch.models import get_pipeline, available_pipelines

__version__ = "0.2.0"

__all__ = [
    "BLOCK_SIZE",
    "T",
    "Q",
    "haweel_integer_core",
    "haweel_row_norms",
    "CodecConfig",
    "get_pipeline",
    "available_pipelines",
    "__version__",
]
