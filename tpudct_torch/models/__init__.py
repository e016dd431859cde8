"""Pipeline families ported so far: ``batched`` (alias ``cublas2``), plain
torch einsum; and ``hp``, the hand-written CUDA kernels."""

from tpudct_torch.models.base import Pipeline, register, get_pipeline, available_pipelines

# Import for registration side effects.
from tpudct_torch.models import batched as _batched  # noqa: F401
from tpudct_torch.models import hp_appr as _hp_appr  # noqa: F401

__all__ = ["Pipeline", "register", "get_pipeline", "available_pipelines"]
