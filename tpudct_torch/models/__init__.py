"""Pipeline families, the reference's four strategies for the same codec:
``cublas`` (a per-block GEMM loop, the slow baseline), ``batched`` (alias
``cublas2``, one whole-image einsum), ``fast`` (the integer core) in plain
torch; and ``hp``, the hand-written CUDA kernels."""

from tpudct_torch.models.base import Pipeline, register, get_pipeline, available_pipelines

# Import for registration side effects.
from tpudct_torch.models import cublas_like as _cublas_like  # noqa: F401
from tpudct_torch.models import batched as _batched  # noqa: F401
from tpudct_torch.models import fast_appr as _fast_appr  # noqa: F401
from tpudct_torch.models import hp_appr as _hp_appr  # noqa: F401

__all__ = ["Pipeline", "register", "get_pipeline", "available_pipelines"]
