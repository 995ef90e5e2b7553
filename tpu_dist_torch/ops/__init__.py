"""`tpu_dist_torch.ops` — the hand-written CUDA kernels of the port."""

from tpu_dist_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_lse,
    flash_dkv,
    flash_dq,
    flash_fwd,
)
from tpu_dist_torch.ops.matmul import (
    fused_dense,
    matmul,
    matmul_reference,
    use_pallas_dense,
)
from tpu_dist_torch.ops.pallas_ring import (
    ring_all_reduce_pallas,
    ring_all_reduce_reference,
    synchronize,
)

__all__ = [
    "flash_attention",
    "flash_attention_lse",
    "flash_dkv",
    "flash_dq",
    "flash_fwd",
    "fused_dense",
    "matmul",
    "matmul_reference",
    "ring_all_reduce_pallas",
    "ring_all_reduce_reference",
    "synchronize",
    "use_pallas_dense",
]
