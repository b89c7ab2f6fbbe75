from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_chunked,
                                                     flash_attention_lse_ref,
                                                     flash_attention_ref)

__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_plain",
           "flash_attention_kernel",
           "flash_attention_bwd_kernel", "flash_attention_chunked",
           "flash_attention_ref", "flash_attention_lse_ref",
           "flash_attention_bwd_ref"]
