from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_attention_plain)
from repro_torch.kernels.paged_attention.kernel import paged_attention_kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

__all__ = ["paged_attention", "paged_attention_plain",
           "paged_attention_kernel", "paged_attention_ref"]
