from repro_torch.kernels.wkv6.ops import wkv6, wkv6_plain
from repro_torch.kernels.wkv6.kernel import wkv6_kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref

__all__ = ["wkv6", "wkv6_plain", "wkv6_kernel", "wkv6_ref"]
