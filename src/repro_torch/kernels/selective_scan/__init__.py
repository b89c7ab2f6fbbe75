from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                    selective_scan_plain)
from repro_torch.kernels.selective_scan.kernel import selective_scan_kernel
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_plain", "selective_scan_kernel",
           "selective_scan_ref"]
