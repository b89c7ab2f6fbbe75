from repro_torch.kernels.tiara_gather.ops import (tiara_gather,
                                                  tiara_gather_window)
from repro_torch.kernels.tiara_gather.kernel import (
    tiara_gather_kernel, tiara_gather_window_kernel)
from repro_torch.kernels.tiara_gather.ref import (tiara_gather_ref,
                                                  tiara_gather_window_ref)

__all__ = ["tiara_gather", "tiara_gather_window", "tiara_gather_kernel",
           "tiara_gather_window_kernel", "tiara_gather_ref",
           "tiara_gather_window_ref"]
