from repro_torch.kernels.lockstep_vm.ops import lockstep_vm
from repro_torch.kernels.lockstep_vm.kernel import lockstep_vm_kernel
from repro_torch.kernels.lockstep_vm.ref import lockstep_vm_ref

__all__ = ["lockstep_vm", "lockstep_vm_kernel", "lockstep_vm_ref"]
