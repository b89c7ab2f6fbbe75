"""Hand-written Hopper kernels of the port, one package per TPU kernel
(``kernel.py`` launch wrapper + ``ref.py`` plain version + ``ops.py``
entry point + ``csrc/`` CUDA source)."""

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Launches of every kernel since the last :func:`reset_launch_counts`."""
    from repro_torch.kernels.tiara_gather import kernel as _tg
    return {"tiara_gather": _tg.LAUNCHES}


def reset_launch_counts() -> None:
    from repro_torch.kernels.tiara_gather import kernel as _tg
    _tg.LAUNCHES = 0
