"""PyTorch/CUDA port of the Tiara reproduction (``src/repro`` is the JAX
reference).  Imports ``torch`` and never ``jax`` or ``repro``."""
