# The Tiara system on PyTorch: ISA, verifier, engines, registry,
# endpoint and serving loop (the JAX package's core/, module for module).
