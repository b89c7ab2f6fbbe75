"""The port's model code: parameter trees, layers, attention, blocks and
the pattern-stacked transformer (``src/repro/models`` is the JAX
reference)."""
