"""Model serving over the paged KV cache.

Public surface (audited ``__all__``): the engine + its completion
handle, the block allocator (with its endpoint region layout export),
the Tiara-backed resolver, and the sampler.
"""

from repro_torch.serving.allocator import BlockAllocator, OutOfPages
from repro_torch.serving.engine import Sequence, SequenceHandle, ServingEngine
from repro_torch.serving.resolver import TiaraResolver, expert_layout
from repro_torch.serving.sampler import sample_tokens

__all__ = [
    "BlockAllocator",
    "OutOfPages",
    "Sequence",
    "SequenceHandle",
    "ServingEngine",
    "TiaraResolver",
    "expert_layout",
    "sample_tokens",
]
