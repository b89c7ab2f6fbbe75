"""Llama-4 Maverick 400B-A17B — MoE 128 experts top-1 + shared expert on
every *second* layer (period-2 dense/MoE interleave, which is what lands
the public 400B total-parameter count) [hf:meta-llama/Llama-4-Maverick]."""
from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models.moe import MoESpec

_MOE = MoESpec(n_experts=128, top_k=1, d_ff_expert=8192, shared_expert=True,
               capacity_factor=2.0)

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),
             LayerSpec(kind="attn", mlp="moe", moe=_MOE)),
    norm="rmsnorm", rope="rope", rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (assigned spec)",
)
