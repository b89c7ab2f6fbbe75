"""Llama-4 Scout 17B-A16E — MoE 16 experts top-1 + shared expert, every
layer [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models.moe import MoESpec

_MOE = MoESpec(n_experts=16, top_k=1, d_ff_expert=8192, shared_expert=True,
               capacity_factor=2.0)

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="moe", moe=_MOE),),
    norm="rmsnorm", rope="rope", rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
