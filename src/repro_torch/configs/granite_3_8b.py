"""Granite-3 8B — dense GQA [hf:ibm-granite/granite-3.0-8b-base]."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),),
    norm="rmsnorm", rope="rope", rope_theta=1e6,
    source="hf:ibm-granite/granite-3.0-2b-base (assigned spec)",
)
