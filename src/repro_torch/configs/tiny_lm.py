"""tiny-lm — ~110M dense model for the runnable end-to-end examples."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="tiny-lm", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=32000, head_dim=64,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),),
    norm="rmsnorm", rope="rope", rope_theta=10000.0,
    dtype="float32", param_dtype="float32", page_size=16,
    source="this repo (examples)",
)
