"""StableLM-2 1.6B — dense MHA (kv=heads) [hf:stabilityai/stablelm-2-1_6b].

Deviation note: upstream uses partial (25%) rotary; we apply full-dim RoPE
(the reference's faithfulness boundary, kept here)."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=5632, vocab=100352, head_dim=64,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),),
    norm="layernorm", rope="rope", rope_theta=10000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
)
