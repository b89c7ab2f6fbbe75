"""Nemotron-4 15B — dense GQA with squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="relu2"),),
    norm="layernorm", rope="rope", rope_theta=10000.0,
    source="arXiv:2402.16819",
)
