"""InternLM2-1.8B — dense GQA [arXiv:2403.17297; hf]."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),),
    norm="rmsnorm", rope="rope", rope_theta=1e6,
    source="arXiv:2403.17297",
)
