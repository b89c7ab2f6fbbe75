"""Qwen2-VL 7B — M-RoPE, dynamic resolution [arXiv:2409.12191].

The vision frontend is a stub: the caller supplies precomputed patch
embeddings ``embeds``, added to the token embeddings, and the 3-stream
(t/h/w) M-RoPE position ids ``positions3``."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, head_dim=128,
    pattern=(LayerSpec(kind="attn", mlp="swiglu"),),
    norm="rmsnorm", rope="mrope", rope_theta=1e6,
    mrope_sections=(16, 24, 24), frontend="vision",
    source="arXiv:2409.12191",
)
