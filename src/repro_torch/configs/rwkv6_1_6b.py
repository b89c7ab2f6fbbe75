"""RWKV-6 (Finch) 1.6B — attention-free, data-dependent decay
[arXiv:2404.05892].  The paper's indirection collapse does not apply (no
KV block table); implemented without the technique."""
from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models.rwkv import RWKVSpec

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
    pattern=(LayerSpec(kind="rwkv", mlp="rwkv_cm"),),
    norm="layernorm", rope="none",
    rwkv=RWKVSpec(head_size=64, decay_lora=64),
    sub_quadratic=True,
    source="arXiv:2404.05892",
)
