"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 with MoE 16e top-2 on every
second layer [arXiv:2403.19887].  Period-8 pattern: one attention layer
per 8, MoE on odd positions."""
from repro_torch.configs import ArchConfig, LayerSpec
from repro_torch.models.mamba import MambaSpec
from repro_torch.models.moe import MoESpec

_MOE = MoESpec(n_experts=16, top_k=2, d_ff_expert=14336,
               shared_expert=False, capacity_factor=1.25)


def _pattern():
    out = []
    for i in range(8):
        kind = "attn" if i == 0 else "mamba"
        if i % 2 == 1:
            out.append(LayerSpec(kind=kind, mlp="moe", moe=_MOE))
        else:
            out.append(LayerSpec(kind=kind, mlp="swiglu"))
    return tuple(out)


CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    pattern=_pattern(),
    norm="rmsnorm", rope="none",     # Jamba uses no positional encoding
    mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
    sub_quadratic=True,
    source="arXiv:2403.19887",
)
