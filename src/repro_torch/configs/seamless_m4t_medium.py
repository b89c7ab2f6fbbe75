"""SeamlessM4T-medium — encoder-decoder, multimodal [arXiv:2308.11596].

The audio frontend is a stub: the caller supplies precomputed frame
embeddings ``enc_embeds`` (B, S_enc, d_model) and their ``enc_lengths``.
As in the reference, self-attention takes RoPE in place of the upstream
relative/sinusoidal positions; cross attention takes none."""
from repro_torch.configs import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    pattern=(LayerSpec(kind="attn", mlp="gelu"),),
    norm="layernorm", rope="rope", rope_theta=10000.0,
    enc_dec=True, n_enc_layers=12, frontend="audio",
    source="arXiv:2308.11596",
)
