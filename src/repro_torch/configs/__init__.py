"""Architecture configs of the port.

``get_config(name)`` resolves an ``--arch`` id; each architecture lives in
its own module with the published numbers.  Ported so far: the
decoder-only attention architectures the serving engine runs — ``tiny-lm``,
the dense models (InternLM2, Granite-3, StableLM-2, Nemotron-4) and the
Llama-4 MoE models (Scout, Maverick) — and the recurrent families, which
run through the model's entry points (``init_caches``, ``prefill``,
``decode_step``): the hybrid Jamba and the attention-free RWKV-6 — and the
multimodal families, which run there too: Qwen2-VL (M-RoPE, a vision
stub) and the encoder-decoder SeamlessM4T (an audio stub).

``remat`` (none | dots | full) and ``remat_unit`` (pattern | layer) keep
the reference's meaning and defaults: the train mode checkpoints the
decoder stack through ``torch.utils.checkpoint`` (see
``models/transformer.py``).  The reference's mesh and compiler knobs
(``dp_spec``, ``scan_layers``) have no counterpart here: PyTorch runs
eagerly, and the port's mesh is explicit (``distributed/mesh.py``).
``paged_attn_fn`` and ``moe_fn`` are where the distributed decode
(``distributed/paged_decode.sharded_paged_attention``) and the
expert-parallel MoE (``distributed/moe_ep.make_moe_ep``) plug in, as in
the reference.  ``attn_fn`` has no counterpart there: it is the
prefill/train attention a launcher may put in place of
``flash_attention`` (``launch/cells.py`` puts the plain version there, so
a cell runs the plain route on any device, the reference's
``attn_impl="xla"``).  ``moe_hints`` (the reference's dispatch sharding
constraints) is accepted and has nothing to shard on one device.

``SHAPES`` carries the reference's input-shape suite and
``cell_applicable`` its long_500k rule (own copies of the reference's).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional, Tuple

from repro_torch.kernels import IMPLS as ATTN_IMPLS
from repro_torch.models.mamba import MambaSpec
from repro_torch.models.moe import MoESpec
from repro_torch.models.rwkv import RWKVSpec


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"            # attn | mamba | rwkv
    mlp: str = "swiglu"           # swiglu | relu2 | gelu | moe | rwkv_cm
    moe: Optional[MoESpec] = None


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[LayerSpec, ...]
    head_dim: int
    source: str = ""
    norm: str = "rmsnorm"
    rope: str = "rope"            # rope | mrope | none
    rope_theta: float = 1_000_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: Optional[str] = None   # audio | vision
    sub_quadratic: bool = False
    mamba: MambaSpec = MambaSpec()
    rwkv: RWKVSpec = RWKVSpec()
    attn_impl: str = "auto"       # auto | cuda | torch (kernels' ``impl``)
    remat: str = "full"           # none | dots | full (train-mode checkpoint)
    remat_unit: str = "pattern"   # pattern | layer (checkpoint granularity)
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    page_size: int = 128          # paged-KV page (tokens)
    paged_attn_fn: Optional[Any] = None   # one-round sharded paged decode
    attn_fn: Optional[Any] = None         # prefill/train attention hook
    moe_hints: bool = False       # dispatch-buffer shardings (no-op here)
    moe_fn: Optional[Any] = None  # local-dispatch expert-parallel MoE

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256 (padded logits are
        masked), as in the reference, so weights cross shape for shape."""
        return (self.vocab + 255) // 256 * 256

    @property
    def n_repeat(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            f"{self.name}: {self.n_layers} layers not a multiple of " \
            f"pattern length {len(self.pattern)}"
        return self.n_layers // len(self.pattern)

    @property
    def is_attention_free(self) -> bool:
        return all(s.kind != "attn" for s in self.pattern)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = (
    "internlm2-1.8b",
    "granite-3-8b",
    "stablelm-1.6b",
    "nemotron-4-15b",
    "llama4-scout-17b-a16e",
    "llama4-maverick-400b-a17b",
    "jamba-v0.1-52b",
    "rwkv6-1.6b",
    "seamless-m4t-medium",
    "qwen2-vl-7b",
)

_MODULES = {
    "internlm2-1.8b": "internlm2_1_8b",
    "granite-3-8b": "granite_3_8b",
    "stablelm-1.6b": "stablelm_1_6b",
    "nemotron-4-15b": "nemotron_4_15b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "tiny-lm": "tiny_lm",
}


def get_config(name: str) -> ArchConfig:
    key = name.strip().lower().replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests: small width, few
    layers (but >= one full pattern period), tiny vocab/experts, preserved
    GQA grouping and layer-kind structure.  The same numbers as the
    reference's ``reduce_config``."""
    group = max(1, cfg.n_heads // cfg.n_kv_heads)
    n_kv = 1 if cfg.n_kv_heads < cfg.n_heads else 2
    n_heads = group * n_kv if cfg.n_kv_heads < cfg.n_heads else 2
    pattern = []
    for spec in cfg.pattern:
        moe = spec.moe
        if moe is not None:
            moe = dataclasses.replace(moe, n_experts=min(4, moe.n_experts),
                                      d_ff_expert=64, capacity_factor=8.0)
        pattern.append(dataclasses.replace(spec, moe=moe))
    n_repeat = min(2, cfg.n_repeat)
    return cfg.replace(
        n_layers=len(pattern) * n_repeat,
        d_model=128, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=32, d_ff=160, vocab=512,
        pattern=tuple(pattern),
        n_enc_layers=min(2, cfg.n_enc_layers),
        mamba=dataclasses.replace(cfg.mamba, d_state=8, dt_rank=8),
        rwkv=dataclasses.replace(cfg.rwkv, head_size=32, decay_lora=16),
        mrope_sections=(4, 6, 6),
        dtype="float32", param_dtype="float32", page_size=8,
    )


def cell_applicable(cfg: ArchConfig, shape: ShapeSpec
                    ) -> Tuple[bool, str]:
    """(runnable, reason) for an (arch x shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k-token dense KV "
                       "decode excluded per assignment (DESIGN.md §4)")
    return True, ""
