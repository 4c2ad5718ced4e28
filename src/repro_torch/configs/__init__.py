"""Architecture + shape configuration system.

``get_config(name)`` returns the full published configuration;
``get_config(name).reduced()`` returns a CPU-smoke-testable miniature of the
same family (same code paths, tiny dims).  ``SHAPES`` holds the assigned
input-shape set; ``cells(arch)`` enumerates the (arch x shape) cells that
are applicable (see DESIGN.md for skip rules).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0           # 0 => no q compression
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 64
    top_k: int = 2
    n_shared_experts: int = 0
    d_expert: int = 1408           # per-expert FFN hidden dim
    n_dense_layers: int = 0        # leading layers that use a dense FFN instead
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class VLMConfig:
    d_vision: int = 1024           # vision-tower output width
    n_image_tokens: int = 576      # tokens contributed by the image
    projector_layers: int = 2
    vision_tower: bool = False     # True => real ViT params (paper repro);
                                   # False => stubbed frontend (assigned arch)
    vit_layers: int = 24
    vit_heads: int = 16
    vit_d_ff: int = 4096
    vit_patch: int = 14
    vit_image_size: int = 336


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 24
    d_frontend: int = 1024         # stubbed speech-frontend embedding width
    enc_seq_ratio: float = 1.0     # encoder seq = ratio * shape.seq_len


@dataclass(frozen=True)
class HybridConfig:
    attn_every: int = 6            # shared attention block applied every k layers
    shared_attn_blocks: int = 2    # distinct shared blocks, alternating


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    vlm: Optional[VLMConfig] = None
    encdec: Optional[EncDecConfig] = None
    hybrid: Optional[HybridConfig] = None
    # training-system defaults (overridable by TrainConfig)
    optimizer: str = "adamw"       # adamw | adafactor | adamw8bit
    fsdp: bool = False             # shard params over the data axis too (ZeRO-3)
    remat: str = "block"           # none | block | dots
    seq_parallel: bool = True      # shard the residual seq dim over `model`
    subquadratic: bool = False     # may run long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def reduced(self) -> "ArchConfig":
        """Miniature config of the same family for CPU smoke tests."""
        r = dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(max(self.n_kv_heads // max(self.n_heads // 4, 1), 1), 4),
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.mla:
            r = dataclasses.replace(r, mla=MLAConfig(
                q_lora_rank=32 if self.mla.q_lora_rank else 0,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16))
        if self.moe:
            r = dataclasses.replace(r, moe=dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                n_dense_layers=min(self.moe.n_dense_layers, 1)))
        if self.ssm:
            r = dataclasses.replace(r, ssm=SSMConfig(
                d_state=16, d_conv=4, expand=2, head_dim=16,
                n_groups=1, chunk=32))
        if self.vlm:
            r = dataclasses.replace(r, vlm=dataclasses.replace(
                self.vlm, d_vision=32, n_image_tokens=16,
                vit_layers=2, vit_heads=2, vit_d_ff=64,
                vit_image_size=28, vit_patch=14))
        if self.encdec:
            r = dataclasses.replace(r, encdec=dataclasses.replace(
                self.encdec, n_enc_layers=2, d_frontend=32))
        if self.hybrid:
            r = dataclasses.replace(r, hybrid=HybridConfig(
                attn_every=2, shared_attn_blocks=1))
        return r


# ---------------------------------------------------------------------------
# Shapes (assigned): seq_len x global_batch; kind decides which step lowers.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_NAMES = [
    "llama3.2-3b",
    "minicpm3-4b",
    "smollm-360m",
    "qwen3-32b",
    "deepseek-v2-lite-16b",
    "arctic-480b",
    "mamba2-1.3b",
    "llava-next-mistral-7b",
    "zamba2-2.7b",
    "seamless-m4t-large-v2",
]

_MODULES = {
    "llama3.2-3b": "llama3_2_3b",
    "minicpm3-4b": "minicpm3_4b",
    "smollm-360m": "smollm_360m",
    "qwen3-32b": "qwen3_32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "arctic-480b": "arctic_480b",
    "mamba2-1.3b": "mamba2_1_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llava15-7b": "llava15_7b",
    "llama3.1-8b": "llama3_1_8b",
}

# runtime-registered configs (register_config); checked before _MODULES
_RUNTIME: dict[str, ArchConfig] = {}


def register_config(cfg: ArchConfig, name: Optional[str] = None) -> None:
    """Register an architecture at runtime so ``get_config``/the sweep
    engine can plan for it without a module under repro/configs/.  See
    docs/configs.md for the file-based registration path."""
    _RUNTIME[name or cfg.name] = cfg


def registered_archs() -> list[str]:
    """All arch names ``get_config`` accepts (file-based + runtime)."""
    return sorted(set(_MODULES) | set(_RUNTIME))


def get_config(name: str) -> ArchConfig:
    if name in _RUNTIME:
        return _RUNTIME[name]
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; known: {registered_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cells(arch: Optional[str] = None) -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells. long_500k only runs for
    sub-quadratic archs (SSM / hybrid); see DESIGN.md."""
    out = []
    for a in ([arch] if arch else ARCH_NAMES):
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue
            out.append((a, s))
    return out


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for a in ARCH_NAMES:
        cfg = get_config(a)
        if not cfg.subquadratic:
            out.append((a, "long_500k",
                        "pure full-attention arch; 500k decode requires "
                        "sub-quadratic attention (DESIGN.md)"))
    return out
