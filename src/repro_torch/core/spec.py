"""Spec trees: the single source of truth shared by model construction and
the memory-prediction framework.

The paper's *Model parser* (workflow step 1-4) decomposes a multimodal model
into modules and fine-grained layers.  In this system every architecture is
*built from* a :class:`ModuleSpec` tree, so the parser does not reflect over
a live object graph - the spec **is** the parse.  The same tree drives

* parameter allocation  (``models.param.init_params``),
* the forward pass      (each arch family's ``apply`` consumes the params
                         whose shapes the spec dictates),
* sharding              (``ParamSpec.axes`` are logical axis names mapped to
                         mesh axes by the policy in ``launch.mesh``),
* memory factorization  (``core.factors`` evaluates the four per-layer
                         factors off this tree).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Logical axis names used across the zoo.  launch.mesh.LOGICAL_RULES maps
# them onto physical mesh axes ("pod", "data", "model").
# ---------------------------------------------------------------------------
AXIS_LAYERS = "layers"        # scan-stacked block dimension
AXIS_VOCAB = "vocab"          # embedding / lm-head vocab dimension
AXIS_EMBED = "embed"          # model (residual) dimension
AXIS_HEADS = "heads"          # merged attention heads*head_dim output dim
AXIS_KV_HEADS = "kv_heads"    # merged kv heads*head_dim output dim
AXIS_FFN = "ffn"              # feed-forward hidden dimension
AXIS_EXPERTS = "experts"      # routed-expert dimension
AXIS_EXPERT_BUF = "expert_buf"  # MoE dispatch/capacity buffer dims (EP-only)
AXIS_LORA = "lora"            # MLA low-rank bottleneck dims
AXIS_CONV = "conv"            # conv kernel dims (mamba, vit patch)
AXIS_SSM = "ssm"              # ssm state / head dims


@dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/logical-sharding metadata for one parameter tensor."""

    shape: tuple[int, ...]
    dtype: str = "bfloat16"
    axes: tuple[Optional[str], ...] = ()
    init: str = "normal"          # "normal" | "zeros" | "ones" | "embed" | "ssm_a" | "dt_bias"
    init_scale: float = 1.0       # stddev multiplier (normal) / fan-in handled by caller

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytes_per_elem(self) -> int:
        return dtype_bytes(self.dtype)

    @property
    def nbytes(self) -> int:
        return self.size * self.bytes_per_elem


def dtype_bytes(dtype: str) -> int:
    return {
        "float64": 8, "int64": 8,
        "float32": 4, "int32": 4, "uint32": 4,
        "bfloat16": 2, "float16": 2, "int16": 2,
        "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "bool": 1,
    }[str(dtype)]


@dataclass(frozen=True)
class ActTerm:
    """One analytically-modelled activation tensor saved for backward.

    ``shape_fn(batch, seq) -> tuple`` gives the *global* (unsharded) shape;
    ``axes`` name each dim so the sharding model can divide by the mesh.
    """

    name: str
    shape: tuple[Any, ...]          # entries: int or "B" (batch) or "S" (seq) or "T" (enc seq)
    dtype: str = "bfloat16"
    axes: tuple[Optional[str], ...] = ()

    def concrete_shape(self, batch: int, seq: int, enc_seq: int = 0) -> tuple[int, ...]:
        out = []
        for d in self.shape:
            if d == "B":
                out.append(batch)
            elif d == "S":
                out.append(seq)
            elif d == "T":
                out.append(enc_seq)
            else:
                out.append(int(d))
        return tuple(out)


@dataclass
class LayerSpec:
    """A fine-grained layer (paper workflow step 4): nn.Linear-granularity.

    ``acts`` lists the activation tensors this layer must keep live for its
    backward pass *when no remat is applied*; the predictor combines them
    with the remat policy.  ``flops_per_token`` is used by the roofline
    napkin-math helpers (2*m*n*k counted once; fwd+bwd multipliers applied
    by the caller).
    """

    name: str
    kind: str                                   # "linear" | "embedding" | ...
    params: dict[str, ParamSpec] = field(default_factory=dict)
    acts: list[ActTerm] = field(default_factory=list)
    flops_per_token: float = 0.0                # forward MACs*2, per (global) token
    meta: dict[str, Any] = field(default_factory=dict)

    @property
    def param_count(self) -> int:
        return sum(p.size for p in self.params.values())

    @property
    def param_bytes(self) -> int:
        return sum(p.nbytes for p in self.params.values())


@dataclass
class ModuleSpec:
    """A modality-level module (paper workflow step 2): vision encoder,
    projector, language decoder, ...  ``repeat`` marks scan-stacked
    homogeneous blocks: the contained layers' params acquire a leading
    ``layers`` axis of that size and the activation/FLOP terms multiply.
    """

    name: str
    modality: str = "text"                      # "vision"|"text"|"audio"|"shared"
    layers: list[LayerSpec] = field(default_factory=list)
    children: list["ModuleSpec"] = field(default_factory=list)
    repeat: int = 1
    scanned: bool = False       # force a leading stack dim even when repeat==1

    # -- traversal ----------------------------------------------------------
    def walk(self, prefix: str = "", repeat: int = 1) -> Iterator[tuple[str, "ModuleSpec", int]]:
        """Yield (path, module, effective_repeat) depth-first."""
        path = f"{prefix}/{self.name}" if prefix else self.name
        eff = repeat * self.repeat
        yield path, self, eff
        for child in self.children:
            yield from child.walk(path, eff)

    def iter_layers(self) -> Iterator[tuple[str, LayerSpec, int]]:
        """Yield (layer_path, layer, effective_repeat) for every leaf layer."""
        for path, mod, eff in self.walk():
            for layer in mod.layers:
                yield f"{path}/{layer.name}", layer, eff

    # -- aggregates ----------------------------------------------------------
    @property
    def param_count(self) -> int:
        return sum(l.param_count * rep for _, l, rep in self.iter_layers())

    @property
    def param_bytes(self) -> int:
        return sum(l.param_bytes * rep for _, l, rep in self.iter_layers())

    def find(self, name: str) -> "ModuleSpec":
        for path, mod, _ in self.walk():
            if mod.name == name or path == name:
                return mod
        raise KeyError(name)


# ---------------------------------------------------------------------------
# Training behaviour (the paper's central multimodal concern): which modules
# are trainable.  LLaVA stage-1 trains only the projector; stage-2 trains
# projector + language model with the vision tower frozen.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrainPolicy:
    """Maps module paths to trainable-ness.

    ``trainable_patterns`` are substring matches against the module path
    (e.g. ``("projector", "language_model")``).  An empty tuple with
    ``default_trainable=True`` trains everything (the unimodal case).
    """

    name: str = "full"
    trainable_patterns: tuple[str, ...] = ()
    default_trainable: bool = True

    def is_trainable(self, path: str) -> bool:
        if not self.trainable_patterns:
            return self.default_trainable
        return any(pat in path for pat in self.trainable_patterns)


FULL_TRAIN = TrainPolicy(name="full")
LLAVA_STAGE1 = TrainPolicy(name="llava_stage1",
                           trainable_patterns=("projector",),
                           default_trainable=False)
LLAVA_STAGE2 = TrainPolicy(name="llava_stage2",
                           trainable_patterns=("projector", "language_model"),
                           default_trainable=False)


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def from_reference(d: dict) -> ModuleSpec:
    """Rebuild a spec tree from ``dataclasses.asdict(...)`` of a
    ModuleSpec tree built elsewhere (plain dicts, lists and tuples) —
    the carrier that lets a test pin a difference between two
    implementations to the spec layer or to what consumes it."""
    def param(p: dict) -> ParamSpec:
        return ParamSpec(shape=tuple(p["shape"]), dtype=p["dtype"],
                         axes=tuple(p["axes"]), init=p["init"],
                         init_scale=p["init_scale"])

    def act(a: dict) -> ActTerm:
        return ActTerm(name=a["name"], shape=tuple(a["shape"]),
                       dtype=a["dtype"], axes=tuple(a["axes"]))

    def layer(l: dict) -> LayerSpec:
        meta = dict(l["meta"])
        # asdict flattened the config objects the spec functions put into
        # meta (an MLA layer's MLAConfig, read by attribute downstream)
        if isinstance(meta.get("mla"), dict):
            from repro_torch.configs import MLAConfig
            meta["mla"] = MLAConfig(**meta["mla"])
        return LayerSpec(
            name=l["name"], kind=l["kind"],
            params={k: param(p) for k, p in l["params"].items()},
            acts=[act(a) for a in l["acts"]],
            flops_per_token=l["flops_per_token"], meta=meta)

    return ModuleSpec(
        name=d["name"], modality=d["modality"],
        layers=[layer(l) for l in d["layers"]],
        children=[from_reference(c) for c in d["children"]],
        repeat=d["repeat"], scanned=d["scanned"])
