"""Model parser (paper workflow steps 1-4).

Decomposes a model into modality-level modules and fine-grained layers,
annotating each layer with its training behaviour (trainable / frozen) and
its scan-stack repeat count.  Because every model in this framework is
*constructed from* the same ModuleSpec tree, parsing is exact — there is no
reflection gap between what the predictor sees and what runs.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.spec import LayerSpec, ModuleSpec, TrainPolicy


@dataclass(frozen=True)
class ParsedLayer:
    """One row of the parse table: a fine-grained layer in context."""

    path: str                  # e.g. "vlm/language_model/blocks/attn"
    module_path: str           # owning module, e.g. "vlm/language_model/blocks"
    modality: str
    layer: LayerSpec
    repeat: int                # scan-stack multiplicity
    scanned: bool              # True => params carry a leading layers axis
    trainable: bool


def parse_model(spec: ModuleSpec, policy: TrainPolicy) -> list[ParsedLayer]:
    rows: list[ParsedLayer] = []

    def visit(mod: ModuleSpec, prefix: str, repeat: int, scanned: bool):
        path = f"{prefix}/{mod.name}" if prefix else mod.name
        scanned = scanned or mod.repeat > 1 or mod.scanned
        repeat = repeat * mod.repeat
        trainable = policy.is_trainable(path)
        for layer in mod.layers:
            rows.append(ParsedLayer(
                path=f"{path}/{layer.name}", module_path=path,
                modality=mod.modality, layer=layer, repeat=repeat,
                scanned=scanned, trainable=trainable))
        for child in mod.children:
            visit(child, path, repeat, scanned)

    visit(spec, "", 1, False)
    return rows


def modules_of(rows: list[ParsedLayer]) -> dict[str, list[ParsedLayer]]:
    """Group the parse table by owning module (paper workflow step 2)."""
    out: dict[str, list[ParsedLayer]] = {}
    for r in rows:
        out.setdefault(r.module_path, []).append(r)
    return out


def total_params(rows: list[ParsedLayer], trainable_only: bool = False) -> int:
    return sum(r.layer.param_count * r.repeat for r in rows
               if r.trainable or not trainable_only)


def active_params(rows: list[ParsedLayer]) -> int:
    """MoE-aware 'active per token' parameter count (for MODEL_FLOPS)."""
    total = 0
    for r in rows:
        if r.layer.kind == "moe":
            m = r.layer.meta
            act_frac = (m["top_k"] + m["n_shared_experts"]) / max(
                m["n_experts"] + m["n_shared_experts"], 1)
            routed = sum(p.size for n, p in r.layer.params.items()
                         if n in ("wg", "wu", "wd"))
            rest = r.layer.param_count - routed
            frac_routed = routed * (m["top_k"] / max(m["n_experts"], 1))
            total += int((rest + frac_routed) * r.repeat)
        else:
            total += r.layer.param_count * r.repeat
    return total
