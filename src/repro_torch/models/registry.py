"""Unified model interface over the architecture families.

``build_model(cfg)`` returns a :class:`Model` exposing:

* ``spec``              — the ModuleSpec tree (consumed by core.parser)
* ``batch_spec(shape)`` — shape/dtype records for every input

Only the spec half is here: the dense-GQA decoder LMs and the VLMs built on
them.  The MLA / MoE / SSM / hybrid / enc-dec families raise
``NotImplementedError`` until their spec functions are ported; the runnable
half (init, loss, prefill, decode) arrives with the model zoo.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class ShapeDtype:
    """Shape/dtype record of one model input (no array behind it)."""

    shape: tuple
    dtype: str


@dataclass
class Model:
    cfg: ArchConfig
    spec: ModuleSpec

    def batch_spec(self, shape: ShapeConfig) -> dict:
        """Shape/dtype stand-ins for every model input of this shape."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        tok = lambda b, s: ShapeDtype((b, s), "int32")
        if shape.kind == "decode":
            return {"token": tok(B, 1)}
        if cfg.family == "vlm":
            n_img = cfg.vlm.n_image_tokens
            s_text = max(S - n_img, 1)
            batch = {"tokens": tok(B, s_text), "labels": tok(B, s_text)}
            if cfg.vlm.vision_tower:
                n_patch = (cfg.vlm.vit_image_size // cfg.vlm.vit_patch) ** 2
                batch["patches"] = ShapeDtype(
                    (B, n_patch, 3 * cfg.vlm.vit_patch ** 2), cfg.dtype)
            else:
                batch["patch_embeds"] = ShapeDtype(
                    (B, n_img, cfg.vlm.d_vision), cfg.dtype)
            if shape.kind == "prefill":
                batch.pop("labels")
            return batch
        batch = {"tokens": tok(B, S), "labels": tok(B, S)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch


def build_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam == "dense":
        return Model(cfg=cfg, spec=T.lm_spec(cfg))
    if fam == "vlm":
        from repro_torch.models import vlm as V
        return Model(cfg=cfg, spec=V.vlm_model_spec(cfg))
    if fam in ("moe", "ssm", "hybrid", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: the {fam!r} family's spec functions are not ported "
            f"yet (supported: dense GQA decoders and VLMs)")
    raise ValueError(f"unknown family {fam!r}")
