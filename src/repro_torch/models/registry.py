"""Unified model interface over the architecture families.

``build_model(cfg)`` returns a :class:`Model` exposing:

* ``spec``                         — the ModuleSpec tree (core.parser)
* ``init(generator, device)``      — parameter tree on ``device``
* ``from_numpy(tree, device)``     — the reference's parameters, carried
  across bit for bit
* ``loss(params, batch, remat)``   — scalar loss + metrics (training)
* ``prefill(params, batch)``       — last-position logits + populated cache
* ``decode_step(params, token, cache)`` — one-token serve step
* ``init_cache(batch, max_len, device)`` — zeroed cache
* ``batch_spec(shape)``            — shape/dtype records for every input

The dense-GQA decoder LMs and the VLMs built on them are here: spec,
training loss and serving path.  The pure-SSM family (mamba2) has its
spec and serving path; its ``loss`` raises ``NotImplementedError`` until
its training is ported.  The MLA / MoE / hybrid / enc-dec families raise
``NotImplementedError`` until they are ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import param as PM
from repro_torch.models import ssm_lm as S
from repro_torch.models import transformer as T
from repro_torch.models import vlm as V


@dataclass(frozen=True)
class ShapeDtype:
    """Shape/dtype record of one model input (no array behind it)."""

    shape: tuple
    dtype: str


@dataclass
class Model:
    cfg: ArchConfig
    spec: ModuleSpec

    def init(self, generator: torch.Generator,
             device="cuda") -> PM.ModuleParams:
        return PM.init_params(self.spec, generator, device)

    def from_numpy(self, tree: dict, device="cuda") -> PM.ModuleParams:
        return PM.params_from_numpy(tree, device, self.spec)

    def loss(self, params, batch: dict, remat=None):
        if self.cfg.family == "ssm":
            raise NotImplementedError(
                f"{self.cfg.name}: the SSM family's training (ssm_loss, "
                f"ssm_backbone, mamba2_forward, ssd_chunked) is not ported "
                f"yet; it comes with the SSM training slice")
        if self.cfg.family == "vlm":
            return V.vlm_loss(self.cfg, params, batch, remat=remat)
        return T.lm_loss(self.cfg, params, batch["tokens"], batch["labels"],
                         remat=remat)

    def prefill(self, params, batch: dict):
        if self.cfg.family == "ssm":
            return S.ssm_prefill(self.cfg, params, batch)
        if self.cfg.family == "vlm":
            return V.vlm_prefill(self.cfg, params, batch)
        return T.lm_prefill(self.cfg, params, batch["tokens"])

    def decode_step(self, params, token, cache: dict):
        if self.cfg.family == "ssm":
            return S.ssm_decode_step(self.cfg, params, token, cache)
        if self.cfg.family == "vlm":
            return V.vlm_decode_step(self.cfg, params, token, cache)
        return T.lm_decode_step(self.cfg, params, token, cache)

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        if self.cfg.family == "ssm":
            return S.ssm_init_cache(self.cfg, batch, max_len, device)
        return T.init_kv_cache(self.cfg, batch, max_len, device)

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
        return Model(cfg=cfg, spec=V.vlm_model_spec(cfg))
    if fam == "ssm":
        return Model(cfg=cfg, spec=S.ssm_model_spec(cfg))
    if fam in ("moe", "hybrid", "encdec"):
        raise NotImplementedError(
            f"{cfg.name}: the {fam!r} family's spec functions are not ported "
            f"yet (supported: dense GQA decoders, VLMs and pure SSMs)")
    raise ValueError(f"unknown family {fam!r}")
