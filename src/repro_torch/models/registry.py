"""Unified model interface over the architecture families.

``build_model(cfg)`` returns a :class:`Model` exposing:

* ``spec``                         — the ModuleSpec tree (core.parser)
* ``init(generator, device)``      — parameter tree on ``device``
* ``from_numpy(tree, device)``     — the reference's parameters, carried
  across bit for bit
* ``param_specs()`` / ``param_axes()`` — shape / dtype and logical axes
  per leaf, in the reference's nested layout (the sharding helpers')
* ``loss(params, batch, remat)``   — scalar loss + metrics (training)
* ``prefill(params, batch)``       — last-position logits + populated cache
* ``decode_step(params, token, cache)`` — one-token serve step
* ``init_cache(batch, max_len, device, enc_len=None)`` — zeroed cache
  (``enc_len``, the enc-dec family's encoder length, defaults to
  ``max_len`` as in the reference)
* ``batch_spec(shape)``            — shape/dtype records for every input

Every family's ``spec`` and ``batch_spec`` are here, so ``planner.check``
and the capacity sweep take all twelve archs, and every family has its
training loss and serving path: the decoder LMs on GQA or MLA attention,
dense or MoE (arctic-480b, deepseek-v2-lite-16b), the VLMs built on them,
the encoder-decoder (seamless-m4t-large-v2), the pure-SSM family (mamba2)
and the hybrid SSM + shared attention (zamba2).  An MoE model picks its
expert-parallel path under ``mesh_ctx.mesh_context`` and its dense path
without one, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import ArchConfig, ShapeConfig
from repro_torch.core.spec import ModuleSpec
from repro_torch.models import encdec as E
from repro_torch.models import hybrid as H
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

    def param_specs(self) -> dict:
        return PM.param_specs(self.spec)

    def param_axes(self) -> dict:
        return PM.param_axes(self.spec)

    def loss(self, params, batch: dict, remat=None):
        if self.cfg.family == "ssm":
            return S.ssm_loss(self.cfg, params, batch, remat=remat)
        if self.cfg.family == "hybrid":
            return H.hybrid_loss(self.cfg, params, batch, remat=remat)
        if self.cfg.family == "vlm":
            return V.vlm_loss(self.cfg, params, batch, remat=remat)
        if self.cfg.family == "encdec":
            return E.encdec_loss(self.cfg, params, batch, remat=remat)
        return T.lm_loss(self.cfg, params, batch["tokens"], batch["labels"],
                         remat=remat)

    def prefill(self, params, batch: dict):
        if self.cfg.family == "ssm":
            return S.ssm_prefill(self.cfg, params, batch)
        if self.cfg.family == "hybrid":
            return H.hybrid_prefill(self.cfg, params, batch)
        if self.cfg.family == "vlm":
            return V.vlm_prefill(self.cfg, params, batch)
        if self.cfg.family == "encdec":
            return E.encdec_prefill(self.cfg, params, batch)
        return T.lm_prefill(self.cfg, params, batch["tokens"])

    def decode_step(self, params, token, cache: dict):
        if self.cfg.family == "ssm":
            return S.ssm_decode_step(self.cfg, params, token, cache)
        if self.cfg.family == "hybrid":
            return H.hybrid_decode_step(self.cfg, params, token, cache)
        if self.cfg.family == "vlm":
            return V.vlm_decode_step(self.cfg, params, token, cache)
        if self.cfg.family == "encdec":
            return E.encdec_decode_step(self.cfg, params, token, cache)
        return T.lm_decode_step(self.cfg, params, token, cache)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   enc_len=None) -> dict:
        if self.cfg.family == "ssm":
            return S.ssm_init_cache(self.cfg, batch, max_len, device)
        if self.cfg.family == "hybrid":
            return H.hybrid_init_cache(self.cfg, batch, max_len, device)
        if self.cfg.family == "encdec":
            return E.encdec_init_cache(self.cfg, batch, max_len,
                                       enc_len or max_len, device)
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
        if cfg.family == "encdec":
            T_enc = int(S * cfg.encdec.enc_seq_ratio)
            batch = {"frames": ShapeDtype(
                        (B, T_enc, cfg.encdec.d_frontend), cfg.dtype),
                     "tokens": tok(B, S), "labels": tok(B, S)}
            if shape.kind == "prefill":
                batch.pop("labels")
            return batch
        batch = {"tokens": tok(B, S), "labels": tok(B, S)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return batch


def build_model(cfg: ArchConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return Model(cfg=cfg, spec=T.lm_spec(cfg))
    if fam == "vlm":
        return Model(cfg=cfg, spec=V.vlm_model_spec(cfg))
    if fam == "ssm":
        return Model(cfg=cfg, spec=S.ssm_model_spec(cfg))
    if fam == "hybrid":
        return Model(cfg=cfg, spec=H.hybrid_model_spec(cfg))
    if fam == "encdec":
        return Model(cfg=cfg, spec=E.encdec_model_spec(cfg))
    raise ValueError(f"unknown family {fam!r}")
