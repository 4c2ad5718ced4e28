"""Deterministic, shard-aware synthetic data pipeline — the reference's
``repro/data/pipeline.py``, numpy for numpy.

Every (step, host_shard) pair maps to a unique counter-based RNG stream, so

* restarts resume mid-epoch without replaying or skipping batches,
* elastic rescaling (different host count) re-partitions the SAME global
  batch sequence — shard s of S takes rows [s*B/S, (s+1)*B/S),
* straggler mitigation can hand a shard's range to another host and produce
  bit-identical data.

The generator is numpy-side (host memory), matching a real ingest pipeline:
``shard_batch`` and ``global_batch`` return numpy arrays, bit-equal to the
reference's for the same config, step and shard.  Moving them onto the
device (and placing them on a mesh) is the caller's job, as in the
launcher (``repro_torch.launch.train``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs import ArchConfig, ShapeConfig


def _rng(step: int, row0: int, tag: int) -> np.random.Generator:
    # Philox takes a 2-word (uint64) key: (tag | step, row0) — unique per
    # (step, shard-row-offset, stream tag).
    return np.random.Generator(
        np.random.Philox(key=[(tag << 48) | step, row0]))


@dataclass
class SyntheticPipeline:
    cfg: ArchConfig
    shape: ShapeConfig
    n_shards: int = 1
    shard_id: int = 0

    def _rows(self) -> tuple[int, int]:
        B = self.shape.global_batch
        per = B // self.n_shards
        return self.shard_id * per, per

    def shard_batch(self, step: int) -> dict:
        """Host-local rows of the global batch for `step` (numpy)."""
        row0, rows = self._rows()
        S = self.shape.seq_len
        cfg = self.cfg
        g = _rng(step, row0, tag=1)
        tokens = g.integers(0, cfg.vocab, (rows, S), dtype=np.int32)
        batch = {"tokens": tokens,
                 "labels": np.roll(tokens, -1, axis=1).astype(np.int32)}
        if cfg.family == "vlm":
            n_img = cfg.vlm.n_image_tokens
            s_text = max(S - n_img, 1)
            batch["tokens"] = batch["tokens"][:, :s_text]
            batch["labels"] = batch["labels"][:, :s_text]
            gi = _rng(step, row0, tag=2)
            if cfg.vlm.vision_tower:
                n_patch = (cfg.vlm.vit_image_size // cfg.vlm.vit_patch) ** 2
                batch["patches"] = gi.normal(
                    0, 0.5, (rows, n_patch, 3 * cfg.vlm.vit_patch ** 2)
                ).astype(np.float32)
            else:
                batch["patch_embeds"] = gi.normal(
                    0, 0.5, (rows, n_img, cfg.vlm.d_vision)).astype(np.float32)
        elif cfg.family == "encdec":
            gi = _rng(step, row0, tag=3)
            T_enc = int(S * cfg.encdec.enc_seq_ratio)
            batch["frames"] = gi.normal(
                0, 0.5, (rows, T_enc, cfg.encdec.d_frontend)
            ).astype(np.float32)
        return batch

    def global_batch(self, step: int) -> dict:
        """Assemble the full global batch (single-process convenience)."""
        saved = self.n_shards, self.shard_id
        try:
            parts = []
            for s in range(self.n_shards):
                self.shard_id = s
                parts.append(self.shard_batch(step))
            return {k: np.concatenate([p[k] for p in parts], axis=0)
                    for k in parts[0]}
        finally:
            self.n_shards, self.shard_id = saved
