"""The measurement artifact: one real train, prefill or decode step on the
card, written as a dry-run-schema record.

The counterpart of the reference's ``launch/dryrun.py`` (``lower_cell`` /
``run_cell``), which compiles a cell for the TPU mesh on the CPU oracle and
records XLA's memory analysis beside the byte model's prediction.  Here
the cell runs for real on one CUDA device and the ground truth is the
caching allocator's (``core.device_metrics``): the record keeps the
dry-run schema (``memory{argument_bytes, output_bytes, temp_bytes,
alias_bytes, total_bytes}``, the same ``predicted{...}`` block) so
``calibrate.Measurement.from_dryrun_record`` and
``autopilot.watch.observed_bytes`` ingest it unchanged, and it carries its
own cell (``seq_len``, ``global_batch``, ``backend``, ``chip``,
``optimizer``, ``remat``, ``policy``, ``grad_accum``), since no card shape
is one of the reference's ``SHAPES``.

    python -m repro_torch.launch.measure                 # every GRID cell
    python -m repro_torch.launch.measure --arch llava15-7b --out DIR

writes ``<arch>__<shape>__1x1.json`` per cell into ``--out`` (default
``experiments/measured``) and the cells' :class:`MeasurementStore` beside
them.  The steps run on the card; without one the CLI exits 2.

The prediction goes through ``planner.make_context`` on a 1 x 1 mesh with
the ``tpu`` term set and the ``h100`` chip (:func:`context_for`) — the
path ``calibrate.residual`` rebuilds the cell by, so a record and its
ingest cannot disagree.

A record of a counted cell (:func:`counted_cells`: the first of each
arch x kind x sequence length x policy x remat) also carries the reference's ``cost``,
``collectives`` and ``loop_aware`` blocks (``core.device_metrics.
cost_blocks``: dot FLOPs, bytes accessed and collectives of one step,
counted by a ``StepCounter`` over one more step of the cell, run once no
later cell reads its state, so that the counter's host work reaches
neither the allocator's readings nor the time, and its update no other
cell's state); every record carries ``step_s``: the wall time of a warm step with no counter
active, from CUDA events recorded around it (a train cell's second
step; a serving cell's step after its measured one).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch

MESH = {"data": 1, "model": 1}
BACKEND = "tpu"
CHIP = "h100"
SEED = 20260811
TRAIN_STEPS = 2


@dataclass(frozen=True)
class MeasureCell:
    """One measured configuration on one card.  ``optimizer`` / ``remat``
    are a train cell's (None on a serving cell: the arch's default, which
    a serving prediction does not read)."""

    arch: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int
    policy: str = "full"           # key into core.sweep.POLICIES
    optimizer: Optional[str] = None
    remat: Optional[str] = None

    @property
    def shape(self) -> str:
        """The record's ``shape`` name, unique within an arch."""
        name = f"{self.kind}_b{self.global_batch}_s{self.seq_len}"
        if self.kind == "train":
            name += f"_{self.policy}_{self.optimizer}_{self.remat}"
        return name


def _train(arch, seq, batches, policy, optimizer, remat="block"):
    return [MeasureCell(arch, "train", seq, b, policy, optimizer, remat)
            for b in batches]


def _serve(arch, kind, seq, batches):
    return [MeasureCell(arch, kind, seq, b) for b in batches]


# Every cell at full published width and depth on one card, admitted when
# the byte model predicts <= 60 GiB (1.25x headroom against the 1.207x of
# ROADMAP C7 inside 80 GB).  Cells of one arch and train state follow each
# other, so a run makes each arch's parameters once per state.
GRID: list[MeasureCell] = (
    # the paper's fig2b (S 2,048 = 576 image + 1,472 text) and fig2a
    # (S 1,024) settings at one data-parallel rank
    _train("llava15-7b", 2048, (1, 2, 4, 8), "llava_stage1", "adamw")
    + _train("llava15-7b", 1024, (4, 8, 16), "llava_stage1", "adamw")
    + _train("llava15-7b", 2048, (1, 2), "llava_stage1", "adamw", "none")
    + _train("llava15-7b", 2048, (1, 4, 8), "llava_stage2", "adafactor")
    + _train("llava15-7b", 1024, (16,), "llava_stage2", "adafactor")
    + _serve("llava15-7b", "prefill", 1088, (1, 4, 8))
    + _serve("llava15-7b", "decode", 4096, (4, 16))
    + _train("llava-next-mistral-7b", 2048, (4, 8), "llava_stage1", "adamw")
    + _serve("llava-next-mistral-7b", "prefill", 2048, (4,))
    + _serve("llava-next-mistral-7b", "decode", 4096, (16,))
    + _train("seamless-m4t-large-v2", 1024, (4, 8), "full", "adamw")
    + _train("seamless-m4t-large-v2", 2048, (2, 4), "full", "adamw")
    + _serve("seamless-m4t-large-v2", "prefill", 2048, (4, 8))
    + _serve("seamless-m4t-large-v2", "decode", 2048, (8, 32))
    + _serve("mamba2-1.3b", "prefill", 2000, (4,))
    + _serve("mamba2-1.3b", "prefill", 4096, (4,))
    + _serve("mamba2-1.3b", "decode", 4096, (4, 32))
    # the SSM's training (the chunked SSD in plain tensor ops), <= 32.7 GiB
    + _train("mamba2-1.3b", 2048, (1, 4, 8), "full", "adamw")
    + _train("mamba2-1.3b", 4096, (4,), "full", "adamw")
    + _train("mamba2-1.3b", 2048, (2,), "full", "adamw", "none")
    + _train("llama3.2-3b", 2048, (1, 2), "full", "adamw")
    + _train("smollm-360m", 2048, (8, 32), "full", "adamw")
    + _train("llama3.1-8b", 2048, (2,), "full", "adafactor")
    # the MLA archs: deepseek-v2-lite-16b (MLA + 64 experts top-6) serves
    # (its training, 89.38 GiB at 1 x 2,048 under Adafactor, does not fit
    # one card); minicpm3-4b serves and trains under Adafactor (AdamW is
    # 70.79 GiB at 1 x 2,048)
    + _serve("deepseek-v2-lite-16b", "prefill", 2048, (4,))
    + _serve("deepseek-v2-lite-16b", "decode", 4096, (16,))
    + _serve("minicpm3-4b", "prefill", 2048, (4,))
    + _serve("minicpm3-4b", "decode", 4096, (16,))
    + _train("minicpm3-4b", 2048, (4, 8), "full", "adafactor")
    # the hybrid zamba2-2.7b: serving, its long-context decode (the arch's
    # 524,288 positions at batch 1, 54.90 GiB predicted), and training
    # under AdamW (8 x 2,048 is 65.71 GiB: Adafactor there; remat "none"
    # passes the rule at 2 x 2,048 but the eager SSD read 1.720x the byte
    # model under it, ~100 GiB)
    + _serve("zamba2-2.7b", "prefill", 2048, (4,))
    + _serve("zamba2-2.7b", "decode", 4096, (16,))
    + _serve("zamba2-2.7b", "decode", 524288, (1,))
    + _train("zamba2-2.7b", 2048, (1, 4), "full", "adamw")
    + _train("zamba2-2.7b", 2048, (8,), "full", "adafactor"))


def context_for(cell: MeasureCell):
    """The cell's PredictContext, through ``planner.make_context`` (the
    path ``calibrate.residual._context_for`` takes)."""
    from repro_torch.configs import get_config
    from repro_torch.core import planner as PL
    return PL.make_context(get_config(cell.arch), MESH, kind=cell.kind,
                           global_batch=cell.global_batch,
                           seq_len=cell.seq_len, backend=BACKEND,
                           remat=cell.remat, optimizer=cell.optimizer)


def predict(cell: MeasureCell):
    """The byte model's prediction for the cell (host only)."""
    from repro_torch.configs import get_config
    from repro_torch.core import predictor as PR
    from repro_torch.core.sweep import POLICIES
    from repro_torch.models import build_model
    return PR.predict(build_model(get_config(cell.arch)),
                      POLICIES[cell.policy], context_for(cell), chip=CHIP)


def card_identity() -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    name, power = (s.strip() for s in out.rsplit(",", 1))
    return {"name": name, "power_limit": power}


def record_for(cell: MeasureCell, stats, device: dict, counter,
               step_s: float) -> dict:
    """The dry-run-schema record of one measured cell (host only):
    ``stats`` a ``device_metrics.StepMemory``, ``device`` the card's
    :func:`card_identity`, ``counter`` a ``device_metrics.StepCounter``
    of one step of the cell (the ``cost``, ``collectives`` and
    ``loop_aware`` blocks), or None for a cell :func:`counted_cells`
    does not count (the record goes without them), and ``step_s`` the
    time of a step."""
    from repro_torch.core import device_metrics as DM
    mem = stats.stats
    pred = predict(cell)
    return {
        "arch": cell.arch, "shape": cell.shape, "kind": cell.kind,
        "mesh": "x".join(str(v) for v in MESH.values()),
        "mesh_shape": dict(MESH), "n_devices": 1,
        "memory": {"argument_bytes": mem.argument_bytes,
                   "output_bytes": mem.output_bytes,
                   "temp_bytes": mem.temp_bytes,
                   "alias_bytes": mem.alias_bytes,
                   "total_bytes": mem.total_bytes},
        "allocator": {"baseline_bytes": stats.baseline_bytes,
                      "start_bytes": stats.start_bytes,
                      "end_bytes": stats.end_bytes,
                      "peak_bytes": stats.peak_bytes,
                      "max_reserved_bytes": stats.max_reserved_bytes,
                      "reserved_over_allocated":
                          stats.reserved_over_allocated,
                      "alloc_retries": stats.alloc_retries},
        "predicted": {
            "param_bytes": pred.param_bytes,
            "grad_bytes": pred.grad_bytes,
            "opt_bytes": pred.opt_bytes,
            "act_saved_bytes": pred.act_saved_bytes,
            "act_transient_bytes": pred.act_transient_bytes,
            "loss_bytes": pred.loss_bytes,
            "input_bytes": pred.input_bytes,
            "cache_bytes": pred.cache_bytes,
            "peak_bytes": pred.peak_bytes,
        },
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
        "backend": BACKEND, "chip": CHIP, "optimizer": cell.optimizer,
        "remat": cell.remat, "policy": cell.policy, "grad_accum": 1,
        "device": dict(device),
        **(DM.cost_blocks(counter) if counter is not None else {}),
        "step_s": step_s,
    }


# ---------------------------------------------------------------------------
# the step of a cell
# ---------------------------------------------------------------------------


def make_state(cell: MeasureCell, model, generator: torch.Generator,
               device):
    """What the cell's step reads besides its inputs: the train state
    (parameters and optimizer state, the policy's leaves trainable) for a
    train cell, the parameters for a serving cell."""
    if cell.kind != "train":
        return model.init(generator, device)
    from repro_torch.core.sweep import POLICIES
    from repro_torch.train import OptimizerConfig, init_train_state
    return init_train_state(model, POLICIES[cell.policy],
                            OptimizerConfig(name=cell.optimizer), generator,
                            device)


def make_batch(model, cell: MeasureCell, generator: torch.Generator) -> dict:
    """Random inputs of the model's ``batch_spec`` for the cell: token ids
    uniform over the vocabulary, embeddings normal x 0.3 in their type."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models.param import TORCH_DTYPES
    dev = generator.device
    out = {}
    for name, sd in model.batch_spec(ShapeConfig(
            cell.shape, cell.seq_len, cell.global_batch,
            cell.kind)).items():
        if sd.dtype == "int32":
            out[name] = torch.randint(0, model.cfg.vocab, sd.shape,
                                      generator=generator, device=dev,
                                      dtype=torch.int32)
        else:
            out[name] = (torch.randn(sd.shape, generator=generator,
                                     device=dev) * 0.3) \
                .to(TORCH_DTYPES[sd.dtype])
    return out


class StepTimer:
    """The wall time of a step, from two CUDA events recorded around it
    on the current stream (they allocate nothing)."""

    def __init__(self):
        self.begin = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def seconds(self) -> float:
        self.end.synchronize()
        return self.begin.elapsed_time(self.end) / 1e3


def cell_step(cell: MeasureCell, model, state, generator: torch.Generator,
              steps: int = TRAIN_STEPS, timer: Optional[StepTimer] = None
              ) -> Callable[[], dict]:
    """The cell's inputs, made now on the generator's device, and a closure
    that runs its step once and returns its outputs (``timer``, where
    given, records around the last step):

    * train: ``steps`` steps of ``make_train_step`` -> ``{"loss":
      [...], "state": ...}``;
    * prefill: one ``make_prefill_step`` -> ``{"logits", "cache"}``;
    * decode: a zeroed cache of ``seq_len`` positions with ``len =
      seq_len - 1`` and one ``make_decode_step`` -> ``{"token", "logits",
      "cache"}``."""
    from repro_torch.serve import make_decode_step, make_prefill_step
    if cell.kind == "train":
        from repro_torch.core.sweep import POLICIES
        from repro_torch.train import OptimizerConfig, make_train_step
        batch = make_batch(model, cell, generator)
        step = make_train_step(model, POLICIES[cell.policy],
                               OptimizerConfig(name=cell.optimizer),
                               remat=cell.remat)

        def run():
            st, losses = state, []
            for i in range(steps):
                if timer is not None and i == steps - 1:
                    timer.begin.record()
                st, metrics = step(st, batch)
                losses.append(metrics["loss"])
            if timer is not None:
                timer.end.record()
            return {"loss": [float(x) for x in losses], "state": st}
        return run
    if cell.kind == "prefill":
        batch = make_batch(model, cell, generator)
        prefill = make_prefill_step(model)

        def run():
            if timer is not None:
                timer.begin.record()
            logits, cache = prefill(state, batch)
            if timer is not None:
                timer.end.record()
            return {"logits": logits, "cache": cache}
        return run
    B, S = cell.global_batch, cell.seq_len
    cache = model.init_cache(B, S, generator.device)
    cache["len"].fill_(S - 1)
    token = torch.randint(0, model.cfg.vocab, (B, 1), generator=generator,
                          device=generator.device, dtype=torch.int32)
    decode = make_decode_step(model)

    def run():
        if timer is not None:
            timer.begin.record()
        tok, logits, new_cache = decode(state, token, cache)
        if timer is not None:
            timer.end.record()
        return {"token": tok, "logits": logits, "cache": new_cache}
    return run


def check_outputs(cell: MeasureCell, model, out: dict) -> None:
    """Finite outputs of the expected shape, else ValueError."""
    if cell.kind == "train":
        if not all(torch.isfinite(torch.tensor(out["loss"]))):
            raise ValueError(f"{cell}: loss {out['loss']} not finite")
        return
    logits = out["logits"]
    want = (cell.global_batch, 1, model.cfg.vocab)
    if tuple(logits.shape) != want or not bool(
            torch.isfinite(logits).all()):
        raise ValueError(f"{cell}: logits {tuple(logits.shape)} (want "
                         f"{want}) not finite / shaped")


@dataclass
class CellRun:
    """A measured cell and what a following cell of the same arch and
    train state may reuse (``state``, ``baseline``, ``resident``)."""

    cell: MeasureCell
    memory: object                 # device_metrics.StepMemory
    outputs: dict                  # losses, or logits shape
    state: object
    baseline: int
    resident: int
    step_s: float                  # a warm step, no counter active


def same_state(a: MeasureCell, b: MeasureCell) -> bool:
    return (a.arch, a.kind == "train", a.policy, a.optimizer) \
        == (b.arch, b.kind == "train", b.policy, b.optimizer)


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a cell's step is measured on a CUDA device, "
                           f"not {dev}")
    return dev


def _generator(dev) -> torch.Generator:
    generator = torch.Generator(device=dev)
    generator.manual_seed(SEED)
    return generator


def run_cell(cell: MeasureCell, reuse: Optional[CellRun] = None,
             device="cuda") -> CellRun:
    """One cell on the card: its state made (or ``reuse``'s, a run of a
    cell of the same arch and train state), its inputs, its step under
    ``device_metrics.memory_stats``, all under ``mesh_context(MESH)`` as
    the reference's dry run lowers a cell under its mesh (only an MoE
    forward reads it: it takes the expert-parallel path).  ``baseline``
    is read before the state is made; on reuse, the allocator must read
    exactly what it read once the state was made (``resident``), so the
    baseline still holds.  ``step_s`` times a train cell's second step;
    a serving cell's measured step is its first, cold (the cuBLAS
    workspaces, new segments), so a second one is run and timed.
    Raises off the card."""
    from repro_torch.configs import get_config
    from repro_torch.core import device_metrics as DM
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import build_model
    dev = _card(device)
    if reuse is not None and not same_state(reuse.cell, cell):
        raise ValueError(f"{cell.shape} of {cell.arch} cannot reuse the "
                         f"state of {reuse.cell}")
    model = build_model(get_config(cell.arch))
    generator = _generator(dev)
    gc.collect()
    # the cuBLAS workspaces, kept by the allocator once a matmul ran, are
    # freed so that every cell's step allocates its own within the step
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    if reuse is not None:
        state, baseline, resident = reuse.state, reuse.baseline, \
            reuse.resident
        now = DM.allocated_bytes(dev)
        if now != resident:
            raise RuntimeError(
                f"{cell.arch}: {now} B allocated at {cell.shape}, "
                f"{resident} B with the reused state alone: a cell left "
                f"memory behind")
    else:
        baseline = DM.allocated_bytes(dev)
        state = make_state(cell, model, generator, dev)
        resident = DM.allocated_bytes(dev)
    timer = StepTimer()
    train = cell.kind == "train"
    with mesh_context(MESH):
        run = cell_step(cell, model, state, generator,
                        timer=timer if train else None)
        memory, out = DM.memory_stats(run, baseline, dev)
    check_outputs(cell, model, out)
    outputs = {"loss": out["loss"]} if train else {
        "logits_shape": list(out["logits"].shape)}
    del run, out
    gc.collect()
    if not train:
        with mesh_context(MESH):
            run = cell_step(cell, model, state, generator, timer=timer)
            out = run()
        del run, out
    return CellRun(cell=cell, memory=memory, outputs=outputs, state=state,
                   baseline=baseline, resident=resident,
                   step_s=timer.seconds())


def count_cell(cell: MeasureCell, state, device="cuda"):
    """One more step of ``cell`` on ``state`` under a ``device_metrics.
    StepCounter`` -> the counter.  A train step updates ``state``: count
    once no cell still to be measured reads it."""
    from repro_torch.configs import get_config
    from repro_torch.core import device_metrics as DM
    from repro_torch.mesh_ctx import mesh_context
    from repro_torch.models import build_model
    dev = _card(device)
    model = build_model(get_config(cell.arch))
    with mesh_context(MESH):
        run = cell_step(cell, model, state, _generator(dev), steps=1)
        counter, out = DM.count_step(run)
    torch.cuda.synchronize(dev)
    del run, out
    return counter


def counted_cells(cells) -> set:
    """The cells whose step :func:`measure_grid` counts: the first of each
    (arch, kind, sequence length, policy, remat) class in ``cells``.  Its
    cells differ only in batch (and a train cell's optimizer, which adds
    no dot product), so the first stands for its class's dot FLOPs per
    token; the policy (which parts train) and remat (a recomputed forward)
    change them.  A counted step costs the host seconds: one per cell
    passed phase 8 of ``chip_smoke.py`` into its time limit's last
    minute."""
    seen, out = set(), set()
    for c in cells:
        key = (c.arch, c.kind, c.seq_len, c.policy, c.remat)
        if key not in seen:
            seen.add(key)
            out.add(c)
    return out


def measure_grid(cells, device="cuda", on_record=None) -> list[dict]:
    """Every cell in order on the card; a cell reuses the state of the one
    before it where they share arch and train state (any other state is
    released before the next is made).  Once the last cell of a state is
    measured, the step of each of its :func:`counted_cells` is counted on
    it (:func:`count_cell`) and their records made, in order.  Returns the
    records; ``on_record(record)`` is called as each is made."""
    ident = card_identity()
    records, group = [], []
    counted = counted_cells(cells)

    def close_group():
        for run in group:
            counter = count_cell(run.cell, run.state, device) \
                if run.cell in counted else None
            rec = record_for(run.cell, run.memory, ident, counter,
                             run.step_s)
            rec["outputs"] = run.outputs
            records.append(rec)
            if on_record is not None:
                on_record(rec)
        group.clear()

    for cell in cells:
        if group and not same_state(group[-1].cell, cell):
            close_group()
        group.append(run_cell(cell, group[-1] if group else None, device))
    close_group()
    gc.collect()
    torch.cuda.empty_cache()
    return records


def store_of(records: list[dict]):
    """The records as a ``MeasurementStore`` (each through
    ``Measurement.from_dryrun_record``)."""
    from repro_torch.calibrate.measurements import (Measurement,
                                                    MeasurementStore)
    return MeasurementStore([Measurement.from_dryrun_record(
        r, source=f"{r['arch']}__{r['shape']}__{r['mesh']}.json")
        for r in records])


def store_name(device: dict) -> str:
    """``h100_80gb_hbm3_700w``: the card's name and power limit."""
    name = device["name"].lower().replace("nvidia", "").strip()
    watts = int(float(device["power_limit"].split()[0]))
    return "_".join(name.split()) + f"_{watts}w"


FAMILY_NAMES = {"vlm": "VLM", "encdec": "enc-dec", "ssm": "SSM",
                "dense": "dense", "moe": "MoE", "hybrid": "hybrid"}


def summary(store, engine=None) -> dict:
    """The predictor's error on measured cells (host only): per arch x kind,
    per family, over the multimodal training cells and over all cells,
    the MAPE of the raw prediction under the ``tpu`` and the ``cpu`` term
    sets, of the prediction calibrated by a profile that
    ``calibrate.fit_profile`` fits on the even-indexed cells (sorted by
    ``Measurement.key``) and evaluates on the odd ones (held out), and of
    a profile fitted on every cell (in sample, a reading); and the worst
    raw cell's measured / predicted ratio."""
    import dataclasses
    from repro_torch.calibrate.fit import fit_profile
    from repro_torch.calibrate.measurements import MeasurementStore
    from repro_torch.calibrate.residual import predict_measurement
    from repro_torch.configs import get_config
    from repro_torch.core import report as RPT
    from repro_torch.core.sweep import SweepEngine
    engine = engine or SweepEngine()
    ms = sorted(store, key=lambda m: m.key)
    held_profile = fit_profile(MeasurementStore(ms[0::2]), engine)
    all_profile = fit_profile(MeasurementStore(ms), engine)
    cells = []
    for i, m in enumerate(ms):
        def peak(m=m, **kw):
            return predict_measurement(m, engine, **kw).peak_bytes
        cells.append({
            "label": str(m.key), "arch": m.arch, "kind": m.kind,
            "family": get_config(m.arch).family,
            "measured": m.measured_bytes, "raw_tpu": peak(),
            "raw_cpu": peak(dataclasses.replace(m, backend="cpu")),
            "held_out": peak(profile=held_profile) if i % 2 else None,
            "in_sample": peak(profile=all_profile)})

    def records(key: str, cs: list) -> list:
        return [RPT.PredictionRecord(c["label"], c[key], c["measured"])
                for c in cs]

    def row(group: str, sel: list) -> dict:
        held = [c for c in sel if c["held_out"] is not None]
        raw, _ = RPT.split_valid(records("raw_tpu", sel))
        worst = max(raw, key=lambda r: r.ape)
        return {"group": group, "cells": len(sel),
                "mape_raw_tpu": RPT.mape(raw),
                "mape_raw_cpu": RPT.mape(records("raw_cpu", sel)),
                "held_out_cells": len(held),
                "mape_held_out": RPT.mape(records("held_out", held))
                if held else None,
                "mape_in_sample": RPT.mape(records("in_sample", sel)),
                "worst_measured_over_predicted":
                    worst.actual_bytes / worst.predicted_bytes}
    rows = [row(f"{a} {k}", [c for c in cells
                              if (c["arch"], c["kind"]) == (a, k)])
            for a, k in sorted({(c["arch"], c["kind"]) for c in cells})]
    rows += [row(FAMILY_NAMES[f], [c for c in cells if c["family"] == f])
             for f in FAMILY_NAMES if any(c["family"] == f for c in cells)]
    multimodal = [c for c in cells if c["kind"] == "train"
                  and c["family"] in ("vlm", "encdec")]
    if multimodal:
        rows.append(row("all multimodal training cells", multimodal))
    rows.append(row("all cells", cells))
    return {"cells": len(cells),
            "held_out_profile": held_profile.to_dict(),
            "in_sample_profile": all_profile.to_dict(),
            "rows": rows}


def main(argv=None) -> int:
    from repro_torch.calibrate.paths import measured_dir
    ap = argparse.ArgumentParser(
        description="Measure GRID cells on the card: one real step each, "
                    "written as dry-run-schema records.")
    ap.add_argument("--arch", action="append", default=None,
                    help="only this arch's cells (repeatable)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="output directory (default: experiments/measured)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device; the cells run on the card",
              file=sys.stderr)
        return 2
    cells = [c for c in GRID if args.arch is None or c.arch in args.arch]
    if not cells:
        ap.error(f"no GRID cell of {args.arch}")
    out = Path(args.out) if args.out else measured_dir()
    out.mkdir(parents=True, exist_ok=True)

    def write(rec):
        fn = out / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        fn.write_text(json.dumps(rec, indent=1) + "\n")
        gib = 1024 ** 3
        counted = (f" flops={rec['cost']['flops_per_device']:.4g} "
                   f"colls={rec['collectives']['counts']}"
                   if "cost" in rec else "")
        print(f"[measure] {rec['arch']} x {rec['shape']}: measured "
              f"{rec['memory']['total_bytes'] / gib:.2f} GiB, predicted "
              f"{rec['predicted']['peak_bytes'] / gib:.2f} GiB "
              f"step={rec['step_s']:.3f}s{counted}", flush=True)
    records = measure_grid(cells, on_record=write)
    path = store_of(records).save(out / f"{store_name(records[0]['device'])}"
                                        f".json")
    print(f"[measure] {len(records)} records, store {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
