"""Checkpointing with async writes and retention.

Layout: ``<dir>/step_<N>/{meta.json, leaf_<i>.npy}`` — the reference's
(``repro/checkpoint/checkpointing.py``): each leaf is stored as its raw
bytes (a flat uint8 ``.npy``) with its dtype's name, shape and tree path
in ``meta.json``, so a bfloat16 leaf survives ``np.save``.  Writes go
through a background thread (training never blocks on IO) into a tmp dir
that is atomically renamed — a crash mid-write can never corrupt the
latest complete checkpoint.  ``keep`` bounds disk usage.

A tree is nested dicts, lists and tuples of leaves (tensors, numpy arrays,
Python scalars, ``None``), dataclasses of such (the train state), and
``nn.Module`` state (parameters and buffers, by name).  Paths are written
as the reference writes them for the same containers — ``['key']`` per
dict key (keys sorted), ``[i]`` per list index — so a checkpoint of a dict
of arrays written by either package restores in the other; a dataclass
field is ``.name`` and a module's parameter, buffer or child ``['name']``.

A restore builds the structure of ``like``: each leaf lands on the device
of ``like``'s leaf (the host where that is not a tensor), with the stored
dtype, and a shape that differs from ``like``'s raises.  A module is
restored in place, as ``load_state_dict`` does: its tensors are what an
optimizer and a train step hold.

``shardings`` (the reference's argument) re-shards a restore onto the
current mesh: a tree of ``mesh_ctx.Sharding``s of ``like``'s structure,
where a module of ``like`` has the reference's nested layout of its
parameters (``launch.mesh.param_shardings``).  A leaf with a sharding
comes back as a ``DTensor`` on it (a module's parameter is replaced by
one), each rank keeping its own elements of the whole leaf it read.  A
``DTensor`` leaf is saved whole (gathered on every rank; rank 0 writes),
and one restored without a sharding takes its own placements (a module's
parameter in place).  Either way the files are the one-device files, so
both packages read them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

TORCH_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float64, torch.float32, torch.bfloat16, torch.float16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def _children(node) -> Optional[list]:
    """(path component, child) of a container, in the order its leaves
    are numbered; None for a leaf."""
    if isinstance(node, nn.Module):
        named = {**{k: v for k, v in node._parameters.items()
                    if v is not None},
                 **{k: v for k, v in node._buffers.items() if v is not None},
                 **node._modules}
        return [(f"[{k!r}]", named[k]) for k in sorted(named)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, path: str = "") -> list:
    """(path, leaf) pairs of ``tree``, leaves ``None`` included."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, f"{path}/{key}" if path else key)
    return out


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _writes() -> bool:
    """Whether this process writes checkpoints (rank 0 of a world)."""
    import torch.distributed as dist
    return not _distributed() or dist.get_rank() == 0


def _to_host(leaf):
    """A leaf as (raw bytes uint8, dtype name, shape) on the host, copied
    (a later in-place update of the leaf cannot reach it); None stays.  A
    ``DTensor`` is gathered whole (every rank must take part)."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in TORCH_DTYPES:
            raise TypeError(f"checkpoint: a {t.dtype} leaf")
        return t.reshape(-1).view(torch.uint8).numpy(), name, list(t.shape)
    arr = np.asarray(leaf)
    return (np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.uint8),
            str(arr.dtype), list(arr.shape))


def _write(directory: str, step: int, flat: list,
           extra: Optional[dict]) -> str:
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "extra": extra or {}, "leaves": []}
    for i, (path, host) in enumerate(flat):
        if host is None:
            meta["leaves"].append({"path": path, "none": True})
            continue
        raw, dtype, shape = host
        name = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, name), raw)
        meta["leaves"].append({"path": path, "file": name, "dtype": dtype,
                               "shape": shape})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> Optional[str]:
    flat = [(p, _to_host(leaf)) for p, leaf in _flatten(tree)]
    return _write(directory, step, flat, extra) if _writes() else None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def _read(d: str, m: dict) -> torch.Tensor:
    if m["dtype"] not in TORCH_DTYPES:
        raise TypeError(f"checkpoint leaf {m['path']}: dtype {m['dtype']}")
    raw = np.load(os.path.join(d, m["file"]))
    return torch.from_numpy(raw).view(TORCH_DTYPES[m["dtype"]]) \
        .reshape(m["shape"])


def load_checkpoint(directory: str, step: int, like: Any,
                    shardings: Any = None) -> Any:
    """Restore into the structure of ``like``, each leaf with a sharding in
    ``shardings`` onto the current mesh (see the module's note)."""
    from repro_torch.mesh_ctx import place
    from repro_torch.models.param import sharding_of
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    by_path = {m["path"]: m for m in meta["leaves"]}

    def read(path: str, like_leaf, device=None):
        """The whole stored leaf, on ``like_leaf``'s device (or
        ``device``); None where the checkpoint holds none."""
        m = by_path.get(path)
        if m is None or m.get("none"):
            return None
        t = _read(d, m)
        if like_leaf is not None and tuple(t.shape) != tuple(
                np.shape(like_leaf)):
            raise ValueError(f"shape mismatch at {path}: "
                             f"{tuple(t.shape)} vs {tuple(np.shape(like_leaf))}")
        if isinstance(like_leaf, torch.Tensor):
            return t.to(like_leaf.device)
        return t if device is None else t.to(device)

    def leaf(path: str, like_leaf, sh=None):
        t = read(path, like_leaf, sh.mesh.device_type if sh else None)
        if t is None:
            return None
        if sh is not None:
            return sh.place(t)
        if _is_dtensor(like_leaf):
            return place(t, like_leaf.device_mesh, like_leaf.placements)
        return t

    def in_place(module: nn.Module, path: str, shs) -> nn.Module:
        for name, t in module.named_parameters():
            p = "/".join([path] + [f"[{k!r}]" for k in name.split(".")])
            new = read(p, t)
            if new is None:
                raise ValueError(f"checkpoint has no leaf at {p}")
            if new.dtype != t.dtype:
                raise ValueError(f"dtype mismatch at {p}: {new.dtype} vs "
                                 f"{t.dtype}")
            with torch.no_grad():
                if shs is not None:
                    owner, attr = module, name
                    if "." in name:
                        mod_name, attr = name.rsplit(".", 1)
                        owner = module.get_submodule(mod_name)
                    owner._parameters[attr] = nn.Parameter(
                        sharding_of(shs, name).place(new),
                        requires_grad=t.requires_grad)
                elif _is_dtensor(t):
                    t.to_local().copy_(place(new, t.device_mesh,
                                             t.placements).to_local())
                else:
                    t.copy_(new)
        for p, t in _flatten(module, path):
            if t is not None and not isinstance(t, nn.Parameter):
                with torch.no_grad():            # buffers
                    t.copy_(leaf(p, t))
        return module

    def build(node, path: str, sh):
        if isinstance(node, nn.Module):
            return in_place(node, path, sh)
        kids = _children(node)
        if kids is None:
            return leaf(path, node, sh)
        sh_kids = dict(_children(sh)) if sh is not None else {}
        out = {key: build(child, f"{path}/{key}" if path else key,
                          sh_kids.get(key))
               for key, child in kids}
        if isinstance(node, dict):
            return {k: out[f"[{k!r}]"] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(out[f"[{i}]"] for i in range(len(node)))
        return dataclasses.replace(node, **{k[1:]: v for k, v in out.items()})

    return build(like, "", shardings)


@dataclass
class Checkpointer:
    """Async checkpointer with retention."""

    directory: str
    keep: int = 3
    _thread: Optional[threading.Thread] = field(default=None, repr=False)
    _error: list = field(default_factory=list, repr=False)

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> None:
        """Copy ``tree`` to the host now, write it in the background."""
        self.wait()
        flat = [(p, _to_host(leaf)) for p, leaf in _flatten(tree)]

        if not _writes():
            return

        def work():
            try:
                _write(self.directory, step, flat, extra)
                self._gc()
            except Exception as e:       # surfaced on next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight (in a world of processes, for rank
        0's: every rank calls it at the same point)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _distributed():
            import torch.distributed as dist
            dist.barrier()
        if self._error:
            raise self._error.pop()

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, shardings: Any = None):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, load_checkpoint(self.directory, step, like, shardings)
