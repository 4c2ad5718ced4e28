"""The weights of a cell, made on the device from the seed.

A configuration's reference lists every weight as (name, shape, init).
All of them live in one flat buffer in the type they are served in, each
at an offset aligned to ``ALIGN`` elements.  The buffer is drawn from a
normal distribution in chunks of ``CHUNK`` elements, each chunk from a
generator of its own seeded from the cell's seed, so that any chunk can be
drawn again alone; then each weight's part of a chunk is scaled
(``normal``) or filled (``ones``, ``zeros``).  The program's parameters
and the reference's frozen weights are views of that buffer.
"""

from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass

import torch

CHUNK = 1 << 28
ALIGN = 128
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of the cell's seed."""
    text = ":".join(str(t) for t in (int(seed),) + tags)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


@dataclass(frozen=True)
class Entry:
    name: str
    shape: tuple
    init: tuple
    offset: int

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n


@dataclass(frozen=True)
class Layout:
    entries: tuple
    total: int
    dtype: torch.dtype

    def names(self) -> list:
        return [e.name for e in self.entries]


def layout(specs: list, dtype: str) -> Layout:
    entries, off = [], 0
    for name, shape, init in specs:
        entries.append(Entry(name, tuple(int(d) for d in shape), tuple(init),
                             off))
        off += -(-entries[-1].numel // ALIGN) * ALIGN
    return Layout(tuple(entries), off, DTYPES[dtype])


def _fill(buf: torch.Tensor, lo: int, lay: Layout, seed: int) -> None:
    """Draw the chunk that starts at ``lo`` into ``buf`` and give each
    weight's part of it its init."""
    buf.normal_(generator=generator(buf.device, derive(seed, "weights",
                                                       lo // CHUNK)))
    hi = lo + buf.numel()
    starts = [e.offset for e in lay.entries]
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    for e in lay.entries[i:]:
        if e.offset >= hi:
            break
        a, b = max(e.offset, lo), min(e.offset + e.numel, hi)
        if a >= b:
            continue
        part = buf[a - lo:b - lo]
        if e.init[0] == "normal":
            part.mul_(e.init[1])
        elif e.init[0] == "ones":
            part.fill_(1.0)
        elif e.init[0] == "zeros":
            part.zero_()
        else:
            raise ValueError(f"{e.name}: unknown init {e.init!r}")


def draw(seed: int, lay: Layout, device) -> torch.Tensor:
    """The flat buffer of every weight."""
    flat = torch.empty(lay.total, dtype=lay.dtype, device=device)
    for lo in range(0, lay.total, CHUNK):
        _fill(flat[lo:lo + CHUNK], lo, lay, seed)
    return flat


def views(flat: torch.Tensor, lay: Layout) -> dict:
    return {e.name: flat[e.offset:e.offset + e.numel].view(e.shape)
            for e in lay.entries}


def initial(seed: int, lay: Layout, names, device) -> dict:
    """Fresh copies of the named weights as drawn, making again only the
    chunks that hold them."""
    want = [e for e in lay.entries if e.name in set(names)]
    out = {e.name: torch.empty(e.shape, dtype=lay.dtype, device=device)
           for e in want}
    chunks = sorted({c for e in want
                     for c in range(e.offset // CHUNK,
                                    (e.offset + e.numel - 1) // CHUNK + 1)})
    for c in chunks:
        lo = c * CHUNK
        buf = torch.empty(min(CHUNK, lay.total - lo), dtype=lay.dtype,
                          device=device)
        _fill(buf, lo, lay, seed)
        for e in want:
            a, b = max(e.offset, lo), min(e.offset + e.numel, lo + buf.numel())
            if a < b:
                out[e.name].view(-1)[a - e.offset:b - e.offset] = \
                    buf[a - lo:b - lo]
        del buf
    return out
