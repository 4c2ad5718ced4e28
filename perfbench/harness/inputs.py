"""The one generator of training traffic.  A traffic file lists the
inputs of a step, each drawn from the seed on the device:

* ``normal``: values from N(0, 1) in ``dtype`` (embeddings that stand in
  for a stubbed frontend);
* ``token_ids``: ids drawn uniformly from the configuration's vocabulary
  (the key named by ``vocab``), one more position than ``shape`` has, so
  that ``labels`` are the next token of each position.

A shape entry is a number or the dotted key of a number in the
configuration.  ``positions`` is what the input adds to the positions a
step holds.  A ring of a few batches is made; the steps cycle through
it.
"""

from __future__ import annotations

import torch

from perfbench.harness.weights import DTYPES, derive, generator


def lookup(cfg: dict, key):
    if isinstance(key, (int, float)):
        return key
    node = cfg
    for part in key.split("."):
        node = node[part]
    return node


def shape_of(spec: dict, cfg: dict) -> tuple:
    return tuple(int(lookup(cfg, d)) for d in spec["shape"])


def positions_per_step(traffic: dict) -> int:
    total = 0
    for spec in traffic["inputs"]:
        n = 1
        for d in spec["positions"]:
            n *= int(d)
        total += n
    return total


def make_batch(seed: int, index: int, traffic: dict, cfg: dict,
               device) -> dict:
    batch = {}
    for spec in traffic["inputs"]:
        shape = shape_of(spec, cfg)
        gen = generator(device, derive(seed, "batch", index, spec["name"]))
        if spec["draw"] == "normal":
            batch[spec["name"]] = torch.randn(
                shape, generator=gen, dtype=DTYPES[spec["dtype"]],
                device=device)
        elif spec["draw"] == "token_ids":
            vocab = int(lookup(cfg, spec["vocab"]))
            ids = torch.randint(0, vocab, shape[:-1] + (shape[-1] + 1,),
                                generator=gen, device=device,
                                dtype=torch.int64).to(torch.int32)
            batch[spec["name"]] = ids[..., :-1].contiguous()
            batch[spec["labels"]] = ids[..., 1:].contiguous()
        else:
            raise ValueError(f"{spec['name']}: unknown draw "
                             f"{spec['draw']!r}")
    return batch


def make_ring(seed: int, size: int, traffic: dict, cfg: dict,
              device) -> list:
    return [make_batch(seed, i, traffic, cfg, device) for i in range(size)]
