"""Host time of the sweep's table builds, for one checkout or two in turns.

Each run is a process of its own that imports the checkout's
``chip_smoke.py`` (and so its ``src/repro_torch``) and, on the card:

* ``check_s``: ``check_shard_factor()``, phase 2's shard-factor checks
  (the eight 2^20-cell requests included);
* ``legacy``: the 124,416-cell large legacy grid swept cold (a fresh
  ``SweepEngine``) ``--repeat`` times: ``cold_s`` (host clock, from a
  synchronised card to a synchronised card), the engine's
  ``table_build_s``, and ``pack_s``, the time its
  ``ShardFactorBatch.pack()`` calls took;
* ``moe``: the moe_epcp grid swept cold once, whose builds include the
  sweeps' largest packed build (97 requests, 771,420 cells): the same
  three numbers.

Each sweep also lists its ``pack()`` calls: time, requests and cells.

Usage (from the root of a checkout, with a card)::

    python3 tools/time_table_builds.py CHECKOUT [OTHER] [--repeat N]

With two checkouts the runs go CHECKOUT, OTHER, OTHER, CHECKOUT, so that
each is measured early and late on the same host.  Prints the card's name
and power limit, then one JSON line per run.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def one_run(checkout: str, repeat: int) -> dict:
    sys.path.insert(0, os.path.abspath(checkout))
    import chip_smoke as CS

    SF, SW = CS.SF, CS.SW
    packs = []
    real = SF.ShardFactorBatch.pack

    def pack(self):
        t0 = time.perf_counter()
        p = real(self)
        packs.append({"s": time.perf_counter() - t0,
                      "requests": len(p.requests), "cells": p.n_out})
        return p
    SF.ShardFactorBatch.pack = pack

    t0 = time.perf_counter()
    CS._build.load()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    CS.check_shard_factor()
    check_s = time.perf_counter() - t0

    def sweep(grid) -> dict:
        del packs[:]
        _, cold_s, stats = CS.timed_sweep(SW.SweepEngine(), grid)
        return {"cold_s": cold_s, "table_build_s": stats["table_build_s"],
                "table_builds": stats["table_builds"],
                "pack_s": sum(p["s"] for p in packs), "packs": list(packs)}
    legacy = [sweep(CS.large_grid("legacy")) for _ in range(repeat)]
    moe = sweep(CS.moe_epcp_grid())
    return {"checkout": os.path.basename(checkout), "build_s": build_s,
            "check_s": check_s, "legacy": legacy, "moe": moe}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--one", action="store_true",
                    help="run the first checkout once, in this process")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_run(args.checkouts[0], args.repeat)))
        return 0
    if len(args.checkouts) > 2:
        ap.error("one checkout, or two to run in turns")
    a, b = (args.checkouts * 2)[:2]
    order = [a] if len(args.checkouts) == 1 else [a, b, b, a]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for checkout in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             os.path.abspath(checkout), "--one", "--repeat",
             str(args.repeat)], capture_output=True, text=True,
            cwd=os.path.abspath(checkout))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(out.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
