"""Operations and bytes of one call of a kernel at its true shape, the
least a kernel could do: each input read once and each output written
once, each tensor at its own width; products as the algorithm needs them
(a causal score matrix counts only its unmasked entries).

Flash attention (FlashAttention-2's count): forward 2 x scores x (D + Dv)
(q k^T at D, P v at Dv); the dq pass 2 x scores x (2D + Dv) (s, dq at D;
dp at Dv); the dk / dv pass 2 x scores x (2D + 2Dv) (s, dk at D; dp, dv
at Dv).  RMSNorm: x read and y written, the scale read (forward); x and
dy read, dx written, the scale read and its gradient written
(backward)."""

from __future__ import annotations

F32_BYTES = 4


def scores(c: dict) -> float:
    """Entries of the score matrices one attention call needs."""
    per = c["Sq"] * (c["Sq"] + 1) / 2 if c["causal"] else c["Sq"] * c["Skv"]
    return c["B"] * c["H"] * per


def flash(c: dict, kernel: str, elt: int) -> tuple:
    """(operations, bytes) of one ``fwd``, ``dq`` or ``dkv`` pass."""
    q = c["B"] * c["Sq"] * c["H"] * c["D"]
    k = c["B"] * c["Skv"] * c["Hkv"] * c["D"]
    v = c["B"] * c["Skv"] * c["Hkv"] * c["Dv"]
    o = c["B"] * c["Sq"] * c["H"] * c["Dv"]
    stat = F32_BYTES * c["B"] * c["H"] * c["Sq"]
    sc, D, Dv = scores(c), c["D"], c["Dv"]
    if kernel == "fwd":        # reads q k v, writes out and lse
        return 2 * sc * (D + Dv), elt * (q + k + v + o) + stat
    if kernel == "dq":         # reads q k v out dout lse, writes dq delta
        return 2 * sc * (2 * D + Dv), elt * (2 * q + k + v + 2 * o) \
            + 2 * stat
    if kernel == "dkv":        # reads q k v dout lse delta, writes dk dv
        return 2 * sc * (2 * D + 2 * Dv), elt * (q + 2 * k + 2 * v + o) \
            + 2 * stat
    raise ValueError(f"unknown flash pass {kernel!r}")


def rmsnorm(c: dict, kernel: str, elt: int) -> tuple:
    """(operations, bytes) of one ``fwd`` or ``bwd`` call."""
    n = c["rows"] * c["D"]
    if kernel == "fwd":
        return 5 * n, elt * (2 * n + c["D"])
    if kernel == "bwd":
        return 10 * n, elt * (3 * n + 2 * c["D"])
    raise ValueError(f"unknown rmsnorm pass {kernel!r}")


def roofline_share(trace, calls: list, kernels: dict, work_fn, elt: int,
                   ops_per_s: float, bytes_per_s: float):
    """Percent of the device time of ``kernels`` (pass -> name patterns)
    that their bound takes: the bound of each pass is the larger of
    operations / ``ops_per_s`` and bytes / ``bytes_per_s`` over the calls
    a step makes, times the traced launches over the calls the traced
    steps make (a pass run again under rematerialisation counts again).
    None when the trace holds none of those kernels."""
    if trace is None or not calls:
        return None
    per_step = sum(c["calls"] for c in calls)
    bound = device = 0.0
    for kernel, patterns in kernels.items():
        launches, seconds = trace.kernel_time(patterns)
        if not launches:
            continue
        runs = launches / (per_step * trace.steps)
        for c in calls:
            ops, nbytes = work_fn(c, kernel, elt)
            bound += runs * trace.steps * c["calls"] * \
                max(ops / ops_per_s, nbytes / bytes_per_s)
        device += seconds
    return 100.0 * bound / device if device > 0 else None
