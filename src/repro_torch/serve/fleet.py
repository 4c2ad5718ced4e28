"""Request-mix math for the serving-fleet memory model.

A production decode fleet runs CONTINUOUS BATCHING: at any instant the
in-flight batch mixes requests that are still prefilling with requests
that are decoding, and their context lengths follow the live traffic
distribution rather than one fixed ``seq_len``.  :class:`RequestMix`
captures that occupancy as two exact-integer knobs:

* ``prefill_bp`` — basis points (x1e-4) of in-flight requests currently
  in their prefill phase.  A chunk-prefilled request has, on average,
  written about half its final context into the pool, so prefill-phase
  slots are charged ``len // 2`` tokens (the chunked-prefill midpoint);
  decode-phase slots hold their full context.
* ``hist`` — a ``((seq_len, weight), ...)`` histogram of final context
  lengths.  Empty means "every request runs to the cell's seq_len".

Everything here is plain-integer arithmetic (no floats) so the scalar
predictor and the columnar batch engine provably agree byte-for-byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

BP = 10000  # basis-point denominator: all rates are ints x 1e-4


@dataclass(frozen=True)
class RequestMix:
    """In-flight request-mix distribution (see module docstring)."""

    prefill_bp: int = 0                       # prefill-phase share, x1e-4
    hist: Tuple[Tuple[int, int], ...] = ()    # ((final_len, weight), ...)

    def __post_init__(self):
        if not (0 <= self.prefill_bp <= BP):
            raise ValueError(
                f"mix prefill fraction {self.prefill_bp / BP} outside "
                f"[0, 1]")
        for length, weight in self.hist:
            if length <= 0 or weight <= 0:
                raise ValueError(
                    f"mix histogram entries need positive length and "
                    f"weight, got ({length}, {weight})")

    @classmethod
    def make(cls, prefill_frac: float = 0.0,
             hist: Tuple[Tuple[int, int], ...] = ()) -> "RequestMix":
        return cls(prefill_bp=int(round(prefill_frac * BP)),
                   hist=tuple((int(l), int(w)) for l, w in hist))

    @property
    def is_identity(self) -> bool:
        """True when this mix cannot change expected tokens-per-slot."""
        return self.prefill_bp == 0 and not self.hist


def expected_len(seq_len: int, mix: Optional[RequestMix]) -> int:
    """Expected live context tokens held by one in-flight request slot.

    Histogram lengths are capped at ``seq_len`` (a slot can never hold
    more context than the cell's KV capacity); prefill-phase slots are
    charged the chunked-prefill midpoint ``len // 2``.  Exact integer
    arithmetic, floor-rounded, clamped to >= 1.
    """
    seq_len = int(seq_len)
    if mix is None or mix.is_identity:
        return seq_len
    hist = mix.hist or ((seq_len, 1),)
    num = sum(min(int(l), seq_len) * int(w) for l, w in hist)
    den = sum(int(w) for _, w in hist)
    decode_bp = BP - mix.prefill_bp
    # E[tokens] = E[len]*(1-p) + E[len//2]*p, all floor arithmetic
    half = sum((min(int(l), seq_len) // 2) * int(w) for l, w in hist)
    return max((num * decode_bp + half * mix.prefill_bp) // (BP * den), 1)


def parse_mix(text: str) -> Optional[RequestMix]:
    """Parse the CLI mix syntax ``P[:LxW,LxW,...]``.

    ``P`` is the prefill fraction in [0, 1]; the optional histogram lists
    ``final_len x weight`` pairs.  Examples::

        0.3                      # 30% prefilling, contexts at seq_len
        0.25:512x1,2048x3        # plus a 1:3 length histogram
    """
    text = text.strip()
    if not text:
        return None
    head, _, tail = text.partition(":")
    try:
        frac = float(head)
    except ValueError:
        raise ValueError(f"bad mix {text!r}: prefill fraction {head!r} "
                         f"is not a number") from None
    hist = []
    if tail:
        for part in tail.split(","):
            l, x, w = part.partition("x")
            if not x:
                raise ValueError(f"bad mix {text!r}: histogram entry "
                                 f"{part!r} is not LENxWEIGHT")
            hist.append((int(l), int(w)))
    mix = RequestMix.make(frac, tuple(hist))
    return None if mix.is_identity else mix
