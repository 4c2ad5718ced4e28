"""Block-paged KV-pool accounting for the serving-fleet memory model.

xMem-style observation: on a real serving fleet the per-layer KV math is
the easy part — what dominates estimation error is the ALLOCATOR: the
KV cache lives in a pool of fixed-size token blocks (vLLM-style paged
attention), shared-prefix blocks are deduplicated by the prefix cache,
and the pool runs below 100% utilization because of fragmentation and
reservation slack.  :class:`ServeSpec` captures those knobs, and
:func:`pool_tokens` folds them into ONE effective tokens-per-sequence
count that the predictor substitutes for ``slen`` in every paged cache
term (the ``pool_tok`` TermSpec variable).

All rates are stored as exact basis-point integers so the scalar and
columnar prediction paths are byte-identical by construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.serve.fleet import BP, RequestMix, expected_len

#: paged-KV blocks must be a positive multiple of this token quantum so
#: block tables stay lane-aligned with the page-aligned head dims
PAGE_TOKENS = 8


@dataclass(frozen=True)
class ServeSpec:
    """Serving-fleet knobs for one sweep cell (all-neutral == absent).

    ``block_size=0`` means contiguous (unpaged) allocation; ``util_bp``
    is pool utilization x1e-4 (allocated bytes are inflated by its
    inverse); ``hit_bp`` x1e-4 of the shared ``prefix_len``-token prefix
    is served from the prefix cache instead of per-sequence blocks;
    ``mix`` reshapes tokens-per-slot for continuous batching;
    ``draft_arch`` adds speculative-decode draft-model residency.
    """

    block_size: int = 0
    util_bp: int = BP
    hit_bp: int = 0
    prefix_len: int = 0
    mix: Optional[RequestMix] = None
    draft_arch: str = ""

    def __post_init__(self):
        if self.block_size < 0 or (
                self.block_size and self.block_size % PAGE_TOKENS):
            raise ValueError(
                f"block_size {self.block_size} is not page-aligned: "
                f"paged-KV blocks must be a positive multiple of "
                f"{PAGE_TOKENS} tokens (0 = contiguous)")
        if not (0 < self.util_bp <= BP):
            raise ValueError(
                f"pool utilization {self.util_bp / BP} outside (0, 1]")
        if not (0 <= self.hit_bp <= BP):
            raise ValueError(
                f"prefix-cache hit rate {self.hit_bp / BP} outside [0, 1]")
        if self.prefix_len < 0:
            raise ValueError(f"prefix_len {self.prefix_len} is negative")
        if self.hit_bp and self.prefix_len <= 0:
            raise ValueError(
                f"prefix-cache hit rate {self.hit_bp / BP} needs a "
                f"positive --prefix-len (the shared-prefix token count)")

    @classmethod
    def make(cls, block_size: int = 0, utilization: float = 1.0,
             prefix_hit_rate: float = 0.0, prefix_len: int = 0,
             mix: Optional[RequestMix] = None,
             draft_arch: str = "") -> "ServeSpec":
        """Float-friendly constructor; rates are rounded to basis points."""
        return cls(block_size=int(block_size),
                   util_bp=int(round(utilization * BP)),
                   hit_bp=int(round(prefix_hit_rate * BP)),
                   prefix_len=int(prefix_len),
                   mix=mix, draft_arch=draft_arch)

    @property
    def is_neutral(self) -> bool:
        """True when every knob is at the value that cannot change any
        byte — such a spec is normalized to None so prior cells stay
        bit-identical."""
        return (self.block_size == 0 and self.util_bp == BP
                and self.hit_bp == 0
                and (self.mix is None or self.mix.is_identity)
                and not self.draft_arch)


@dataclass(frozen=True)
class PoolAccounting:
    """Exact token ledger for one sequence slot in the paged pool.

    Conservation invariant (tested property):
    ``pool_tokens == unique + pad_slack + frag_slack``.
    """

    live: int          # expected live context tokens (after the mix)
    shared: int        # prefix tokens eligible for prefix-cache sharing
    unique: int        # tokens this slot must actually store
    blocks: int        # allocated blocks (0 when contiguous)
    alloc_tokens: int  # block-granular allocation (== unique when contiguous)
    pool_tokens: int   # allocation inflated by 1/utilization
    pad_slack: int     # alloc_tokens - unique (last-block padding)
    frag_slack: int    # pool_tokens - alloc_tokens (fragmentation share)


def pool_accounting(seq_len: int, spec: ServeSpec) -> PoolAccounting:
    """Full block-pool ledger for one sequence at context ``seq_len``.

    A paged pool is sized in WHOLE blocks: the 1/utilization inflation
    applies to the block count, so ``pool_tokens`` stays block-aligned
    (a pool with dangling partial blocks is not something a block
    allocator can hand out — and alignment also keeps the ``cache_seq``
    shard divisibility of the pool terms independent of the hit rate).
    Contiguous allocation (``block_size=0``) inflates raw tokens."""
    live = expected_len(seq_len, spec.mix)
    shared = min(spec.prefix_len, live) if spec.hit_bp else 0
    unique = live - spec.hit_bp * shared // BP
    if spec.block_size:
        blocks = -(-unique // spec.block_size)
        alloc = blocks * spec.block_size
        pool = -(-blocks * BP // spec.util_bp) * spec.block_size
    else:
        blocks = 0
        alloc = unique
        pool = -(-alloc * BP // spec.util_bp)  # ceil: under-utilized pool
    return PoolAccounting(live=live, shared=shared, unique=unique,
                          blocks=blocks, alloc_tokens=alloc,
                          pool_tokens=pool, pad_slack=alloc - unique,
                          frag_slack=pool - alloc)


def pool_tokens(seq_len: int, spec: Optional[ServeSpec]) -> int:
    """Effective pool tokens per sequence — the ``pool_tok`` TermSpec
    variable.  ``spec=None`` (no serve knobs) degenerates to ``seq_len``
    exactly, so neutral cells stay bit-identical to prior main."""
    if spec is None:
        return int(seq_len)
    return pool_accounting(seq_len, spec).pool_tokens


def pool_blocks(seq_len: int, spec: Optional[ServeSpec]) -> int:
    """Allocated blocks per sequence (0 for contiguous / no serve)."""
    if spec is None:
        return 0
    return pool_accounting(seq_len, spec).blocks
