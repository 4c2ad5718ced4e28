"""Serving: the block-pool memory ledger and the prefill / decode steps."""

from repro_torch.serve.pool import (PAGE_TOKENS, PoolAccounting,  # noqa: F401
                                    ServeSpec, pool_accounting, pool_blocks,
                                    pool_tokens)
from repro_torch.serve.serve_step import (generate,  # noqa: F401
                                          make_decode_step,
                                          make_prefill_step, pad_cache)
