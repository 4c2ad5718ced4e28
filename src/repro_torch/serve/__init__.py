"""Serving-side memory accounting (the pure block-pool ledger)."""

from repro_torch.serve.pool import (PAGE_TOKENS, PoolAccounting,  # noqa: F401
                                    ServeSpec, pool_accounting, pool_blocks,
                                    pool_tokens)
