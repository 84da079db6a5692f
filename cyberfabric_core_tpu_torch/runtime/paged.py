"""Paged KV pool (the chain part of ``runtime/paged.py``'s ``PrefixKVPool``).

The pool is two tensors ``[L, N, page, Hkv, D]`` on the device; page 0 is
scratch (padding and frozen rows write there), the allocator hands out pages
``1 .. N-1``. A request's KV lives in its *chain*: the list of page ids its
page-table row points at. The paged forwards write into the pool tensors in
place (the JAX package donates them instead).

A chain is built one of two ways: chunk by chunk as mixed rounds write a
prompt into it (:meth:`admit_chain` + :meth:`extend_chain`), or at once from
a phase-separated prefill's collected KV (:meth:`admit_slot`).

Until the radix prefix cache lands every page has exactly one holder, its
chain: :meth:`release_slot` frees the chain's pages directly and
:meth:`commit_chain` (radix publishing) is a no-op. Per-page reference
counts, ``store_prefill`` and tree publishing come with prefix reuse, which
shares pages between chains.
"""

from __future__ import annotations

from typing import Any

import torch

from ..models.configs import ModelConfig
from .native import BlockAllocator


class PrefixKVPool:
    """Device page pool + host allocator (the radix half of the JAX class
    comes with prefix reuse)."""

    def __init__(self, model_config: ModelConfig, *, num_pages: int,
                 page_size: int, dtype: torch.dtype, device: torch.device) -> None:
        self.page_size = page_size
        self.num_pages = num_pages
        shape = (model_config.num_layers, num_pages, page_size,
                 model_config.num_kv_heads, model_config.head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=device)
        self.allocator = BlockAllocator(num_pages - 1)  # page 0 is scratch
        self._page_offset = 1

    def pages_for(self, length: int) -> int:
        return (length + self.page_size - 1) // self.page_size

    def _alloc(self, n: int) -> list[int]:
        return [p + self._page_offset for p in self.allocator.alloc(n)]

    def admit_chain(self, prompt_ids: list[int]) -> list[int]:
        """Start a chain for a request entering chunked prefill. Without the
        radix cache nothing is matched, so the chain starts empty and grows
        chunk by chunk through :meth:`extend_chain`."""
        del prompt_ids  # the prefix match of a later slice reads it
        return []

    def commit_chain(self, prompt_ids: list[int], chain: list[int]) -> None:
        """After the final prompt chunk: publish the prompt's full pages to
        the radix cache. A no-op until prefix reuse lands."""
        del prompt_ids, chain

    def extend_chain(self, chain: list[int], length_needed: int) -> list[int]:
        """Grow a chain to cover ``length_needed`` tokens, in place. Raises
        MemoryError (nothing allocated) when the pool is short."""
        add = self.pages_for(length_needed) - len(chain)
        if add > 0:
            chain.extend(self._alloc(add))
        return chain

    def admit_slot(self, prompt_ids: list[int], kv: tuple[torch.Tensor, torch.Tensor]
                   ) -> list[int]:
        """Place one request's prefilled KV (``[L, 1, T', Hkv, D]`` each,
        T' >= len(prompt_ids)) into freshly allocated private pages — the
        full prompt pages, then the tail page — and return the chain. One
        indexed copy per pool writes every page; positions past the prompt
        in the tail page carry the prefill's padding KV, masked by length
        until decode overwrites them. Raises MemoryError (nothing
        allocated) when the pool is short."""
        T = len(prompt_ids)
        n = self.pages_for(T)
        chain = self._alloc(n)
        span = n * self.page_size
        ids = torch.tensor(chain, dtype=torch.long, device=self.k_pool.device)
        for pool, new in ((self.k_pool, kv[0]), (self.v_pool, kv[1])):
            L, _, width, Hkv, D = new.shape
            src = new[:, 0, :span]
            if width < span:  # the prefill bucket is shorter than the pages
                src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, span - width))
            pool[:, ids] = src.reshape(L, n, self.page_size, Hkv, D).to(pool.dtype)
        return chain

    def release_slot(self, chain: list[int]) -> None:
        """Free a finished slot's chain — the one release path."""
        self.allocator.free([p - self._page_offset for p in chain])

    def stats(self) -> dict[str, Any]:
        return {
            "pages_free": self.allocator.num_free,
            "pages_total": self.num_pages - 1,
            "pages_in_use": self.num_pages - 1 - self.allocator.num_free,
        }
