"""Prefix-cached paged KV pool (counterpart of ``runtime/paged.py``'s
``PrefixKVPool``).

The pool is two tensors ``[L, N, page, Hkv, D]`` on the device; page 0 is
scratch (padding and frozen rows write there), the allocator hands out pages
``1 .. N-1``. A request's KV lives in its *chain*: the list of page ids its
page-table row points at. The paged forwards write into the pool tensors in
place (the JAX package donates them instead).

Prompt prefixes are shared through a radix tree (:class:`.native.PrefixCache`)
at page granularity. A request whose prompt starts with cached full pages
matches them (:meth:`match_prefix`, which pins the tree path) and its chain
starts with those pages; only the uncached suffix is prefilled. A prompt's
full pages enter the tree when its prefill is done: from a phase-separated
prefill's collected KV (:meth:`admit_slot` → :meth:`store_prefill`), or,
after mixed rounds wrote the prompt chunk by chunk into the chain
(:meth:`extend_chain`), by :meth:`commit_chain`.

Ownership: every page of a live chain is reference-counted for the chain's
lifetime (:meth:`ref_pages` / :meth:`unref_pages`); tree pages are
*tree-owned*. The tree may evict a page a live chain still reads — it then
becomes an *orphan*, returned to the allocator when its last reference
goes. :meth:`_alloc` evicts unpinned LRU tree pages when the allocator runs
short. ``tests/test_torch_prefix_cache.py`` audits the invariants of this
protocol after every operation of bounded and random operation sequences.

The movers (:meth:`gather_for_prefill`, :meth:`store_prefill`,
:meth:`scatter_tail`, the host copies) are one indexed copy per pool; the
JAX package pads page lists to powers of two to bound its compile variants,
which eager PyTorch does not need.

Tensor parallelism (``mesh``, :mod:`..parallel.mesh`): one pool pair a rank,
``[L, N, page, Hkv/tp, D]`` on the rank's device when tp divides the kv
heads, else all heads on every rank (JAX's replicated fallback). Page ids,
the allocator, the radix tree and the chains are host bookkeeping shared by
every rank. A collected KV handed to the movers holds one tensor a rank
(``([k_r], [v_r])``, :func:`..models.llama.init_model_cache`). The host
copies join the ranks' heads (:meth:`save_chain_to_host`) and split them
again (:meth:`restore_chain_from_host`), so a saved chain is the unsharded
``[L, n, page, Hkv, D]`` whatever the tp: preemption and PD handoff work
across engines of any tp.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

import torch

from ..device import to_device
from ..models.configs import ModelConfig
from ..parallel.mesh import RankMesh
from ..parallel.sharding import kv_heads_sharded
from .native import BlockAllocator, PrefixCache

logger = logging.getLogger("paged")

KV = tuple[torch.Tensor, torch.Tensor]


class PrefixKVPool:
    """Device page pool + host allocator and radix tree."""

    def __init__(self, model_config: ModelConfig, *, num_pages: int,
                 page_size: int, dtype: torch.dtype, device: torch.device,
                 mesh: Optional[RankMesh] = None) -> None:
        self.page_size = page_size
        self.num_pages = num_pages
        tp = mesh.tp if mesh is not None else 1
        #: whether each rank holds a kv-head slice (else all heads)
        self.kv_sharded = kv_heads_sharded(model_config, tp)
        heads = model_config.num_kv_heads // (tp if self.kv_sharded else 1)
        shape = (model_config.num_layers, num_pages, page_size, heads, model_config.head_dim)
        devices = mesh.devices if mesh is not None else (device,)
        #: one pool pair a rank
        self.k_ranks = [torch.zeros(shape, dtype=dtype, device=d) for d in devices]
        self.v_ranks = [torch.zeros(shape, dtype=dtype, device=d) for d in devices]
        #: rank 0's pools (the only ones without tp)
        self.k_pool, self.v_pool = self.k_ranks[0], self.v_ranks[0]
        self.allocator = BlockAllocator(num_pages - 1)  # page 0 is scratch
        self._page_offset = 1
        self.tree = PrefixCache(page_size)
        #: serialises radix-tree access: the tree has no lock of its own, and
        #: ``stats()`` may be read from any thread
        self._tree_lock = threading.Lock()
        self.prefill_tokens_saved = 0
        self.prefill_tokens_total = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self._refs: dict[int, int] = {}
        self._tree_owned: set[int] = set()
        self._orphans: set[int] = set()

    @property
    def capacity_pages(self) -> int:
        """Pages a single chain could ever hold (page 0 is scratch)."""
        return self.num_pages - self._page_offset

    @property
    def tp(self) -> int:
        return len(self.k_ranks)

    @property
    def pools(self) -> tuple:
        """What the paged forwards take: ``(k_pool, v_pool)``, or under tp
        the ranks' lists ``([k_r], [v_r])``."""
        if self.tp == 1:
            return self.k_pool, self.v_pool
        return self.k_ranks, self.v_ranks

    def rank_bytes(self) -> list[int]:
        """Bytes of each rank's k and v pools."""
        return [k.numel() * k.element_size() + v.numel() * v.element_size()
                for k, v in zip(self.k_ranks, self.v_ranks)]

    def pages_for(self, length: int) -> int:
        return (length + self.page_size - 1) // self.page_size

    @staticmethod
    def _ids(pages: list[int], device: torch.device) -> torch.Tensor:
        return to_device(torch.tensor(pages, dtype=torch.long), device)

    def _rank_pairs(self, kv: KV) -> list[tuple]:
        """(k pool, v pool, k, v) a rank, for a collected KV of every rank."""
        ks, vs = kv
        if not isinstance(ks, list):
            ks, vs = [ks], [vs]
        return list(zip(self.k_ranks, self.v_ranks, ks, vs))

    # ------------------------------------------------------------ movers
    def _scatter_full_pages(self, kv: KV, page_ids: list[int],
                            start_token: int) -> None:
        """Write len(page_ids) full pages of ``kv`` ([L, 1, S, Hkv, D]),
        from token ``start_token`` on, into the pool; a bucket shorter than
        the pages is padded."""
        n = len(page_ids)
        span = n * self.page_size
        for k_pool, v_pool, k, v in self._rank_pairs(kv):
            ids = self._ids(page_ids, k_pool.device)
            for pool, new in ((k_pool, k), (v_pool, v)):
                L, _, _, Hkv, D = new.shape
                src = new[:, 0, start_token: start_token + span]
                if src.shape[1] < span:
                    src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, span - src.shape[1]))
                pool[:, ids] = src.reshape(L, n, self.page_size, Hkv, D).to(pool.dtype)

    def scatter_tail(self, kv: KV, start_token: int, page_id: int) -> None:
        """Place a slot's partial tail (one page of tokens from
        ``start_token``) into its private page; positions past the prompt
        carry padding KV, masked by length until decode overwrites them."""
        self._scatter_full_pages(kv, [page_id], start_token)

    def gather_for_prefill(self, page_ids: list[int], seq_bucket: int,
                           cache: KV) -> KV:
        """Place cached pages at the head of a fresh [L, 1, seq_bucket, ...]
        prefill cache, in place. Returns the cache."""
        if not page_ids:
            return cache
        span = min(len(page_ids) * self.page_size, seq_bucket)
        for k_pool, v_pool, k, v in self._rank_pairs(cache):
            ids = self._ids(page_ids, k_pool.device)
            for c, pool in ((k, k_pool), (v, v_pool)):
                L, _, page, Hkv, D = pool.shape
                blk = pool[:, ids].reshape(L, len(page_ids) * page, Hkv, D)
                c[:, 0, :span] = blk[:, :span].to(c.dtype)
        return cache

    # ------------------------------------------------------------ allocation
    def _alloc(self, n: int) -> list[int]:
        """Allocate n pages, evicting unpinned tree entries as needed. Evicted
        pages still referenced by a live chain become orphans (freed at
        unref), so eviction may take several rounds to free allocator space."""
        while True:
            try:
                return [p + self._page_offset for p in self.allocator.alloc(n)]
            except MemoryError:
                with self._tree_lock:
                    freed = self.tree.evict(n)
                if not freed:
                    raise
                now_free = []
                for p in freed:
                    self._tree_owned.discard(p)
                    if self._refs.get(p, 0) > 0:
                        self._orphans.add(p)
                    else:
                        now_free.append(p - self._page_offset)
                self.allocator.free(now_free)

    def ref_pages(self, pages: list[int]) -> None:
        for p in pages:
            self._refs[p] = self._refs.get(p, 0) + 1

    def unref_pages(self, pages: list[int]) -> None:
        """Drop a chain's references; frees pages nothing else owns."""
        to_free = []
        for p in pages:
            c = self._refs.get(p, 0) - 1
            if c <= 0:
                self._refs.pop(p, None)
                if p not in self._tree_owned:
                    self._orphans.discard(p)
                    to_free.append(p - self._page_offset)
            else:
                self._refs[p] = c
        self.allocator.free(to_free)

    # ------------------------------------------------------------ matching
    def match_prefix(self, prompt_ids: list[int]) -> tuple[list[int], int]:
        """Returns (pinned page ids, cached token count). Never returns the
        whole prompt as cached: at least one token must go through prefill
        so the model produces the first-token logits. The pin holds until
        :meth:`release`, also when the page list was trimmed to empty."""
        with self._tree_lock:
            pages = self.tree.match(prompt_ids)
        cached = len(pages) * self.page_size
        if cached >= len(prompt_ids):
            drop = (cached - len(prompt_ids)) // self.page_size + 1
            pages = pages[:-drop] if drop <= len(pages) else []
            cached = len(pages) * self.page_size
        self.prefix_lookups += 1
        self.prefill_tokens_total += len(prompt_ids)
        if pages:
            self.prefix_hits += 1
            self.prefill_tokens_saved += cached
        return pages, cached

    def peek_prefix_len(self, prompt_ids: list[int]) -> int:
        """Non-pinning probe: how many head tokens of ``prompt_ids`` the
        pool could serve from cache now (a placement hint; no stats)."""
        with self._tree_lock:
            pages = self.tree.match(prompt_ids)
            self.tree.release(prompt_ids)
        return min(len(pages) * self.page_size, max(len(prompt_ids) - 1, 0))

    def release(self, prompt_ids: list[int]) -> None:
        with self._tree_lock:
            self.tree.release(prompt_ids)

    # ------------------------------------------------------------ chains
    def store_prefill(self, prompt_ids: list[int], cached_pages: list[int],
                      kv: KV) -> list[int]:
        """After a phase-separated prefill: write the prompt's NEW full pages
        into the pool and record the prompt's full-page chain in the tree.
        Returns that chain (cached + new); under pool pressure the store is
        skipped and only the cached pages come back."""
        total_pages = len(prompt_ids) // self.page_size
        n_new = total_pages - len(cached_pages)
        if n_new <= 0:
            return list(cached_pages)
        try:
            new_ids = self._alloc(n_new)
        except MemoryError:
            logger.debug("pool exhausted; skipping prefix store")
            return list(cached_pages)
        try:
            self._scatter_full_pages(kv, new_ids, len(cached_pages) * self.page_size)
        except Exception:
            self.allocator.free([p - self._page_offset for p in new_ids])
            raise
        chain = list(cached_pages) + new_ids
        with self._tree_lock:
            _, unused = self.tree.insert_tracked(
                prompt_ids[: total_pages * self.page_size], chain)
        # a new page the tree declined (its position was already cached)
        # stays private to this chain
        declined = set(unused)
        self._tree_owned.update(p for p in new_ids if p not in declined)
        return chain

    def admit_slot(self, prompt_ids: list[int], cached_pages: list[int],
                   kv: KV) -> list[int]:
        """Place one request's prefilled KV (``[L, 1, T', Hkv, D]`` each,
        holding positions ``0 .. T'-1`` with the cached head gathered in)
        into pool pages and return its chain: the cached pages, the new
        full pages (published to the tree), then a private tail page. Every
        chain page is referenced until :meth:`release_slot`. Raises
        MemoryError when the pool cannot hold the request even after
        eviction (nothing stays held)."""
        T = len(prompt_ids)
        full = T // self.page_size
        tail = T - full * self.page_size
        chain = self.store_prefill(prompt_ids, cached_pages, kv)
        # Reference at once, before any further allocation: the allocations
        # below may evict, and on a full pool the evictor could pick this
        # request's just-inserted (unpinned) pages, free them and hand them
        # back as its own tail page (invariant I5 of the pool audit).
        self.ref_pages(chain)
        refed = list(chain)
        try:
            if len(chain) < full:
                # the tree store was skipped (pool pressure): hold the rest
                # of the full pages privately so the slot can still decode
                ids = self._alloc(full - len(chain))
                self.ref_pages(ids)
                refed.extend(ids)
                self._scatter_full_pages(kv, ids, len(chain) * self.page_size)
                chain = chain + ids
            if tail:
                tid = self._alloc(1)[0]
                self.ref_pages([tid])
                refed.append(tid)
                self.scatter_tail(kv, full * self.page_size, tid)
                chain = chain + [tid]
        except Exception:
            self.unref_pages(refed)
            raise
        return chain

    def commit_chain(self, prompt_ids: list[int], chain: list[int]) -> None:
        """After the final mixed prompt chunk: record the prompt's full pages
        (already written in place) in the tree so later requests share them.
        Pages the tree declines stay private to the chain."""
        total_pages = len(prompt_ids) // self.page_size
        if total_pages <= 0:
            return
        with self._tree_lock:
            _, unused = self.tree.insert_tracked(
                prompt_ids[: total_pages * self.page_size], chain[:total_pages])
        declined = set(unused)
        for p in chain[:total_pages]:
            if p not in declined:
                self._tree_owned.add(p)
                # a page evicted mid-prefill (kept alive as an orphan by the
                # chain's reference) is tree-owned again
                self._orphans.discard(p)

    def extend_chain(self, chain: list[int], length_needed: int) -> list[int]:
        """Grow a chain with private pages to cover ``length_needed`` tokens,
        in place. Raises MemoryError (nothing allocated) when the pool is
        short even after eviction."""
        add = self.pages_for(length_needed) - len(chain)
        if add > 0:
            ids = self._alloc(add)
            self.ref_pages(ids)
            chain.extend(ids)
        return chain

    def release_slot(self, chain: list[int]) -> None:
        """Drop a chain's references — the one release path: tree pages stay
        cached, private pages and orphans return to the allocator."""
        self.unref_pages(chain)

    # ------------------------------------------------------------ host copies
    def save_chain_to_host(self, chain: list[int]) -> KV:
        """Copy a chain's pages to host memory ([L, n, page, Hkv, D] CPU
        tensors in the pool's dtype), one gather per pool. On CUDA the copy
        goes into pinned memory without blocking the host: the bytes are
        there once the stream has run it, so a host reader synchronises
        first, while :meth:`restore_chain_from_host` (a copy queued later on
        the same stream) needs no wait."""
        n_ranks = self.tp if self.kv_sharded else 1  # a replica holds every head
        out = []
        for ranks in (self.k_ranks, self.v_ranks):
            home = ranks[0].device
            parts = [pool[:, self._ids(chain, pool.device)] for pool in ranks[:n_ranks]]
            src = parts[0] if n_ranks == 1 else torch.cat([p.to(home) for p in parts], dim=3)
            if home.type != "cuda":
                out.append(src)
                continue
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            host.copy_(src, non_blocking=True)
            out.append(host)
        return out[0], out[1]

    def restore_chain_from_host(self, host_kv: KV) -> list[int]:
        """Allocate fresh private pages and write a saved chain back. Raises
        MemoryError when the pool lacks space even after eviction."""
        n = host_kv[0].shape[1]
        if n == 0:
            return []
        ids = self._alloc(n)
        self.ref_pages(ids)
        for ranks, host in ((self.k_ranks, host_kv[0]), (self.v_ranks, host_kv[1])):
            host = host.to(ranks[0].dtype)
            # a pinned buffer of save_chain_to_host goes straight to the
            # device: staging it would read it on the host before its copy
            # ran. The ranks' heads are split on the device.
            full = (host.to(ranks[0].device, non_blocking=True) if host.is_pinned()
                    else to_device(host, ranks[0].device))
            heads = ranks[0].shape[3]
            for r, pool in enumerate(ranks):
                part = full[:, :, :, r * heads:(r + 1) * heads] if self.kv_sharded else full
                pool[:, self._ids(ids, pool.device)] = part.to(pool.device)
        return ids

    def export_pages(self, chain: list[int],
                     prompt_ids: Optional[list[int]] = None) -> KV:
        """Copy a chain's pages to host and give up this pool's hold on them
        (tree pages stay cached here); ``prompt_ids`` releases a radix pin
        the caller still holds."""
        host_kv = self.save_chain_to_host(chain)
        if prompt_ids is not None:
            self.release(prompt_ids)
        self.release_slot(chain)
        return host_kv

    def import_pages(self, host_kv: KV) -> list[int]:
        """Land an exported chain's KV in fresh private pages of this pool."""
        return self.restore_chain_from_host(host_kv)

    def stats(self) -> dict[str, Any]:
        with self._tree_lock:
            tree_stats = self.tree.stats()
        free = self.allocator.num_free
        return {
            **tree_stats,
            "pages_free": free,
            "pages_total": self.capacity_pages,
            #: pages off the free list: live chains' and the tree's
            "pages_in_use": self.capacity_pages - free,
            "pages_referenced": len(self._refs),
            "orphan_pages": len(self._orphans),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefill_tokens_total": self.prefill_tokens_total,
            "hit_rate": round(self.prefill_tokens_saved / self.prefill_tokens_total, 4)
            if self.prefill_tokens_total else 0.0,
            "lookups": self.prefix_lookups,
            "hits": self.prefix_hits,
        }
