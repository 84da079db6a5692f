"""Host structures of the paged-KV runtime: the port's pure-Python copies of
``runtime/native.py``'s ``BlockAllocator`` and ``PrefixCache``.

The JAX package binds a C++ library for both when it builds and falls back
to these same Python structures otherwise; the port keeps only the Python
half (no ctypes, no ``libfabric_host``). Results are the JAX fallback's,
operation for operation.
"""

from __future__ import annotations


class BlockAllocator:
    """LIFO free-list of page ids ``0 .. num_pages-1``."""

    def __init__(self, num_pages: int) -> None:
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))

    def alloc(self, n: int) -> list[int]:
        """Allocate n pages; raises MemoryError when short (nothing allocated)."""
        if len(self._free) < n:
            raise MemoryError(f"KV pool exhausted: wanted {n}, had {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        self._free.extend(pages)

    @property
    def num_free(self) -> int:
        return len(self._free)


class PrefixCache:
    """Radix prefix cache over token ids at page granularity.

    Each node is one full page of tokens (its key) holding that page's id;
    a path from the root spells a cached page-aligned prefix. ``match`` pins
    the nodes it walks (a pinned node is never evicted) until ``release``;
    ``evict`` drops least-recently-used unpinned leaves. Not thread-safe:
    the pool serialises access."""

    def __init__(self, page_size: int) -> None:
        self.page_size = page_size
        self._root: dict = {"children": {}, "pages": [], "pins": 0, "used": 0}
        self._clock = 0
        # cached pages, hits, misses, evicted pages
        self._stats = [0, 0, 0, 0]

    def match(self, tokens: list[int]) -> list[int]:
        """Longest cached page-aligned prefix; pins matched nodes."""
        node, pos, pages, path = self._root, 0, [], []
        toks = list(tokens)
        self._clock += 1
        while pos < len(toks):
            key = tuple(toks[pos:pos + self.page_size])
            child = node["children"].get(key)
            if child is None or len(key) < self.page_size:
                break
            pages.extend(child["pages"])
            child["used"] = self._clock
            path.append(child)
            node = child
            pos += self.page_size
        for nd in path:
            nd["pins"] += 1
        self._stats[1 if pages else 2] += 1
        return pages

    def release(self, tokens: list[int]) -> None:
        """Unpin the nodes along ``tokens``' cached path (pins floor at 0)."""
        node, pos = self._root, 0
        toks = list(tokens)
        while pos < len(toks):
            key = tuple(toks[pos:pos + self.page_size])
            child = node["children"].get(key)
            if child is None:
                break
            child["pins"] = max(0, child["pins"] - 1)
            node = child
            pos += self.page_size

    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Record ``pages`` for ``tokens``; returns the count newly taken."""
        added, _ = self.insert_tracked(tokens, pages)
        return added

    def insert_tracked(self, tokens: list[int],
                       pages: list[int]) -> tuple[int, list[int]]:
        """Insert and report (added, unused_pages): the tree takes a caller
        page only where it creates a node, so pages at already-cached
        positions (and past the usable span) come back in ``unused`` — the
        caller owns them."""
        toks = list(tokens)
        usable = min(len(toks) // self.page_size, len(pages))
        node, added = self._root, 0
        unused: list[int] = []
        self._clock += 1
        for i in range(usable):
            key = tuple(toks[i * self.page_size:(i + 1) * self.page_size])
            child = node["children"].get(key)
            if child is None:
                child = {"children": {}, "pages": [pages[i]], "pins": 0,
                         "used": self._clock, "parent": node, "key": key}
                node["children"][key] = child
                added += 1
                self._stats[0] += 1
            else:
                child["used"] = self._clock
                unused.append(pages[i])
            node = child
        unused.extend(pages[usable:])
        return added, unused

    def evict(self, target_pages: int) -> list[int]:
        """Drop least-recently-used unpinned leaves until ``target_pages``
        pages are freed or nothing is evictable; returns the freed ids."""
        freed: list[int] = []
        while len(freed) < target_pages:
            lru = None
            stack = list(self._root["children"].values())
            while stack:
                nd = stack.pop()
                if not nd["children"] and nd["pins"] == 0 and (
                        lru is None or nd["used"] < lru["used"]):
                    lru = nd
                stack.extend(nd["children"].values())
            if lru is None:
                break
            freed.extend(lru["pages"][: target_pages - len(freed)])
            self._stats[0] -= len(lru["pages"])
            self._stats[3] += len(lru["pages"])
            del lru["parent"]["children"][lru["key"]]
        return freed

    def stats(self) -> dict[str, int]:
        vals = self._stats
        return {"cached_pages": vals[0], "hits": vals[1], "misses": vals[2],
                "evicted": vals[3]}
