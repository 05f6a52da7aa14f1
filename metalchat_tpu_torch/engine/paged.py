"""Paged KV host-side machinery: the free-list page allocator (port of the
JAX package's ``engine/paged.py``). The device-side pool and its write and
gather helpers live in ``metalchat_tpu_torch.cache``."""

from __future__ import annotations

from typing import Dict, List


class PageAllocator:
    """Host-side free-list page allocator (slot-level accounting). Pages are
    handed out lowest first and a freed slot's pages return in order."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_allocate(self, n: int) -> bool:
        return len(self._free) >= n

    def allocate(self, slot: int, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(f"out of KV pages (want {n}, free {len(self._free)})")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def free_slot(self, slot: int) -> None:
        self._free.extend(reversed(self._owned.pop(slot, [])))
