"""Host-side page allocator with fragmentation accounting: a copy of
``repro.paged.allocator`` (pure Python; the port imports nothing of the
reference).

This is the control-plane twin of the device page pool: the serving engine
allocates/frees page indices here, and the KV-transformation benchmarks use
the same allocator to measure peak-page usage and fragmentation for the
Basic vs. header-centric migration strategies (paper Fig. 9b).

The paper's CUDA VMM (cuMemMap / cuMemUnmap on 2 MB pages) becomes: a fixed
pool of page slots; "mapping" = assigning a pool slot to (request, logical
page); "unmapping" = returning the slot to the free list.  Sub-page
occupancy (the "full of holes" state of Fig. 5b) is tracked per slot so we
can quantify trimming costs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


class OutOfPages(RuntimeError):
    pass


@dataclass
class PageAllocator:
    num_pages: int
    free: List[int] = field(default_factory=list)
    # request id -> ordered list of page slots
    tables: Dict[int, List[int]] = field(default_factory=dict)
    # slot -> fraction of the page actually occupied (1.0 = full)
    occupancy: Dict[int, float] = field(default_factory=dict)
    peak_used: int = 0

    def __post_init__(self):
        if not self.free:
            self.free = list(range(self.num_pages - 1, -1, -1))

    # ------------------------------------------------------------------
    @property
    def used(self) -> int:
        return self.num_pages - len(self.free)

    def _track_peak(self):
        self.peak_used = max(self.peak_used, self.used)

    def alloc(self, req_id: int, n: int = 1) -> List[int]:
        if len(self.free) < n:
            raise OutOfPages(f"need {n}, have {len(self.free)}")
        slots = [self.free.pop() for _ in range(n)]
        self.tables.setdefault(req_id, []).extend(slots)
        for s in slots:
            self.occupancy[s] = 1.0
        self._track_peak()
        return slots

    def free_request(self, req_id: int) -> int:
        slots = self.tables.pop(req_id, [])
        for s in slots:
            self.occupancy.pop(s, None)
            self.free.append(s)
        return len(slots)

    def shrink(self, req_id: int, keep_fraction: float) -> Tuple[int, float]:
        """Drop ``1-keep_fraction`` of each page of a request (a TP
        transformation keeps only the local head slice).

        Returns (pages_freed, holes): with a *header-centric* layout the
        freed fraction of every page is contiguous, so whole pages can be
        released immediately by block reshaping (``pages_freed`` > 0,
        ``holes`` == 0).  With token-first layouts the freed bytes are
        interleaved — nothing can be released without trimming
        (``holes`` = wasted page-fractions until a trim pass copies data).
        """
        slots = self.tables.get(req_id, [])
        for s in slots:
            self.occupancy[s] *= keep_fraction
        return 0, sum(1.0 - self.occupancy[s] for s in slots)

    def compact_headercentric(self, req_id: int, keep_fraction: float) -> int:
        """Header-centric in-place compaction: contiguous freed segments of
        adjacent pages coalesce into whole free pages (O(1) metadata ops per
        page, no data copies). Returns pages freed."""
        slots = self.tables.get(req_id, [])
        n_keep = max(1, round(len(slots) * keep_fraction)) if slots else 0
        freed = slots[n_keep:]
        self.tables[req_id] = slots[:n_keep]
        for s in self.tables.get(req_id, []):
            self.occupancy[s] = 1.0
        for s in freed:
            self.occupancy.pop(s, None)
            self.free.append(s)
        return len(freed)

    def trim(self, req_id: int) -> Tuple[int, int]:
        """Token-first trimming pass (the paper's Basic solution): copy the
        surviving bytes into fresh compact pages, then free the holey ones.
        Returns (pages_freed, bytes_copied_in_page_units*1000)."""
        slots = self.tables.get(req_id, [])
        if not slots:
            return 0, 0
        live = sum(self.occupancy[s] for s in slots)
        n_new = max(1, int(live + 0.999))
        # needs *extra* pages while copying (peak memory!)
        new_slots = [self.free.pop() for _ in range(min(n_new, len(self.free)))]
        if len(new_slots) < n_new:
            for s in new_slots:
                self.free.append(s)
            raise OutOfPages("trim needs headroom")
        self._track_peak()
        copied = int(live * 1000)
        for s in slots:
            self.occupancy.pop(s, None)
            self.free.append(s)
        self.tables[req_id] = new_slots
        for s in new_slots:
            self.occupancy[s] = 1.0
        return len(slots) - len(new_slots), copied
