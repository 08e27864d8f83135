"""Paged KV storage of the port (layouts, pool operations and the
host-side page allocator)."""
from repro_torch.paged.allocator import OutOfPages, PageAllocator

__all__ = ["OutOfPages", "PageAllocator"]
