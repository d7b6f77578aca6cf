"""Generational handle pools (counterpart of ``zrenderer_tpu/engine/pools.py``).

Resources are referenced by (index, generation) handles so a stale handle
is detected after its slot is destroyed or reused.  The pipeline cache
keeps one frame function per content key (the PSO-cache analog); on the
port a "pipeline" is a Python callable closing over the frame's static
sizes, so building one is cheap and nothing is compiled.  Pipelines made
by handle (``add_pipeline``: the Renderer's compute and mesh pipelines)
live in the same pool and are looked up and destroyed by that handle.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Optional

log = logging.getLogger("zrenderer_torch.pools")

MAX_POOL_SIZE = 256


@dataclass(frozen=True)
class Handle:
    index: int
    generation: int

    def is_null(self) -> bool:
        return self.generation == 0


NULL_HANDLE = Handle(0, 0)


class _Slot:
    __slots__ = ("payload", "generation")

    def __init__(self):
        self.payload = None
        self.generation = 0


class ResourcePool:
    """Fixed-capacity generational pool."""

    def __init__(self, capacity: int = MAX_POOL_SIZE, name: str = "resource"):
        self._slots = [_Slot() for _ in range(capacity)]
        self._name = name

    def add(self, payload: Any) -> Handle:
        for i, slot in enumerate(self._slots):
            if slot.payload is None:
                slot.payload = payload
                slot.generation += 1
                return Handle(i, slot.generation)
        raise RuntimeError(f"{self._name} pool exhausted ({len(self._slots)})")

    def is_valid(self, h: Handle) -> bool:
        return (
            not h.is_null()
            and 0 <= h.index < len(self._slots)
            and self._slots[h.index].generation == h.generation
            and self._slots[h.index].payload is not None
        )

    def lookup(self, h: Handle) -> Optional[Any]:
        return self._slots[h.index].payload if self.is_valid(h) else None

    def destroy(self, h: Handle) -> None:
        if self.is_valid(h):
            self._slots[h.index].payload = None

    def __len__(self) -> int:
        return sum(1 for s in self._slots if s.payload is not None)


class PipelineCache:
    """Content-key cache of frame functions with hit/miss counts."""

    def __init__(self):
        self._cache: dict = {}
        self._pool = ResourcePool(name="pipeline")
        self.hits = 0
        self.misses = 0

    def get_or_create(self, key, make: Callable[[], Any]):
        if key in self._cache:
            self.hits += 1
            return self._pool.lookup(self._cache[key])
        self.misses += 1
        log.info("pipeline cache miss for key %s", key)
        payload = make()
        self._cache[key] = self._pool.add(payload)
        return payload

    def add_pipeline(self, payload: Any) -> Handle:
        """Pool a pipeline by handle, outside the content-key cache."""
        return self._pool.add(payload)

    def lookup_pipeline(self, h: Handle) -> Optional[Any]:
        """The pipeline behind ``h``, or None for a stale handle."""
        return self._pool.lookup(h)

    def destroy_pipeline(self, h: Handle) -> None:
        """Free ``h``'s slot and drop every content key that points at it."""
        self._pool.destroy(h)
        for key, cached in list(self._cache.items()):
            if cached == h:
                del self._cache[key]

    def __len__(self) -> int:
        return len(self._cache)
