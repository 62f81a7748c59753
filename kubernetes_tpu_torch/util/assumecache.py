"""Generic assume cache (pkg/scheduler/util/assumecache/assume_cache.go).

A copy of the JAX package's util/assumecache.py.  An informer-backed store
that lets the scheduler "assume" a newer version of an object before the
watch confirms it:

  * informer add / update events overwrite an entry only when the incoming
    ``resource_version`` is newer than the stored one (assume_cache.go:218-263:
    an older event is the watch catching up, so the assumed version wins);
  * ``assume(obj)`` installs a local version, which must carry the stored
    object's resource_version (the optimistic-concurrency precondition,
    :426-462);
  * ``restore(key)`` reverts an assumed entry to the latest API object (:464).

Objects expose ``.key`` and ``.resource_version``.  The scheduler's loop is
the only writer, so there is no lock.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, List, Optional, TypeVar

T = TypeVar("T")


class AssumeCacheError(Exception):
    pass


class _Entry(Generic[T]):
    __slots__ = ("latest_api_obj", "obj")

    def __init__(self, api_obj: T):
        self.latest_api_obj = api_obj  # the last object the informer delivered
        self.obj = api_obj  # what get() returns (assumed or API)


class AssumeCache(Generic[T]):
    def __init__(self, description: str = "") -> None:
        self.description = description
        self._entries: Dict[str, _Entry[T]] = {}

    def on_add(self, obj: T) -> None:
        if obj is None:
            return
        cur = self._entries.get(obj.key)
        if cur is not None and obj.resource_version <= cur.obj.resource_version:
            return  # stale or same-version redelivery keeps the stored object
        self._entries[obj.key] = _Entry(obj)

    def on_update(self, old: Optional[T], new: T) -> None:
        self.on_add(new)

    def on_delete(self, obj: T) -> None:
        if obj is not None:
            self._entries.pop(obj.key, None)

    def get(self, key: str) -> Optional[T]:
        e = self._entries.get(key)
        return e.obj if e else None

    def get_api_obj(self, key: str) -> Optional[T]:
        e = self._entries.get(key)
        return e.latest_api_obj if e else None

    def list(self, predicate: Optional[Callable[[T], bool]] = None) -> List[T]:
        out = [e.obj for e in self._entries.values()]
        return out if predicate is None else [o for o in out if predicate(o)]

    def __len__(self) -> int:
        return len(self._entries)

    def assume(self, obj: T) -> None:
        """Install a locally modified version of a stored object, which must
        carry the stored object's resource_version (assume_cache.go:426)."""
        e = self._entries.get(obj.key)
        if e is None:
            raise AssumeCacheError(f"{self.description}: {obj.key!r} not found")
        if obj.resource_version != e.obj.resource_version:
            raise AssumeCacheError(
                f"{self.description}: assume {obj.key!r} at version "
                f"{obj.resource_version}, cache has {e.obj.resource_version}"
            )
        e.obj = obj

    def restore(self, key: str) -> None:
        e = self._entries.get(key)
        if e is not None:
            e.obj = e.latest_api_obj
