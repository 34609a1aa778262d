"""Exact per-structure memory accounting for every index.

The reference publishes memory for each index type (flat 488 MB, HNSW
634 MB / 1.30x, PQ 7.8 MB / 62.5x — /root/reference/docs/INDEX.md:1977-1990,
3984-3991) but offers no API to measure it. Here `memory_report(index)`
reflectively walks an index's instance state and tallies every numpy array
as HOST bytes and every jax.Array as DEVICE (HBM) bytes, grouped by the
top-level attribute that owns it — so the HNSW adjacency and seed lists,
the IVF chunk tables, PQ codes, BM25 postings, and metadata planes
all land on the record without each index hand-enumerating its buffers
(new buffers are counted the day they are added).

Attached to every index as `stats()["memory"]`; bench.py's memory rows
read these numbers. The tally covers ARRAY bytes (numpy + jax)
— Python-object overhead (dict/list/str structures, e.g. BM25's
incremental tf maps before their compiled-array cache builds) is not
estimated.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _is_device_array(x: Any) -> bool:
    # cheap structural check that avoids importing jax for host-only paths
    cls = type(x)
    mod = getattr(cls, "__module__", "") or ""
    return (
        mod.startswith("jax") or cls.__name__ == "ArrayImpl"
    ) and hasattr(x, "nbytes") and hasattr(x, "dtype")


_SCALARS = (str, bytes, int, float, bool, type(None))


def _scalar_like(v: Any) -> bool:
    """True when v cannot (transitively) hold an array worth counting: a
    plain scalar, or a list/tuple of scalars (probed by first element)."""
    if isinstance(v, _SCALARS):
        return True
    if isinstance(v, (list, tuple)) and v:
        return isinstance(v[0], _SCALARS)
    return False


def _children(obj: Any):
    """Yield the traversable members of a container/comet object.

    Large containers whose first elements are plain scalars are skipped
    wholesale: they cannot hold arrays (e.g. BM25's _doc_tokens — a
    million lists of strings), and walking them would turn a
    microsecond stats() call into seconds (code review r5)."""
    if isinstance(obj, dict):
        if len(obj) > 64:
            it = iter(obj.values())
            probe = [v for _, v in zip(range(4), it)]
            if all(_scalar_like(v) for v in probe):
                return
            yield from probe
            yield from it
            return
        yield from obj.values()
    elif isinstance(obj, (list, tuple, set, frozenset)):
        if len(obj) > 64:
            it = iter(obj)
            probe = [v for _, v in zip(range(4), it)]
            if all(_scalar_like(v) for v in probe):
                return
            yield from probe
            yield from it
            return
        yield from obj
    else:
        mod = getattr(type(obj), "__module__", "") or ""
        if mod.startswith("comet_tpu"):
            d = getattr(obj, "__dict__", None)
            if d is not None:
                yield from d.values()
            for slots_cls in type(obj).__mro__:
                for name in getattr(slots_cls, "__slots__", ()):
                    if hasattr(obj, name):
                        yield getattr(obj, name)


def _tally(obj: Any, host: dict, device: dict, key: str, seen: set) -> None:
    oid = id(obj)
    if oid in seen:
        return
    if isinstance(obj, np.ndarray):
        seen.add(oid)
        host[key] = host.get(key, 0) + int(obj.nbytes)
        return
    if _is_device_array(obj):
        seen.add(oid)
        try:
            device[key] = device.get(key, 0) + int(obj.nbytes)
        except Exception:
            pass  # deleted/donated buffers have no nbytes
        return
    if isinstance(obj, _SCALARS):
        return
    seen.add(oid)
    for child in _children(obj):
        _tally(child, host, device, key, seen)


def memory_report(index: Any) -> dict:
    """{"host": {attr: bytes}, "device": {attr: bytes},
    "host_total": int, "device_total": int} — exact array bytes, grouped by
    the index's top-level attribute names (leading underscores stripped).

    Shared arrays are counted once (identity-deduped), in the first
    attribute that reaches them."""
    host: dict[str, int] = {}
    device: dict[str, int] = {}
    seen: set[int] = set()
    d = getattr(index, "__dict__", None)
    items = list(d.items()) if d is not None else []
    for slots_cls in type(index).__mro__:
        for name in getattr(slots_cls, "__slots__", ()):
            if hasattr(index, name):
                items.append((name, getattr(index, name)))
    for name, value in items:
        _tally(value, host, device, name.lstrip("_"), seen)
    return {
        "host": host,
        "device": device,
        "host_total": sum(host.values()),
        "device_total": sum(device.values()),
    }


def fmt_mb(n: int) -> str:
    return f"{n / 1e6:,.1f} MB"
