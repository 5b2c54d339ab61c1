"""Linear-probing hash tables with multiplicative hashing.

Copy of ``sparse_matrix_tpu/utils/linprobe.py``, the Python form of the
reference crate's ``linprobe`` (``linprobe/src/lib.rs``, ``set.rs``,
``map.rs``): the table design of the host library's hash SpGEMM
(``native/src/spmx_host.cpp``). The port's dict-loop SpGEMM
(``ops/spgemm_host.py``) runs :class:`LinProbeMap` beside its dict under the
debug flag to record probe-length histograms.

Design constants, as in the library:

* multiplicative hash ``h(k) = (k * 107) mod 2^32``
* power-of-two capacity, index = ``hash & (capacity - 1)``
* ``0xFFFF_FFFF`` is the empty-slot sentinel, hence keys must be < 2^32-1
* minimum capacity 16; grow at load factor 1/2
* ``shrink_to(n)`` narrows the *probed window* without freeing
* probe-length histograms behind a flag
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["mul_hash_u32", "LinProbeSet", "LinProbeMap", "MIN_CAPACITY", "EMPTY"]

HASH_MULTIPLIER = np.uint32(107)
MIN_CAPACITY = 16
EMPTY = 0xFFFFFFFF  # empty-slot sentinel


def mul_hash_u32(key) -> int:
    """h(k) = k * 107 mod 2^32 (``linprobe/src/lib.rs:13,17-32``)."""
    return int((np.uint64(key) * np.uint64(107)) & np.uint64(0xFFFFFFFF))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _capacity_for(n: int) -> int:
    # capacity = next_pow2(n) * 2, min 16 -> load factor <= 1/2
    return max(MIN_CAPACITY, _next_pow2(max(1, n)) * 2)


class LinProbeSet:
    """u32 set: flat array with EMPTY sentinel (``linprobe/src/set.rs``)."""

    def __init__(self, capacity_hint: int = 0, record_probes: bool = False):
        self._cap = _capacity_for(capacity_hint) if capacity_hint else MIN_CAPACITY
        self._slots = np.full(self._cap, EMPTY, dtype=np.uint32)
        self._window = self._cap  # probed window (shrink_to semantics)
        self._len = 0
        self.record_probes = record_probes
        self.probe_lengths: Dict[int, int] = {}

    def __len__(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return self._window

    def shrink_to(self, n: int) -> None:
        """Narrow the probed window to fit n keys without freeing storage
        (``linprobe/src/set.rs:55-64``); grows storage if needed."""
        want = _capacity_for(n)
        if want > self._cap:
            self._cap = want
            self._slots = np.full(self._cap, EMPTY, dtype=np.uint32)
            self._len = 0
        self._window = want
        # ensure current window is clean
        self._slots[: self._window] = EMPTY
        self._len = 0

    def clear(self) -> None:
        # refill the probed window only (linprobe/src/set.rs:71-74)
        self._slots[: self._window] = EMPTY
        self._len = 0

    def _maybe_grow(self) -> None:
        if (self._len + 1) * 2 > self._window:
            old = self._slots[: self._window]
            keys = old[old != EMPTY]
            self._window = self._window * 2
            if self._window > self._cap:
                self._cap = self._window
            self._slots = np.full(self._cap, EMPTY, dtype=np.uint32)
            self._len = 0
            rec, self.record_probes = self.record_probes, False
            for k in keys:
                self._insert_raw(int(k))
            self.record_probes = rec

    def insert(self, key: int) -> bool:
        """Insert; returns True if the key was new."""
        if key >= EMPTY:
            raise ValueError("keys must be < 0xFFFFFFFF (sentinel)")
        self._maybe_grow()
        return self._insert_raw(key)

    def _insert_raw(self, key: int) -> bool:
        mask = self._window - 1
        idx = mul_hash_u32(key) & mask
        probes = 0
        while True:
            cur = int(self._slots[idx])
            if cur == EMPTY:
                self._slots[idx] = key
                self._len += 1
                if self.record_probes:
                    self.probe_lengths[probes] = self.probe_lengths.get(probes, 0) + 1
                return True
            if cur == key:
                if self.record_probes:
                    self.probe_lengths[probes] = self.probe_lengths.get(probes, 0) + 1
                return False
            idx = (idx + 1) & mask
            probes += 1

    def __contains__(self, key: int) -> bool:
        mask = self._window - 1
        idx = mul_hash_u32(key) & mask
        while True:
            cur = int(self._slots[idx])
            if cur == EMPTY:
                return False
            if cur == key:
                return True
            idx = (idx + 1) & mask


class LinProbeMap:
    """u32 -> value map with fixed capacity, mirrored from
    ``linprobe/src/map.rs``: no grow path — callers pre-size from the symbolic
    phase's exact per-row counts, as ``mul_hash_numeric`` does
    (``spam_csr/src/mul_hash.rs:132-133``)."""

    def __init__(self, capacity: int, record_probes: bool = False):
        self._cap = _capacity_for(capacity)
        self._window = self._cap
        self._keys = np.full(self._cap, EMPTY, dtype=np.uint32)
        self._vals = np.zeros(self._cap, dtype=object)
        self._len = 0
        self.record_probes = record_probes
        self.probe_lengths: Dict[int, int] = {}

    def __len__(self) -> int:
        return self._len

    def shrink_to(self, n: int) -> None:
        want = _capacity_for(n)
        if want > self._cap:
            self._cap = want
            self._keys = np.full(self._cap, EMPTY, dtype=np.uint32)
            self._vals = np.zeros(self._cap, dtype=object)
        self._window = want
        self._keys[: self._window] = EMPTY
        self._len = 0

    def upsert(self, key: int, value, add) -> None:
        """entry(key).and_modify(add).or_insert(value)
        (``linprobe/src/map.rs:67-121``)."""
        if key >= EMPTY:
            raise ValueError("keys must be < 0xFFFFFFFF (sentinel)")
        mask = self._window - 1
        idx = mul_hash_u32(key) & mask
        probes = 0
        while True:
            cur = int(self._keys[idx])
            if cur == EMPTY:
                self._keys[idx] = key
                self._vals[idx] = value
                self._len += 1
                break
            if cur == key:
                self._vals[idx] = add(self._vals[idx], value)
                break
            idx = (idx + 1) & mask
            probes += 1
        if self.record_probes:
            self.probe_lengths[probes] = self.probe_lengths.get(probes, 0) + 1

    def get(self, key: int) -> Optional[object]:
        mask = self._window - 1
        idx = mul_hash_u32(key) & mask
        while True:
            cur = int(self._keys[idx])
            if cur == EMPTY:
                return None
            if cur == key:
                return self._vals[idx]
            idx = (idx + 1) & mask

    def drain(self):
        """Yield (key, value) in table order and clear the window
        (``linprobe/src/map.rs:59-64``)."""
        for idx in range(self._window):
            k = int(self._keys[idx])
            if k != EMPTY:
                yield k, self._vals[idx]
        self._keys[: self._window] = EMPTY
        self._len = 0
