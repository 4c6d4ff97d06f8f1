"""khashl-compatible open-addressing hash set (khashl-km.h semantics) and
klib's heap and k-small routines, a copy of
ropebwt3_tpu/align/khashl_compat.py for the Python BWA-SW DP (bwasw.py).

BWA-SW's top-N cell selection inserts candidate cells into a binary heap in
*hash-table iteration order*, so score ties are broken by bucket index
(bwa-sw.c:432-438).  Byte-identical PAF output therefore requires replicating
khashl exactly: splitmix64-truncated hashing, Fibonacci bucket mapping, linear
probing, 75% load factor, and the cuckoo-style kick-out rehash.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def kh_hash_uint64(x: int) -> int:
    x &= M64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & M64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & M64
    x ^= x >> 31
    return x & M32


def _h2b(hash_: int, bits: int) -> int:
    return ((hash_ * 2654435769) & M32) >> (32 - bits)


def _max_count(cap: int) -> int:
    return (cap >> 1) + (cap >> 2)


class KhashlSet:
    """Open-addressing set; keys are arbitrary objects with hash_fn/eq_fn."""

    def __init__(self, hash_fn, eq_fn):
        self.hash_fn = hash_fn
        self.eq_fn = eq_fn
        self.bits = 0
        self.count = 0
        self.keys: list = []
        self.used = bytearray()

    @property
    def n_buckets(self) -> int:
        return (1 << self.bits) if self.keys else 0

    def end(self) -> int:
        return self.n_buckets

    def clear(self) -> None:
        self.count = 0
        for i in range(len(self.used)):
            self.used[i] = 0

    def resize(self, new_n_buckets: int) -> int:
        j, x = 0, new_n_buckets
        while x >> 1:
            x >>= 1
            j += 1
        if new_n_buckets & (new_n_buckets - 1):
            j += 1
        new_bits = j if j > 2 else 2
        new_n = 1 << new_bits
        if self.count > _max_count(new_n):
            return 0
        new_used = bytearray(new_n)
        n_buckets = self.n_buckets
        if n_buckets < new_n:
            self.keys.extend([None] * (new_n - n_buckets))
        mask = new_n - 1
        for j2 in range(n_buckets):
            if not self.used[j2]:
                continue
            key = self.keys[j2]
            self.used[j2] = 0
            while True:  # kick-out process
                i = _h2b(self.hash_fn(key), new_bits)
                while new_used[i]:
                    i = (i + 1) & mask
                new_used[i] = 1
                if i < n_buckets and self.used[i]:
                    self.keys[i], key = key, self.keys[i]
                    self.used[i] = 0
                else:
                    self.keys[i] = key
                    break
        if n_buckets > new_n:
            del self.keys[new_n:]
        self.used = new_used
        self.bits = new_bits
        return 0

    def put(self, key, copy_on_insert: bool = False) -> tuple[int, bool]:
        """Returns (bucket, absent). On absent the key object (or its .copy()
        when copy_on_insert, saving a copy for the common present case) is
        stored."""
        n_buckets = self.n_buckets
        if self.count >= _max_count(n_buckets):
            self.resize(n_buckets + 1)
            n_buckets = 1 << self.bits
        mask = n_buckets - 1
        h = self.hash_fn(key)
        i = last = _h2b(h, self.bits)
        while self.used[i] and not self.eq_fn(self.keys[i], key):
            i = (i + 1) & mask
            if i == last:
                break
        if not self.used[i]:
            self.keys[i] = key.copy() if copy_on_insert else key
            self.used[i] = 1
            self.count += 1
            return i, True
        return i, False

    def get(self, key) -> int:
        n_buckets = self.n_buckets
        if n_buckets == 0:
            return 0
        mask = n_buckets - 1
        i = last = _h2b(self.hash_fn(key), self.bits)
        while self.used[i] and not self.eq_fn(self.keys[i], key):
            i = (i + 1) & mask
            if i == last:
                return n_buckets
        return n_buckets if not self.used[i] else i

    def __iter__(self):
        """kh_foreach order: bucket index ascending over occupied slots."""
        for i in range(self.n_buckets):
            if self.used[i]:
                yield i


def ks_heapup(heap: list, lt) -> None:
    """klib ks_heapup with comparator lt (max-heap when lt is <)."""
    k = len(heap) - 1
    tmp = heap[k]
    while k:
        i = (k - 1) >> 1
        if lt(tmp, heap[i]):
            break
        heap[k] = heap[i]
        k = i
    heap[k] = tmp


def ks_heapdown(heap: list, i: int, n: int, lt) -> None:
    k = i
    tmp = heap[i]
    while True:
        k = (k << 1) + 1
        if k >= n:
            break
        if k != n - 1 and lt(heap[k], heap[k + 1]):
            k += 1
        if lt(heap[k], tmp):
            break
        heap[i] = heap[k]
        i = k
    heap[i] = tmp


def ks_heapsort(heap: list, lt) -> None:
    for i in range(len(heap) - 1, 0, -1):
        heap[0], heap[i] = heap[i], heap[0]
        ks_heapdown(heap, 0, i, lt)


def ks_ksmall(arr: list, kk: int, lt=None) -> int:
    """klib ks_ksmall: k-th smallest under lt (default <) — quickselect."""
    if lt is None:
        lt = lambda a, b: a < b
    a = arr
    low, high, k = 0, len(a) - 1, kk
    while True:
        if high <= low:
            return a[k]
        if high == low + 1:
            if lt(a[high], a[low]):
                a[low], a[high] = a[high], a[low]
            return a[k]
        mid = low + (high - low) // 2
        if lt(a[high], a[mid]):
            a[mid], a[high] = a[high], a[mid]
        if lt(a[high], a[low]):
            a[low], a[high] = a[high], a[low]
        if lt(a[low], a[mid]):
            a[mid], a[low] = a[low], a[mid]
        a[mid], a[low + 1] = a[low + 1], a[mid]
        ll, hh = low + 1, high
        while True:
            ll += 1
            while lt(a[ll], a[low]):
                ll += 1
            hh -= 1
            while lt(a[low], a[hh]):
                hh -= 1
            if hh < ll:
                break
            a[ll], a[hh] = a[hh], a[ll]
        a[low], a[hh] = a[hh], a[low]
        if hh <= k:
            low = ll
        if hh >= k:
            high = hh - 1
