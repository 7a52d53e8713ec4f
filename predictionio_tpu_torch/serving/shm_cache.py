"""Shared-memory result cache: ONE physical copy of the pool's hot set (a
copy of the JAX package's ``serving/shm_cache.py``).

The private :class:`~predictionio_tpu_torch.serving.result_cache.ResultCache`
replicates per worker what `pio deploy --workers N` should share: a key
warmed by worker A cold-starts again on workers B..N, and a `/reload`
re-warms N caches instead of one. A hit answers from host memory and
launches nothing on the card, in any worker. This module keeps the
ResultCache *interface* — ``lookup``/``put``/``invalidate``/
``invalidate_matching``/``snapshot``/``__len__``/``generation`` — but
backs it with one ``multiprocessing.shared_memory`` segment every
worker attaches, so ``engine_server``, the online overlay's per-user
invalidation, and ``/stats.json`` compose unchanged.

Layout (one segment, fixed geometry stamped in the header)::

    [header 4096 B] [user-tag column: nslots x u64] [nslots x slot_bytes]

    header: magic u64 | version u32 | nslots u32 | slot_bytes u32 | pad
            | generation u64 | last_reload u64 | epoch u64
    slot:   seq u64 | gen_stamp u64 | key_hash u64 | inserted_at f64
            | key_len u32 | val_len u32 | crc32 u32 | pad
            | key bytes | pickled value

Concurrency is a per-slot **seqlock**, not a lock: a writer bumps the
slot ``seq`` to odd, writes payload + crc32, then bumps it even; a
reader snapshots ``seq``, copies the payload, re-reads ``seq``, and
retries (bounded, then miss) on odd-or-changed. Readers therefore
NEVER block the writer — there is no cross-process mutex to convoy on,
and a worker killed -9 mid-write leaves exactly one slot odd (a
permanent miss until overwritten), never a wedged pool. Writer-writer
collisions on a slot are *benign*, not prevented: the crc32 over the
payload rejects any interleaved result at read time (slots are
direct-mapped by key hash, so two writers on one slot are already a
cache-collision overwrite).

**Memory-ordering assumption (x86-TSO).** The protocol issues no
explicit fences — CPython has no portable store barrier — and leans on
x86's total-store-order (stores become visible in program order;
loads are not reordered with older loads) plus the crc32 backstop.
What that buys and what it does not:

- Slot payloads can never be *served* torn on any architecture: a
  reordered or interleaved view fails the seq re-read or the crc/key
  check and reads as a miss (the hammer test's zero-torn criterion).
- The epoch fence's post-publish re-check vs ``invalidate_matching``'s
  bump-then-scan is a classic store-buffer litmus (each side stores
  then loads the other's word): on a machine that lets a load hop its
  own earlier store, both sides could read the pre-store value and a
  pre-fold result could theoretically survive per-user invalidation.
  x86-TSO forbids neither side's store-load reordering being hidden
  from the OTHER core's later loads in the order stored, and in
  CPython every one of these accesses brushes the GIL's own seq-cst
  handoffs, so the window is not observable in practice; on weakly
  ordered hosts (aarch64) it is real but bounded — a stale entry
  outlives the fence only until the key's TTL or next overwrite.
  Serializing the epoch word through an OS-level atomic (fcntl byte
  lock) would close it at the cost of a syscall per put; the TTL
  bound is the deliberate trade.

Invalidation is a stamp compare, not a broadcast:

- ``generation`` (header) rides the pool's shared reload sequence. A
  slot is live only while its ``gen_stamp`` equals the header
  generation, so ``invalidate()`` — `/reload` — is ONE u64 bump that
  stales every slot at once, applied once per reload sequence
  (``last_reload`` makes each sibling's sync-loop re-apply a no-op, so
  the worker that re-warms a key right after the handling worker's
  bump leaves it HOT for the whole pool). Once-per-sequence is
  best-effort, not exactly-once: the ``last_reload`` check-then-set is
  guarded only by each process's own ``threading.Lock``, so two
  siblings applying the SAME sequence truly concurrently can both pass
  the check and double-bump — over-invalidation (re-warmed keys stale
  again), never staleness. The guarantee that matters — the common
  sequential re-apply, each sibling's sync loop firing after the
  handling worker's bump, is a no-op — holds regardless.
- ``epoch`` (header) is the put-fence token ``lookup`` hands out and
  ``put`` checks — it bumps on EVERY invalidation event, including the
  per-user kind, so an in-flight computation started before the event
  can never land after it (the private cache's stale-``put`` guard,
  now pool-wide). ``put`` re-checks the epoch AFTER publishing and
  zaps its own slot on a lost race, closing the check-then-write
  window a cross-process cache cannot lock away.
- The epoch alone cannot fence a computation started AFTER a reload
  bump on a worker that has not yet swapped its own model: that
  worker's lookup would hand out a fresh token, and its old-model
  result would publish into the NEW generation and serve pool-wide
  (the private per-worker cache never had this hole — each worker's
  swap cleared exactly its own entries). ``model_generation_fn`` —
  the engine server wires it to its live ``model_generation`` — closes
  it: while the local model trails the segment's ``last_reload``,
  ``lookup`` hands out a poisoned token and ``put`` refuses to
  publish (pre-check AND post-publish re-check, same discipline as
  the epoch fence), so pre-swap results land nowhere and the worker
  resumes publishing the moment its own swap catches it up.
- ``invalidate_matching(fragment)`` — the online plane's per-user contract —
  reads the contiguous user-tag column (one u64 per slot: the hash of
  the ``"user":...`` fragment extracted from the canonical key at put
  time), zaps only matching slots, and leaves the generation alone:
  every other user's entries keep serving warm.

Values cross process boundaries as pickles. That is a same-host,
same-codebase trust domain (every attacher is a worker of THIS deploy,
spawned from the same binary) — do not point ``PIO_SERVING_SHM_SEGMENT``
at a segment other software writes.

TTL stamps use ``time.monotonic()`` (CLOCK_MONOTONIC), which is
system-wide per boot on Linux, so timestamps written by one worker are
comparable in another. An injected test clock is honored but only
meaningful single-process.

Everything degrades, nothing dies: a host without POSIX shared memory
(or a full /dev/shm) makes :func:`open_shm_cache` warn and return
``None``, and the engine server falls back to its private LRU.
"""

from __future__ import annotations

import hashlib
import logging
import pickle
import struct
import threading
import zlib
from typing import Any

from predictionio_tpu_torch.api.stats import ServingStats
from predictionio_tpu_torch.serving.result_cache import _MISS, user_fragment_of
from predictionio_tpu_torch.utils.resilience import SYSTEM_CLOCK, Clock

logger = logging.getLogger(__name__)

_MAGIC = 0x50494F5348_4D0001          # "PIOSHM" + layout version tag
_VERSION = 1
_HEADER_SIZE = 4096

#: header field offsets (u64 unless noted)
_OFF_MAGIC = 0
_OFF_VERSION = 8                      # u32
_OFF_NSLOTS = 12                      # u32
_OFF_SLOT_BYTES = 16                  # u32
_OFF_GENERATION = 24
_OFF_LAST_RELOAD = 32
_OFF_EPOCH = 40

#: slot header: seq, gen_stamp, key_hash, inserted_at, key_len,
#: val_len, crc32 (+4 pad so payload starts 8-aligned)
_SLOT_HDR = struct.Struct("<QQQdIII4x")
SLOT_OVERHEAD = _SLOT_HDR.size

#: bounded seqlock read retries before declaring a miss — the reader
#: never waits on the writer, it just stops trying
_READ_RETRIES = 3

#: the poisoned epoch token ``lookup`` hands out while this worker's
#: model trails the pool's reload sequence: the header epoch is a u64,
#: so -1 can never equal it and the eventual ``put`` is always fenced
_STALE_TOKEN = -1


def _hash64(data: bytes) -> int:
    """Stable 64-bit key/tag hash — processes must agree, so the
    PYTHONHASHSEED-salted builtin is out."""
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "little") or 1


class ShmResultCache:
    """ResultCache-compatible cache over one shared-memory segment.

    ``create='auto'`` attaches the named segment if it exists and
    creates it otherwise (two workers racing the creation resolve
    through FileExistsError -> attach); ``'create'``/``'attach'`` force
    one behavior. The creator owns the segment name: ``close()``
    unlinks only when ``owner`` (or when told explicitly), so pool
    workers detaching never destroy their siblings' cache.
    """

    def __init__(self, segment: str, nslots: int = 4096,
                 slot_bytes: int = 4096, ttl_s: float = 30.0,
                 stats: ServingStats | None = None,
                 clock: Clock = SYSTEM_CLOCK,
                 create: str = "auto"):
        from multiprocessing import shared_memory

        self.segment = segment
        self.ttl_s = ttl_s
        self.stats = stats or ServingStats()
        self._clock = clock
        #: the pool-reload put fence (module docstring): the engine
        #: server points this at its live ``model_generation`` so a
        #: worker that has not yet swapped after a sibling's /reload
        #: cannot publish old-model results into the new generation.
        #: None (bare handles, tests, single-process deploys where
        #: ``last_reload`` never moves) means no fence.
        self.model_generation_fn = None
        # serializes THIS process's threads; cross-process coordination
        # is the seqlock protocol itself (module docstring)
        self._lock = threading.Lock()
        nslots = max(8, int(nslots))
        slot_bytes = max(SLOT_OVERHEAD + 64, int(slot_bytes))
        size = _HEADER_SIZE + nslots * 8 + nslots * slot_bytes
        self.owner = False
        if create == "create":
            shm = shared_memory.SharedMemory(segment, create=True,
                                             size=size)
            self.owner = True
        elif create == "attach":
            shm = shared_memory.SharedMemory(segment)
        else:
            try:
                shm = shared_memory.SharedMemory(segment)
            except FileNotFoundError:
                try:
                    shm = shared_memory.SharedMemory(segment, create=True,
                                                     size=size)
                    self.owner = True
                except FileExistsError:   # lost the creation race
                    shm = shared_memory.SharedMemory(segment)
        self._shm = shm
        self._buf = shm.buf
        if self.owner:
            struct.pack_into("<QIII", self._buf, 0, _MAGIC, _VERSION,
                             nslots, slot_bytes)
            self.nslots, self.slot_bytes = nslots, slot_bytes
        else:
            # Python <3.13 registers ATTACHED segments with the
            # resource tracker too, which unlinks them when this
            # process exits — that would tear the pool's cache down
            # with the first worker to stop. De-register; the creator
            # (or the deploy CLI) owns cleanup.
            try:
                from multiprocessing import resource_tracker

                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:             # tracker drift across versions
                pass
            magic, version, got_nslots, got_slot_bytes = struct.unpack_from(
                "<QIII", self._buf, 0)
            if magic != _MAGIC or version != _VERSION:
                shm.close()
                raise ValueError(
                    f"segment {segment!r} is not a pio shm cache "
                    f"(magic {magic:#x}, version {version})")
            self.nslots, self.slot_bytes = got_nslots, got_slot_bytes
        self._tags_off = _HEADER_SIZE
        self._slots_off = _HEADER_SIZE + self.nslots * 8
        self.max_entries = self.nslots   # interface parity (snapshot)

    # ---- header words ---------------------------------------------------

    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self._buf, off)[0]

    def _set_u64(self, off: int, value: int) -> None:
        struct.pack_into("<Q", self._buf, off, value & (2**64 - 1))

    @property
    def generation(self) -> int:
        return self._u64(_OFF_GENERATION)

    @property
    def last_reload(self) -> int:
        """The highest pool reload sequence applied to the segment."""
        return self._u64(_OFF_LAST_RELOAD)

    def _worker_lags(self) -> bool:
        """True while THIS worker's model trails the pool's applied
        reload sequence — the window between a sibling's /reload bump
        and this worker's own model swap, when local computations are
        old-model results that must not publish (module docstring)."""
        fn = self.model_generation_fn
        return fn is not None and fn() < self._u64(_OFF_LAST_RELOAD)

    # ---- slot helpers ---------------------------------------------------

    def _slot_off(self, idx: int) -> int:
        return self._slots_off + idx * self.slot_bytes

    def _tag_off(self, idx: int) -> int:
        return self._tags_off + idx * 8

    def _zap(self, idx: int) -> None:
        """Kill one slot: bump its seq to odd (readers see
        write-in-progress forever) and clear its tag. The next put on
        the slot resumes the even/odd protocol from the bumped value."""
        off = self._slot_off(idx)
        seq = self._u64(off)
        self._set_u64(off, (seq + 1) | 1)
        self._set_u64(self._tag_off(idx), 0)

    # ---- ResultCache interface ------------------------------------------

    def get(self, key: str) -> Any:
        return self.lookup(key)[1]

    def lookup(self, key: str) -> tuple[bool, Any, int]:
        """(hit, value_or_MISS, epoch_token) — the token is the shared
        put-fence epoch, not the reload generation: callers thread it
        into :meth:`put` exactly like the private cache's triple."""
        key_b = key.encode("utf-8")
        key_hash = _hash64(key_b)
        idx = key_hash % self.nslots
        off = self._slot_off(idx)
        now = self._clock.monotonic()
        # the token must be read BEFORE the slot so it is conservative:
        # an invalidation between here and the payload copy makes the
        # eventual put stale, never fresh. A worker whose model trails
        # the pool's reload sequence gets a POISONED token: the miss it
        # is about to take would be recomputed with the OLD model, and
        # that result must never publish into the new generation (hits
        # are still served — live slots were stamped by caught-up
        # workers, so their values are new-model results)
        token = (_STALE_TOKEN if self._worker_lags()
                 else self._u64(_OFF_EPOCH))
        for _ in range(_READ_RETRIES):
            seq0 = self._u64(off)
            if seq0 & 1 or seq0 == 0:
                break                      # mid-write or never written
            (_, gen_stamp, slot_hash, inserted, key_len, val_len,
             crc) = _SLOT_HDR.unpack_from(self._buf, off)[0:7]
            if slot_hash != key_hash:
                break
            payload = bytes(self._buf[off + SLOT_OVERHEAD:
                                      off + SLOT_OVERHEAD + key_len
                                      + val_len])
            if self._u64(off) != seq0:
                continue                   # torn by a concurrent write
            if gen_stamp != self._u64(_OFF_GENERATION):
                break                      # staled by a /reload bump
            if self.ttl_s > 0 and now - inserted >= self.ttl_s:
                self.stats.bump("cache_expirations")
                break
            if zlib.crc32(payload) != crc or payload[:key_len] != key_b:
                break                      # torn write or hash collision
            try:
                value = pickle.loads(payload[key_len:])
            except Exception:
                break                      # truncated by a dying writer
            self.stats.bump("cache_hits")
            return True, value, token
        self.stats.bump("cache_misses")
        return False, _MISS, token

    def put(self, key: str, value: Any,
            generation: int | None = None) -> bool:
        """Publish; returns False (caching nothing) when the epoch
        token is stale, the value does not pickle, or the entry
        outsizes a slot."""
        key_b = key.encode("utf-8")
        try:
            val_b = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            return False                   # unpicklable -> just uncached
        if SLOT_OVERHEAD + len(key_b) + len(val_b) > self.slot_bytes:
            return False                   # oversized entry: not shareable
        key_hash = _hash64(key_b)
        idx = key_hash % self.nslots
        off = self._slot_off(idx)
        tag = user_fragment_of(key)
        tag_hash = _hash64(tag.encode("utf-8")) if tag else 0
        payload = key_b + val_b
        crc = zlib.crc32(payload)
        with self._lock:
            if (generation is not None
                    and generation != self._u64(_OFF_EPOCH)):
                return False               # computed before an invalidation
            if self._worker_lags():
                # this worker's model trails the pool's reload
                # sequence: the value was computed with the OLD model
                # (also catches direct puts that never took a token)
                return False
            seq0 = self._u64(off)
            if seq0 and not seq0 & 1:
                old_hash = _SLOT_HDR.unpack_from(self._buf, off)[2]
                if old_hash != key_hash:
                    self.stats.bump("cache_evictions")
            gen_stamp = self._u64(_OFF_GENERATION)
            # seqlock publish: odd -> payload -> even. No fsync, no
            # barrier calls: x86-TSO store order plus the crc make a
            # torn read detectable, never servable.
            self._set_u64(off, (seq0 + 1) | 1)
            _SLOT_HDR.pack_into(self._buf, off, (seq0 + 1) | 1,
                                gen_stamp, key_hash,
                                self._clock.monotonic(),
                                len(key_b), len(val_b), crc)
            self._buf[off + SLOT_OVERHEAD:
                      off + SLOT_OVERHEAD + len(payload)] = payload
            self._set_u64(self._tag_off(idx), tag_hash)
            self._set_u64(off, ((seq0 + 1) | 1) + 1)
            if ((generation is not None
                    and generation != self._u64(_OFF_EPOCH))
                    or self._worker_lags()):
                # an invalidation (or a sibling's reload bump this
                # worker has not swapped for) landed between the
                # pre-check and the publish: un-publish rather than
                # serve a fenced result
                self._zap(idx)
                return False
            return True

    def invalidate(self, generation: int | None = None) -> None:
        """One header bump stales every slot (stamp compare — no
        broadcast, no slot walk). With ``generation`` (the pool's
        shared reload sequence) the bump applies ONCE per sequence:
        the segment is shared, so the handling worker's bump already
        invalidated for every sibling, and each sibling's sync-loop
        re-apply must not re-stale the keys the pool just re-warmed.
        Once is best-effort across processes — ``self._lock`` only
        serializes this process's threads, so two siblings applying
        the same sequence truly concurrently can both pass the
        ``last_reload`` check and double-bump. That over-invalidates
        (keys warmed between the bumps stale again — the safe
        direction, never staleness), and the case the no-op exists
        for — each sibling's sync loop re-applying AFTER the handling
        worker's bump — is sequential and stays a no-op. Without
        ``generation`` (single-process ``/reload``, retrieval
        reconfig) every call is its own event."""
        with self._lock:
            if generation is not None:
                if generation <= self._u64(_OFF_LAST_RELOAD):
                    return                 # this reload already applied
                self._set_u64(_OFF_LAST_RELOAD, generation)
            self._set_u64(_OFF_GENERATION, self._u64(_OFF_GENERATION) + 1)
            self._set_u64(_OFF_EPOCH, self._u64(_OFF_EPOCH) + 1)
            self.stats.bump("cache_invalidations")

    def invalidate_matching(self, fragment: str) -> int:
        """Drop the slots tagged with ``fragment``'s user tag — the
        online plane's per-fold invalidation, proportional to one
        contiguous u64 column scan + the user's own slots, pool-wide.
        The epoch bumps FIRST so a racing put either sees the bump
        (pre-check / post-publish re-check) or publishes its tag in
        time for this scan to zap it — either way the pre-fold result
        dies. Non-user fragments fall back to a full key scan (the
        generic substring contract)."""
        import numpy as np

        with self._lock:
            self._set_u64(_OFF_EPOCH, self._u64(_OFF_EPOCH) + 1)
            doomed = 0
            if fragment.startswith('"user":'):
                tag_hash = _hash64(fragment.encode("utf-8"))
                tags = np.frombuffer(
                    bytes(self._buf[self._tags_off:self._slots_off]),
                    dtype="<u8")
                for idx in np.flatnonzero(tags == tag_hash):
                    if fragment in (self._slot_key(int(idx)) or ""):
                        self._zap(int(idx))
                        doomed += 1
            else:
                for idx in range(self.nslots):
                    key = self._slot_key(idx)
                    if key is not None and fragment in key:
                        self._zap(idx)
                        doomed += 1
            if doomed:
                self.stats.bump("cache_user_invalidations", doomed)
        return doomed

    def _slot_key(self, idx: int) -> str | None:
        """The canonical key a live slot holds (crc-checked), else
        None."""
        off = self._slot_off(idx)
        seq0 = self._u64(off)
        if seq0 == 0 or seq0 & 1:
            return None
        key_len, val_len, crc = _SLOT_HDR.unpack_from(self._buf, off)[4:7]
        payload = bytes(self._buf[off + SLOT_OVERHEAD:
                                  off + SLOT_OVERHEAD + key_len + val_len])
        if self._u64(off) != seq0 or zlib.crc32(payload) != crc:
            return None
        try:
            return payload[:key_len].decode("utf-8")
        except UnicodeDecodeError:
            return None

    def __len__(self) -> int:
        now = self._clock.monotonic()
        gen = self._u64(_OFF_GENERATION)
        live = 0
        for idx in range(self.nslots):
            off = self._slot_off(idx)
            seq = self._u64(off)
            if seq == 0 or seq & 1:
                continue
            gen_stamp, _, inserted = _SLOT_HDR.unpack_from(
                self._buf, off)[1:4]
            if gen_stamp != gen:
                continue
            if self.ttl_s > 0 and now - inserted >= self.ttl_s:
                continue
            live += 1
        return live

    def snapshot(self) -> dict:
        return {
            "size": len(self),
            "maxEntries": self.nslots,
            "ttlS": self.ttl_s,
            "generation": self.generation,
            "backend": "shm",
            "segment": self.segment,
            "slotBytes": self.slot_bytes,
        }

    # ---- lifecycle -------------------------------------------------------

    def close(self, unlink: bool | None = None) -> None:
        """Detach; unlink iff this handle created the segment (or the
        caller says so — the deploy CLI owns the pool's segment)."""
        do_unlink = self.owner if unlink is None else unlink
        try:
            self._buf.release()
        except Exception:
            pass
        try:
            self._shm.close()
        except Exception:
            pass
        if do_unlink:
            try:
                # an attach handle in THIS process (the deploy parent
                # is both segment owner and worker 0) already
                # de-registered the name; re-register so unlink()'s
                # own de-registration balances instead of KeyError-ing
                # in the tracker process
                from multiprocessing import resource_tracker

                resource_tracker.register(self._shm._name,
                                          "shared_memory")
            except Exception:
                pass
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass                       # a sibling already unlinked
            except Exception:
                logger.warning("shm segment %s unlink failed",
                               self.segment, exc_info=True)


def open_shm_cache(config: Any,
                   stats: ServingStats | None = None
                   ) -> ShmResultCache | None:
    """The engine server's entry: an attached/created cache per the
    ``PIO_SERVING_SHM_*`` config, or ``None`` with a warning when the
    platform can't (no /dev/shm, exhausted shm, bad segment) — the
    caller falls back to the private LRU, degrade-don't-die."""
    import os

    segment = config.shm_segment or f"pio-shm-{os.getpid()}"
    try:
        return ShmResultCache(
            segment, nslots=config.shm_slots,
            slot_bytes=config.shm_slot_bytes,
            ttl_s=config.cache_ttl_s, stats=stats)
    except Exception as exc:
        logger.warning(
            "shared-memory result cache unavailable (%s: %s); "
            "falling back to the private in-process LRU",
            type(exc).__name__, exc)
        return None
