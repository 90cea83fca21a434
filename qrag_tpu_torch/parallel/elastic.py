"""Elastic sharded retrieval: failure detection and re-shard on fewer
slots (PyTorch port of ``qrag_tpu.parallel.elastic``).

The master copy of the corpus lives on the host (the index is
ingestion-owned data, not training state), so recovery is a re-shard,
not a restore.  On a failed call the whole mesh is probed first (a tiny
sum over every slot under a deadline); if it is unhealthy, each slot
gets its own probe and EXACTLY the unhealthy slots are evicted, in one
rebuild.  A failure with a healthy mesh is transient: the call is
retried without eviction, and only a repeated one drops a slot as a
last resort.

Failures are addressed by mesh SLOT (``Slot``: a number, a
``torch.device`` and the rank that owns it), where the reference
addresses a ``jax.Device``: one device may fill several slots here (the
CPU tests put 8 on ``cpu``), and a slot is what holds a shard.  The
test hooks (``inject_search_failure``, ``inject_device_failure``,
``inject_device_hang``) take slots.

Across processes (after ``mesh.distributed_init``) the index starts on
every rank's slots.  ``probe`` is a deadlined all-reduce over the
group; ``probe_device`` pings a slot of this rank as in one process,
and another rank's slot through that rank's heartbeat in the rendezvous
store (``mesh.peers_alive``; ``localize_failures`` reads every other
rank's heartbeat once, over one wait), so it names exactly the slots of
a dead rank.  Once a rank evicts anything from a mesh that
spans processes, it re-shards over its OWN surviving slots alone, from
the host master: each live rank then serves the whole corpus with no
collective over the broken group, whose teardown
(``destroy_process_group``) could wait on the dead peer and is never
called on this path.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

import torch.distributed as dist

from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.parallel import collectives
from qrag_tpu_torch.parallel.mesh import (
    local_device,
    make_mesh,
    mesh_devices,
    peers_alive,
    process_index,
)
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

logger = logging.getLogger(__name__)


class Slot(NamedTuple):
    """One mesh slot: its number, the device that holds it and the rank
    that owns it."""

    id: int
    device: torch.device
    rank: int = 0


def _put(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The probes' host -> device transfer (one place to stub it)."""
    return x.to(device)


def _run_with_deadline(fn: Callable[[], object], timeout_s: float):
    """Run ``fn`` on a daemon thread; return ``(ok, value, thread)``.

    A hung device call (what the probes exist to detect) must not hang
    the prober: the daemon thread is abandoned at the deadline and the
    caller gets its verdict on schedule.  The (possibly still running)
    thread is returned so callers can bound abandonment."""
    box: dict = {}

    def _target() -> None:
        try:
            box["value"] = fn()
        except Exception as e:  # noqa: BLE001 - any failure = unhealthy
            box["error"] = e

    t = threading.Thread(target=_target, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        return False, TimeoutError(f"probe exceeded {timeout_s}s deadline"), t
    if "error" in box:
        return False, box["error"], t
    return True, box.get("value"), t


class ElasticShardedIndex:
    """``ShardedFlatIndex`` wrapper that survives the loss of slots."""

    has_device_snapshot = False  # sharded family

    def __init__(
        self,
        vectors: Optional[np.ndarray] = None,
        devices: Optional[Sequence[Slot]] = None,
        probe_timeout_s: float = 30.0,
        probe_cache_ttl_s: float = 30.0,
        d: Optional[int] = None,
        metadata: Optional[Sequence[str]] = None,
        mesh_config: Optional[MeshConfig] = None,
        device=None,
        **index_kwargs,
    ):
        if vectors is None:
            if d is None:
                raise ValueError("need vectors or d")
            vectors = np.zeros((0, d), np.float32)
        self._vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self._metadata: List[str] = (
            [str(m) for m in metadata]
            if metadata is not None
            else [""] * self._vectors.shape[0]
        )
        index_kwargs.pop("mesh", None)  # elastic owns its mesh
        self._index_kwargs = index_kwargs
        self.probe_timeout_s = probe_timeout_s
        if devices is None:
            # one slot per slot of the configured grid (1 x S: re-sharding
            # shrinks the model axis); after distributed_init, every
            # rank's slots in rank order
            cfg = mesh_config or MeshConfig()
            dp, mp = cfg.data_parallel, cfg.model_parallel
            slots = dp * mp if dp > 0 and mp > 0 else 0
            if local_device() is not None:
                grid = make_mesh(MeshConfig(data_parallel=1, model_parallel=slots or -1),
                                 device=device)
                devices = [Slot(s, grid.devices.flat[s], grid.rank(0, s))
                           for s in range(grid.devices.size)]
            else:
                devices = [Slot(i, d) for i, d in enumerate(mesh_devices(device, slots))]
        self.devices: List[Slot] = list(devices)
        self.probe_cache_ttl_s = probe_cache_ttl_s
        self._failure_injector: Optional[Callable[[], None]] = None
        self._injected_bad: set = set()  # test hook: persistently-bad slots
        self._injected_hangs: dict = {}  # test hook: slot -> hang seconds
        # at most one live abandoned probe thread per target: a target
        # whose previous probe is still hung is reported unhealthy
        self._abandoned: dict = {}  # probe key -> still-running Thread
        # negative-verdict TTL cache: a slot that just failed is not
        # re-probed at full deadline cost on every recovery attempt
        self._probe_verdicts: dict = {}  # slot -> (False, monotonic ts)
        self._rebuilds = 0
        self._build(self.devices)

    def __getattr__(self, name):
        # engine-surface delegation (metadata, d, metric, topk_mode,
        # fallback_rows, sample_rows, save_*, ...) to the live index
        if name == "index":  # not yet built: avoid recursion
            raise AttributeError(name)
        return getattr(self.index, name)

    # ------------------------------------------------------------ lifecycle

    def _build(self, slots: Sequence[Slot]) -> None:
        spans = len({s.rank for s in slots}) > 1
        self.mesh = make_mesh(
            MeshConfig(data_parallel=1, model_parallel=len(slots)),
            devices=[s.device for s in slots],
            ranks=[s.rank for s in slots],
            group=dist.group.WORLD if spans else None,
        )
        self.index = ShardedFlatIndex(
            self._vectors if self._vectors.shape[0] else None,
            self.mesh,
            d=self._vectors.shape[1],
            metadata=self._metadata if self._vectors.shape[0] else None,
            **self._index_kwargs,
        )
        logger.info(
            "elastic index sharded over %d slots (rebuild #%d)",
            len(slots), self._rebuilds,
        )

    def add(self, vectors: np.ndarray, metadata: Optional[Sequence[str]] = None) -> int:
        """Append to the master copy AND the live index (the master is
        what re-shards after a failure)."""
        n = self.index.add(vectors, metadata)
        # the live index validated/normalized: mirror its canonical rows
        self._vectors = np.array(self.index._host_vectors)
        self._metadata = list(self.index.metadata)
        return n

    @classmethod
    def load_faiss(cls, path: str, **kwargs) -> "ElasticShardedIndex":
        from qrag_tpu_torch.index import faiss_io

        data, meta = faiss_io.read_flat_with_metadata(path)
        kwargs.setdefault("metric", data.metric)
        kwargs.pop("row_pad_multiple", None)
        return cls(data.vectors, metadata=meta, **kwargs)

    @classmethod
    def load_native(cls, directory: str, **kwargs) -> "ElasticShardedIndex":
        from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

        host = DeviceFlatIndex.load_native(directory, device="cpu")
        kwargs.setdefault("metric", host.metric)
        kwargs.pop("row_pad_multiple", None)
        idx = cls(host._host_vectors, metadata=host.metadata, **kwargs)
        idx.index.normalize = host.normalize
        return idx

    def layout(self) -> dict:
        lay = self.index.layout()
        lay["elastic"] = True
        lay["rebuilds"] = self._rebuilds
        lay["leaked_probe_threads"] = self.leaked_probe_threads
        return lay

    @property
    def leaked_probe_threads(self) -> int:
        """Live abandoned probe threads (each pinned on a hung call);
        at most one per probe target by construction."""
        return sum(1 for t in self._abandoned.values() if t.is_alive())

    @property
    def rebuilds(self) -> int:
        return self._rebuilds

    @property
    def ntotal(self) -> int:
        return self.index.ntotal

    # ------------------------------------------------------------ detection

    def _probe_with_deadline(self, key, fn) -> Tuple[bool, object]:
        """Deadlined probe with bounded thread abandonment: if the
        previous probe of ``key`` is still hung, report unhealthy at
        once instead of stacking another thread on the same target."""
        for stale in [k for k, t in self._abandoned.items() if not t.is_alive()]:
            del self._abandoned[stale]
        prev = self._abandoned.get(key)
        if prev is not None and prev.is_alive():
            return False, TimeoutError(f"previous probe of {key} still hung; not re-probing")
        ok, value, thread = _run_with_deadline(fn, self.probe_timeout_s)
        if thread.is_alive():
            self._abandoned[key] = thread
        return ok, value

    def probe(self) -> bool:
        """Whole-mesh health check (the fast path): a one on every slot
        of this rank, summed on its lead slot, then all-reduced over the
        group (a rank's group that lost a peer raises or hangs: either
        way unhealthy), under the deadline."""

        def _ping() -> float:
            if self._injected_bad & set(self.devices):
                raise RuntimeError("injected slot failure in mesh")
            local = [s for s in self.devices if s.rank == process_index()]
            lead = local[0].device
            ones = [_put(torch.ones((1,)), s.device) for s in local]
            total = sum(t.to(lead) for t in ones)
            return float(collectives.all_reduce(self.mesh, total).item())

        ok, value = self._probe_with_deadline("mesh", _ping)
        if not ok:
            logger.warning("mesh probe failed: %s", value)
            return False
        return value == len(self.devices)

    def probe_device(self, slot: Slot, _alive: Optional[dict] = None) -> bool:
        """Per-slot health probe under the same deadline: for a slot of
        this rank a tiny host -> device transfer and a reduction on its
        device; for another rank's slot, whether that rank's heartbeat
        still moves (``_alive``: {rank: verdict} already read by
        ``localize_failures``).  Unhealthy verdicts are cached for
        ``probe_cache_ttl_s``."""
        cached = self._probe_verdicts.get(slot)
        if cached is not None:
            verdict, ts = cached
            if time.monotonic() - ts < self.probe_cache_ttl_s:
                return verdict
            del self._probe_verdicts[slot]

        def _ping() -> float:
            if slot in self._injected_bad:
                raise RuntimeError(f"injected failure on {slot}")
            hang = self._injected_hangs.get(slot)
            if hang:
                time.sleep(hang)
            if slot.rank != process_index():
                alive = _alive if _alive is not None else peers_alive([slot.rank])
                if not alive[slot.rank]:
                    raise RuntimeError(f"rank {slot.rank}'s heartbeat stopped")
                return 8.0
            x = _put(torch.ones((8,), dtype=torch.float32), slot.device)
            return float(torch.sum(x).item())

        ok, value = self._probe_with_deadline(slot, _ping)
        if not ok:
            logger.warning("slot probe failed on %s: %s", slot, value)
            self._probe_verdicts[slot] = (False, time.monotonic())
            return False
        return value == 8.0

    def localize_failures(self) -> List[Slot]:
        """Probe every slot on its own; return the unhealthy ones.  The
        other ranks' heartbeats are read once for all their slots (one
        wait, under the deadline; a store that cannot be read fails
        them all)."""
        me = process_index()
        remote = sorted({s.rank for s in self.devices if s.rank != me})
        alive = {}
        if remote:
            ok, value = self._probe_with_deadline(("peers", tuple(remote)),
                                                  lambda: peers_alive(remote))
            if not ok:
                logger.warning("heartbeat read failed: %s", value)
            alive = value if ok else dict.fromkeys(remote, False)
        return [s for s in self.devices if not self.probe_device(s, alive)]

    # ------------------------------------------------------------- recovery

    def remove_devices(self, bad: Sequence[Slot]) -> None:
        """Drop slots and re-shard over the survivors: on a mesh that
        spans processes, over this rank's surviving slots alone."""
        bad_set = set(bad)
        survivors = [s for s in self.devices if s not in bad_set]
        if self.mesh.spans_processes:
            survivors = [s for s in survivors if s.rank == process_index()]
        if not survivors:
            raise RuntimeError("no healthy devices left")
        self.devices = survivors
        for s in bad_set:  # evicted slots are never probed again
            self._probe_verdicts.pop(s, None)
        self._rebuilds += 1
        self._build(survivors)

    def inject_search_failure(self, fn: Callable[[], None]) -> None:
        """Test hook: raise inside the next search (one-shot, transient —
        the mesh itself stays healthy)."""
        self._failure_injector = fn

    def inject_device_failure(self, slot: Slot) -> None:
        """Test hook: mark one slot persistently dead — searches fail
        while it is in the mesh, and its probe fails, so recovery must
        localize and evict exactly this slot."""
        self._injected_bad.add(slot)

    def inject_device_hang(self, slot: Slot, seconds: float) -> None:
        """Test hook: make this slot's probes HANG for ``seconds`` (past
        the deadline: the abandoned-thread path)."""
        self._injected_hangs[slot] = float(seconds)

    # --------------------------------------------------------------- search

    def _with_recovery(self, call: Callable[[], object], max_retries: int = 2):
        """Failure-triggered recovery around any device entry point: a
        whole-mesh probe; unhealthy -> per-slot probes evict exactly the
        dead slots in one rebuild; healthy -> retry without eviction
        (transient), and a repeated healthy-mesh failure drops one slot
        as a last resort."""
        last_err: Optional[Exception] = None
        healthy_failures = 0
        for attempt in range(max_retries + 1):
            try:
                if self._failure_injector is not None:
                    injector, self._failure_injector = self._failure_injector, None
                    injector()
                if self._injected_bad & set(self.devices):
                    raise RuntimeError(
                        f"injected slot failure: {self._injected_bad & set(self.devices)}"
                    )
                return call()
            except Exception as e:  # noqa: BLE001 - recovery contract
                last_err = e
                logger.warning("sharded call failed (attempt %d): %s", attempt + 1, e)
                if self.probe():
                    healthy_failures += 1
                    if healthy_failures == 1:
                        logger.info("mesh probes healthy; retrying without eviction")
                        continue
                    if len(self.devices) <= 1:
                        break
                    logger.warning("repeated failure with healthy probes; dropping one slot")
                    self.remove_devices([self.devices[-1]])
                    continue
                bad = self.localize_failures()
                if not bad:
                    # the mesh sum failed but every slot answers alone
                    bad = [self.devices[-1]]
                if len(bad) >= len(self.devices):
                    break  # nothing healthy to recover onto
                logger.warning("evicting %d unhealthy slot(s): %s", len(bad), bad)
                self.remove_devices(bad)
        raise RuntimeError("sharded call failed after recovery attempts") from last_err

    def search(self, queries: np.ndarray, k: int = 10, max_retries: int = 2):
        return self._with_recovery(lambda: self.index.search(queries, k=k), max_retries)

    def search_device(self, queries, k: int):
        return self._with_recovery(lambda: self.index.search_device(queries, k))

    def search_device_raw(self, queries, k: int):
        return self._with_recovery(lambda: self.index.search_device_raw(queries, k))

    def search_rerank_device(self, queries, k, candidates, n_qubits):
        return self._with_recovery(
            lambda: self.index.search_rerank_device(queries, k, candidates, n_qubits)
        )

    def search_rerank_routed_device(self, queries, route, k, candidates, n_qubits):
        return self._with_recovery(
            lambda: self.index.search_rerank_routed_device(
                queries, route, k, candidates, n_qubits
            )
        )
