"""Sharded flat index: corpus rows over the mesh's model axis, exact
top-k merge (PyTorch port of ``qrag_tpu.parallel.sharded_index``).

The (N, d) matrix is split by rows into S equal blocks, one per model
slot (replicated over the data axis); each slot scans its block with
the single-device selection of the index's ``topk_mode``, then the
per-shard (B, k) candidates merge exactly — k·S candidates per query,
no full-score exchange.  Queries split over the data axis.  A process
drives its own slots in turn, as the reference's controller does its
addressable devices; on a mesh that spans processes (after
``mesh.distributed_init``) every rank builds from the same full host
corpus, as the reference's processes do, uploads only its own slots'
rows, and reaches the other ranks' slots through ``collectives.py``.
Every rank gets the whole (B, k) result, as the reference's replicated
output.

Per shard:

  * "bounded": the provably-exact window scan (``ops.bounded_topk``,
    the packed window-scan kernel on a CUDA tensor) where the shard
    qualifies (>= 4096 rows, % 128, >= max(k, 16) windows), else the
    exact sort.  Queries stay f32 (or the store dtype with
    ``bounded_query_dtype="store"``); on an f32 store the shard's bf16
    scan copy is cast on every call, as the reference does.
  * "verified": a 16 x k candidate selection, the certificate with its
    tie check (``ops.topk``), the exact sort of the shard when a row
    fails.
  * "exact" / "approx": ``ops.topk``'s sort / candidate selection.

Merges (``merge``): "allgather" gathers every shard's candidates to
each rank (``collectives.all_gather``) and keeps the k best of the
shard-major concatenation by a stable sort; "ring" runs S-1 rounds in
which each slot folds its neighbour's travelling set into its own
(``collectives.ring_shift``: send to the next slot, receive from the
previous), ordering by (value desc, index asc) with two stable sorts
(the reference's ``lexsort``); a rank that holds no slot of a data row
receives the row's result by broadcast.  Every shard's
candidates are exact with ties to the lower index, and global ids grow
with the shard, so both merges give the single-device exact answer,
tie order included, and equal each other bit for bit.

``small_batch_accel`` builds the clustered accelerator per shard
(``ops.cluster_topk``) and merges its exact per-shard answers the same
way.  Candidate slots that hold no row carry -inf and the row id
``_PAD_IDX`` (past every shard), which the host edge maps to -1.

The counters (``fallback_rows``, ``bounded_escalations``, the
accelerator's) are summed over every slot of every rank, and the
cross-shard row gather is a masked local take plus one all-reduce (the
reference's ``psum``).  Across processes the index keeps its host
master: the streaming mode (``keep_host_master=False``) grows and
checkpoints the corpus slot to slot, which only one process can do.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.index import faiss_io
from qrag_tpu_torch.index.flat_index import (
    DeviceFlatIndex,
    METADATA_NAME,
    MANIFEST_NAME,
    SearchResult,
    VECTORS_NAME,
    _host_sqnorms,
)
from qrag_tpu_torch.ops.cluster_topk import _PAD_IDX
from qrag_tpu_torch.ops.topk import (
    DEFAULT_OVERSAMPLE,
    DEFAULT_RECALL_TARGET,
    _finalize,
    _goodness,
    _scan_topk_device,
    _verified_topk,
    top_k,
)
from qrag_tpu_torch.parallel import collectives
from qrag_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    row_sharded,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MODES = ("exact", "approx", "verified", "bounded")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _merge_candidates(acc_v, acc_i, new_v, new_i, k: int):
    """Exact (B, k) merge of two candidate sets by (value desc, global
    index asc): a stable sort by index, then a stable descending sort
    by value — the reference's ``lexsort((idx, -v))``."""
    comb_v = torch.cat([acc_v, new_v], dim=1)
    comb_i = torch.cat([acc_i, new_i], dim=1)
    by_idx = torch.sort(comb_i, dim=1, stable=True).indices
    comb_v, comb_i = comb_v.gather(1, by_idx), comb_i.gather(1, by_idx)
    order = torch.sort(comb_v, dim=1, descending=True, stable=True).indices[:, :k]
    return comb_v.gather(1, order), comb_i.gather(1, order)


def _pad_k(vals, idx, k: int):
    """Pad a (B, k') candidate set to k slots of (-inf, _PAD_IDX)."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, idx
    b = vals.shape[0]
    return (
        torch.cat([vals, vals.new_full((b, short), -torch.inf)], dim=1),
        torch.cat([idx, idx.new_full((b, short), _PAD_IDX)], dim=1),
    )


class ShardedFlatIndex:
    """Row-sharded device-resident flat index over a mesh of slots.

    Engine-compatible: the same ``add`` / ``search`` / ``sample_rows``
    / persistence surface as ``DeviceFlatIndex``.  Appends keep a host
    master copy and reach the shards lazily on the next query; with
    ``keep_host_master=False`` (streaming) the corpus lives only on the
    slots, capacity grows slot-side and ``sample_rows`` gathers there.

    Score contract: ``search_device`` returns FINALIZED scores (l2
    distances ascending, ip dots descending); ``search_device_raw``
    the raw descending goodness the rerank stages consume."""

    # the engine picks the sharded query arm on this flag
    has_device_snapshot = False
    row_pad_multiple = 128  # manifest field parity

    def __init__(
        self,
        vectors: Optional[np.ndarray] = None,
        mesh: Optional[Mesh] = None,
        metric: str = "l2",
        metadata: Optional[Sequence[str]] = None,
        topk_mode: str = "approx",
        store_dtype: str = "float32",
        merge: str = "allgather",
        d: Optional[int] = None,
        normalize: bool = False,
        keep_host_master: bool = True,
        bounded_query_dtype: str = "float32",
        small_batch_accel: str = "none",
        accel_max_batch: int = 16,
        cluster_group_rows: int = 512,
        cluster_budget: Optional[int] = None,
        accel_read_cap: float = 0.5,
        mesh_config: Optional[MeshConfig] = None,
        device=None,
    ):
        if metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if merge not in ("allgather", "ring"):
            raise ValueError(f"unknown merge strategy {merge!r}")
        if topk_mode not in _MODES:
            raise ValueError(
                f"sharded topk_mode {topk_mode!r}: expected one of {_MODES} "
                "(the engine serves 'refined' as 'approx')"
            )
        if small_batch_accel not in ("none", "clustered", "clustered_probe"):
            raise ValueError(f"unknown small_batch_accel {small_batch_accel!r}")
        if bounded_query_dtype not in ("float32", "store"):
            raise ValueError(f"unknown bounded_query_dtype {bounded_query_dtype!r}")
        if store_dtype not in _DTYPES:
            raise ValueError(f"unknown store_dtype {store_dtype!r}")
        self.mesh = mesh if mesh is not None else make_mesh(mesh_config, device=device)
        local = self.mesh.local_slots()
        if not local:
            raise ValueError("this rank holds no slot of the mesh")
        if self.mesh.spans_processes and not keep_host_master:
            raise ValueError("an index over several processes keeps its host master")
        self.device = self.mesh.device(*local[0])  # the lead local slot's
        self.small_batch_accel = small_batch_accel
        self.accel_max_batch = int(accel_max_batch)
        self.cluster_group_rows = int(cluster_group_rows)
        self.cluster_budget = cluster_budget
        self.accel_read_cap = float(accel_read_cap)
        self._accel_struct = None  # (per-column groups, rows_per, ntotal)
        self._cluster_assign = None  # no persisted assignment when sharded
        self.cluster_fallbacks = 0
        self.cluster_escalations = 0
        self.bounded_query_dtype = bounded_query_dtype
        if vectors is None:
            if d is None:
                raise ValueError("need vectors or d")
            vectors = np.zeros((0, d), np.float32)
        self.merge = merge
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        self.metric = metric
        self.topk_mode = topk_mode
        self.normalize = normalize
        self.use_pallas = False
        self.fallback_rows = 0  # bounded-mode exact full sorts, summed
        self.bounded_escalations = 0  # bounded-mode 4x-budget re-certs
        self._stats_lock = threading.Lock()
        self.d = int(d if d is not None else vectors.shape[1])
        self.store_dtype = _DTYPES[store_dtype]
        self._dp = self.mesh.shape[DATA_AXIS]
        self._mp = self.mesh.shape[MODEL_AXIS]
        self.keep_host_master = keep_host_master
        self._host_vectors = np.zeros((0, self.d), np.float32)
        self._ntotal = 0
        self.metadata: List[str] = []
        self._dirty = True
        # [data row][shard] -> (matrix, sqnorms, valid) on that slot
        self._shards: Optional[List[List[Tuple[torch.Tensor, ...]]]] = None
        self._dev_ntotal = 0
        self._capacity = 0
        # rows added since the last device build: within capacity the
        # next _ensure_device transfers ONLY these
        self._pending: List[np.ndarray] = []
        self._needs_full = True
        self._write_lock = threading.Lock()
        if vectors.shape[0]:
            self.add(vectors, metadata)

    @property
    def ntotal(self) -> int:
        return self._ntotal

    def add(
        self, vectors: np.ndarray, metadata: Optional[Sequence[str]] = None
    ) -> int:
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.d:
            raise ValueError(f"expected (*, {self.d}) vectors, got {vectors.shape}")
        if self.normalize:
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = np.where(norms > 0, vectors / np.where(norms > 0, norms, 1), vectors)
        if metadata is not None and len(metadata) != vectors.shape[0]:
            raise ValueError(
                f"metadata length {len(metadata)} != vectors {vectors.shape[0]}"
            )
        with self._write_lock:
            if self.keep_host_master:
                self._host_vectors = np.concatenate([self._host_vectors, vectors], axis=0)
            self._pending.append(vectors)
            self._ntotal += vectors.shape[0]
            if metadata is not None:
                self.metadata.extend(str(m) for m in metadata)
            else:
                self.metadata.extend([""] * vectors.shape[0])
            self._dirty = True
        return self.ntotal

    def sample_rows(self, rows: Sequence[int]) -> np.ndarray:
        if self.keep_host_master:
            return np.asarray(self._host_vectors[np.asarray(rows, dtype=np.int64)])
        # streaming mode: the corpus lives only on the slots; the gather
        # splits its batch over the data axis, so one row per data row
        idx = np.tile(np.asarray(rows, dtype=np.int64)[None, :], (self._dp, 1))
        return self.gather_rows_device(torch.from_numpy(idx))[0].cpu().numpy()

    def layout(self) -> dict:
        """Shard layout for /stats — from the padding formula and build
        state, never by touching the shards (no upload)."""
        mp = self._mp
        npad = self._capacity or (
            _round_up(max(self.ntotal, mp), mp * 128) if self.ntotal else 0
        )
        return {
            "sharded": True,
            "mesh": {DATA_AXIS: self._dp, MODEL_AXIS: mp},
            "merge": self.merge,
            "rows_per_shard": npad // mp if mp else 0,
            "devices": int(self.mesh.devices.size),
            "host_master": self.keep_host_master,
        }

    # ------------------------------------------------------------------
    # shard residency
    # ------------------------------------------------------------------

    @property
    def _rows_per(self) -> int:
        return self._capacity // self._mp

    def _place(self, j: int, parts: Tuple[torch.Tensor, ...]) -> None:
        """Publish shard j's buffers on every slot of its column that
        this rank owns; a slot on the same device shares the tensors."""
        for i in range(self._dp):
            if self.mesh.is_local(i, j):
                self._shards[i][j] = tuple(t.to(self.mesh.device(i, j)) for t in parts)

    def _col_shard(self, j: int) -> Optional[Tuple[torch.Tensor, ...]]:
        """Shard j's (matrix, sqnorms, valid) on this rank's first slot
        of column j; None when another rank owns the column."""
        for row in self._shards:
            if row[j] is not None:
                return row[j]
        return None

    def _new_grid(self) -> None:
        self._shards = [[None] * self._mp for _ in range(self._dp)]

    def _ensure_device(self) -> None:
        if not self._dirty and self._shards is not None:
            return
        with self._write_lock:
            if not self._dirty and self._shards is not None:
                return
            mp = self._mp
            n = self.ntotal
            needed = _round_up(max(n, mp), mp * 128)
            if self._shards is not None and not self._needs_full and self._pending:
                new_rows = np.concatenate(self._pending, axis=0)
                if needed > self._capacity:
                    if not self.keep_host_master:
                        self._grow_device_locked(needed)
                    else:
                        self._full_upload_locked(n, needed)
                        return
                self._append_pending_locked(new_rows)
                return
            if not self.keep_host_master and self._shards is None:
                # streaming first build: empty capacity, then the
                # pending chunks — the host never holds the corpus
                if needed > self._capacity:
                    self._capacity = _round_up(max(needed, 2 * self._capacity), mp * 128)
                self._alloc_device_locked()
                if self._pending:
                    self._append_pending_locked(np.concatenate(self._pending, axis=0))
                else:
                    self._dirty = False
                self._needs_full = False
                return
            self._full_upload_locked(n, needed)

    def _full_upload_locked(self, n: int, needed: int) -> None:
        if not self.keep_host_master:
            raise RuntimeError(
                "full re-shard requires the host master copy "
                "(keep_host_master=False streaming index cannot rebuild)"
            )
        mp = self._mp
        if needed > self._capacity:
            if self._capacity:
                cap = max(needed, self._capacity * 2)
            else:
                # first build: headroom so early appends stay incremental
                cap = needed + max(needed // 4, mp * 128)
            self._capacity = _round_up(cap, mp * 128)
        padded = np.zeros((self._capacity, self.d), np.float32)
        padded[:n] = self._host_vectors
        valid = np.zeros((self._capacity,), bool)
        valid[:n] = True
        # sqnorms in f32 from the master copy (the reference's formula)
        mats, sqs, vls = (
            row_sharded(self.mesh, torch.from_numpy(padded).to(self.store_dtype)),
            row_sharded(self.mesh, torch.from_numpy(_host_sqnorms(padded))),
            row_sharded(self.mesh, torch.from_numpy(valid)),
        )
        # [data row][shard] -> (matrix, sqnorms, valid); None on a slot
        # another rank owns
        self._shards = [
            [None if m is None else (m, q, v) for m, q, v in zip(*row)]
            for row in zip(mats, sqs, vls)
        ]
        self._dev_ntotal = n
        self._accel_struct = None
        self._dirty = False
        self._pending = []
        self._needs_full = False

    def _alloc_device_locked(self) -> None:
        """Zero-filled shard buffers of the current capacity."""
        rp = self._rows_per
        self._new_grid()
        for j in range(self._mp):
            dev = self.mesh.device(0, j)
            self._place(j, (
                torch.zeros((rp, self.d), dtype=self.store_dtype, device=dev),
                torch.zeros((rp,), dtype=torch.float32, device=dev),
                torch.zeros((rp,), dtype=torch.bool, device=dev),
            ))
        self._dev_ntotal = 0

    def _slot_rows(self, lo: int, hi: int, dev, shards=None, rp=None):
        """Global rows [lo, hi) of the shards' (matrix, sqnorms, valid)
        (of data row 0, or of ``shards`` split ``rp`` rows a shard),
        concatenated on ``dev`` (slot-to-slot copies, no host)."""
        shards = self._shards[0] if shards is None else shards
        rp = self._rows_per if rp is None else rp
        parts = []
        for j in range(lo // rp, -(-hi // rp)):
            a, b = max(lo, j * rp) - j * rp, min(hi, (j + 1) * rp) - j * rp
            parts.append(tuple(t[a:b].to(dev) for t in shards[j]))
        return tuple(torch.cat(ts) for ts in zip(*parts))

    def _grow_device_locked(self, needed: int) -> None:
        """Slot-side capacity growth (streaming mode): every shard's
        rows move into bigger buffers — the corpus never crosses to the
        host."""
        mp = self._mp
        new_cap = _round_up(
            max(needed, self._capacity * 2 if self._capacity else needed), mp * 128
        )
        old, old_rp, n = self._shards[0], self._rows_per, self._dev_ntotal
        self._capacity = new_cap
        rp = self._rows_per
        grown = []
        for j in range(mp):
            dev = self.mesh.device(0, j)
            m = torch.zeros((rp, self.d), dtype=self.store_dtype, device=dev)
            s = torch.zeros((rp,), dtype=torch.float32, device=dev)
            v = torch.zeros((rp,), dtype=torch.bool, device=dev)
            lo, hi = j * rp, min(n, (j + 1) * rp)
            if hi > lo:
                om, os_, ov = self._slot_rows(lo, hi, dev, old, old_rp)
                m[: hi - lo], s[: hi - lo], v[: hi - lo] = om, os_, ov
            grown.append((m, s, v))
        self._new_grid()
        for j, parts in enumerate(grown):
            self._place(j, parts)
        self._accel_struct = None

    def _append_pending_locked(self, new_rows: np.ndarray) -> None:
        """Incremental append: only the new rows cross to the slots, into
        COPIES of the shards they land in — concurrent readers may still
        hold the previous generation."""
        start, n_new = self._dev_ntotal, new_rows.shape[0]
        if start + n_new > self._capacity:
            if self.keep_host_master:
                self._full_upload_locked(
                    self.ntotal, _round_up(max(self.ntotal, self._mp), self._mp * 128)
                )
                return
            self._grow_device_locked(start + n_new)
        rp = self._rows_per
        end = start + n_new
        sq = _host_sqnorms(new_rows)
        for j in range(start // rp, -(-end // rp)):
            shard = self._col_shard(j)
            if shard is None:  # another rank appends to its own shards
                continue
            lo, hi = max(start, j * rp), min(end, (j + 1) * rp)
            m, s, v = (t.clone() for t in shard)
            dev = m.device
            a, b = lo - j * rp, hi - j * rp
            m[a:b] = torch.from_numpy(new_rows[lo - start : hi - start]).to(dev, m.dtype)
            s[a:b] = torch.from_numpy(sq[lo - start : hi - start]).to(dev)
            v[a:b] = True
            self._place(j, (m, s, v))
        self._dev_ntotal = self.ntotal
        self._accel_struct = None
        self._dirty = False
        self._pending = []
        self._needs_full = False

    # ------------------------------------------------------------------
    # the small-batch clustered accelerator, per shard
    # ------------------------------------------------------------------

    def _accel_eligible(self, batch: int, k: int) -> bool:
        """Route this batch through the sharded clustered accelerator?
        The thresholds are the unsharded ones over the whole corpus (the
        last shards hold the capacity padding); the read cap is per
        shard, over the queries each data row sees."""
        if (
            self.small_batch_accel not in ("clustered", "clustered_probe")
            or batch > self.accel_max_batch
            or self.ntotal == 0
        ):
            return False
        L = self.cluster_group_rows
        if not (self.ntotal >= max(4096, 4 * L) and self.ntotal // L >= max(2 * k, 8)):
            return False
        if not self.accel_read_cap:
            return True
        from qrag_tpu_torch.ops.cluster_topk import _auto_budget

        s_budget = self.cluster_budget or _auto_budget(k, L)
        eff_batch = -(-batch // max(self._dp, 1))
        return eff_batch * s_budget * L <= max(self.ntotal // self._mp, 1) * (
            self.accel_read_cap
        )

    def build_clustered(self):
        """Build (or fetch the cached) per-shard clustered structures
        (``ops.cluster_topk``), each on its shard's slots.  Search
        routing builds it lazily; ``QragEngine.warmup`` eagerly.  A
        shard that capacity padding left rowless holds None."""
        from qrag_tpu_torch.ops.cluster_topk import build_clustered_groups

        self._ensure_device()
        if self._accel_struct is not None and self._accel_struct[2] == self.ntotal:
            return self._accel_struct
        rp = self._rows_per
        per = []
        for j in range(self._mp):
            lo, hi = j * rp, min(self.ntotal, (j + 1) * rp)
            shard = self._col_shard(j)
            if hi <= lo or shard is None:  # no rows, or another rank's
                per.append(None)
                continue
            m, s, _ = shard
            # scoring norms: the shard's master-f32 sqnorms, the same
            # refine function as the plain sharded scan
            g = build_clustered_groups(
                m[: hi - lo], group_rows=self.cluster_group_rows, sqnorms=s[: hi - lo]
            )
            per.append(g)
        self._accel_struct = (per, rp, self.ntotal)
        return self._accel_struct

    def _accel_search_device(self, queries: torch.Tensor, k: int):
        """Raw sharded accelerator search (goodness, global idx); its
        (fell_back, escalated) counts wait for ``search``."""
        from qrag_tpu_torch.ops.cluster_topk import _auto_budget, cluster_pruned_topk

        per, rp, _ = self.build_clustered()
        budget = self.cluster_budget or _auto_budget(k, self.cluster_group_rows)
        stats = [0, 0]

        def local(q, i, j):
            g = per[j]
            if g is None:  # no rows: _per_slot pads the empty set
                b = q.shape[0]
                return q.new_empty((b, 0)), torch.empty((b, 0), dtype=torch.int64, device=q.device)
            dev = self.mesh.device(i, j)
            if g.corpus_p.device != dev:
                g = type(g)(*(t.to(dev) if torch.is_tensor(t) else t for t in g))
            kl = min(k, int(g.valid_p.sum()))
            vals, idx, fb, esc = cluster_pruned_topk(
                q, g, kl, metric=self.metric, budget=budget,
                certify=self.small_batch_accel != "clustered_probe",
            )
            stats[0] += int(fb)
            stats[1] += int(esc)
            return vals, idx

        out = self._per_slot(queries.to(torch.float32), k, local)
        fb, esc = self._summed(stats)
        with self._stats_lock:
            self.cluster_fallbacks += fb
            self.cluster_escalations += esc
        return out

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _local_search(self, q: torch.Tensor, shard, k: int, stats: list):
        """One slot's raw (goodness, shard-local idx) in the index's mode."""
        x, sq, vl = shard
        nl = x.shape[0]
        kl = min(k, nl)
        mode = self.topk_mode
        if mode == "bounded":
            from qrag_tpu_torch.ops.bounded_topk import (
                WINDOW,
                bounded_exact_topk,
                window_maxnorms_device,
            )
            from qrag_tpu_torch.ops.window_scan import make_lane_rank, pad_cols

            if nl >= 4096 and nl % WINDOW == 0 and nl // WINDOW >= max(kl, 16):
                # the bf16 scan copy, cast per call on an f32 store
                scan = pad_cols(x.to(torch.bfloat16), _round_up(self.d, 16)).contiguous()
                vals, idx, fb, _, esc = bounded_exact_topk(
                    q, scan, x, sq, window_maxnorms_device(sq),
                    make_lane_rank(nl, x.device), kl,
                    metric=self.metric, valid_rows=vl,
                )
                stats[0] += int(fb)
                stats[1] += int(esc)
                return vals, idx
            return top_k(_goodness(q, x, self.metric, sq, vl), kl)
        if mode == "verified":
            kk = min(16 * kl, nl)
            if kk * 8 >= nl:  # small shard: the sort
                return top_k(_goodness(q, x, self.metric, sq, vl), kl)
            vals, idx, _ = _verified_topk(q, x, sq, vl, kl, self.metric, 16)
            return vals, idx
        vals, idx, _ = _scan_topk_device(
            q, x, sq, vl, kl, self.metric, mode, DEFAULT_OVERSAMPLE, DEFAULT_RECALL_TARGET
        )
        return vals, idx

    def _per_slot(self, queries: torch.Tensor, k: int, local):
        """Run ``local(q_i, i, j)`` -> shard-local (vals, idx) on every
        slot of this rank, globalize the ids and merge each data row over
        the model axis; every row's result, concatenated on this rank's
        lead slot."""
        b = queries.shape[0]
        if b % self._dp:
            raise ValueError(
                f"batch {b} is not a multiple of the data axis ({self._dp}); "
                "search() pads it"
            )
        rp, bl = self._rows_per, b // self._dp
        sets = {}
        for i, j in self.mesh.local_slots():
            q = queries[i * bl : (i + 1) * bl].to(self.mesh.device(i, j))
            vals, idx = local(q, i, j)
            vals, idx = _pad_k(vals, idx.to(torch.int64), k)
            gidx = torch.where(
                torch.isneginf(vals) | (idx >= _PAD_IDX), _PAD_IDX, idx + j * rp
            )
            sets[(i, j)] = (vals, gidx)
        rows = self._merge_ring(sets, k) if self.merge == "ring" else self._merge_gathered(sets, k)
        return torch.cat([v for v, _ in rows]), torch.cat([ix for _, ix in rows])

    def _merge_gathered(self, sets, k: int):
        """allgather: every slot's candidates on this rank, the k best of
        each row's shard-major concatenation (positional = lower id)."""
        mesh = self.mesh
        vals = collectives.all_gather(mesh, {s: v for s, (v, _) in sets.items()}, self.device)
        idx = collectives.all_gather(mesh, {s: ix for s, (_, ix) in sets.items()}, self.device)
        rows = []
        for i in range(self._dp):
            comb_v = torch.cat([vals[(i, j)] for j in range(self._mp)], dim=1)
            comb_i = torch.cat([idx[(i, j)] for j in range(self._mp)], dim=1)
            v, sel = top_k(comb_v, k)
            rows.append((v, comb_i.gather(1, sel)))
        return rows

    def _merge_ring(self, sets, k: int):
        """ring: each slot folds the ORIGINAL per-shard sets travelling
        around its row's ring into its accumulator — a (B, 2k) working
        set per step instead of allgather's (B, S k); after S-1 steps
        every slot of the row holds the row's result."""
        mesh = self.mesh
        acc, trav = dict(sets), dict(sets)
        for _ in range(self._mp - 1):
            trav = collectives.ring_shift(mesh, trav)
            acc = {s: _merge_candidates(*acc[s], *trav[s], k) for s in acc}
        every = {mesh.rank(i, j) for i in range(self._dp) for j in range(self._mp)}
        like_v, like_i = next(iter(sets.values()))
        rows = []
        for i in range(self._dp):
            mine = [s for s in acc if s[0] == i]
            v, ix = acc[mine[0]] if mine else (torch.empty_like(like_v), torch.empty_like(like_i))
            if {mesh.rank(i, j) for j in range(self._mp)} != every:
                # a rank without a slot of this row: the row's lead sends it
                v = collectives.broadcast(mesh, v.to(self.device), mesh.rank(i, 0))
                ix = collectives.broadcast(mesh, ix.to(self.device), mesh.rank(i, 0))
            rows.append((v.to(self.device), ix.to(self.device)))
        return rows

    def _summed(self, stats) -> Tuple[int, int]:
        """A (fell_back, escalated) pair summed over every rank."""
        if not self.mesh.spans_processes:
            return tuple(stats)
        t = collectives.all_reduce(
            self.mesh, torch.tensor(stats, dtype=torch.int64, device=self.device)
        )
        return tuple(int(c) for c in t.tolist())

    def search_device_raw(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Raw per-query goodness (descending; l2 goodness = -d^2) and
        global row ids on the lead slot — the fused rerank's form.
        Bounded mode keeps queries f32 unless
        ``bounded_query_dtype="store"``; the scan modes cast them to the
        store dtype."""
        self._ensure_device()
        if self._accel_eligible(queries.shape[0], k):
            return self._accel_search_device(queries, k)
        keep_f32 = self.topk_mode == "bounded" and self.bounded_query_dtype == "float32"
        q = queries.to(torch.float32 if keep_f32 else self.store_dtype)
        stats = [0, 0]
        out = self._per_slot(
            q, k, lambda qi, i, j: self._local_search(qi, self._shards[i][j], k, stats)
        )
        # (fell_back, escalated) summed over every slot of every rank,
        # counted by the call that made them (search and rerank alike)
        fb, esc = self._summed(stats)
        with self._stats_lock:
            self.fallback_rows += fb
            self.bounded_escalations += esc
        return out

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-level search with ``DeviceFlatIndex.search_device``'s
        score semantics: l2 distances ascending, ip dots descending."""
        vals, idx = self.search_device_raw(queries, k)
        return _finalize(vals, idx, self.metric)

    def gather_rows_device(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows by global id across shards: each slot contributes the
        rows its shard owns (a masked local take) into its data row's
        block, and one all-reduce over the ranks sums the contributions
        (the reference's ``psum``).  (B, C) -> (B, C, d) f32 on every
        rank; an id no shard owns gives a zero row."""
        self._ensure_device()
        rp = self._rows_per
        idx = idx.to(torch.int64)
        bl = idx.shape[0] // self._dp
        out = torch.zeros(tuple(idx.shape) + (self.d,), dtype=torch.float32, device=self.device)
        for i, j in self.mesh.local_slots():
            part = idx[i * bl : (i + 1) * bl].to(self.mesh.device(i, j))
            x = self._shards[i][j][0]
            local = part - j * rp
            owned = (local >= 0) & (local < rp)
            take = x[local.clamp(0, rp - 1)].to(torch.float32)
            out[i * bl : (i + 1) * bl] += torch.where(owned[..., None], take, 0.0).to(self.device)
        return collectives.all_reduce(self.mesh, out)

    def _rerank(self, queries, k, candidates, n_qubits, route_quantum=None):
        """The merged top-C, the candidates' rows gathered across shards,
        the analytic fidelity (or, per ``route_quantum`` row, the
        cosine), the final top-k; retrieval scores finalized."""
        from qrag_tpu_torch.ops.statevector import fidelity_analytic

        retr, idx = self.search_device_raw(queries, candidates)
        cand = self.gather_rows_device(idx)  # (B, C, d)
        q32 = queries.to(self.device, torch.float32)
        scores = fidelity_analytic(q32[:, None, :], cand, n_qubits)
        if route_quantum is not None:
            qn = q32 / torch.linalg.norm(q32, dim=-1, keepdim=True).clamp_min(1e-12)
            cn = cand / torch.linalg.norm(cand, dim=-1, keepdim=True).clamp_min(1e-12)
            cos = torch.einsum("bd,bcd->bc", qn, cn)
            scores = torch.where(route_quantum.to(self.device)[:, None], scores, cos)
        scores = torch.where(torch.isneginf(retr), -torch.inf, scores)
        top, sel = top_k(scores, k)
        sel_idx = idx.gather(1, sel)
        return top, sel_idx, _finalize(retr.gather(1, sel), sel_idx, self.metric)[0]

    def search_rerank_device(
        self, queries: torch.Tensor, k: int, candidates: int, n_qubits: int
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sharded retrieval -> quantum fidelity rerank.  Retrieval
        scores come back finalized, as ``engine.fused_search_rerank``'s
        third output."""
        return self._rerank(queries, k, candidates, n_qubits)

    def search_rerank_routed_device(
        self,
        queries: torch.Tensor,
        route_quantum: torch.Tensor,  # (B,) bool
        k: int,
        candidates: int,
        n_qubits: int,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sharded retrieval -> per-query expert-routed rerank (fidelity
        or cosine, branchless select): the sharded counterpart of
        ``engine.fused_search_rerank_routed``."""
        return self._rerank(queries, k, candidates, n_qubits, route_quantum)

    def search(self, queries: np.ndarray, k: int = 10) -> SearchResult:
        """Host-level sharded search (pads the batch to the data axis)."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.d:
            raise ValueError(f"expected (*, {self.d}) queries, got {queries.shape}")
        b = queries.shape[0]
        bp = _round_up(b, self._dp)
        if bp != b:
            # edge-repeat: zero padding rows are certificate-hostile for
            # the clustered accelerator
            queries = np.pad(queries, ((0, bp - b), (0, 0)), mode="edge")
        k_eff = min(k, max(self.ntotal, 1))
        vals, idx = self.search_device(torch.from_numpy(queries).to(self.device), k_eff)
        scores = vals.cpu().numpy()[:b]
        indices = idx.cpu().numpy()[:b]
        invalid = (indices < 0) | (indices >= self.ntotal)
        indices = np.where(invalid, -1, indices).astype(np.int32)
        meta = [
            [None if i < 0 else (self.metadata[i] or None) for i in row]
            for row in indices
        ]
        return SearchResult(scores=scores, indices=indices, metadata=meta)

    # ------------------------------------------------------------------
    # persistence (the unsharded formats: a bundle saved sharded
    # restores on any mesh, or unsharded)
    # ------------------------------------------------------------------

    def _download_vectors_memmap(self, path: str) -> np.ndarray:
        """Stream the slots' corpus to a disk-backed array in chunks (the
        streaming index checkpoints without the corpus in host RAM);
        values carry the store dtype's precision."""
        self._ensure_device()
        out = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32, shape=(self.ntotal, self.d)
        )
        step = 65536
        for i0 in range(0, self.ntotal, step):
            i1 = min(self.ntotal, i0 + step)
            rows = self._slot_rows(i0, i1, torch.device("cpu"))[0]
            out[i0:i1] = rows.to(torch.float32).numpy()
        out.flush()
        return out

    def save_native(self, directory: str) -> None:
        """The unsharded manifest format."""
        if self.keep_host_master:
            DeviceFlatIndex.save_native(self, directory)  # type: ignore[arg-type]
            return
        os.makedirs(directory, exist_ok=True)
        self._download_vectors_memmap(os.path.join(directory, VECTORS_NAME))
        with open(os.path.join(directory, METADATA_NAME), "w") as f:
            json.dump(self.metadata, f)
        manifest = {
            "format": "qrag_tpu.flat_index",
            "version": 1,
            "d": self.d,
            "ntotal": self.ntotal,
            "metric": self.metric,
            "dtype": "float32",
            "normalized": self.normalize,
            "row_pad_multiple": self.row_pad_multiple,
        }
        with open(os.path.join(directory, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load_native(
        cls, directory: str, mesh: Optional[Mesh] = None, **kwargs
    ) -> "ShardedFlatIndex":
        host = DeviceFlatIndex.load_native(directory, device="cpu")
        kwargs.pop("row_pad_multiple", None)
        return cls(
            host._host_vectors, mesh, metric=host.metric, metadata=host.metadata,
            normalize=host.normalize, **kwargs,
        )

    def save_faiss(self, path: str) -> None:
        if self.keep_host_master:
            DeviceFlatIndex.save_faiss(self, path)  # type: ignore[arg-type]
            return
        tmp = path + ".vectors.tmp.npy"
        try:
            vecs = self._download_vectors_memmap(tmp)
            faiss_io.write_flat_index(path, vecs, metric=self.metric)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        meta_path = faiss_io.metadata_path_for(path)
        with open(meta_path + ".tmp", "wb") as f:
            pickle.dump(list(self.metadata), f)
        os.replace(meta_path + ".tmp", meta_path)

    @classmethod
    def load_faiss(cls, path: str, mesh: Optional[Mesh] = None, **kwargs) -> "ShardedFlatIndex":
        """Load a FAISS flat artifact directly into a sharded index."""
        data, meta = faiss_io.read_flat_with_metadata(path)
        kwargs.pop("row_pad_multiple", None)
        return cls(data.vectors, mesh, metric=data.metric, metadata=meta, **kwargs)
