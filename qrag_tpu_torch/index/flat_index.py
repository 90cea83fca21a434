"""Device-resident exact flat index (PyTorch port of
``qrag_tpu.index.flat_index``).

The corpus lives as a padded float32 (or bf16) matrix on the device;
the host keeps the master copy for append and save.  Capacity grows
geometrically (25% headroom on the first build), and appends within
capacity transfer only the new rows.  Each upload publishes one
``DeviceBuffers`` generation with a single attribute store, and an
append builds FRESH buffers rather than writing into the published
ones, so lock-free readers never see a mix of two generations.

Search under ``topk_mode="bounded"`` (the default) runs the provably-
exact norm-bounded scan (``ops.bounded_topk``) over a cached bf16 scan
copy, or with ``bounded_scan="int8"`` over cached per-window int8 codes
of the stored rows; small or odd-shaped corpora take the exact sort.

Speaks the same artifacts as the reference: FAISS flat files +
metadata pickle (``load_faiss``/``save_faiss``) and the native
manifest + ``vectors.npy`` + ``metadata.json`` directory
(``save_native``/``load_native``).

With ``small_batch_accel="clustered"`` query batches of at most
``accel_max_batch`` route through the cluster-pruned provably-exact
search (``ops.cluster_topk``), which reads only the certified groups;
``"clustered_probe"`` is its IVF nprobe arm (no certificates).  The
structure is built lazily per snapshot generation (``build_clustered``)
and its k-means assignment persists with ``save_native``.

The other modes ("exact", "approx", "verified", "refined") run through
``ops.topk``: their candidates come from the fused scan + top-k kernel
(``ops.scan_topk``), and "verified" patches the rows that fail its
certificate with the exact sort in ``search`` (``fallback_rows``).
``use_pallas`` selects the reference's Pallas scans and is refused: the
port's kernels run on every CUDA tensor.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.index import faiss_io
from qrag_tpu_torch.ops.topk import _finalize, flat_scan_topk, scan_topk_verified

MANIFEST_NAME = "manifest.json"
VECTORS_NAME = "vectors.npy"
METADATA_NAME = "metadata.json"
CLUSTER_ASSIGN_NAME = "cluster_assign.npy"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _host_sqnorms(rows: np.ndarray) -> np.ndarray:
    """Row sqnorms in f32 from the host master copy (the reference's
    formula, so both packages derive bit-equal norms)."""
    return np.sum(rows * rows, axis=1, dtype=np.float32)


def _append_into_capacity(
    old: "DeviceBuffers", new_rows: np.ndarray, start: int, ntotal: int
) -> "DeviceBuffers":
    """Device-side append: only the new rows cross host -> device, into
    COPIES of the capacity buffers — concurrent readers may still hold
    the previous generation, so it is never updated in place."""
    dev = old.matrix.device
    end = start + new_rows.shape[0]
    matrix = old.matrix.clone()
    matrix[start:end] = torch.from_numpy(new_rows).to(dev, matrix.dtype)
    sqnorms = old.sqnorms.clone()
    sqnorms[start:end] = torch.from_numpy(_host_sqnorms(new_rows)).to(dev)
    valid = old.valid.clone()
    valid[start:end] = True
    return DeviceBuffers(matrix, sqnorms, valid, ntotal, {})


@dataclass
class DeviceBuffers:
    """One immutable-by-convention generation of device buffers,
    published atomically (single attribute store)."""

    matrix: torch.Tensor  # (capacity, d) store dtype
    sqnorms: torch.Tensor  # (capacity,) f32
    valid: torch.Tensor  # (capacity,) bool
    ntotal: int
    extras: dict  # derived buffers: fidelity features, bounded scan copy


@dataclass
class SearchResult:
    """Results of a top-k search over the index."""

    scores: np.ndarray  # (B, k) — L2: ascending distances; IP: descending
    indices: np.ndarray  # (B, k) int32, -1 for padded/invalid slots
    metadata: List[List[Optional[str]]]  # per query, per hit

    def top(self, query: int = 0) -> List[Tuple[int, float, Optional[str]]]:
        return [
            (int(i), float(s), m)
            for i, s, m in zip(
                self.indices[query], self.scores[query], self.metadata[query]
            )
            if i >= 0
        ]


class DeviceFlatIndex:
    """Exact flat index with the corpus resident in device memory."""

    # one device snapshot (``device_buffers``); the sharded family has none
    has_device_snapshot = True

    def __init__(
        self,
        d: int,
        metric: str = "l2",
        normalize: bool = False,
        row_pad_multiple: int = 128,
        use_pallas: bool = False,
        topk_mode: str = "bounded",
        store_dtype: str = "float32",
        bounded_scan: str = "bf16",
        bounded_query_dtype: str = "float32",
        small_batch_accel: str = "none",
        accel_max_batch: int = 16,
        cluster_group_rows: int = 512,
        cluster_budget: Optional[int] = None,
        accel_read_cap: float = 0.5,
        device=None,
    ):
        if metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        if topk_mode not in ("exact", "approx", "verified", "refined", "bounded"):
            raise ValueError(f"unknown topk_mode {topk_mode!r}")
        if bounded_scan not in ("bf16", "int8"):
            raise ValueError(f"unknown bounded_scan {bounded_scan!r}")
        if bounded_query_dtype not in ("float32", "store"):
            raise ValueError(
                f"unknown bounded_query_dtype {bounded_query_dtype!r}"
            )
        if store_dtype not in _DTYPES:
            raise ValueError(f"unknown store_dtype {store_dtype!r}")
        if small_batch_accel not in ("none", "clustered", "clustered_probe"):
            raise ValueError(f"unknown small_batch_accel {small_batch_accel!r}")
        if use_pallas:
            raise NotImplementedError(
                "use_pallas selects the reference's Pallas scans; the port's "
                "kernels run on every CUDA tensor (ROADMAP.md, Queue 2)"
            )
        self.device = resolve_device(device)
        # small-batch accelerator: batches of <= accel_max_batch read only
        # the certified groups (exact; "clustered_probe" is the IVF arm)
        self.small_batch_accel = small_batch_accel
        self.accel_max_batch = int(accel_max_batch)
        self.cluster_group_rows = int(cluster_group_rows)
        self.cluster_budget = cluster_budget
        # routing guard: skip the accelerator when its expected read
        # (batch * S * group_rows rows) exceeds this fraction of the
        # corpus; 0 disables the guard
        self.accel_read_cap = float(accel_read_cap)
        self._cluster_assign: Optional[np.ndarray] = None
        self.bounded_scan = bounded_scan
        # "store": round queries to the store dtype before the bounded
        # scan — exact w.r.t. the ROUNDED query
        self.bounded_query_dtype = bounded_query_dtype
        self.d = int(d)
        self.metric = metric
        self.normalize = normalize
        self.row_pad_multiple = max(8, int(row_pad_multiple))
        self.topk_mode = topk_mode
        self.store_dtype = _DTYPES[store_dtype]
        # verified-mode exact re-runs (rows) + bounded-mode full sorts
        self.fallback_rows = 0
        self.bounded_escalations = 0  # bounded-mode 4x-budget re-certs
        self.cluster_fallbacks = 0  # accel: chunked full scan ran
        self.cluster_escalations = 0  # accel: 4x-budget tier ran
        self._stats_lock = threading.Lock()
        self._host_vectors = np.zeros((0, d), dtype=np.float32)
        self.metadata: List[str] = []
        self._snapshot: Optional[DeviceBuffers] = None
        self._capacity = 0
        self._dirty = True
        self._pending: List[np.ndarray] = []
        self._needs_full = True
        # single writer: mutation and upload are serialized; searches
        # read an immutable published generation without the lock
        self._write_lock = threading.Lock()

    # ------------------------------------------------------------------
    # construction / ingestion
    # ------------------------------------------------------------------

    @property
    def ntotal(self) -> int:
        return self._host_vectors.shape[0]

    def sample_rows(self, rows: Sequence[int]) -> np.ndarray:
        """Host copies of the stored rows ``rows`` (recall sampling,
        tooling)."""
        return np.asarray(self._host_vectors[np.asarray(rows, dtype=np.int64)])

    def add(
        self, vectors: np.ndarray, metadata: Optional[Sequence[str]] = None
    ) -> int:
        """Append vectors (validating d).  Returns new ntotal."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.d:
            raise ValueError(
                f"expected (*, {self.d}) vectors, got {vectors.shape}"
            )
        if self.normalize:
            norms = np.linalg.norm(vectors, axis=1, keepdims=True)
            vectors = np.where(norms > 0, vectors / np.where(norms > 0, norms, 1), vectors)
        if metadata is not None and len(metadata) != vectors.shape[0]:
            raise ValueError(
                f"metadata length {len(metadata)} != vectors {vectors.shape[0]}"
            )
        with self._write_lock:
            self._host_vectors = np.concatenate(
                [self._host_vectors, vectors], axis=0
            )
            if metadata is not None:
                self.metadata.extend(str(m) for m in metadata)
            else:
                self.metadata.extend([""] * vectors.shape[0])
            if self._snapshot is not None and not self._needs_full:
                self._pending.append(vectors)
            self._dirty = True
        return self.ntotal

    @classmethod
    def from_numpy(
        cls,
        vectors: np.ndarray,
        metric: str = "l2",
        metadata: Optional[Sequence[str]] = None,
        normalize: bool = False,
        **kwargs,
    ) -> "DeviceFlatIndex":
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        idx = cls(d=vectors.shape[1], metric=metric, normalize=normalize, **kwargs)
        idx.add(vectors, metadata)
        return idx

    @classmethod
    def load_faiss(cls, path: str, **kwargs) -> "DeviceFlatIndex":
        """Load a FAISS flat index file + metadata sidecar."""
        data, meta = faiss_io.read_flat_with_metadata(path)
        return cls.from_numpy(
            data.vectors, metric=data.metric, metadata=meta, **kwargs
        )

    # ------------------------------------------------------------------
    # device residency
    # ------------------------------------------------------------------

    def _upload_locked(self) -> None:
        if not self._dirty and self._snapshot is not None:
            return
        n = self.ntotal
        needed = max(self.row_pad_multiple, _round_up(n, self.row_pad_multiple))
        if (
            self._snapshot is not None
            and not self._needs_full
            and self._pending
            and needed <= self._capacity
        ):
            # incremental append: transfer ONLY the new rows
            snap = _append_into_capacity(
                self._snapshot,
                np.concatenate(self._pending, axis=0),
                self._snapshot.ntotal,
                n,
            )
        else:
            if needed > self._capacity:
                if self._capacity:
                    cap = max(needed, self._capacity * 2)  # geometric growth
                else:
                    # first build: 25% headroom so early appends take
                    # the incremental path
                    cap = needed + max(needed // 4, self.row_pad_multiple)
                self._capacity = _round_up(cap, self.row_pad_multiple)
            padded = np.zeros((self._capacity, self.d), dtype=np.float32)
            padded[:n] = self._host_vectors
            valid = np.zeros((self._capacity,), dtype=bool)
            valid[:n] = True
            dev = self.device
            # sqnorms in f32 from the master copy even for a bf16 store
            snap = DeviceBuffers(
                matrix=torch.from_numpy(padded).to(dev, self.store_dtype),
                sqnorms=torch.from_numpy(_host_sqnorms(padded)).to(dev),
                valid=torch.from_numpy(valid).to(dev),
                ntotal=n,
                extras={},
            )
        self._finalize_snapshot(snap)
        # single attribute store publishes the whole generation
        self._snapshot = snap
        self._dirty = False
        self._pending = []
        self._needs_full = False

    def _finalize_snapshot(self, snap: DeviceBuffers) -> None:
        """Hook for subclasses to attach derived buffers (quantized
        forms) BEFORE the snapshot is published, so all forms of one
        generation appear together."""

    def device_buffers(self) -> DeviceBuffers:
        """Atomic snapshot of all device-resident buffers for one corpus
        generation; multi-buffer reads MUST come from one snapshot."""
        if self._dirty or self._snapshot is None:
            with self._write_lock:
                self._upload_locked()
        return self._snapshot

    @property
    def device_matrix(self) -> torch.Tensor:
        """The current snapshot's (capacity, d) store, uploaded if
        needed: the same storage, not a copy."""
        return self.device_buffers().matrix

    def fidelity_features(
        self, n_qubits: int, snap: Optional[DeviceBuffers] = None
    ) -> torch.Tensor:
        """Cached (capacity, n_qubits) rotation-encoding features — what
        the fused quantum rerank gathers instead of full rows."""
        from qrag_tpu_torch.ops.statevector import rotation_features

        snap = self.device_buffers() if snap is None else snap
        feats = snap.extras.get(("fid_feats", n_qubits))
        if feats is None:
            feats = rotation_features(
                snap.matrix.to(torch.float32), n_qubits, snap.sqnorms
            )
            snap.extras[("fid_feats", n_qubits)] = feats
        return feats

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def _bounded_buffers(self, snap: Optional[DeviceBuffers] = None):
        """Derived buffers for topk_mode="bounded", cached per snapshot
        generation: the bf16 scan copy (zero-padded to d % 16 == 0 for
        the kernel — exact for dots; aliases a bf16 matrix that needs
        no padding), per-window max row norms, lane ranks."""
        from qrag_tpu_torch.ops.bounded_topk import window_maxnorms_device
        from qrag_tpu_torch.ops.window_scan import make_lane_rank, pad_cols

        snap = self.device_buffers() if snap is None else snap
        bufs = snap.extras.get("bounded")
        if bufs is None:
            scan = pad_cols(snap.matrix.to(torch.bfloat16), _round_up(self.d, 16))
            bufs = (
                scan.contiguous(),
                window_maxnorms_device(snap.sqnorms),
                make_lane_rank(snap.matrix.shape[0], snap.matrix.device),
            )
            snap.extras["bounded"] = bufs
        return snap, bufs

    def _bounded_buffers_int8(self, snap: Optional[DeviceBuffers] = None):
        """Derived buffers for ``bounded_scan="int8"``, cached per
        snapshot generation: per-window int8 codes of the stored
        (refine-domain) rows, zero-padded to d % 16 == 0 for the kernel,
        window scales, max row norms, min row sqnorms, exact
        quantization-residual norms, lane ranks."""
        from qrag_tpu_torch.ops.bounded_topk import (
            window_maxnorms_device,
            window_minsqnorms_device,
            window_quant_residuals_device,
        )
        from qrag_tpu_torch.ops.window_scan import (
            make_lane_rank,
            pad_cols,
            quantize_block_rows_device,
        )

        snap = self.device_buffers() if snap is None else snap
        bufs = snap.extras.get("bounded_int8")
        if bufs is None:
            q8x, wscale = quantize_block_rows_device(snap.matrix)
            q8x = pad_cols(q8x, _round_up(self.d, 16)).contiguous()
            bufs = (
                q8x,
                wscale,
                window_maxnorms_device(snap.sqnorms),
                window_minsqnorms_device(snap.sqnorms),
                window_quant_residuals_device(snap.matrix, q8x, wscale),
                make_lane_rank(snap.matrix.shape[0], snap.matrix.device),
            )
            snap.extras["bounded_int8"] = bufs
        return snap, bufs

    def _bounded_eligible(self, k: int) -> bool:
        if self.topk_mode != "bounded" or self.ntotal == 0:
            return False
        cap = self.device_buffers().matrix.shape[0]
        # small corpora route to the exact sort (already cheap there)
        return cap >= 4096 and cap % 128 == 0 and cap // 128 >= max(k, 16)

    def _bounded_search(self, queries: torch.Tensor, k: int):
        """Provably-exact search via norm-bounded window pruning; the
        raw op output (goodness, idx, fell_back, n_patched, escalated)
        — callers finalize."""
        from qrag_tpu_torch.ops.bounded_topk import (
            bounded_exact_topk,
            bounded_exact_topk_int8,
        )

        if self.bounded_query_dtype == "store":
            queries = queries.to(self.store_dtype)
        if self.bounded_scan == "int8":
            snap, (q8x, wscale, mx, minsq, resid, lr) = (
                self._bounded_buffers_int8()
            )
            return bounded_exact_topk_int8(
                queries.to(torch.float32), q8x, wscale, snap.matrix,
                snap.sqnorms, mx, minsq, resid, lr, k,
                metric=self.metric, valid_rows=snap.valid,
            )
        snap, (scan, mx, lr) = self._bounded_buffers()
        return bounded_exact_topk(
            queries, scan, snap.matrix, snap.sqnorms, mx, lr, k,
            metric=self.metric, valid_rows=snap.valid,
        )

    def _accel_eligible(self, batch: int, k: int) -> bool:
        """Route this batch through the small-batch clustered
        accelerator?  Small corpora are already cheap exactly, and the
        structure needs several groups per top-k row to prune."""
        if (
            self.small_batch_accel not in ("clustered", "clustered_probe")
            or batch > self.accel_max_batch
        ):
            return False
        n = self.ntotal
        L = self.cluster_group_rows
        if not (n >= max(4096, 4 * L) and n // L >= max(2 * k, 8)):
            return False
        if not self.accel_read_cap:
            return True
        from qrag_tpu_torch.ops.cluster_topk import _auto_budget

        # past accel_read_cap of the corpus the full scan (each row
        # read once) is strictly better than ~batch * S * L group rows
        s_budget = self.cluster_budget or _auto_budget(k, L)
        return batch * s_budget * L <= n * self.accel_read_cap

    def build_clustered(self, snap: Optional[DeviceBuffers] = None):
        """Build (or fetch the cached) clustered structure of a
        snapshot (``ops.cluster_topk``).  Search routing builds it
        lazily; ``QragEngine.warmup`` builds it eagerly.  A persisted
        assignment (``load_native``) skips the k-means; it is dropped
        once rows are appended."""
        from qrag_tpu_torch.ops.cluster_topk import build_clustered_groups

        snap = self.device_buffers() if snap is None else snap
        groups = snap.extras.get("clustered")
        if groups is None:
            # size off the SNAPSHOT's rows: with an explicit (older)
            # snapshot a concurrent append must not leak capacity padding
            n = snap.ntotal
            assign = self._cluster_assign
            if assign is not None and assign.shape[0] != n:
                assign = None  # appended since the assignment was made
            # the valid rows only, scored with the snapshot's master f32
            # norms: the same refine function as the other l2 paths
            groups = build_clustered_groups(
                snap.matrix[:n], group_rows=self.cluster_group_rows,
                assign=assign, sqnorms=snap.sqnorms[:n],
            )
            snap.extras["clustered"] = groups
            if assign is None:
                # a persistable assignment: labelling each row by its
                # GROUP reproduces the exact layout on rebuild
                oid = groups.orig_idx.cpu().numpy()
                vld = groups.valid_p.cpu().numpy()
                L = groups.group_rows
                gid = np.repeat(np.arange(oid.shape[0] // L, dtype=np.int32), L)
                assign = np.empty((n,), np.int32)
                assign[oid[vld]] = gid[vld]
            self._cluster_assign = assign
        return groups

    def _accel_search(self, queries: torch.Tensor, k: int):
        """Raw cluster-pruned search (goodness, ORIGINAL idx, fell_back,
        escalated); callers finalize."""
        from qrag_tpu_torch.ops.cluster_topk import cluster_pruned_topk

        return cluster_pruned_topk(
            queries.to(torch.float32), self.build_clustered(), k,
            metric=self.metric, budget=self.cluster_budget,
            # "clustered_probe": IVF nprobe semantics, the ONLY
            # approximate arm ("clustered" stays provably exact)
            certify=self.small_batch_accel != "clustered_probe",
        )

    def search_device(
        self, queries: torch.Tensor, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device-level search: (B, d) queries -> finalized (scores,
        indices) tensors, padded rows masked out.  The accelerator
        routes here only once its structure is built (``search`` and
        ``build_clustered`` build it).  "verified" runs as "approx"
        here (no host patch-up); ``search`` runs it for real."""
        queries = queries.to(self.device)
        if (
            self._accel_eligible(queries.shape[0], k)
            and self.device_buffers().extras.get("clustered") is not None
        ):
            vals, idx, _, _ = self._accel_search(queries, k)
            return _finalize(vals, idx, self.metric)
        if self._bounded_eligible(k):
            vals, idx, _, _, _ = self._bounded_search(
                queries.to(torch.float32), k
            )
            return _finalize(vals, idx, self.metric)
        snap = self.device_buffers()
        return flat_scan_topk(
            queries.to(self.store_dtype), snap.matrix, k, metric=self.metric,
            corpus_sqnorms=snap.sqnorms, valid_rows=snap.valid,
            mode=self.topk_mode,
        )

    def search(self, queries: np.ndarray, k: int = 10) -> SearchResult:
        """Host-level search with metadata resolution."""
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if queries.shape[1] != self.d:
            raise ValueError(
                f"expected (*, {self.d}) queries, got {queries.shape}"
            )
        k_eff = min(k, max(self.ntotal, 1))
        if queries.shape[0] == 0:
            return SearchResult(
                scores=np.zeros((0, k_eff), np.float32),
                indices=np.zeros((0, k_eff), np.int32),
                metadata=[],
            )
        q = torch.from_numpy(queries).to(self.device)
        if self._accel_eligible(q.shape[0], k_eff):
            vals, idx, fell_back, escalated = self._accel_search(q, k_eff)
            with self._stats_lock:
                self.cluster_fallbacks += int(fell_back)
                self.cluster_escalations += int(escalated)
            scores, indices = _finalize(vals, idx, self.metric)
        elif self.topk_mode == "verified":
            snap = self.device_buffers()
            scores, indices, n_bad = scan_topk_verified(
                q.to(self.store_dtype), snap.matrix, k_eff, metric=self.metric,
                corpus_sqnorms=snap.sqnorms, valid_rows=snap.valid,
            )
            with self._stats_lock:
                self.fallback_rows += n_bad
            scores, indices = torch.from_numpy(scores), torch.from_numpy(indices)
        elif self._bounded_eligible(k_eff):
            vals, idx, fell_back, _, escalated = self._bounded_search(q, k_eff)
            # whole-batch events: the full sort ran / the 4x tier ran
            with self._stats_lock:
                self.fallback_rows += int(fell_back)
                self.bounded_escalations += int(escalated)
            scores, indices = _finalize(vals, idx, self.metric)
        else:
            scores, indices = self.search_device(q, k_eff)
        scores = scores.cpu().numpy()
        indices = indices.cpu().numpy().astype(np.int32)
        invalid = (indices < 0) | (indices >= self.ntotal)
        indices = np.where(invalid, -1, indices)
        meta = [
            [None if i < 0 else (self.metadata[i] or None) for i in row]
            for row in indices
        ]
        return SearchResult(scores=scores, indices=indices, metadata=meta)

    # ------------------------------------------------------------------
    # persistence (the reference's formats, readable by both packages)
    # ------------------------------------------------------------------

    def save_faiss(self, path: str) -> None:
        faiss_io.write_flat_index(path, self._host_vectors, metric=self.metric)
        meta_path = faiss_io.metadata_path_for(path)
        with open(meta_path + ".tmp", "wb") as f:
            pickle.dump(list(self.metadata), f)
        os.replace(meta_path + ".tmp", meta_path)

    def save_native(self, directory: str) -> None:
        """Manifest + raw vectors: the framework's checkpoint format."""
        os.makedirs(directory, exist_ok=True)
        np.save(os.path.join(directory, VECTORS_NAME), self._host_vectors)
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
        # the clustered accelerator's assignment, when one exists for
        # the current rows: load_native then skips the k-means
        assign = self._cluster_assign
        if assign is not None and assign.shape[0] == self.ntotal:
            np.save(
                os.path.join(directory, CLUSTER_ASSIGN_NAME),
                np.asarray(assign, np.int32),
            )
            manifest["cluster_group_rows"] = self.cluster_group_rows
        with open(os.path.join(directory, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)

    @classmethod
    def load_native(cls, directory: str, **kwargs) -> "DeviceFlatIndex":
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        if manifest.get("format") != "qrag_tpu.flat_index":
            raise ValueError(f"{directory}: not a qrag_tpu flat index")
        vectors = np.load(os.path.join(directory, VECTORS_NAME))
        meta_path = os.path.join(directory, METADATA_NAME)
        metadata: Optional[List[str]] = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                metadata = json.load(f)
        kwargs.setdefault("row_pad_multiple", manifest.get("row_pad_multiple", 128))
        idx = cls.from_numpy(
            vectors, metric=manifest["metric"], metadata=metadata, **kwargs
        )
        idx.normalize = bool(manifest.get("normalized", False))
        assign_path = os.path.join(directory, CLUSTER_ASSIGN_NAME)
        if (
            os.path.exists(assign_path)
            and manifest.get("cluster_group_rows") == idx.cluster_group_rows
        ):
            assign = np.load(assign_path)
            if assign.shape[0] == idx.ntotal:
                idx._cluster_assign = assign.astype(np.int32)
        return idx
