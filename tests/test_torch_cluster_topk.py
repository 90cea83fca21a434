"""Parity of the port's cluster-pruned exact top-k
(``qrag_tpu_torch.ops.cluster_topk``) and its index/engine routing with
the JAX reference, on the CPU.

Same numpy inputs (fixed seeds) to ``qrag_tpu.ops.cluster_topk`` and to
the port on ``device="cpu"``: with a shared k-means assignment the
permuted layout is bit-equal and the group stats agree to 1e-6
relative; the search gives equal indices, values within rtol 1e-5 and
the same (fell_back, escalated) flags on the reference test's corpora.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.config import QragConfig as JConfig
from qrag_tpu.engine import QragEngine as JEngine
from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
from qrag_tpu.ops import cluster_topk as jct
from qrag_tpu.ops.topk import _goodness
from qrag_tpu_torch.config import QragConfig as TConfig
from qrag_tpu_torch.engine import QragEngine as TEngine
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex as TIndex
from qrag_tpu_torch.ops import cluster_topk as tct


def _clustered(seed, n, d, n_centers=24, spread=0.05):
    """Mixture of Gaussians on the unit sphere (the reference test's)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.randint(0, n_centers, size=n)] + spread * rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def _uniform(seed, n, d):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _builds(x, group_rows=128, iters=3, bf16=False, master=False):
    """(JAX groups, port groups) over ``x`` with one shared assignment."""
    assign = jct.cluster_assignments(x, group_rows=group_rows, kmeans_iters=iters)
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    xt = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    sq = np.sum(x * x, axis=1, dtype=np.float32) if master else None
    gj = jct.build_clustered_groups(
        xj, group_rows=group_rows, assign=assign,
        sqnorms=None if sq is None else jnp.asarray(sq),
    )
    gt = tct.build_clustered_groups(
        xt, group_rows=group_rows, assign=assign,
        sqnorms=None if sq is None else torch.from_numpy(sq),
    )
    return gj, gt


def _oracle(q, x, metric, k):
    g = _goodness(jnp.asarray(q, jnp.float32), jnp.asarray(x, jnp.float32), metric, None, None)
    v, i = jax.lax.top_k(g, k)
    return np.asarray(v), np.asarray(i), np.asarray(g)


def _same(q, gj, gt, k, metric="l2", budget=None, certify=True):
    """Port == JAX: indices equal, values rtol 1e-5, same flags."""
    vj, ij, fj, ej = jct.cluster_pruned_topk(
        jnp.asarray(q), gj, k, metric=metric, budget=budget, certify=certify
    )
    vt, it, ft, et = tct.cluster_pruned_topk(
        torch.from_numpy(q), gt, k, metric=metric, budget=budget, certify=certify
    )
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-6)
    assert (ft, et) == (bool(fj), bool(ej))
    return vt.numpy(), it.numpy(), ft, et


def _assert_exact(q, x, metric, k, vals, idx):
    """The framework contract against the f32 oracle: identity except
    at sub-noise ties (the reference test's tolerance)."""
    ov, oi, g = _oracle(q, x, metric, k)
    if not np.array_equal(idx, oi):
        rows, pos = np.where(idx != oi)
        gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
        assert (gap <= 3e-4 * (1.0 + np.abs(ov[rows, pos]))).all()
    np.testing.assert_allclose(vals, ov, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bf16,master", [(False, False), (True, False), (True, True)])
def test_build_layout_bit_equal_and_stats(bf16, master):
    x = _clustered(0, 3000, 32)  # not a multiple of group_rows
    gj, gt = _builds(x, bf16=bf16, master=master)
    for name in ("orig_idx", "valid_p", "group_valid"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)))
    np.testing.assert_array_equal(
        gt.corpus_p.to(torch.float32).numpy(), np.asarray(gj.corpus_p.astype(jnp.float32))
    )
    assert gt.corpus_p.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert tuple(gt.corpus_p.shape) == tuple(gj.corpus_p.shape)
    assert gt.corpus_p.shape[0] % (128 * tct._FALLBACK_GROUP_CHUNK) == 0
    for name in ("sqnorms_p", "csq", "radii", "maxnorms"):
        np.testing.assert_allclose(
            getattr(gt, name).numpy(), np.asarray(getattr(gj, name)), rtol=1e-6, atol=1e-30
        )
    # the norm gap is a difference of two row norms (~1 here): 1e-6
    # relative to the norms it is taken from
    scale = float(np.asarray(gj.maxnorms).max()) ** 2
    np.testing.assert_allclose(
        gt.norm_gap.numpy(), np.asarray(gj.norm_gap), rtol=0, atol=1e-6 * scale
    )
    # centroid vectors: relative to each centroid's norm (components
    # near zero carry the sum's absolute rounding)
    cj = np.asarray(gj.centroids)
    err = np.linalg.norm(gt.centroids.numpy() - cj, axis=1)
    assert (err <= 1e-6 * np.linalg.norm(cj, axis=1) + 1e-30).all()
    if master:
        assert float(gt.norm_gap.max()) > 0  # the bf16 rows' norms differ


def test_cluster_assignments_agree_with_reference():
    """Same seed, same initial rows and training subsample: on a
    well-separated mixture (one natural center per k-means cluster) the
    assignments agree on at least 99.9% of the rows (seen: 100%; chunked
    sums in another order move the centroids in the last bits only).
    Near-tie rows may go either way; that changes pruning, never
    exactness."""
    x = _clustered(1, 8192, 48, n_centers=16, spread=0.03)
    aj = jct.cluster_assignments(x, group_rows=128, kmeans_iters=4, seed=3)
    at = tct.cluster_assignments(x, group_rows=128, kmeans_iters=4, seed=3, device="cpu")
    assert at.dtype == np.int32 and at.shape == aj.shape
    assert np.mean(at == aj) >= 0.999


def test_structure_is_exact_with_own_kmeans():
    """The port's own k-means (no shared assignment) gives an exact
    structure too: any assignment is correct."""
    x = _clustered(2, 4096, 64, n_centers=6)
    g = tct.build_clustered_groups(x, group_rows=128, kmeans_iters=4, device="cpu")
    q = _clustered(3, 16, 64, n_centers=6)
    vals, idx, fb, _ = tct.cluster_pruned_topk(q, g, 10)
    _assert_exact(q, x, "l2", 10, vals.numpy(), idx.numpy())
    assert not fb, "clustered geometry must certify without the full scan"


def test_clustered_corpus_parity():
    x = _clustered(4, 4096, 64, n_centers=6)
    gj, gt = _builds(x, iters=4)
    q = _clustered(5, 16, 64, n_centers=6)
    vals, idx, fb, _ = _same(q, gj, gt, 10)
    _assert_exact(q, x, "l2", 10, vals, idx)
    assert not fb


def test_uniform_corpus_ladder_parity():
    """Uniform rows defeat the bounds: the ladder must fire and stay
    exact, with the reference's flags."""
    x = _uniform(6, 8192, 48)
    gj, gt = _builds(x, group_rows=64, iters=2)  # G = 128 > 4 S
    q = _uniform(7, 8, 48)
    vals, idx, fb, esc = _same(q, gj, gt, 10)
    _assert_exact(q, x, "l2", 10, vals, idx)
    assert esc and fb


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_metrics_parity(metric):
    x = _clustered(8, 3000, 32)
    gj, gt = _builds(x)
    q = _clustered(9, 9, 32)
    vals, idx, _, _ = _same(q, gj, gt, 7, metric=metric)
    _assert_exact(q, x, metric, 7, vals, idx)


def test_duplicate_rows_tie_break_by_original_index():
    x = _clustered(10, 1024, 32)
    dup = x[137].copy()
    for i in (3, 200, 512, 900, 1019):
        x[i] = dup
    gj, gt = _builds(x)
    q = (dup + 0.001 * np.random.RandomState(11).randn(32)).astype(np.float32)[None, :]
    q /= np.linalg.norm(q)
    vals, idx, _, _ = _same(q, gj, gt, 8)
    _assert_exact(q, x, "l2", 8, vals, idx)
    assert set(idx[0, :6].tolist()) == {3, 137, 200, 512, 900, 1019}


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_mass_ties_at_threshold(metric):
    """40 copies of one row: the top-10 are the 10 lowest original
    indices, and no selection that could miss one certifies."""
    x = _clustered(12, 4096, 32, n_centers=6)
    v = x[500].copy()
    spots = np.random.RandomState(13).choice(4096, size=40, replace=False)
    x[spots] = v
    gj, gt = _builds(x)
    vals, idx, _, _ = _same(v[None, :], gj, gt, 10, metric=metric)
    _assert_exact(v[None, :], x, metric, 10, vals, idx)
    np.testing.assert_array_equal(idx[0], np.flatnonzero((x == v).all(axis=1))[:10])


def test_tiny_budget_escalates_parity():
    x = _clustered(14, 2048, 32, n_centers=4, spread=0.3)
    gj, gt = _builds(x, iters=2)
    q = np.random.RandomState(15).randn(4, 32).astype(np.float32)
    vals, idx, _, esc = _same(q, gj, gt, 10, budget=1)
    _assert_exact(q, x, "l2", 10, vals, idx)
    assert esc, "budget below k must at least escalate"


def test_bf16_store_master_sqnorms_parity():
    """A bf16 store scored with the master f32 norms (the index's other
    l2 paths): the plain paths' scoring function, certified soundly."""
    x = _clustered(16, 4096, 64)
    gj, gt = _builds(x, bf16=True, master=True)
    q = _clustered(17, 8, 64)
    vals, idx, _, _ = _same(q, gj, gt, 10)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    q32 = q.astype(np.float32)
    g = 2.0 * (q32 @ xb.T) - np.sum(q32 * q32, axis=1, keepdims=True) - np.sum(
        x * x, axis=1, dtype=np.float32
    )[None, :]
    order = np.argsort(-g, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(idx, order)


def test_budget_covering_all_groups_parity():
    x = _clustered(18, 1024, 32)
    gj, gt = _builds(x, iters=2)
    q = np.random.RandomState(19).randn(5, 32).astype(np.float32)
    vals, idx, fb, esc = _same(q, gj, gt, 10, budget=64)
    _assert_exact(q, x, "l2", 10, vals, idx)
    assert (fb, esc) == (False, False)


def test_small_and_empty_corpora():
    x = np.random.RandomState(20).normal(size=(64, 32)).astype(np.float32)
    gj = jct.build_clustered_groups(x, group_rows=128)
    gt = tct.build_clustered_groups(x, group_rows=128, device="cpu")
    q = np.random.RandomState(21).normal(size=(2, 32)).astype(np.float32)
    vals, idx, _, _ = _same(q, gj, gt, 5)
    _assert_exact(q, x, "l2", 5, vals, idx)
    eg = tct.empty_groups(32, 128, torch.float32, "cpu")
    vals, idx, fb, esc = tct.cluster_pruned_topk(q, eg, 5)
    assert (fb, esc) == (False, False)
    assert torch.isneginf(vals).all() and (idx == tct._PAD_IDX).all()
    assert tct.build_clustered_groups(np.zeros((0, 32), np.float32), device="cpu").orig_idx.shape[0] > 0


def test_probe_mode_parity():
    """certify=False = IVF nprobe: the reference's selection and exact
    candidate scores, both flags False, at the auto and a starved
    budget."""
    x = _clustered(22, 4096, 64, n_centers=6)
    gj, gt = _builds(x, iters=4)
    q = _clustered(23, 8, 64, n_centers=6)
    for budget in (None, 1):
        vals, idx, fb, esc = _same(q, gj, gt, 10, certify=False, budget=budget)
        assert (fb, esc) == (False, False)
        _, _, g = _oracle(q, x, "l2", 10)
        rows, cols = np.nonzero(idx < x.shape[0])
        np.testing.assert_allclose(vals[rows, cols], g[rows, idx[rows, cols]], rtol=1e-5, atol=1e-4)


def test_invalid_assignment_rejected():
    x = _clustered(24, 512, 16)
    with pytest.raises(ValueError):
        tct.build_clustered_groups(x, group_rows=128, assign=np.full(512, 600), device="cpu")
    with pytest.raises(ValueError):
        tct.build_clustered_groups(x, assign=np.zeros(10, np.int32), device="cpu")


# ------------------------------------------------------------ index / engine


def _indexes(x, **kw):
    kw = {"metric": "l2", "small_batch_accel": "clustered", "cluster_group_rows": 128,
          "accel_read_cap": 0, **kw}
    meta = [f"m/{i}" for i in range(x.shape[0])]
    return (
        TIndex.from_numpy(x, metadata=meta, device="cpu", **kw),
        JIndex.from_numpy(x, metadata=meta, **kw),
    )


def test_index_routes_and_counts():
    x = _clustered(25, 6000, 64)
    ti, ji = _indexes(x, accel_max_batch=8)
    assert ti._accel_eligible(4, 10) and not ti._accel_eligible(9, 10)
    # the read guard: batch * S * L (4 * 20 * 128 = 10k rows) > 0.5 * 6000
    ti.accel_read_cap = 0.5
    assert not ti._accel_eligible(4, 10) and ti._accel_eligible(1, 10)
    ti.accel_read_cap = 0.0
    q = _clustered(26, 4, 64)
    rt, rj = ti.search(q, 10), ji.search(q, 10)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5, atol=1e-5)
    assert rt.metadata == rj.metadata
    assert (ti.cluster_fallbacks, ti.cluster_escalations) == (ji.cluster_fallbacks, ji.cluster_escalations)
    assert ti.device_buffers().extras.get("clustered") is not None
    _, si = ti.search_device(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(si.numpy(), rj.indices)
    # a batch over accel_max_batch keeps the bounded path, counters still
    qb = np.repeat(q, 3, axis=0)
    esc = ti.cluster_escalations
    np.testing.assert_array_equal(ti.search(qb, 10).indices, ji.search(qb, 10).indices)
    assert ti.cluster_escalations == esc
    # an append invalidates the snapshot's structure; the next search rebuilds
    extra = _clustered(27, 10, 64)
    ti.add(extra)
    ji.add(extra)
    np.testing.assert_array_equal(ti.search(q, 10).indices, ji.search(q, 10).indices)
    assert ti._cluster_assign.shape[0] == 6010


def test_index_ladder_counters_parity():
    """A starved budget escalates on the index too; the counters move as
    the reference's do."""
    x = _clustered(28, 6000, 64, n_centers=4, spread=0.3)
    ti, ji = _indexes(x, cluster_budget=1)
    q = np.random.RandomState(29).randn(2, 64).astype(np.float32)
    np.testing.assert_array_equal(ti.search(q, 10).indices, ji.search(q, 10).indices)
    assert (ti.cluster_fallbacks, ti.cluster_escalations) == (ji.cluster_fallbacks, ji.cluster_escalations)
    assert ti.cluster_escalations > 0


def test_index_probe_routes():
    x = _clustered(30, 5000, 64, n_centers=6)
    ti, ji = _indexes(x, small_batch_accel="clustered_probe")
    q = _clustered(31, 4, 64, n_centers=6)
    rt, rj = ti.search(q, 10), ji.search(q, 10)
    np.testing.assert_array_equal(rt.indices, rj.indices)
    assert ti.cluster_fallbacks == ti.cluster_escalations == 0


def test_bf16_index_accel_matches_bounded_search():
    x = _clustered(32, 6144, 64)
    mk = dict(metric="l2", store_dtype="bfloat16", cluster_group_rows=128, accel_read_cap=0,
              device="cpu")
    accel = TIndex.from_numpy(x, small_batch_accel="clustered", accel_max_batch=8, **mk)
    plain = TIndex.from_numpy(x, small_batch_accel="none", topk_mode="bounded", **mk)
    q = _clustered(33, 4, 64)
    assert accel._accel_eligible(4, 10)
    ra, rp = accel.search(q, 10), plain.search(q, 10)
    np.testing.assert_array_equal(ra.indices, rp.indices)
    np.testing.assert_allclose(ra.scores, rp.scores, rtol=1e-5, atol=1e-4)


def test_build_pins_to_explicit_snapshot():
    x = _clustered(34, 5000, 64, n_centers=6)
    ti, _ = _indexes(x)
    snap_old = ti.device_buffers()
    ti.add(_clustered(35, 200, 64))
    groups = ti.build_clustered(snap=snap_old)
    valid = groups.valid_p.numpy()
    assert valid.sum() == 5000 and groups.orig_idx.numpy()[valid].max() < 5000


def test_native_dir_loads_across_packages(tmp_path):
    """save_native persists the assignment (cluster_assign.npy and the
    manifest's cluster_group_rows); a directory saved by either package
    loads in the other without k-means and rebuilds the same layout."""
    x = _clustered(36, 5000, 64)
    ti, ji = _indexes(x)
    ti.build_clustered()
    ji.build_clustered()
    np.testing.assert_array_equal(ti._cluster_assign, ji._cluster_assign)
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    ti.save_native(dt)
    ji.save_native(dj)
    assert (tmp_path / "port" / "cluster_assign.npy").exists()
    kw = dict(small_batch_accel="clustered", cluster_group_rows=128, accel_read_cap=0)
    j_from_t = JIndex.load_native(dt, **kw)
    t_from_j = TIndex.load_native(dj, device="cpu", **kw)
    np.testing.assert_array_equal(j_from_t._cluster_assign, ti._cluster_assign)
    np.testing.assert_array_equal(t_from_j._cluster_assign, ji._cluster_assign)
    q = _clustered(37, 4, 64)
    np.testing.assert_array_equal(t_from_j.search(q, 10).indices, j_from_t.search(q, 10).indices)
    np.testing.assert_array_equal(
        t_from_j.device_buffers().extras["clustered"].orig_idx.numpy(),
        np.asarray(ji.device_buffers().extras["clustered"].orig_idx),
    )
    # another group size does not adopt the stale assignment
    assert TIndex.load_native(dj, device="cpu", small_batch_accel="clustered",
                              cluster_group_rows=256)._cluster_assign is None


@pytest.fixture(scope="module")
def accel_engines():
    cfg = {"embedding": {"provider": "hash", "dim": 64},
           "index": {"small_batch_accel": "clustered", "cluster_group_rows": 128,
                     "accel_read_cap": 0.0}}
    x = _clustered(38, 6000, 64, n_centers=6)
    meta = [f"m/{i}" for i in range(6000)]
    te = TEngine(config=TConfig.from_dict(cfg), device="cpu")
    je = JEngine(config=JConfig.from_dict(cfg))
    te.index.add(x, meta)
    je.index.add(x, meta)
    return te, je, x


def test_engine_config_warmup_and_stats(accel_engines):
    te, _, _ = accel_engines
    assert te.index.small_batch_accel == "clustered" and te.index.cluster_group_rows == 128
    te.warmup(batch_sizes=[1])
    assert te.index.device_buffers().extras.get("clustered") is not None
    st = te.stats()["index"]
    assert st["small_batch_accel"] == "clustered"
    assert isinstance(st["cluster_fallbacks"], int) and isinstance(st["cluster_escalations"], int)


@pytest.mark.parametrize("rtype", ["quantum", "classical"])
def test_fused_candidates_through_accel(accel_engines, rtype):
    """search_rerank at a small batch takes its candidates from the
    accelerator; the result equals the JAX engine's (same candidate
    set, same rerank)."""
    te, je, x = accel_engines
    snap = te.index.device_buffers()
    mode, kw = te._fused_candidate_mode(16, snap, batch=1)
    assert mode == "clustered" and kw["cluster_groups"] is te.index.build_clustered(snap)
    assert te._fused_candidate_mode(16, snap, batch=64)[0] != "clustered"
    q = x[17:18] + 0.001
    ot = te.search_rerank(q, k=5, candidates=16, reranker_type=rtype)
    oj = je.search_rerank(q, k=5, candidates=16, reranker_type=rtype)
    assert [h["index"] for h in ot["results"][0]] == [h["index"] for h in oj["results"][0]]
    np.testing.assert_allclose(
        [h["score"] for h in ot["results"][0]], [h["score"] for h in oj["results"][0]],
        rtol=1e-5, atol=1e-6,
    )


def test_cli_small_batch_accel_flag(monkeypatch):
    from qrag_tpu_torch.serving import http_app

    # recorded first, so the env channel the CLI writes is restored
    monkeypatch.setenv("QRAG_INDEX_SMALL_BATCH_ACCEL", "none")
    parser = http_app._parser()
    cfg = http_app._configure(parser, parser.parse_args(["--small-batch-accel", "clustered"]))
    assert cfg.index.small_batch_accel == "clustered"
    assert os.environ["QRAG_INDEX_SMALL_BATCH_ACCEL"] == "clustered"
    with pytest.raises(SystemExit):
        parser.parse_args(["--small-batch-accel", "ivf"])
