"""The approx / verified / refined modes of the port (``ops.topk``)
against the JAX package's, case for case with ``tests/test_topk_modes.py``.

Same numpy inputs (seeded) to ``qrag_tpu.ops.topk`` and
``qrag_tpu_torch.ops.topk`` on the CPU.  JAX's ``approx_max_k`` on its
CPU backend is the exact ``top_k`` (lower index on ties), and the port's
candidate selection (the scan_topk kernel's plain twin here) is exact
too, so approx and verified must give JAX's indices, tie order
included; values within rtol 1e-5 (f32 sums in another order: the port
re-scores the candidates, JAX keeps the matrix's value).  "refined"
rounds in another place (JAX: the f32 goodness to bf16; the port: the
operands, as the kernel's bf16 arm does), so its candidate sets may
differ at the k·o-th place: there the test holds the mode's contract
(recall against the exact scan, exact values of the rows returned)
beside JAX's own, and the rows the two share must carry the same
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
from qrag_tpu.ops import topk as J
from qrag_tpu_torch.index.flat_index import DeviceFlatIndex as TIndex
from qrag_tpu_torch.ops import topk as T


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _data(seed, n, d, b):
    rng = np.random.RandomState(seed)
    return rng.randn(b, d).astype(np.float32), rng.randn(n, d).astype(np.float32)


def test_goodness_topk_small_n_uses_exact():
    g = np.random.RandomState(1).randn(4, 100).astype(np.float32)
    (gj,), (gt,) = _both(g)
    for mode in ("approx", "verified", "exact"):
        vj, ij = J.goodness_topk(gj, 5, mode=mode)
        vt, it = T.goodness_topk(gt, 5, mode=mode)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    with pytest.raises(ValueError):
        T.goodness_topk(torch.zeros((1, 5000)), 5, mode="nope")


@pytest.mark.parametrize("oversample", [1, 2, 8])
def test_goodness_topk_approx_arm_on_a_large_matrix(oversample):
    """Past the short-cuts (n >= 4096, k·o·8 < n) the approx arm picks
    k·o candidates and re-ranks them: JAX's indices and values."""
    g = np.random.RandomState(2).randn(6, 9000).astype(np.float32)
    g[:, 100:110] = g[:, 50:51]  # planted ties
    (gj,), (gt,) = _both(g)
    vj, ij = J.goodness_topk(gj, 12, "approx", oversample)
    vt, it = T.goodness_topk(gt, 12, "approx", oversample)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["approx", "exact"])
def test_flat_scan_topk_parity(metric, mode):
    q, x = _data(3, 8192, 64, 16)
    (qj, xj), (qt, xt) = _both(q, x)
    sj, ij = J.flat_scan_topk(qj, xj, 10, metric=metric, mode=mode)
    st, it = T.flat_scan_topk(qt, xt, 10, metric=metric, mode=mode)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-4)


def test_verified_scan_matches_exact_values():
    q, x = _data(4, 8192, 64, 16)
    (qj, xj), (qt, xt) = _both(q, x)
    s_v, i_v, n_bad = T.scan_topk_verified(qt, xt, 10, metric="l2")
    js_v, ji_v, jn_bad = J.scan_topk_verified(qj, xj, 10, metric="l2")
    s_e, i_e = J.flat_scan_topk(qj, xj, 10, metric="l2", mode="exact")
    np.testing.assert_array_equal(i_v, ji_v)
    np.testing.assert_array_equal(i_v, np.asarray(i_e))
    np.testing.assert_allclose(s_v, js_v, rtol=1e-5, atol=1e-4)
    assert n_bad == jn_bad == 0


def test_verified_scan_ip():
    q, x = _data(5, 8192, 32, 8)
    (qj, xj), (qt, xt) = _both(q, x)
    s_v, i_v, _ = T.scan_topk_verified(qt, xt, 7, metric="ip")
    s_e, i_e = J.flat_scan_topk(qj, xj, 7, metric="ip", mode="exact")
    np.testing.assert_allclose(s_v, np.asarray(s_e), rtol=1e-5)
    np.testing.assert_array_equal(i_v, np.asarray(i_e))


def test_verified_fallback_fires_on_adversarial_input():
    """The reference's adversarial corpus: the true top-10 planted in
    adjacent rows among near-zero noise.  The port's verified values and
    indices equal JAX's verified and exact answers."""
    rng = np.random.RandomState(6)
    q = np.zeros((4, 16), np.float32)
    q[:, 0] = 1.0
    x = rng.randn(8192, 16).astype(np.float32) * 0.01
    for j in range(10):
        x[4000 + j] = 0.0
        x[4000 + j, 0] = 1.0 - 1e-4 * j
    (qj, xj), (qt, xt) = _both(q, x)
    s_v, i_v, n_bad = T.scan_topk_verified(qt, xt, 10, metric="ip")
    js_v, ji_v, jn_bad = J.scan_topk_verified(qj, xj, 10, metric="ip")
    s_e, i_e = J.flat_scan_topk(qj, xj, 10, metric="ip", mode="exact")
    np.testing.assert_array_equal(i_v, ji_v)
    np.testing.assert_array_equal(i_v, np.asarray(i_e))
    np.testing.assert_allclose(s_v, np.asarray(s_e), rtol=1e-6)
    assert n_bad == jn_bad


def _sabotaged(orig, rows, rank):
    """``_select`` whose candidate at ``rank`` is replaced, on ``rows``,
    by the query's worst row: a selection that drops a row it should
    hold."""

    def select(queries, corpus, kk, metric, sq, valid, cd):
        vals, idx = orig(queries, corpus, kk, metric, sq, valid, cd)
        idx = idx.clone()
        for r in rows:
            g = T._goodness(queries[r : r + 1], corpus, metric, sq, valid)
            idx[r, rank] = int(torch.argmin(g))
        return vals, idx

    return select


def test_verified_certificate_catches_a_bad_selection(monkeypatch):
    """A selection that omits a true top-k row (rows 1 and 4 lose their
    best and their 5th-best candidate): the certificate, which counts
    against the whole corpus, fails on exactly those queries and the
    patch-up restores the exact answer.  It does not rest on the
    kernel being right."""
    q, x = _data(7, 8192, 32, 6)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    orig = T._select
    bad_first = _sabotaged(orig, [1], 0)

    def select(queries, corpus, kk, *a):
        vals, idx = bad_first(queries, corpus, kk, *a)
        return _sabotaged(lambda *_: (vals, idx), [4], 4)(queries, corpus, kk, *a)

    monkeypatch.setattr(T, "_select", select)
    s_v, i_v, n_bad = T.scan_topk_verified(qt, xt, 5, metric="ip")
    monkeypatch.setattr(T, "_select", orig)
    assert n_bad == 2
    s_e, i_e = J.flat_scan_topk(jnp.asarray(q), jnp.asarray(x), 5, metric="ip", mode="exact")
    np.testing.assert_array_equal(i_v, np.asarray(i_e))
    np.testing.assert_allclose(s_v, np.asarray(s_e), rtol=1e-5)


@pytest.mark.parametrize("entry", ["host", "device"])
@pytest.mark.parametrize("case", ["first", "kth", "tie", "disorder"])
def test_verified_certificate_cases(monkeypatch, entry, case):
    """The certificate per kind of selection, through the host patch-up
    (``scan_topk_verified``) and the device form
    (``scan_topk_verified_jit``, which patches from its own goodness):
    dropping the best row, dropping the k-th, keeping the higher of two
    equal rows at the k-th place (the tie contract) — each fails on the
    sabotaged query alone — and a selection whose values are disordered
    but whose rows are right, which passes.  The answer equals JAX's
    exact one in every case (ties to the lower index)."""
    q, x = _data(16, 8192, 32, 3)
    k = 5
    if case == "tie":
        # query 2's 5th-best row gets a twin at a higher index, which
        # the sabotaged selection ranks ahead of it
        g = q[2] @ x.T
        fifth = int(np.argsort(-g, kind="stable")[4])
        x[8000] = x[fifth]
        assert fifth < 8000
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    orig = T._select
    if case == "disorder":
        def select(queries, corpus, kk, *a):
            vals, idx = orig(queries, corpus, kk, *a)
            vals = vals.clone()
            vals[2, -1] = vals[2, 0] + 1.0  # the last candidate ranked first
            return vals, idx
    elif case == "tie":
        def select(queries, corpus, kk, *a):
            vals, idx = orig(queries, corpus, kk, *a)
            # both twins are candidates: swap their places, so that the
            # re-score's stable sort puts the higher index first
            a, b = idx[2] == fifth, idx[2] == 8000
            assert a.sum() == b.sum() == 1
            idx = idx.clone()
            idx[2, a], idx[2, b] = 8000, fifth
            return vals, idx
    else:
        select = _sabotaged(orig, [2], 0 if case == "first" else k - 1)
    monkeypatch.setattr(T, "_select", select)
    if entry == "host":
        s_v, i_v, n_bad = T.scan_topk_verified(qt, xt, k, metric="ip")
    else:
        s_v, i_v, n_bad = T.scan_topk_verified_jit(qt, xt, k, metric="ip", oversample=2)
        s_v, i_v, n_bad = s_v.numpy(), i_v.numpy(), int(n_bad)
    monkeypatch.setattr(T, "_select", orig)
    assert n_bad == (0 if case == "disorder" else 1)
    s_e, i_e = J.flat_scan_topk(jnp.asarray(q), jnp.asarray(x), k, metric="ip", mode="exact")
    np.testing.assert_array_equal(i_v, np.asarray(i_e))
    np.testing.assert_allclose(s_v, np.asarray(s_e), rtol=1e-5)


def test_index_modes_agree():
    rng = np.random.RandomState(8)
    x = rng.randn(9000, 48).astype(np.float32)
    q = x[123:127] + 0.001 * rng.randn(4, 48).astype(np.float32)
    exact = JIndex.from_numpy(x, topk_mode="exact")
    r_e = exact.search(q, k=10)
    for mode in ("verified", "approx"):
        r_t = TIndex.from_numpy(x, topk_mode=mode, device="cpu").search(q, k=10)
        r_j = JIndex.from_numpy(x, topk_mode=mode).search(q, k=10)
        np.testing.assert_array_equal(r_t.indices, r_j.indices)
        np.testing.assert_array_equal(r_t.indices, r_e.indices)
        # atol: an l2 distance near 0 is 2q.x - |q|^2 - |x|^2 with
        # |x|^2 ~ 48, whose f32 rounding (ulp ~4e-6) differs between the
        # re-score and the matrix product by a few ulps
        np.testing.assert_allclose(r_t.scores, r_e.scores, rtol=1e-5, atol=1e-4)
    t = TIndex.from_numpy(x, topk_mode="verified", device="cpu")
    t.search(q, k=10)
    assert t.fallback_rows == 0


@pytest.mark.parametrize("mode", ["approx", "verified", "refined"])
def test_bf16_store_dtype_search(mode):
    """A bf16 store: queries are cast to it (as JAX does), selection and
    re-score run on the stored rows; JAX's hits for approx / verified,
    the planted row first for all."""
    rng = np.random.RandomState(9)
    x = rng.randn(6000, 64).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    t = TIndex.from_numpy(x, store_dtype="bfloat16", topk_mode=mode, device="cpu")
    j = JIndex.from_numpy(x, store_dtype="bfloat16", topk_mode=mode)
    rt, rj = t.search(x[7:12], k=3), j.search(x[7:12], k=3)
    assert list(rt.indices[:, 0]) == list(range(7, 12))
    assert rt.scores[0, 0] < 1e-2  # bf16 noise floor
    if mode != "refined":
        np.testing.assert_array_equal(rt.indices, rj.indices)
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-5, atol=1e-5)


def test_verified_fallback_writable_patch(monkeypatch):
    """The reference's sabotage: the certificate fails rows 1 and 3
    (their values / indices corrupted); the exact patch-up must write
    into a writable copy and restore JAX's exact answer."""
    q, x = _data(10, 8192, 32, 4)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    orig = T._scan_topk_device

    def sabotage(queries, corpus, sqnorms, valid, k, metric, mode, o, rt):
        vals, idx, ok = orig(queries, corpus, sqnorms, valid, k, metric, mode, o, rt)
        if mode == "verified":
            ok = torch.tensor([True, False, True, False])
            vals = vals.clone()
            idx = idx.clone()
            vals[1] -= 1.0
            idx[3] = 0
        return vals, idx, ok

    monkeypatch.setattr(T, "_scan_topk_device", sabotage)
    s_v, i_v, n_bad = T.scan_topk_verified(qt, xt, 5, metric="ip")
    assert n_bad == 2
    monkeypatch.setattr(T, "_scan_topk_device", orig)
    s_e, i_e = J.flat_scan_topk(jnp.asarray(q), jnp.asarray(x), 5, metric="ip", mode="exact")
    np.testing.assert_array_equal(i_v, np.asarray(i_e))
    np.testing.assert_allclose(s_v, np.asarray(s_e), rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_refined_mode_exact_scores(metric):
    """'refined': exact score values (bf16 only in the selection).  The
    comparison made: (1) the mode's contract — recall against the exact
    scan above 0.9 and the returned rows' values equal to their exact
    values; (2) against JAX's refined — where both return a row its
    value agrees, and the port's recall is no worse than JAX's by more
    than one row in a hundred."""
    q, x = _data(11, 8192, 48, 8)
    (qj, xj), (qt, xt) = _both(q, x)
    s_r, i_r = T.flat_scan_topk(qt, xt, 10, metric=metric, mode="refined")
    s_r, i_r = s_r.numpy(), i_r.numpy()
    js_r, ji_r = (np.asarray(a) for a in J.flat_scan_topk(qj, xj, 10, metric=metric, mode="refined"))
    s_e, i_e = (np.asarray(a) for a in J.flat_scan_topk(qj, xj, 10, metric=metric, mode="exact"))
    agree = i_r == i_e
    assert agree.mean() > 0.9
    np.testing.assert_allclose(s_r[agree], s_e[agree], rtol=1e-5, atol=1e-4)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_r, i_e)])
    j_recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ji_r, i_e)])
    assert recall >= j_recall - 0.01
    for row in range(q.shape[0]):
        common = dict(zip(ji_r[row], js_r[row]))
        for i, s in zip(i_r[row], s_r[row]):
            if i in common:
                np.testing.assert_allclose(s, common[i], rtol=1e-5, atol=1e-4)


def test_refined_mode_through_index():
    x = np.random.RandomState(12).randn(5000, 32).astype(np.float32)
    t = TIndex.from_numpy(x, topk_mode="refined", device="cpu")
    j = JIndex.from_numpy(x, topk_mode="refined")
    rt, rj = t.search(x[99:100], k=3), j.search(x[99:100], k=3)
    assert rt.indices[0, 0] == rj.indices[0, 0] == 99
    assert rt.scores[0, 0] < 1e-4


def test_verified_jit_mode():
    """scan_topk_verified_jit: exact values and indices against JAX's
    ``l2_topk``, n_bad 0, also in a loop that feeds each result into
    the next call (the reference runs it inside ``lax.scan``)."""
    q, x = _data(13, 6000, 32, 8)
    sq = np.sum(x * x, axis=1)
    (qj, xj, sqj), (qt, xt, sqt) = _both(q, x, sq)
    vals, idx, n_bad = T.scan_topk_verified_jit(qt, xt, 5, metric="l2", corpus_sqnorms=sqt)
    want_v, want_i = J.l2_topk(qj, xj, 5, corpus_sqnorms=sqj)
    jv, ji, jbad = J.scan_topk_verified_jit(qj, xj, 5, metric="l2", corpus_sqnorms=sqj)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), rtol=1e-5, atol=1e-5)
    assert int(n_bad) == int(jbad) == 0
    carry, total_bad = qt, 0
    for _ in range(3):
        v, i, nb = T.scan_topk_verified_jit(carry, xt, 5, metric="l2", corpus_sqnorms=sqt)
        carry = carry + 1e-9 * v[:, :1]
        total_bad += int(nb)
    assert total_bad == 0


@pytest.mark.parametrize("k", [10, 100])
def test_selection_routes_and_wide_candidate_sets(k):
    """k·o <= 1024 selects through scan_topk; past it (k=100 at o=16:
    1,600) through the counted product + sort route.  Either way the
    result equals JAX's, and the routes are counted."""
    q, x = _data(14, 20000, 16, 5)
    (qj, xj), (qt, xt) = _both(q, x)
    before = dict(T.selection_routes)
    vals, idx, n_bad = T.scan_topk_verified_jit(qt, xt, k)
    rose = {r: c - before[r] for r, c in T.selection_routes.items()}
    assert rose == ({"scan_topk": 1, "product_sort": 0} if k == 10
                    else {"scan_topk": 0, "product_sort": 1})
    jv, ji, _ = J.scan_topk_verified_jit(qj, xj, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-4)


def test_selection_past_the_valid_rows():
    """Fewer valid rows than candidates: the empty slots carry -inf and
    row -1 out of the selection, and the finalized result masks them as
    the exact sort does (JAX's index there is a padded row; the host
    edge maps both to -1)."""
    q, x = _data(15, 8192, 16, 3)
    valid = np.zeros(8192, bool)
    valid[[5, 77, 4000]] = True
    st, it = T.flat_scan_topk(torch.from_numpy(q), torch.from_numpy(x), 5, metric="l2",
                              valid_rows=torch.from_numpy(valid), mode="approx")
    sj, ij = J.flat_scan_topk(jnp.asarray(q), jnp.asarray(x), 5, metric="l2",
                              valid_rows=jnp.asarray(valid), mode="approx")
    np.testing.assert_array_equal(it.numpy()[:, :3], np.asarray(ij)[:, :3])
    assert np.isinf(st.numpy()[:, 3:]).all() and np.isinf(np.asarray(sj)[:, 3:]).all()
    assert (it.numpy()[:, 3:] == -1).all()


@pytest.mark.parametrize("mode", ["exact", "approx", "verified", "refined"])
def test_bf16_corpus_is_upcast_a_block_at_a_time(monkeypatch, mode):
    """A bf16 corpus is read as f32 a block of rows at a time
    (``ops.scan_topk.f32_blocks``), so a call never holds an f32 copy of
    the store.  With blocks of 1,000 rows (the last one ragged, twin
    rows on either side of a block edge, masked rows, given squared
    norms) every mode returns the rows it returns over an f32 copy of
    the corpus, ties to the lower index; values within rtol 1e-6 (the
    same f32 sums, in products of another width)."""
    from qrag_tpu_torch.ops import scan_topk as st

    rng = np.random.RandomState(17)
    x = torch.from_numpy(rng.randn(6500, 32).astype(np.float32)).to(torch.bfloat16)
    x[1500] = x[200]  # twins in two blocks
    x[2999], x[3000] = x[10], x[10]  # twins across a block edge
    q = torch.from_numpy(np.concatenate([
        rng.randn(3, 32).astype(np.float32), x[[200, 10]].float().numpy()]))
    valid = torch.ones(6500, dtype=torch.bool)
    valid[4000:4100] = False
    sq = torch.sum(x.float() ** 2, dim=1)

    def run(corpus):
        if mode == "verified":
            s, i, n_bad = T.scan_topk_verified(q, corpus, 12, "l2", sq, valid)
            assert n_bad == 0
            return s, i
        s, i = T.flat_scan_topk(q, corpus, 12, "l2", sq, valid, mode=mode)
        return s.numpy(), i.numpy()

    want_s, want_i = run(x.float())
    monkeypatch.setattr(st, "CAST_ROWS", 1000)
    got_s, got_i = run(x)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)
    assert {200, 1500} <= set(got_i[3]) and {10, 2999, 3000} <= set(got_i[4])
    assert not ((got_i >= 4000) & (got_i < 4100)).any()
