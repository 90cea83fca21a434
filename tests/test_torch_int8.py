"""Parity of the port's int8 retrieval ops with the JAX reference, on the
CPU.

Inputs come from numpy seeds and go to ``qrag_tpu`` (CPU, XLA backend,
and the Pallas scans in interpret mode) and to ``qrag_tpu_torch`` (the
plain twins the kernel wrapper runs on a CPU tensor).  Tolerances:

* quantizers: codes and scales bit-equal (both round half to even);
  window quantization residuals to rtol 1e-6;
* int-domain planes (top-1 and top-2): bit-equal, clipped keys included;
  float top-1 planes: bit-equal on dyadic inputs, the plane contract of
  tests/test_torch_planes.py on random ones;
* ``bounded_exact_topk_int8`` on the planted corpora of
  tests/test_bounded_int8.py (copied, with fixed seeds): flags and
  indices equal to JAX's, identity exact against the f32 oracle
  (``_assert_exact``), values to rtol 1e-5;
* ``exact_topk_int8_domain`` / ``full_topk_int8_domain`` on the corpora
  of tests/test_int8_domain.py: indices (identity and tie order) equal
  to JAX's, values to rtol 1e-6;
* ``windowed_scan_topk`` and the row scan (``int8_scan_topk`` ->
  ``refine_candidates``): indices equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops import bounded_topk as jbt
from qrag_tpu.ops import int8_domain as jid
from qrag_tpu.ops import quantize as jq
from qrag_tpu.ops import window_scan as jws
from qrag_tpu.ops.pallas.fused_scan import (
    pallas_packed_window_scan,
    pallas_packed_window_scan_t,
    pallas_packed_window_scan_top2_t,
)
from qrag_tpu.ops.topk import _goodness as j_goodness
from qrag_tpu_torch.ops import bounded_topk as tbt
from qrag_tpu_torch.ops import int8_domain as tid
from qrag_tpu_torch.ops import quantize as tq
from qrag_tpu_torch.ops import window_scan as tws
from qrag_tpu_torch.ops.cuda import fused_scan as tfs

W = 128


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ----------------------------------------------------------------- quantizers


def test_quantizers_bit_equal():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1024, 48)) * 3).astype(np.float32)
    x[:128] = 0.0  # an all-zero window: scale 1.0, codes 0
    x[200] = 0.0  # a zero row
    xs = x.copy()
    xs[5, 7] = 2.5 * np.abs(x[5]).max() / 127  # a half-way code (round to even)
    for fn_j, fn_t in ((jq.quantize_rows, tq.quantize_rows),
                       (jws.quantize_block_rows_device, tws.quantize_block_rows_device),
                       (jid.quantize_query_int8, tid.quantize_query_int8)):
        for arr in (x, xs):
            for a, b in zip(fn_t(_t(arr)), jax.jit(fn_j)(jnp.asarray(arr))):
                _eq(a, b)
    for a, b in zip(tws.quantize_block_rows(x), jws.quantize_block_rows(x)):
        np.testing.assert_array_equal(a, b)
    q8, sc = jws.quantize_block_rows(x)
    sq = (x * x).sum(1, dtype=np.float32)
    np.testing.assert_allclose(
        tbt.window_quant_residuals_device(_t(x), _t(q8), _t(sc)).numpy(),
        np.asarray(jbt.window_quant_residuals_device(
            jnp.asarray(x), jnp.asarray(q8), jnp.asarray(sc))),
        rtol=1e-6,
    )
    # zero-padded code columns (the kernel's d % 16) change nothing
    np.testing.assert_array_equal(
        tbt.window_quant_residuals_device(
            _t(x), tws.pad_cols(_t(q8), 64), _t(sc)).numpy(),
        tbt.window_quant_residuals_device(_t(x), _t(q8), _t(sc)).numpy(),
    )
    _eq(tbt.window_minsqnorms_device(_t(sq)),
        jbt.window_minsqnorms_device(jnp.asarray(sq)))
    _eq(tid.row_int_sqnorms(_t(q8)), jid.row_int_sqnorms(jnp.asarray(q8)))


# --------------------------------------------------------------------- planes


def _int_inputs(seed, b, n, d, clip=False):
    rng = np.random.default_rng(seed)
    if clip:
        # tests/test_bounded_int8.py clip case: +-1 rows quantize to
        # +-127 codes, so an aligned pair's dot is d * 127^2 >> 2^23
        x8 = np.where(rng.standard_normal((n, d)) >= 0, 127, -127).astype(np.int8)
        q8 = np.where(rng.standard_normal((b, d)) >= 0, 127, -127).astype(np.int8)
        q8[0] = x8[5]
        return q8, x8
    x8 = rng.integers(-127, 128, (n, d)).astype(np.int8)
    q8 = rng.integers(-127, 128, (b, d)).astype(np.int8)
    return q8, x8


@pytest.mark.parametrize("bsize", [1, 7, 24])
def test_int_planes_bit_equal(bsize):
    """Top-1 and top-2 int planes against the XLA twins and the Pallas
    int kernels K3, K4 (top-1) and K1 (top-2) in interpret mode."""
    for n, d in ((4096, 128), (4224, 16)):
        q8, x8 = _int_inputs(bsize + d, bsize, n, d)
        lr = jnp.asarray(jws.make_lane_rank(n))
        (t1,) = tfs.packed_window_scan(_t(q8), _t(x8), tws.make_lane_rank(n), planes=1)
        t2 = tfs.packed_window_scan(_t(q8), _t(x8), tws.make_lane_rank(n), planes=2)
        qj, xj = jnp.asarray(q8), jnp.asarray(x8)
        _eq(t1, jws.packed_window_scan(qj, xj, lr))
        for a, b in zip(t2, jbt.packed_window_scan_top2_int(qj, xj, lr)):
            _eq(a, b)
        _eq(t2[0], t1)
        if d % 128 == 0:
            _eq(t1, pallas_packed_window_scan(qj, xj, bn=512, interpret=True))
            _eq(t1, pallas_packed_window_scan_t(qj, xj, bn=1024, interpret=True))
            for a, b in zip(t2, pallas_packed_window_scan_top2_t(
                    qj, xj, bn=1024, interpret=True)):
                _eq(a, b)


def test_int_planes_clipped_keys_bit_equal():
    n, d = 4096, 8192
    q8, x8 = _int_inputs(3, 2, n, d, clip=True)
    lr = jnp.asarray(jws.make_lane_rank(n))
    t2 = tfs.packed_window_scan(_t(q8), _t(x8), tws.make_lane_rank(n), planes=2)
    ref = jbt.packed_window_scan_top2_int(jnp.asarray(q8), jnp.asarray(x8), lr)
    for a, b in zip(t2, ref):
        _eq(a, b)
    assert (t2[0].numpy()[0] >> 7).max() == (1 << 23) - 1  # clipped


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_float_top1_planes(metric):
    """Float planes=1 against the XLA twin (bit-equal on dyadic inputs,
    the plane contract on random ones) and K3/K4 in interpret mode."""
    n, d, b = 4096, 128, 5
    for dyadic in (True, False):
        rng = np.random.default_rng(7 + dyadic)
        if dyadic:
            q = rng.integers(-8, 9, (b, d)).astype(np.float32) / 16
            x = rng.integers(-8, 9, (n, d)).astype(np.float32) / 16
        else:
            q = rng.standard_normal((b, d)).astype(np.float32)
            x = rng.standard_normal((n, d)).astype(np.float32)
        q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        bias = np.where(np.arange(n) % 11 == 3, -np.inf, 0.0).astype(np.float32)[None]
        alpha, ra, ca = 1.0, bias, None
        if metric == "l2":
            alpha = 2.0
            ra = -(x * x).sum(1, dtype=np.float32)[None] + bias
            ca = -(q * q).sum(1, dtype=np.float32, keepdims=True)
        (got,) = tfs.packed_window_scan(
            _t(q).bfloat16(), _t(x).bfloat16(), tws.make_lane_rank(n),
            row_add=_t(ra), col_add=None if ca is None else _t(ca),
            alpha=alpha, planes=1,
        )
        qj, xj = jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
        kw = dict(row_add=jnp.asarray(ra), alpha=alpha,
                  col_add=None if ca is None else jnp.asarray(ca))
        refs = [
            jws.packed_window_scan(qj, xj, jnp.asarray(jws.make_lane_rank(n)), **kw),
            pallas_packed_window_scan(qj, xj, bn=512, interpret=True, **kw),
            pallas_packed_window_scan_t(qj, xj, bn=1024, interpret=True, **kw),
        ]
        for i, ref in enumerate(refs):
            r, g = np.asarray(ref), got.numpy()
            if dyadic:
                np.testing.assert_array_equal(g, r)
                continue
            _, hi_r = jbt.plane_value_bounds(jnp.asarray(r))
            _, hi_g = tbt.plane_value_bounds(_t(g))
            np.testing.assert_allclose(hi_g.numpy(), np.asarray(hi_r),
                                       rtol=1e-4, atol=1e-3)
            same = (r & ~127) == (g & ~127)
            assert same.mean() >= (0.9 if i == 2 else 0.99)
            np.testing.assert_array_equal((r & 127)[same], (g & 127)[same])


# ------------------------------------------------- bounded_exact_topk_int8


def _oracle(q, x, metric, valid, k):
    sq = (x ** 2).sum(1, dtype=np.float32)
    g = j_goodness(
        jnp.asarray(q), jnp.asarray(x), metric, jnp.asarray(sq),
        None if valid is None else jnp.asarray(valid),
        precision=jax.lax.Precision.HIGHEST,
    )
    v, i = jax.lax.top_k(g, k)
    return np.asarray(g), np.asarray(v), np.asarray(i)


def _assert_exact(q, x, metric, k, vals, idx, valid=None, atol=1e-4):
    """The repo's exactness contract: identity equals the f32 oracle
    except where the oracle's own values show a sub-noise tie."""
    g, ov, oi = _oracle(q, x, metric, valid, k)
    if not np.array_equal(idx, oi):
        rows, pos = np.where(idx != oi)
        tol = 3e-4 * (1.0 + np.abs(ov[rows, pos]))
        gap = np.abs(g[rows, idx[rows, pos]] - ov[rows, pos])
        assert (gap <= tol).all(), f"non-tie mismatch: rows {rows} pos {pos}"
    np.testing.assert_allclose(vals, ov, rtol=1e-5, atol=atol)


def _bounded_int8_both(q, x, metric, k, valid=None, atol=1e-4, **kw):
    """JAX and the port on the same inputs; asserts flag, index and
    value parity plus exactness, returns the port's 5-tuple."""
    x = np.asarray(x, np.float32)
    sq = (x ** 2).sum(1, dtype=np.float32)
    q8x, wscale = jws.quantize_block_rows(x)
    n = x.shape[0]
    jres = jbt.bounded_exact_topk_int8(
        jnp.asarray(q), jnp.asarray(q8x), jnp.asarray(wscale), jnp.asarray(x),
        jnp.asarray(sq), jnp.asarray(jbt.window_maxnorms(sq)),
        jbt.window_minsqnorms_device(jnp.asarray(sq)),
        jbt.window_quant_residuals_device(
            jnp.asarray(x), jnp.asarray(q8x), jnp.asarray(wscale)),
        jnp.asarray(jws.make_lane_rank(n)), k, metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid), **kw,
    )
    xt, sqt, q8t, wt = _t(x), _t(sq), _t(q8x), _t(wscale)
    tres = tbt.bounded_exact_topk_int8(
        _t(q), tws.pad_cols(q8t, -(-x.shape[1] // 16) * 16), wt, xt, sqt,
        tbt.window_maxnorms_device(sqt), tbt.window_minsqnorms_device(sqt),
        tbt.window_quant_residuals_device(xt, q8t, wt),
        tws.make_lane_rank(n), k, metric=metric,
        valid_rows=None if valid is None else _t(valid), **kw,
    )
    vals, idx = tres[0].numpy(), tres[1].numpy()
    assert (tres[2], tres[4]) == (bool(jres[2]), bool(jres[4]))
    np.testing.assert_array_equal(idx, np.asarray(jres[1]))
    np.testing.assert_allclose(vals, np.asarray(jres[0]), rtol=1e-5, atol=1e-6)
    _assert_exact(q, x, metric, k, vals, idx, valid=valid, atol=atol)
    return tres


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_bounded_int8_random_and_near_boundary(metric):
    rng = np.random.RandomState(0)
    x = _unit(rng.randn(32768, 64).astype(np.float32))
    q = rng.randn(8, 64).astype(np.float32)
    assert not _bounded_int8_both(q, x, metric, 10)[2]
    # rows planted inside the int8 band around the k-th boundary must
    # become extra candidates or patches, never wrong answers
    rng = np.random.RandomState(1)
    x = _unit(rng.randn(32768, 128).astype(np.float32))
    q = _unit(rng.randn(6, 128).astype(np.float32))
    for j in range(24):
        x[W * (9 * j + 3) + (j % W)] = q[0] * (1.0 - 2e-3 * j)
    _bounded_int8_both(q, x, metric, 10, atol=5e-3)


def test_bounded_int8_norm_spread_and_collision():
    rng = np.random.RandomState(2)
    x = rng.randn(16384, 32).astype(np.float32)
    x *= np.exp(rng.randn(16384, 1)).astype(np.float32)  # lognormal norms
    q = rng.randn(4, 32).astype(np.float32)
    _bounded_int8_both(q, x, "l2", 8, atol=1e-2)
    x = 0.05 * rng.randn(16384, 32).astype(np.float32)
    q = rng.randn(4, 32).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for j, off in enumerate((3, 40, 100)):
        x[23 * W + off] = t * (4.0 + 0.01 * j)
    res = _bounded_int8_both(q, x, "ip", 8)
    assert {23 * W + 3, 23 * W + 40, 23 * W + 100} <= set(res[1].numpy()[0].tolist())


@pytest.mark.parametrize("count,stride,fell_back", [(20, 2, False), (40, 1, True)])
def test_bounded_int8_escalation(count, stride, fell_back):
    """Near-tied tops in `count` windows with C=8: 20 escalate and
    certify at 4C=32 (no full sort); 40 exceed 4C and fall back."""
    rng = np.random.RandomState(3)
    x = rng.randn(8192, 16).astype(np.float32)
    q = rng.randn(4, 16).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for j in range(count):
        x[j * W * stride + 5] = t * (5.0 + 1e-6 * j)
    res = _bounded_int8_both(q, x, "ip", 6, candidates=8)
    assert res[4] and res[2] == fell_back


def test_bounded_int8_clip_falls_back():
    rng = np.random.RandomState(4)
    x = np.sign(rng.randn(4096, 8192)).astype(np.float32)
    q = np.sign(rng.randn(2, 8192)).astype(np.float32)
    q[0] = x[5]  # aligned pair: the int dot clips at 2^23
    res = _bounded_int8_both(q, x, "ip", 5, atol=1e-1)
    assert res[2] and not res[4]  # straight to the full sort


def test_bounded_int8_valid_rows_and_padding_windows():
    rng = np.random.RandomState(5)
    n, d = 4096, 32
    x = np.abs(rng.randn(n, d)).astype(np.float32)
    q = -np.abs(rng.randn(4, d)).astype(np.float32)  # every score negative
    valid = np.ones(n, bool)
    valid[n - 300:] = False  # trailing padding + one partial window
    x[n - 300:] = 0.0
    for metric in ("ip", "l2"):
        res = _bounded_int8_both(q, x, metric, 5, valid=valid)
        assert (res[1].numpy() < n - 300).all()


# ------------------------------------------------------ own-domain int8


def _own_both(q, x, k, metric, valid=None, **kw):
    x8, sc = jax.jit(jws.quantize_block_rows_device)(jnp.asarray(x))
    isq = jid.row_int_sqnorms(x8)
    n = x.shape[0]
    vj = None if valid is None else jnp.asarray(valid)
    vt = None if valid is None else _t(valid)
    x8t = tws.pad_cols(_t(x8), -(-x.shape[1] // 16) * 16)
    isqt = tid.row_int_sqnorms(x8t)
    _eq(isqt, isq)
    if n // W < k:
        jres = jid.full_topk_int8_domain(jnp.asarray(q), x8, sc, isq, k,
                                         metric=metric, valid_rows=vj)
        tres = tid.full_topk_int8_domain(_t(q), x8t, _t(sc), isqt, k,
                                         metric=metric, valid_rows=vt)
    else:
        jres = jid.exact_topk_int8_domain(
            jnp.asarray(q), x8, sc, isq, jnp.asarray(jws.make_lane_rank(n)),
            k, metric=metric, valid_rows=vj, **kw)
        tres = tid.exact_topk_int8_domain(
            _t(q), x8t, _t(sc), isqt, tws.make_lane_rank(n), k,
            metric=metric, valid_rows=vt, **kw)
        assert (tres[2], tres[4]) == (bool(jres[2]), bool(jres[4]))
        assert int(tres[3]) == int(jres[3])
    np.testing.assert_array_equal(tres[1].numpy(), np.asarray(jres[1]))
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]), rtol=1e-6)
    return tres


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_domain_random_ties_and_single(metric):
    rng = np.random.default_rng(0)
    x = _unit(rng.standard_normal((32768, 128), np.float32))
    q = rng.standard_normal((8, 128), np.float32)
    assert not _own_both(q, x, 10, metric)[2]
    # 16 distinct rows tiled 128x: ties across > C windows escalate or
    # fall back, and the index tie order must survive it
    rng = np.random.default_rng(1)
    x = np.tile(rng.standard_normal((16, 64), np.float32), (128, 1))
    q = rng.standard_normal((4, 64), np.float32)
    res = _own_both(q, x, 10, metric, candidates=16)
    assert res[2] or res[4]
    rng = np.random.default_rng(4)
    _own_both(rng.standard_normal((1, 100), np.float32),
              rng.standard_normal((16384, 100), np.float32), 10, metric)


def test_int8_domain_patch_valid_rows_and_clip():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8192, 128), np.float32)
    x /= 10.0 * np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((2, 128), np.float32)
    qn = q[0] / np.linalg.norm(q[0])
    x[130], x[131] = qn, qn * 0.999  # global top-2 in one window
    res = _own_both(q, x, 5, "ip")
    assert not res[2] and int(res[3]) >= 1
    rng = np.random.default_rng(3)
    n, ntotal = 16384, 15000
    q = np.abs(rng.standard_normal((4, 128)).astype(np.float32))
    x = -np.abs(rng.standard_normal((n, 128)).astype(np.float32))
    x[ntotal:] = 0.0  # zero padding codes carry dot 0
    valid = np.arange(n) < ntotal
    for metric in ("ip", "l2"):
        _own_both(q, x, 10, metric, valid=valid)
    x = np.ones((1024, 768), np.float32)
    x[:, 0] += np.arange(1024, dtype=np.float32) / 1024
    assert _own_both(np.ones((2, 768), np.float32), x, 5, "ip")[2]  # clip
    rng = np.random.default_rng(5)
    _own_both(rng.standard_normal((3, 64), np.float32),
              rng.standard_normal((256, 64), np.float32), 10, "l2")  # full sort


# ----------------------------------------------------- windowed / row scan


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_windowed_scan_topk_int_domain(metric):
    rng = np.random.default_rng(10)
    n, ntotal, d = 16384, 16000, 96
    x = _unit(rng.standard_normal((n, d)).astype(np.float32))
    x[ntotal:] = 0.0
    q = _unit(x[rng.choice(ntotal, 6)] + 0.1 * rng.standard_normal((6, d)).astype(np.float32))
    sq = (x * x).sum(1, dtype=np.float32)
    x8, sc = jws.quantize_block_rows(x)
    for exact in (True, False):
        kw = dict(k=10, metric=metric, refine_factor=4, exact_scores=exact)
        vj, ij = jws.windowed_scan_topk(
            jnp.asarray(q), jnp.asarray(x8), jnp.asarray(x),
            jnp.asarray(jws.make_lane_rank(n)), corpus_sqnorms=jnp.asarray(sq),
            window_scale=jnp.asarray(sc), ntotal=jnp.asarray(ntotal), **kw)
        vt, it = tws.windowed_scan_topk(
            _t(q), tws.pad_cols(_t(x8), 96), _t(x), tws.make_lane_rank(n),
            corpus_sqnorms=_t(sq), window_scale=_t(sc), ntotal=ntotal, **kw)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
        assert (it.numpy() < ntotal).all()


def test_windowed_scan_topk_float_domain_dyadic():
    rng = np.random.default_rng(11)
    n, d = 8192, 64
    x = rng.integers(-8, 9, (n, d)).astype(np.float32) / 16
    q = rng.integers(-8, 9, (4, d)).astype(np.float32) / 16
    sq = (x * x).sum(1, dtype=np.float32)
    valid = np.arange(n) % 13 != 0
    for metric in ("l2", "ip"):
        vj, ij = jws.windowed_scan_topk(
            jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), jnp.asarray(x),
            jnp.asarray(jws.make_lane_rank(n)), 8, metric=metric,
            corpus_sqnorms=jnp.asarray(sq), valid_rows=jnp.asarray(valid))
        vt, it = tws.windowed_scan_topk(
            _t(q), _t(x).bfloat16(), _t(x), tws.make_lane_rank(n), 8,
            metric=metric, corpus_sqnorms=_t(sq), valid_rows=_t(valid))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_row_scan_then_refine(metric):
    rng = np.random.default_rng(12)
    n, d, k = 16384, 64, 10
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = x[rng.choice(n, 8)] + 0.3 * rng.standard_normal((8, d)).astype(np.float32)
    sq = (x * x).sum(1, dtype=np.float32)
    valid = np.arange(n) < n - 100
    x8, xs = jq.quantize_rows(jnp.asarray(x))
    q8, qs = jq.quantize_rows(jnp.asarray(q))
    qsq = (q * q).sum(1)
    gj, cj = jq.int8_scan_topk(q8, qs, x8, xs, 4 * k, metric=metric,
                               corpus_sqnorms=jnp.asarray(sq),
                               query_sqnorms=jnp.asarray(qsq),
                               valid_rows=jnp.asarray(valid))
    vj, ij = jq.refine_candidates(jnp.asarray(q), jnp.asarray(x), cj, gj, k,
                                  metric=metric, corpus_sqnorms=jnp.asarray(sq))
    gt, ct = tq.int8_scan_topk(_t(q8), _t(qs), _t(x8), _t(xs), 4 * k,
                               metric=metric, corpus_sqnorms=_t(sq),
                               query_sqnorms=_t(qsq), valid_rows=_t(valid))
    vt, it = tq.refine_candidates(_t(q), _t(x), ct, gt, k, metric=metric,
                                  corpus_sqnorms=_t(sq))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5, atol=1e-5)
    # the int8 product itself: exact, and padded past _int_mm's shape rules
    ref = np.asarray(q8, np.int64) @ np.asarray(x8, np.int64)[:77].T
    np.testing.assert_array_equal(tq.int8_matmul(_t(q8), _t(x8)[:77]).numpy(), ref)
