"""Parity of the PyTorch ``bounded_exact_topk`` with the JAX reference.

The seeded cases of tests/test_bounded_topk.py (sizes cut to at most
32768 x 128) go to both ``qrag_tpu`` (CPU, XLA backend) and
``qrag_tpu_torch`` (CPU, plain scan twin).  Each must give indices and
certificate flags equal to JAX's, values to rtol 1e-5 / atol 1e-4, and
exactness against the f32 oracle (``_assert_exact``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops import bounded_topk as jbt
from qrag_tpu.ops import window_scan as jws
from qrag_tpu.ops.topk import _goodness as j_goodness
from qrag_tpu_torch.ops import bounded_topk as tbt
from qrag_tpu_torch.ops import window_scan as tws

WINDOW = 128


def _t(a):
    return torch.from_numpy(np.array(a))


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


def _run_both(q, x, metric, k, x_scan=None, valid=None, **kw):
    """JAX ``bounded_exact_topk`` (XLA) and the port on the same inputs;
    asserts index/flag/value parity and exactness, returns the port's
    5-tuple."""
    bf16 = x_scan == "bf16"  # scan over the bf16 copy of x
    sq = (x ** 2).sum(1, dtype=np.float32)
    mx = jbt.window_maxnorms(sq)
    jres = jbt.bounded_exact_topk(
        jnp.asarray(q),
        jnp.asarray(x, jnp.bfloat16) if bf16 else jnp.asarray(x),
        jnp.asarray(x), jnp.asarray(sq), jnp.asarray(mx),
        jnp.asarray(jws.make_lane_rank(x.shape[0])), k, metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid), **kw,
    )
    tres = tbt.bounded_exact_topk(
        _t(q), _t(x).bfloat16() if bf16 else _t(x), _t(x), _t(sq),
        _t(mx), tws.make_lane_rank(x.shape[0]), k, metric=metric,
        valid_rows=None if valid is None else _t(valid), **kw,
    )
    vals, idx = tres[0].numpy(), tres[1].numpy()
    np.testing.assert_array_equal(idx, np.asarray(jres[1]))
    assert tres[2] == bool(jres[2]) and tres[4] == bool(jres[4])
    assert int(tres[3]) == int(jres[3])
    np.testing.assert_allclose(vals, np.asarray(jres[0]), rtol=1e-5, atol=1e-4)
    if valid is None:
        _assert_exact(q, x, metric, k, vals, idx,
                      atol=5e-3 if bf16 else 1e-4)
    else:
        _, ov, oi = _oracle(q, x, metric, valid, k)
        np.testing.assert_array_equal(idx, oi)
    return tres


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_random_exact(metric):
    rng = np.random.RandomState(0)
    n, d, b, k = 32768, 64, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    res = _run_both(q, x, metric, k)
    assert not res[2]


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_window_collision_patch_path(metric):
    rng = np.random.RandomState(1)
    n, d, b, k = 16384, 32, 4, 8
    x = 0.05 * rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    target = q[0] / np.linalg.norm(q[0])
    for j, off in enumerate((3, 40, 100)):
        x[17 * WINDOW + off] = target * (4.0 + 0.001 * j)
    res = _run_both(q, x, metric, k)
    assert not res[2] and int(res[3]) >= 1


def test_exact_tie_break_lower_index():
    rng = np.random.RandomState(2)
    n, d, b, k = 4096, 16, 3, 12
    x = np.tile(rng.randn(32, d).astype(np.float32), (n // 32, 1))
    q = rng.randn(b, d).astype(np.float32)
    _run_both(q, x, "ip", k)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_bf16_scan_f32_refine_margins(metric):
    """Planted near-boundary rows: slightly-decayed copies of the top
    direction (the trap where rounding margins must hold)."""
    rng = np.random.RandomState(3)
    n, d, b, k = 32768, 128, 8, 10
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    step = 5e-3 if metric == "l2" else 1e-4
    for j in range(24):
        x[128 * (7 * j + 1) + (j % WINDOW)] = q[0] * (1.0 - step * j)
    _run_both(q, x, metric, k, x_scan="bf16")


def _planted_far_windows(seed, count, stride):
    rng = np.random.RandomState(seed)
    n, d, b = 8192, 16, 4
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for j in range(count):
        x[j * WINDOW * stride + 5] = t * (5.0 + 1e-6 * j)
    return q, x


def test_cert_failure_escalates_without_full_sort():
    q, x = _planted_far_windows(4, 20, 2)  # 20 windows > C=8, < 4C
    res = _run_both(q, x, "ip", 6, candidates=8)
    assert res[4] and not res[2]


def test_cert_failure_beyond_escalation_falls_back_exact():
    q, x = _planted_far_windows(5, 40, 1)  # 40 windows > 4C=32
    res = _run_both(q, x, "ip", 6, candidates=8)
    assert res[4] and res[2]


def test_multiflag_query_falls_back_exact():
    rng = np.random.RandomState(6)
    n, d, b, k = 8192, 16, 4, 10
    x = 0.05 * rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    for wi, w in enumerate((3, 19, 40)):
        x[w * WINDOW + 7] = t * (4.0 + 0.01 * wi)
        x[w * WINDOW + 90] = t * (4.0 + 0.005 * wi)
    res = _run_both(q, x, "ip", k)
    assert res[2]


def test_valid_rows_mask():
    rng = np.random.RandomState(7)
    n, d, b, k = 4096, 32, 4, 5
    x = rng.randn(n, d).astype(np.float32)
    q = x[:b] + 0.01 * rng.randn(b, d).astype(np.float32)
    valid = np.ones(n, bool)
    valid[: b // 2] = False
    _run_both(q, x, "l2", k, valid=valid)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_large_k_random_exact(metric):
    rng = np.random.RandomState(8)
    n, d, b, k = 32768, 64, 8, 64
    x = rng.randn(n, d).astype(np.float32)
    q = rng.randn(b, d).astype(np.float32)
    res = _run_both(q, x, metric, k)
    assert not res[2]


def _plant_large_k(seed, k, doubles, triples=0):
    """Background + a planted top-k for query 0 that fills all k ranks
    (doubles/triples share windows, singles get their own)."""
    trng = np.random.RandomState(seed)
    n, d, b = 16384, 32, 4
    x = 0.05 * trng.randn(n, d).astype(np.float32)
    q = trng.randn(b, d).astype(np.float32)
    t = q[0] / np.linalg.norm(q[0])
    w = 3
    for j in range(doubles):
        x[w * WINDOW + 9] = t * (4.0 + 0.01 * j)
        x[w * WINDOW + 70] = t * (3.7 + 0.01 * j)
        w += 5
    for j in range(triples):
        for lane, s in ((7, 3.9), (60, 3.8), (101, 3.75)):
            x[w * WINDOW + lane] = t * (s + 0.01 * j)
        w += 5
    for j in range(k - 2 * doubles - 3 * triples):
        x[w * WINDOW + 33] = t * (3.5 + 0.01 * j)
        w += 5
    return q, x


def test_large_k_double_collisions_runner_layer():
    q, x = _plant_large_k(42, 30, doubles=12)
    assert not _run_both(q, x, "ip", 30)[2]


def test_large_k_triple_collision_window_patch():
    q, x = _plant_large_k(43, 20, doubles=4, triples=1)
    res = _run_both(q, x, "ip", 20)
    assert not res[2] and int(res[3]) >= 1


def test_large_k_runner_budget_escalates():
    q, x = _plant_large_k(44, 24, doubles=8)
    res = _run_both(q, x, "ip", 24, runner_rows=4)
    assert res[4] and not res[2]


def test_large_k_beyond_runner_escalation_falls_back():
    q, x = _plant_large_k(45, 30, doubles=12)
    assert _run_both(q, x, "ip", 30, runner_rows=2)[2]


def test_large_k_bf16_scan_margins():
    rng = np.random.RandomState(9)
    n, d, b, k = 32768, 128, 6, 48
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for j in range(10):
        w = 11 * j + 3
        x[w * WINDOW + 2] = q[0] * (1.0 - 5e-3 * j)
        x[w * WINDOW + 77] = q[0] * (1.0 - 5e-3 * j - 1e-3)
    _run_both(q, x, "l2", k, x_scan="bf16")


def test_large_k_dense_regime():
    """k = NW/4: the per-query whole-window patch cap widens past 2
    (the top_k selection branch of cert_b)."""
    rng = np.random.RandomState(10)
    n, d, b, k = 32768, 128, 16, 64
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.randn(b, d).astype(np.float32)
    _run_both(q, x, "l2", k, x_scan="bf16")
