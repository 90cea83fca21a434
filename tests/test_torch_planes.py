"""Parity of the PyTorch scan planes and small helpers with the JAX
reference, on the CPU.

Inputs come from numpy seeds and go to both ``qrag_tpu`` (the XLA
twins, and the Pallas scans in interpret mode) and ``qrag_tpu_torch``
(the plain twins the kernel wrapper runs on a CPU tensor).  Planes are
bit-equal on dyadic inputs (every sum exact in f32); on random inputs
they meet the repo's plane contract (tests/test_bounded_topk.py):
upper value bounds to rtol 1e-4 / atol 1e-3, trunc keys equal on
>= 99% of entries (>= 90% against the transposed kernel, whose
contraction order differs), lanes equal wherever the keys agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops import bounded_topk as jbt
from qrag_tpu.ops import window_scan as jws
from qrag_tpu.ops.pallas.fused_scan import (
    pallas_packed_window_scan_top2,
    pallas_packed_window_scan_top2_t,
)
from qrag_tpu_torch.ops import bounded_topk as tbt
from qrag_tpu_torch.ops import topk as ttopk
from qrag_tpu_torch.ops import window_scan as tws
from qrag_tpu_torch.ops.cuda import fused_scan as tfs


def _t(a):
    return torch.from_numpy(np.array(a))


def _plane_inputs(seed, b, n, d, metric, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        q = rng.integers(-8, 9, (b, d)).astype(np.float32) / 16
        x = rng.integers(-8, 9, (n, d)).astype(np.float32) / 16
    else:
        q = rng.standard_normal((b, d)).astype(np.float32)
        x = rng.standard_normal((n, d)).astype(np.float32)
    # the production scan dtype; dyadic values are exact in bf16
    q = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    valid = np.ones(n, bool)
    valid[3::11] = False  # invalid rows ride row_add as -inf
    bias = np.where(valid, 0.0, -np.inf).astype(np.float32)[None, :]
    alpha, ra, ca = 1.0, bias, None
    if metric == "l2":
        alpha = 2.0
        ra = -(x * x).sum(1, dtype=np.float32)[None, :] + bias
        ca = -(q * q).sum(1, dtype=np.float32, keepdims=True)
    return q, x, alpha, ra, ca


def _port_planes(q, x, alpha, ra, ca, planes):
    return tfs.packed_window_scan(
        _t(q).bfloat16(), _t(x).bfloat16(), tws.make_lane_rank(x.shape[0]),
        row_add=None if ra is None else _t(ra),
        col_add=None if ca is None else _t(ca),
        alpha=alpha, planes=planes,
    )


def _jax_planes(q, x, alpha, ra, ca, planes, kind):
    qj = jnp.asarray(q, jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    raj = None if ra is None else jnp.asarray(ra)
    caj = None if ca is None else jnp.asarray(ca)
    if kind == "xla":
        twin = jbt.packed_window_scan_top3 if planes == 3 else jbt.packed_window_scan_top2
        return twin(qj, xj, jnp.asarray(jws.make_lane_rank(x.shape[0])),
                    row_add=raj, col_add=caj, alpha=alpha)
    if kind == "pallas_t":
        return pallas_packed_window_scan_top2_t(
            qj, xj, bn=1024, row_add=raj, col_add=caj, alpha=alpha,
            interpret=True, planes=planes,
        )
    return pallas_packed_window_scan_top2(
        qj, xj, row_add=raj, col_add=caj, alpha=alpha, interpret=True,
    )


def _assert_plane_contract(ref, got, min_key_share):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        r, g = np.asarray(r), g.numpy()
        assert r.shape == g.shape and g.dtype == np.int32
        _, hi_r = jbt.plane_value_bounds(jnp.asarray(r))
        _, hi_g = tbt.plane_value_bounds(_t(g))
        np.testing.assert_allclose(
            hi_g.numpy(), np.asarray(hi_r), rtol=1e-4, atol=1e-3
        )
        same_key = (r & ~127) == (g & ~127)
        assert same_key.mean() >= min_key_share
        np.testing.assert_array_equal((r & 127)[same_key], (g & 127)[same_key])


@pytest.mark.parametrize("bsize", [1, 7, 24])
@pytest.mark.parametrize("planes", [2, 3])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_planes_match_jax(metric, planes, bsize):
    """Random and dyadic inputs against the XLA twin and the Pallas
    kernels in interpret mode (the straight kernel has planes=2 only)."""
    n, d = 4096, 128
    kinds = ["xla", "pallas_t"] + (["pallas"] if planes == 2 else [])
    for dyadic in (True, False):
        q, x, alpha, ra, ca = _plane_inputs(
            10 * bsize + planes, bsize, n, d, metric, dyadic
        )
        got = _port_planes(q, x, alpha, ra, ca, planes)
        assert len(got) == planes
        for kind in kinds:
            ref = _jax_planes(q, x, alpha, ra, ca, planes, kind)
            if dyadic:
                for r, g in zip(ref, got):
                    np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            else:
                share = 0.9 if kind == "pallas_t" else 0.99
                _assert_plane_contract(ref, got, share)


def test_plane_helpers_bit_equal():
    vals = np.array(
        [-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 0.5, 7.0, np.inf], np.float32
    )
    kj = np.asarray(jws._float_sort_key(jnp.asarray(vals)))
    kt = tws._float_sort_key(_t(vals)).numpy()
    np.testing.assert_array_equal(kt, kj)
    keys = (kj & ~127).astype(np.int32)
    keys = np.concatenate([keys, np.array([-(2 ** 31)], np.int32)])
    np.testing.assert_array_equal(
        tws._float_from_key(_t(keys)).numpy().view(np.int32),
        np.asarray(jws._float_from_key(jnp.asarray(keys))).view(np.int32),
    )
    np.testing.assert_array_equal(
        tws.make_lane_rank(300).numpy(), jws.make_lane_rank(300)
    )
    pk = (keys | 5).astype(np.int32)[None, :]
    for a, b_ in zip(tbt.plane_value_bounds(_t(pk)),
                     jbt.plane_value_bounds(jnp.asarray(pk))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    for dom in (False, True):
        for a, b_ in zip(tws.unpack_stats(_t(pk), dom),
                         jws.unpack_stats(jnp.asarray(pk), dom)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))


def test_scan_dispatch_rejects_int8():
    q = torch.zeros((2, 16), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        tfs.packed_window_scan(q, torch.zeros((128, 16), dtype=torch.int8),
                               tws.make_lane_rank(128))


def test_budget_and_margin_functions_match():
    pairs = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
    for qd in pairs:
        for sd in pairs:
            for rd in pairs:
                for d in (16, 128, 768, 1536):
                    assert tbt.margin_coeff(qd[1], sd[1], rd[1], d) == (
                        jbt.margin_coeff(qd[0], sd[0], rd[0], d)
                    )
                    for c, f in ((None, None), (7, None), (None, 5)):
                        assert tbt._auto_budgets(c, f, qd[1], sd[1], rd[1], d) == (
                            jbt._auto_budgets(c, f, qd[0], sd[0], rd[0], d)
                        )
    for k in (1, 10, 30, 64, 100):
        for nw in (32, 128, 8192):
            assert tbt._auto_runner_budget(k, nw) == jbt._auto_runner_budget(k, nw)
    assert tbt._LARGE_K_AUTO == jbt._LARGE_K_AUTO
    assert (tbt._EPS_ACC, tbt._BF16_HALF_ULP, tbt._SAFETY) == (
        jbt._EPS_ACC, jbt._BF16_HALF_ULP, jbt._SAFETY
    )
    sq = np.random.default_rng(1).random(1000).astype(np.float32)
    np.testing.assert_array_equal(tbt.window_maxnorms(sq), jbt.window_maxnorms(sq))
    sq_pad = np.concatenate([sq, np.zeros(24, np.float32)])
    np.testing.assert_array_equal(
        tbt.window_maxnorms_device(_t(sq_pad)).numpy(),
        np.asarray(jbt.window_maxnorms_device(jnp.asarray(sq_pad))),
    )


def test_topk_tiebreak_and_top_k_match_lax():
    rng = np.random.default_rng(2)
    g = rng.integers(0, 4, (5, 40)).astype(np.float32)  # heavy ties
    g[:, ::7] = -np.inf
    idx = rng.permutation(400)[:200].reshape(5, 40).astype(np.int32)
    vj, ij = jbt.topk_tiebreak(jnp.asarray(g), jnp.asarray(idx), 12)
    vt, it = tbt.topk_tiebreak(_t(g), _t(idx).long(), 12)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    vj, ij = jax.lax.top_k(jnp.asarray(g), 9)
    vt, it = ttopk.top_k(_t(g), 9)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
