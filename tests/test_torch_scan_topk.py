"""The port's fused scan + top-k (``qrag_tpu_torch.ops.scan_topk``, the
plain twin on the CPU) against the JAX ``pallas_scan_topk`` in interpret
mode, on the shapes of ``tests/test_pallas_scan.py``: indices equal,
values within rtol 1e-5 / atol 1e-5 (the two frameworks sum the dots in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops.pallas.scan_topk import pallas_scan_topk
from qrag_tpu_torch.ops import scan_topk as ts

_CD = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _both(q, x, k, metric, valid=None, cd="f32", tile_n=None):
    jcd, tcd = _CD[cd]
    sj, ij = pallas_scan_topk(
        jnp.asarray(q), jnp.asarray(x), k, metric=metric,
        valid_rows=None if valid is None else jnp.asarray(valid),
        compute_dtype=jcd, tile_n=tile_n,
    )
    st, it = ts.scan_topk(
        torch.from_numpy(q), torch.from_numpy(x), k, metric,
        valid_rows=None if valid is None else torch.from_numpy(valid),
        compute_dtype=tcd,
    )
    assert st.shape == it.shape == (q.shape[0], k) and it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-5)
    return st.numpy(), it.numpy()


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize(
    "b,n,d,k",
    [
        (4, 300, 64, 10),  # unaligned everything
        (1, 128, 128, 5),  # aligned, single query
        (9, 1000, 48, 7),  # odd batch
    ],
)
def test_scan_topk_matches_jax(metric, b, n, d, k, cd):
    rng = np.random.default_rng(b * 1000 + n + d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    _both(q, x, k, metric, cd=cd)


def test_scan_topk_valid_rows_and_multi_tile():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    x = rng.standard_normal((256, 32)).astype(np.float32)
    x[200:] = 0.0
    valid = np.zeros(256, bool)
    valid[:200] = True
    _, i = _both(q, x, 8, "l2", valid)
    assert i.max() < 200
    # three reference tiles: the running buffer carries across them
    _both(q, x, 8, "ip", valid, tile_n=128)


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_scan_topk_k_exceeds_valid_rows(metric):
    """Fewer valid rows than k: the remaining slots are sentinels, index
    -1 and an infinite score, as the reference returns them."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    x = rng.standard_normal((64, 16)).astype(np.float32)
    valid = np.zeros(64, bool)
    valid[:5] = True
    s, i = _both(q, x, 8, metric, valid)
    assert np.all(np.isfinite(s[:, :5])) and np.all(np.isinf(s[:, 5:]))
    assert set(i[0, :5]) == set(range(5)) and np.all(i[:, 5:] == -1)


def test_scan_topk_duplicate_rows_tie_to_lower_index():
    rng = np.random.default_rng(3)
    x = np.repeat(rng.standard_normal((10, 16)).astype(np.float32), 3, axis=0)
    _, i = _both(rng.standard_normal((1, 16)).astype(np.float32), x, 6, "ip")
    assert list(i[0, :3]) == sorted(i[0, :3])


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_scan_topk_k_above_128(cd):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 32)).astype(np.float32)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    _both(q, x, 150, "l2", cd=cd)


def test_scan_topk_rejects_bad_inputs():
    x = torch.zeros((8, 4))
    for args in ((x[:1], x, 0), (x[:1], x, 9), (x[:1, :3], x, 2)):
        with pytest.raises(ValueError):
            ts.scan_topk(*args)
    with pytest.raises(ValueError):
        ts.scan_topk(x[:1], x, 2, metric="cosine")
    with pytest.raises(ValueError):
        ts.scan_topk(x[:1], x, 2, compute_dtype=torch.float16)
