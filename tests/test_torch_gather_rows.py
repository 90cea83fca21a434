"""The port's row gather (``qrag_tpu_torch.ops.gather_rows``, the plain
twin on the CPU) against the JAX gather kernels in interpret mode, as
``tests/test_gather_rows.py`` runs them: bit-equal rows for f32, bf16
and int8, clamped out-of-range and negative indices, M not a multiple
of 256, and odd row widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops.pallas import gather_rows as jg
from qrag_tpu_torch.ops import gather_rows as tg

_DTYPES = {
    "f32": (jnp.float32, torch.float32),
    "bf16": (jnp.bfloat16, torch.bfloat16),
    "int8": (jnp.int8, torch.int8),
}


def _corpus(rng, n, d, name):
    jdt, tdt = _DTYPES[name]
    if name == "int8":
        x = rng.integers(-127, 128, (n, d)).astype(np.int8)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.standard_normal((n, d)).astype(np.float32)
    jx = jnp.asarray(x).astype(jdt)
    # the same rounded values on both sides
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    return jx, tx


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,d,m", [(5000, 128, 700), (4096, 256, 513), (300, 100, 37), (64, 13, 5)])
def test_gather_rows_matches_jax(name, n, d, m):
    rng = np.random.default_rng(n + d + m)
    jx, tx = _corpus(rng, n, d, name)
    idx = rng.integers(-20, n + 20, (m,)).astype(np.int32)  # clamps at both ends
    idx[:3] = [-5, 0, n + 1000]
    want = _jnp(jg.gather_rows(jx, jnp.asarray(idx), rows_per_block=256, interpret=True))
    for it in (torch.int32, torch.int64):
        got = tg.gather_rows(tx, torch.from_numpy(idx).to(it))
        assert got.dtype == tx.dtype and got.shape == (m, d)
        np.testing.assert_array_equal(_tnp(got), want)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_gather_rows_2d_and_blockspec_match_jax(name):
    rng = np.random.default_rng(7)
    jx, tx = _corpus(rng, 4096, 256, name)
    idx = rng.integers(-3, 4100, (16, 32)).astype(np.int32)
    want = _jnp(jg.gather_rows_2d(jx, jnp.asarray(idx), interpret=True))
    got = tg.gather_rows_2d(tx, torch.from_numpy(idx))
    assert got.shape == (16, 32, 256)
    np.testing.assert_array_equal(_tnp(got), want)
    # a 2-D index list that is not contiguous
    got_t = tg.gather_rows_2d(tx, torch.from_numpy(idx).T)
    want_t = jg.gather_rows_2d(jx, jnp.asarray(np.ascontiguousarray(idx.T)), interpret=True)
    np.testing.assert_array_equal(_tnp(got_t), _jnp(want_t))
    flat = idx[:, 0].copy()
    want_bs = _jnp(jg.gather_rows_blockspec(jx, jnp.asarray(flat), interpret=True))
    np.testing.assert_array_equal(_tnp(tg.gather_rows_blockspec(tx, torch.from_numpy(flat))), want_bs)


def test_gather_rows_edges():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert tg.gather_rows(x, torch.zeros(0, dtype=torch.int64)).shape == (0, 3)
    assert tg.gather_rows_2d(x, torch.zeros((2, 0), dtype=torch.int32)).shape == (2, 0, 3)
    with pytest.raises(ValueError):
        tg.gather_rows(torch.zeros((0, 3)), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        tg.gather_rows(x, torch.zeros((2, 2), dtype=torch.int64))  # 1-D only
