"""The port's fused scan + top-k (``qrag_tpu_torch.ops.scan_topk``, the
plain twin on the CPU) against the JAX ``pallas_scan_topk`` in interpret
mode, on the shapes of ``tests/test_pallas_scan.py``: indices equal,
values within rtol 1e-5 / atol 1e-5 (the two frameworks sum the dots in
another order); and the CUDA wrapper's choice of arm, tile, buffer and
row split (``ops.cuda.scan_topk._config``) against what
``csrc/scan_topk.cu`` instantiates and a block's shared memory.
"""

import re
from pathlib import Path

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


_CU = Path(ts.__file__).resolve().parents[1] / "csrc" / "scan_topk.cu"


def _source_instances():
    """(arm, bf16, qt, vec) of every dispatch line of the CUDA source."""
    pat = re.compile(
        r"if \(arm == k(\w+) && qt == (\d+)(?: && vec == (\d))?(?: && (!?)BF16)?\) "
        r"return launch_(\w+?)(?:<BF16, (\d+)(?:, (\d))?>|<\w+>)?\(a\);"
    )
    out = set()
    for arm, qt, vec, neg, fn, tqt, tvec in pat.findall(_CU.read_text()):
        assert fn == arm.lower()
        assert tqt in ("", qt) and tvec in ("", vec)  # template = condition
        # a template instance serves both compute types; the two
        # plain kernels name theirs (BF16 or !BF16) in the condition
        bf16s = (False, True) if tqt else (neg == "",)
        for bf16 in bf16s:
            for v in ((int(vec),) if vec else (4, 1)):
                name = arm.lower() + (qt if arm == "Wgmma" else "")
                out.add((name, bf16, int(qt), v))
    return out


def test_scan_topk_instances_match_source():
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    src = _CU.read_text()
    assert _source_instances() == set(ct.INSTANCES)
    for arm, const in (("general", "kRows"), ("stream", "kStreamChunk"),
                       ("tiled", "kTileChunk"), ("wgmma64", "kMmaChunk"),
                       ("wgmma128", "kMmaChunk")):
        (value,) = re.findall(rf"constexpr int {const} = (\d+);", src)
        assert int(value) == ct.CHUNK[arm]
    for arm, const in (("general", "kRows"), ("stream", "kStreamChunk"),
                       ("tiled", "kTileR"), ("wgmma64", "kMmaR"), ("wgmma128", "kMmaR")):
        (value,) = re.findall(rf"constexpr int {const} = (\d+);", src)
        assert ct.TILE_ROWS[arm] % int(value) == 0
    ids = dict(re.findall(r"k(\w+) = (\d)", re.search(r"enum Arm \{(.*?)\}", src).group(1)))
    assert {a: ct.ARM_IDS[a] for a in ct.ARM_IDS} == {
        a: int(ids[a.rstrip("0123456789").capitalize()]) for a in ct.ARM_IDS
    }


@pytest.mark.parametrize("b", [1, 2, 8, 9, 16, 17, 32, 33, 64, 65, 200, 1024])
def test_scan_topk_config_grid(b):
    """Every (arm, tile, buffer, split) that ``_config`` returns is an
    instance of the source, holds k entries and one more chunk, covers
    the rows, and fits a block's shared memory."""
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    arms = set()
    for n in (50, 5000, 100_000, 1_250_176):
        for k in (1, 10, 24, 25, 50, 64, 65, 100, 129, 256, 257, 768, 769, 1000, 1024):
            if k > n:
                continue
            for d in (13, 100, 768, 1024, 4096):
                for bf16 in (False, True):
                    for aligned in (d % 4 == 0, False):
                        c = ct._config(b, n, k, d, bf16, aligned, 132)
                        arms.add(c.arm)
                        assert (c.arm, bf16, c.qt, c.vec) in ct.INSTANCES, c
                        assert c.vec == (4 if aligned else 1)
                        assert c.buf & (c.buf - 1) == 0 and k + ct.CHUNK[c.arm] <= c.buf, c
                        assert c.splits * c.rows >= n > (c.splits - 1) * c.rows, c
                        assert c.rows % ct.TILE_ROWS[c.arm] == 0
                        assert ct.smem_bytes(c.arm, c.qt, c.buf, d) <= ct.SMEM_LIMIT, c
                        if c.arm == "stream":
                            assert b <= ct.STREAM_MAX_B[bf16]
                        if c.arm in ("tiled", "wgmma64", "wgmma128"):
                            assert aligned and bf16 == (c.arm != "tiled")
    assert arms >= ({"stream"} if b <= 64 else {"general"})
    if 8 < b <= 64:
        assert "wgmma64" in arms and "wgmma128" not in arms
    if b > 64:  # d = 1024 is past the wide arm's shared memory, 4096 past both
        assert arms == {"general", "tiled", "wgmma64", "wgmma128"}


def test_scan_topk_config_forced_arm():
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    assert ct._config(64, 100_000, 10, 768, True, True, 132, arm="stream").arm == "stream"
    assert ct._config(8, 100_000, 10, 768, False, True, 132, arm="general").qt == 16
    assert ct._config(8, 100_000, 10, 768, False, True, 132, arm="tiled").qt == 128
    assert ct._config(65, 100_000, 10, 768, True, True, 132, arm="stream").qt == 8
    # a depth past the arm's shared memory, the wrong compute type, k past the tile's buffer
    for bad in (dict(d=60_000, arm="stream"), dict(arm="wgmma64"), dict(k=65, arm="tiled")):
        kw = dict(b=64, n=100_000, k=10, d=768, bf16=False, aligned=True, sms=132)
        kw.update(bad)
        with pytest.raises(ValueError):
            ct._config(**kw)


def test_cuda_wrappers_raise_on_cpu_tensors():
    """Handed CPU tensors, the kernel wrappers raise: nothing falls
    back to a plain twin."""
    from qrag_tpu_torch.ops.cuda import fused_scan, gather_rows, scan_topk

    x = torch.zeros((256, 16))
    with pytest.raises(ValueError, match="CUDA"):
        scan_topk.scan_topk_cuda(x[:2], x[:2, 0], x, x[:, 0], None, 3, True, False)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rows.gather_rows_cuda(x, torch.arange(4))
    with pytest.raises(ValueError, match="CUDA"):
        fused_scan.packed_window_scan_cuda(x[:2].bfloat16(), x.bfloat16(), None, None, 1.0, 2)
    assert gather_rows.launches == 0 and not any(scan_topk.launches.values())
