"""``bench_torch.py`` on the CPU: each section's step function against
the JAX composition ``bench.py`` times, and the script's contract.

The same numpy inputs (fixed seeds; n=4096, d=64, B=8, two dependent
steps as the timed loops chain them) go through the ``qrag_tpu``
functions and through the port's step on ``device="cpu"``: the same
indices in the same tie order, goodness within 1e-5, fidelity within
1e-6, equal fallback, escalation and fallback-row counts.  Bounded
top-100 needs >= 100 windows of 128 rows, so it runs on 16,384 rows.
Then ``main()`` at a cut size prints one JSON line with ``bench.py``'s
keys and the bound; a failed section is recorded and exits 1; without
CUDA and without ``--device`` the script exits non-zero with a
diagnostic line; the watchdog does the same past its deadline.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops import bounded_topk as jbt
from qrag_tpu.ops import cluster_topk as jct
from qrag_tpu.ops import window_scan as jws
from qrag_tpu.ops.quantize import int8_scan_topk as j_int8_scan_topk
from qrag_tpu.ops.quantize import quantize_rows as j_quantize_rows
from qrag_tpu.ops.quantize import refine_candidates as j_refine_candidates
from qrag_tpu.ops.statevector import fidelity_from_features as j_fidelity_from_features
from qrag_tpu.ops.statevector import rotation_features as j_rotation_features
from qrag_tpu.ops.topk import _goodness as j_goodness
from qrag_tpu.ops.topk import goodness_topk as j_goodness_topk
from qrag_tpu.ops.topk import scan_topk_verified_jit as j_verified
from qrag_tpu_torch.ops import cluster_topk as tct
from qrag_tpu_torch.ops.bounded_topk import window_maxnorms_device
from qrag_tpu_torch.ops.window_scan import make_lane_rank

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench_torch as bt  # noqa: E402

N, D, B, ITERS = 4096, 64, 8, 2


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d), dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16(x):
    """x rounded to bf16, as f32 numpy (the values both sides hold)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _chain(step, q, iters, cast):
    """``iters`` dependent steps as the timed loops run them."""
    outs = []
    for _ in range(iters):
        out = step(q)
        outs.append(out)
        q = q + cast(1e-9 * out[0][:, :1], q)
    return outs


def _chain_jax(step, q, iters=ITERS):
    return _chain(step, q, iters, lambda v, q: v.astype(q.dtype))


def _chain_torch(step, q, iters=ITERS):
    return _chain(step, q, iters, lambda v, q: v.to(q.dtype))


def _same(jout, tout, atol=1e-5, flags=()):
    """Indices equal (order included), values within ``atol``, flags at
    ``flags`` equal."""
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    np.testing.assert_allclose(tout[0].float().numpy(), np.asarray(jout[0], np.float32),
                               rtol=0, atol=atol)
    for p in flags:
        assert int(tout[p]) == int(np.asarray(jout[p])), p


@pytest.mark.parametrize("k,n,qdtype", [(10, N, "bf16"), (10, N, "f32"), (100, 16384, "bf16")])
def test_bounded_step_matches_jax(k, n, qdtype):
    """The headline's step (K1's path; bf16 corpus as scan and store),
    the MID regime's f32 queries and the k=100 companion: identity,
    values and the fell_back / escalated flags of ``bounded_exact_topk``
    (XLA)."""
    rng = np.random.default_rng(k + n)
    x = _bf16(_unit(rng, n))
    q = _unit(rng, B)
    q = _bf16(q) if qdtype == "bf16" else q
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    xt = torch.from_numpy(x).bfloat16()
    sqt = torch.from_numpy(sq)
    bufs = bt.BoundedBuffers(xt, sqt, window_maxnorms_device(sqt), make_lane_rank(n))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mxj = jnp.sqrt(jnp.max(jnp.asarray(sq).reshape(-1, 128), axis=1))
    lrj = jnp.asarray(jws.make_lane_rank(n))

    def jstep(qq):
        vals, idx, fb, _, esc = jbt.bounded_exact_topk(
            qq, xj, xj, jnp.asarray(sq), mxj, lrj, k, metric="l2", backend="xla")
        return vals, idx, fb, esc

    jdt = jnp.bfloat16 if qdtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if qdtype == "bf16" else torch.float32
    jouts = _chain_jax(jstep, jnp.asarray(q).astype(jdt))
    touts = _chain_torch(lambda qq: bt.bounded_step(qq, bufs, k), torch.from_numpy(q).to(tdt))
    for jo, to in zip(jouts, touts):
        _same(jo, to, flags=(2, 3))
    # the port's buffers from the corpus alone: the same norms and ranks
    built = bt.bounded_buffers(xt)
    np.testing.assert_allclose(built.sqnorms.numpy(), sq, rtol=1e-6)
    assert torch.equal(built.lane_rank, bufs.lane_rank)


@pytest.mark.parametrize("mode", ["approx", "exact"])
def test_retrieval_step_matches_jax(mode):
    """``run``'s approx / exact step: the f32 goodness matrix over the
    bf16 corpus and ``goodness_topk``."""
    rng = np.random.default_rng(7)
    x, q = _bf16(_unit(rng, N)), _bf16(_unit(rng, B))
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    xj, sqj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(sq)
    xt, sqt = torch.from_numpy(x).bfloat16(), torch.from_numpy(sq)
    jouts = _chain_jax(
        lambda qq: j_goodness_topk(j_goodness(qq, xj, "l2", sqj, None), 10, mode=mode),
        jnp.asarray(q).astype(jnp.bfloat16))
    touts = _chain_torch(lambda qq: bt.retrieval_step(qq, xt, sqt, 10, mode),
                         torch.from_numpy(q).bfloat16())
    for jo, to in zip(jouts, touts):
        _same(jo, to)


def test_verified_step_matches_jax():
    """The verified section's step (K7's path): distances, identity and
    the fallback-row count of ``scan_topk_verified_jit``."""
    rng = np.random.default_rng(8)
    x, q = _bf16(_unit(rng, N)), _bf16(_unit(rng, B))
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    jouts = _chain_jax(
        lambda qq: j_verified(qq, xj, 10, metric="l2", corpus_sqnorms=jnp.asarray(sq)),
        jnp.asarray(q).astype(jnp.bfloat16))
    touts = _chain_torch(lambda qq: bt.verified_step(qq, xt, torch.from_numpy(sq), 10),
                         torch.from_numpy(q).bfloat16())
    for jo, to in zip(jouts, touts):
        _same(jo, to, flags=(2,))


def test_int8_step_matches_jax():
    """``bench_int8``'s step: int8 scan of 4k candidates and the exact
    re-score, f32 queries."""
    rng = np.random.default_rng(5)
    x, q = _bf16(_unit(rng, N)), _unit(rng, B)
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    xj, sqj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(sq)
    x8j, xsj = jax.jit(j_quantize_rows)(jnp.asarray(x))

    def jstep(qq):
        q8, q_scale = j_quantize_rows(qq)
        g, idx = j_int8_scan_topk(q8, q_scale, x8j, xsj, 40, metric="l2", corpus_sqnorms=sqj,
                                  query_sqnorms=jnp.sum(qq * qq, axis=-1))
        return j_refine_candidates(qq, xj, idx, g, 10, metric="l2", corpus_sqnorms=sqj)

    x8t, xst = torch.from_numpy(np.array(x8j)), torch.from_numpy(np.array(xsj))
    xt, sqt = torch.from_numpy(x).bfloat16(), torch.from_numpy(sq)
    touts = _chain_torch(lambda qq: bt.int8_step(qq, xt, sqt, x8t, xst, 10),
                         torch.from_numpy(q))
    for jo, to in zip(_chain_jax(jstep, jnp.asarray(q)), touts):
        _same(jo, to)


@pytest.mark.parametrize("fused", [False, True])
def test_fused_rerank_step_matches_jax(fused):
    """``bench_fused_rerank``'s step: 100 candidates, then (fused) the
    10-qubit fidelity of their features and its top-10."""
    rng = np.random.default_rng(3)
    x, q = _bf16(_unit(rng, N)), _bf16(_unit(rng, B))
    sq = np.sum(x * x, axis=1, dtype=np.float32)
    xj, sqj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(sq)
    fj = j_rotation_features(jnp.asarray(x), 10, sqnorms=sqj)

    def jstep(qq):
        vals, idx = j_goodness_topk(j_goodness(qq, xj, "l2", sqj, None), 100, mode="approx",
                                    oversample=1)
        if fused:
            fid = j_fidelity_from_features(j_rotation_features(qq.astype(jnp.float32), 10),
                                           jnp.take(fj, idx, axis=0))
            vals, sel = jax.lax.top_k(fid, 10)
            idx = jnp.take_along_axis(idx, sel, axis=1)
        return vals, idx

    xt, sqt = torch.from_numpy(x).bfloat16(), torch.from_numpy(sq)
    ft = bt.rerank_features(xt, sqt, 10)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    touts = _chain_torch(
        lambda qq: bt.fused_rerank_step(qq, xt, sqt, ft, 10, 100, "approx", fused),
        torch.from_numpy(q).bfloat16())
    for jo, to in zip(_chain_jax(jstep, jnp.asarray(q).astype(jnp.bfloat16)), touts):
        _same(jo, to, atol=1e-6 if fused else 1e-5)


def test_accel_step_matches_jax():
    """``bench_accel_latency``'s step at B = 1 and 8 over ``bench.py``'s
    clustered recipe (bf16 store, one shared k-means assignment):
    identity, values and the fell_back / escalated flags of
    ``cluster_pruned_topk``."""
    rng = np.random.default_rng(42)
    centers = _unit(rng, 16)
    x = centers[rng.integers(0, 16, N)] + (0.25 / np.sqrt(D)) * rng.standard_normal(
        (N, D), dtype=np.float32)
    x = _bf16(x / np.linalg.norm(x, axis=1, keepdims=True))
    assign = jct.cluster_assignments(x, group_rows=128, kmeans_iters=3)
    gj = jct.build_clustered_groups(jnp.asarray(x).astype(jnp.bfloat16), group_rows=128,
                                    assign=assign)
    gt = tct.build_clustered_groups(torch.from_numpy(x).bfloat16(), group_rows=128,
                                    assign=assign)
    for b in (1, 8):
        q = x[rng.integers(0, N, b)] + (0.1 / np.sqrt(D)) * rng.standard_normal(
            (b, D), dtype=np.float32)
        jouts = _chain_jax(lambda qq: jct.cluster_pruned_topk(qq, gj, 10, metric="l2"),
                           jnp.asarray(q))
        touts = _chain_torch(lambda qq: bt.accel_step(qq, gt, 10), torch.from_numpy(q))
        for jo, to in zip(jouts, touts):
            _same(jo, to, flags=(2, 3))


def test_floor_step_and_bound():
    """The floor's row max equals the f32 product of the bf16 operands;
    the bound at the card's sizes is the operations' (1.574 TFLOP over
    the bf16 peak)."""
    rng = np.random.default_rng(11)
    x, q = _bf16(_unit(rng, N)), _unit(rng, B)
    (m,) = bt.floor_step(torch.from_numpy(q), torch.from_numpy(x).bfloat16())
    want = (_bf16(q) @ x.T).max(axis=1, keepdims=True)
    np.testing.assert_allclose(m.numpy(), want, rtol=1e-6, atol=1e-7)
    n = -(-bt.FULL_SIZES[0] // 512) * 512
    ms, by = bt.scan_bound(n, 768, 1024, 10)
    assert n == 1_000_448 and by == "operations"
    assert ms == pytest.approx(1e3 * 2 * 1024 * n * 768 / 989e12) and 1.59 < ms < 1.592


def test_make_corpus_is_unit_cached_and_seeded():
    a = bt.make_corpus(1000, 32, torch.bfloat16, "cpu")
    assert a.shape == (1000, 32) and a.dtype == torch.bfloat16
    assert bt.make_corpus(1000, 32, torch.bfloat16, "cpu") is a
    np.testing.assert_allclose(torch.linalg.norm(a.float(), dim=1).numpy(), 1.0, atol=1e-2)
    bt._CORPUS_CACHE.clear()
    assert torch.equal(bt.make_corpus(1000, 32, torch.bfloat16, "cpu"), a)
    bt._CORPUS_CACHE.clear()


@pytest.fixture
def small_bench(monkeypatch):
    """bench_torch at a cut size, with its results reset."""
    monkeypatch.setattr(bt, "SMALL_SIZES", (16384, 64, 8, 2))  # k=100: >= 100 windows
    monkeypatch.setattr(bt, "DISTINCT_BATCHES", 3)
    monkeypatch.setattr(bt, "ACCEL_ITERS", 2)
    monkeypatch.setattr(bt, "BEST_OF", 1)
    monkeypatch.setattr(bt, "RESULTS", {})
    monkeypatch.setattr(bt, "_JSON_PRINTED", bt.threading.Event())
    monkeypatch.setattr(bt, "_CORPUS_CACHE", {})
    return bt


def _one_line(capsys):
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1, lines
    return lines[0], json.loads(lines[0])


def test_main_prints_one_json_line(small_bench, capsys):
    """Every section at a cut size on the CPU (``--all``): one line with
    ``bench.py``'s keys and companions, the bound, no section error and
    no TPU prose."""
    rc = bt.main(bt._parse_args(["--device", "cpu", "--all"]))
    line, payload = _one_line(capsys)
    assert rc == 0
    assert set(payload) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert payload["metric"] == "retrieval_qps_exact_top10_16384x64_cpu"
    assert payload["unit"] == "qps" and payload["value"] > 0
    extra = payload["extra"]
    assert "section_errors" not in extra
    for key in ("bounded_exact_ms_per_batch", "bounded_fallback_batches", "iters",
                "approx_qps", "approx_ms_per_batch", "verified_qps", "verified_ms_per_batch",
                "verified_fallback_rows", "bounded_exact_k100_qps",
                "bounded_exact_k100_ms_per_batch", "bounded_k100_fallback_batches",
                "matmul_rowmax_ms_per_batch", "exact_over_floor", "rerank_overhead_pct",
                "rerank_base_ms", "rerank_fused_ms", "full_sort_qps", "bounded_mid_qps",
                "bounded_mid_fallback_batches", "accel_build_s", "accel_b1_ms",
                "accel_b1_vs_bounded", "accel_b1_fallbacks", "accel_b8_ms",
                "accel_b8_vs_bounded", "accel_b8_fallbacks",
                "bound_ms", "bound_qps", "bound_by", "bounded_fallback_rate", "card", "device",
                "int8_qps", "rerank_1k_overhead_pct"):
        assert key in extra, key
    assert len(extra["bounded_exact_reps_ms"]) == 1 and extra["iters"] == 2
    assert extra["bounded_fallback_batches"] in (0, 2)  # the same queries every step
    assert payload["vs_baseline"] == pytest.approx(payload["value"] / extra["bound_qps"])
    assert extra["device"] == extra["card"] == "cpu"
    for word in ("tpu", "v5e", "v5p", "mxu", "roofline_context", "north"):
        assert word not in line.lower(), word


def test_failed_section_is_recorded_and_exits_1(small_bench, capsys, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("injected")

    monkeypatch.setattr(bt, "bench_matmul_floor", boom)
    rc = bt.main(bt._parse_args(["--device", "cpu"]))
    _, payload = _one_line(capsys)
    assert rc == 1
    assert payload["extra"]["section_errors"] == {"matmul_floor": "RuntimeError: injected"}
    assert payload["value"] > 0 and "rerank_fused_ms" in payload["extra"]
    assert "exact_over_floor" not in payload["extra"]


def _script(env, args=(), timeout=120):
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), *args],
                       capture_output=True, text=True, timeout=timeout, cwd=REPO,
                       env={**os.environ, **env})
    lines = [line for line in r.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, (r.stdout, r.stderr[-800:])
    return r, json.loads(lines[0])


def test_no_cuda_prints_diagnostic_and_exits_nonzero():
    r, payload = _script({"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == bt.EXIT_NO_CUDA != 0
    assert payload["error"].startswith("no_cuda_device") and payload["value"] == 0.0
    assert payload["metric"] == "retrieval_qps_exact_top10_1000000x768_1gpu"


def test_watchdog_prints_diagnostic_and_exits_nonzero():
    r, payload = _script({"QRAG_BENCH_DEADLINE_S": "0.5"}, ["--device", "cpu", "--small"])
    assert r.returncode == bt.EXIT_DEADLINE != 0
    assert payload["error"].startswith("bench_deadline_0s_exceeded_in_")
