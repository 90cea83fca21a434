"""The benchmark cells (``bench_cells``) on the CPU, at a cut size.

Cell A runs at 16,384 x 64 with B=64 over 4 batches (16 queries of each
held against the oracle), cell B at 4,096 x 128 with 8 warm-up, 64
serial and 32 concurrent requests: both cells run with ``--device cpu``
on the plain twins and print every metric by name and unit; the oracle
check passes, and fails (exit 1, the run marked incorrect) on a planted
wrong index; a server error counts as a failed request; ``--seed``
changes the rows and the same seed repeats them; A's batches are the
same in every pass.  Each precision control (an answer over bf16
inputs in the program's place) fails the cell's check.  The benchmark's
own reference (the f32 oracle, the float64 fidelity) agrees with the
JAX package's functions on the same inputs, and the traced run's
reading is held to a made timeline.
"""

import itertools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qrag_tpu.ops.statevector import fidelity_from_features as j_fidelity_from_features
from qrag_tpu.ops.statevector import rotation_features as j_rotation_features
from qrag_tpu.ops.topk import _goodness as j_goodness
from qrag_tpu.ops.topk import goodness_topk as j_goodness_topk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from bench_cells import CELLS, common  # noqa: E402
from bench_cells import __main__ as cli  # noqa: E402
from bench_cells import control, search_exact, search_rerank, spread  # noqa: E402
from bench_cells import trace as tr  # noqa: E402

A, B = "search_exact_b1024_768d1m", "search_rerank_b1_1536d500k"


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(search_exact, "ROWS", 16_384)
    monkeypatch.setattr(search_exact, "DIM", 64)
    monkeypatch.setattr(search_exact, "BATCH", 64)
    monkeypatch.setattr(search_exact, "BATCHES", 4)
    monkeypatch.setattr(search_exact, "CHECKED", 16)
    monkeypatch.setattr(search_rerank, "ROWS", 4_096)
    monkeypatch.setattr(search_rerank, "DIM", 128)
    monkeypatch.setattr(search_rerank, "WARM_REQUESTS", 8)
    monkeypatch.setattr(search_rerank, "SERIAL_REQUESTS", 64)
    monkeypatch.setattr(search_rerank, "CONCURRENT_REQUESTS", 32)
    monkeypatch.setattr(search_rerank, "TRACED_REQUESTS", 16)


def _run(capsys, *argv):
    rc = cli.main(list(argv))
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, lines[:-1], json.loads(lines[-1])


@pytest.mark.parametrize("cell", [A, B])
def test_cell_runs_on_cpu_and_prints_every_metric(small, capsys, cell):
    rc, text, result = _run(capsys, cell, "--device", "cpu", "--seed", "3", "--trace")
    metrics = (search_exact if cell == A else search_rerank).METRICS
    assert rc == 0 and result["correct"] is True
    assert (result["cell"], result["seed"], result["device"]) == (cell, 3, "cpu")
    assert result["configuration"] == CELLS[cell].configuration
    for name, spec in metrics.items():
        assert any(line.strip().startswith(f"{name} = ") and f" {spec.unit} " in line
                   for line in text), name
        assert result["metrics"][name]["unit"] == spec.unit
        assert result["metrics"][name]["value"] >= 0
    # a device number is never read off the CPU
    assert result["trace"]["device"].startswith("not measured")
    assert result["setup"]["peak_device_mib_timed"] is None
    if cell == A:
        assert result["counts"]["timed_batches"] == 12 * 4
        assert result["check"]["checked"] == 4 * 16
        assert result["metrics"]["qps"]["value"] > 0
        assert result["trace"]["host_ms_by_layer"]["index.search"] > 0
    else:
        assert result["counts"]["attempted_requests"] == result["check"]["checked"] == 96
        assert result["counts"]["concurrency"] == 5
        assert result["metrics"]["failed_requests"]["value"] == 0
        layers = result["trace"]["host_call_p50_ms_by_layer"]
        assert 0 < layers["engine.search_rerank"] <= result["trace"]["http_round_trip_p50_ms"]


def test_exact_cell_flags_a_planted_wrong_index(small, capsys, monkeypatch):
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    search = DeviceFlatIndex.search

    def planted(self, q, k=10):
        res = search(self, q, k)
        res.indices[5, 0] = (res.indices[5, 9] + 7) % self.ntotal  # far from the top-10
        return res

    monkeypatch.setattr(DeviceFlatIndex, "search", planted)
    rc, _, result = _run(capsys, A, "--device", "cpu")
    assert rc == common.EXIT_INCORRECT and result["correct"] is False
    assert result["check"]["wrong"] == result["check"]["wrong_by_index"] == 4  # query 5 a batch


def _planted_engine(monkeypatch, at, change):
    """``QragEngine.search_rerank`` with ``change`` applied to its
    ``at``-th call (counted from 0, the engine warm-up's included)."""
    from qrag_tpu_torch.engine import QragEngine

    call, calls = QragEngine.search_rerank, itertools.count()

    def planted(self, *a, **kw):
        out = call(self, *a, **kw)
        return change(out) if next(calls) == at else out

    monkeypatch.setattr(QragEngine, "search_rerank", planted)


def test_rerank_cell_flags_a_planted_wrong_index(small, capsys, monkeypatch):
    def wrong(out):
        hits = out["results"][0]
        hits[0]["index"], hits[9]["index"] = hits[9]["index"], hits[0]["index"]
        return out

    _planted_engine(monkeypatch, 30, wrong)
    rc, _, result = _run(capsys, B, "--device", "cpu")
    assert rc == common.EXIT_INCORRECT and result["correct"] is False
    assert result["metrics"]["failed_requests"]["value"] == 1
    assert result["counts"]["errored_requests"] == 0


def test_rerank_cell_counts_a_server_error_as_failed(small, capsys, monkeypatch):
    def fail(out):
        raise RuntimeError("planted server error")

    _planted_engine(monkeypatch, 30, fail)
    rc, _, result = _run(capsys, B, "--device", "cpu")
    assert rc == common.EXIT_INCORRECT and result["correct"] is False
    assert result["counts"]["errored_requests"] == 1
    assert result["metrics"]["failed_requests"]["value"] == 1
    assert result["check"]["checked"] == 96


def test_seed_makes_the_rows_and_the_queries():
    a = common.seeded_rows(2_000, 32, 0, "cpu")
    assert a.dtype == np.float32 and a.shape == (2_000, 32)
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-6)
    assert np.array_equal(a, common.seeded_rows(2_000, 32, 0, "cpu"))
    assert not np.array_equal(a, common.seeded_rows(2_000, 32, 1, "cpu"))
    q = common.seeded_rows(2_000, 32, common.query_seed(0), "cpu")
    assert not np.array_equal(a, q)  # the queries' stream is apart from the rows'
    # the rows are the first of a longer run of the same seed
    assert np.array_equal(a, common.seeded_rows(3_000, 32, 0, "cpu")[:2_000])


def test_seed_changes_the_cell_inputs(small, monkeypatch):
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    seen = []
    add = DeviceFlatIndex.add

    def record(self, vectors, metadata=None):
        seen.append(np.array(vectors))
        return add(self, vectors, metadata)

    monkeypatch.setattr(DeviceFlatIndex, "add", record)
    for seed in (0, 0, 1):
        search_exact.run(seed, "cpu")
    assert np.array_equal(seen[0], seen[1]) and not np.array_equal(seen[0], seen[2])


def test_exact_cell_sends_the_same_batches_every_pass(small, monkeypatch):
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    sent = []
    search = DeviceFlatIndex.search

    def record(self, q, k=10):
        sent.append(np.array(q))
        return search(self, q, k)

    monkeypatch.setattr(DeviceFlatIndex, "search", record)
    result = search_exact.run(0, "cpu")
    passes = search_exact.WARM_PASSES + search_exact.TIMED_PASSES
    assert len(sent) == passes * 4
    for p in range(1, passes):
        assert all(np.array_equal(sent[i], sent[p * 4 + i]) for i in range(4))
    assert len({s.tobytes() for s in sent}) == 4  # four distinct batches
    assert result["counts"]["passes_agree"] is True


def test_reference_agrees_with_the_jax_package():
    """The benchmark's f32 oracle orders as the JAX package's exact top-k,
    and its float64 fidelity agrees with the JAX analytic fidelity."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3_000, 48), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((6, 48), dtype=np.float32)
    oracle = common.Oracle(x, torch.device("cpu"))
    g = oracle.goodness(q)
    want = oracle.order(g, 100).numpy()
    jg = j_goodness(jnp.asarray(q), jnp.asarray(x), "l2", jnp.sum(jnp.asarray(x) ** 2, 1), None)
    jv, ji = j_goodness_topk(jg, 100, mode="exact")
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
    assert np.array_equal(want, np.asarray(ji))
    feats = search_rerank.features64(x)
    fid = search_rerank.fidelity64(search_rerank.features64(q), feats[want])
    n = search_rerank.N_QUBITS
    jfid = j_fidelity_from_features(j_rotation_features(jnp.asarray(q), n),
                                    j_rotation_features(jnp.asarray(x), n)[want])
    np.testing.assert_allclose(fid, np.asarray(jfid), atol=2e-6)


def test_compare_holds_ties_values_and_padding():
    want = np.array([[4, 7, 9]])
    ref = np.array([[0.5, 0.4, 0.3]])
    vals = -ref
    ok = common.compare(want, want, ref, ref, vals, vals)
    assert not ok.bad.any() and ok.reorders == 0
    # 7 and 9 swapped, their scores within 1e-5: a tie reorder
    tied = np.array([[0.5, 0.4, 0.4 - 5e-6]])
    swap = np.array([[4, 9, 7]])
    c = common.compare(swap, want, tied[:, [0, 2, 1]], tied, vals, vals)
    assert not c.bad.any() and c.reorders == 2
    c = common.compare(swap, want, ref[:, [0, 2, 1]], ref, vals, vals)
    assert c.bad.all()
    assert common.compare(want, want, ref, ref, vals + 2e-5, vals).bad.all()
    assert common.compare(np.array([[4, 7, -1]]), want, ref, ref, vals, vals).bad.all()


def test_trace_summary_of_a_made_timeline():
    D, S = tr.DeviceSpan, tr.Span
    dev = [D(0, 100, "packed_window_scan_wide_kernel<...>", 5),
           D(300, 350, "DeviceSegmentedRadixSortKernel", 290),
           D(340, 400, "Memcpy DtoH (Device -> Pageable)", 330),
           D(1400, 1500, "vectorized_elementwise_kernel", 1390)]
    runtime = [S(150, 260, "cudaStreamSynchronize"), S(1390, 1395, "cudaLaunchKernel")]
    layers = [S(0, 1600, "index.search"), S(0, 420, "bounded_exact_topk"),
              S(280, 420, "certify tail"), S(1300, 1600, "finalize")]
    out = tr.summarize(dev, runtime, layers, wall_ms=2.0, calls=1)
    assert out["device_busy_ms_per_call"] == pytest.approx(0.3)  # the union of spans
    assert out["idle_share"] == pytest.approx(0.85)
    groups = out["device_ms_by_group"]
    assert groups["K1 wide arm"] == pytest.approx(0.1)
    assert groups["sorts"] == pytest.approx(0.05)
    assert groups["copies device to host"] == pytest.approx(0.06)
    by_layer = out["device_ms_by_launching_layer"]
    assert by_layer == pytest.approx({"bounded_exact_topk": 0.1, "certify tail": 0.11,
                                      "finalize": 0.1})
    assert out["host_ms_by_layer"]["index.search"] == pytest.approx(1.6)
    assert out["host_call_p50_ms_by_layer"]["certify tail"] == pytest.approx(0.14)
    gaps = out["longest_idle_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([1.0, 0.2])
    assert gaps[0]["host"] == "index.search > Python"  # 900: no runtime call, index.search open
    assert gaps[1]["host"] == "bounded_exact_topk > cudaStreamSynchronize"  # 200
    assert out["idle_ms_by_host_activity"]["index.search > Python"] == pytest.approx(1.0)
    assert tr.summarize([], runtime, layers, 2.0, 1)["device"].startswith("not measured")
    assert tr.innermost(layers, [2000, 300, 10]) == [None, layers[2], layers[1]]


def test_layer_spans_record_every_thread_and_restore():
    import threading

    from qrag_tpu_torch.ops import topk

    class Obj:
        def f(self, x):
            return x + 1

    obj, top_k, seen = Obj(), topk.top_k, []
    with tr.layer_spans([(obj, "f", "layer f"), (topk, "top_k", "layer top_k")], seen):
        t = threading.Thread(target=obj.f, args=(1,))
        t.start()
        t.join(timeout=10)
        assert obj.f(2) == 3
        topk.top_k(torch.arange(5.0)[None], 2)
    assert "f" not in vars(obj) and topk.top_k is top_k
    assert [label for label, _, _ in seen] == ["layer f", "layer f", "layer top_k"]
    assert all(t1 >= t0 for _, t0, t1 in seen)


def test_spread_reads_runs_against_their_bounds(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(search_exact, "METRICS", {
        "qps": common.Metric("queries/s", "higher", 0.3),
        "p50": common.Metric("ms", "lower", 0.1)})

    def line(seed, qps, p50):
        return json.dumps({"cell": A, "seed": seed, "metrics": {
            "qps": {"value": qps, "bound": 9.0}, "p50": {"value": p50, "bound": 9.0}}})

    path = tmp_path / "runs.jsonl"
    path.write_text("\n".join([line(0, 100.0, 10.0), line(0, 110.0, 10.0),
                               line(0, 90.0, 10.0), line(1, 50.0, 20.0), ""]))
    assert spread.main([str(path)]) == 1  # qps's 0.2 is above half its bound
    table = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    seed0 = next(t for t in table if t["seed"] == 0)["metrics"]
    assert seed0["qps"]["runs"] == [100.0, 110.0, 90.0]
    assert (seed0["qps"]["median"], seed0["qps"]["min"], seed0["qps"]["max"]) == (100.0, 90.0,
                                                                                 110.0)
    # the bound is the cell's, not the one a run's line carries
    assert seed0["qps"]["spread"] == pytest.approx(0.2) and seed0["qps"]["bound"] == 0.3
    assert seed0["qps"]["ok"] is False
    assert seed0["p50"]["spread"] == 0.0 and seed0["p50"]["ok"] is True
    path.write_text(line(0, 100.0, 10.0) + "\n" + line(0, 101.0, 10.0) + "\n")
    assert spread.main([str(path)]) == 0


@pytest.mark.parametrize("cell", [A, B])
def test_precision_controls_fail_the_check(small, capsys, cell):
    """An answer over bf16 inputs in the program's place fails the cell's
    own check, each control by the limit it is there for."""
    assert control.main([cell, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["controls"]
    assert all(r["correct"] is False for r in out.values())
    values, ranking = ((out["bf16_reference"], out["bf16_ranking_f32_values"]) if cell == A
                       else (out["bf16_features"], out["bf16_candidates"]))
    assert values["wrong_by_value"] > 0 and values["max_value_err"] > 10 * common.VALUE_TOL
    # right values for the rows returned: the rows themselves are wrong
    assert ranking["wrong_by_index"] > 0 and ranking["max_index_gap"] > common.TIE_TOL


def test_no_card_exits_nonzero_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cell would run")
    assert cli.main([A]) == common.EXIT_NO_CUDA
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_cells_name_their_deployment():
    assert set(CELLS) == {A, B}
    for name, cell in CELLS.items():
        assert len(cell.source) <= 200 and cell.chips == 1 and cell.reduced
        mod = {A: search_exact, B: search_rerank}[name]
        assert cell.module == mod.__name__
        assert all(spec.bound >= 0 and spec.better in ("higher", "lower")
                   for spec in mod.METRICS.values())
    assert CELLS[A].configuration == "cohere-768d-1m-flat"
    assert CELLS[B].configuration == "openai-1536d-500k-flat"
    # the cells' traffic, as the benchmark defines it
    assert (search_exact.ROWS, search_exact.DIM, search_exact.BATCH, search_exact.BATCHES,
            search_exact.K, search_exact.WARM_PASSES, search_exact.TIMED_PASSES,
            search_exact.CHECKED) == (1_000_000, 768, 1024, 48, 10, 1, 12, 64)
    assert (search_rerank.ROWS, search_rerank.DIM, search_rerank.K, search_rerank.CANDIDATES,
            search_rerank.WARM_REQUESTS, search_rerank.SERIAL_REQUESTS,
            search_rerank.CONCURRENCY, search_rerank.CONCURRENT_REQUESTS) == (
        500_000, 1536, 10, 100, 200, 2000, 5, 2000)


def test_the_cells_command_runs_as_a_module():
    """``python -m bench_cells --help`` in a fresh interpreter from the
    repo root: the command line parses and names both cells."""
    out = subprocess.run([sys.executable, "-m", "bench_cells", "--help"], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert A in out and B in out
