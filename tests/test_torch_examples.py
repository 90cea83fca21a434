"""The port's counterparts of the reference's examples and user scripts
(``examples/*_torch.py``, ``scripts/{eval_distilled,accel_real_embed}_torch.py``),
each run in a subprocess on ``--device cpu`` at its own size or at a size
cut through its arguments or a module constant, with what the original
prints as its result asserted; and each refusing to run without CUDA
when no device is given.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = (
    "examples/full_workflow_torch.py",
    "examples/latency_mode_demo_torch.py",
    "examples/sharded_streaming_demo_torch.py",
    "scripts/eval_distilled_torch.py",
    "scripts/accel_real_embed_torch.py",
)


def _run(args, timeout=180, env=None, code=None):
    cmd = [sys.executable, "-c", code] if code else [sys.executable, *args]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO,
                       env={**os.environ, **(env or {})})
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout


def test_full_workflow():
    out = _run(["examples/full_workflow_torch.py", "--device", "cpu"])
    ingest = out.splitlines()[0]
    assert ingest.startswith("ingest:") and "'embeddings_created': 4" in ingest
    assert "search top hit: Demo_Podcast/ep3_transcript" in out
    assert "fused rerank: ['Demo_Podcast/" in out
    assert "route: quantum" in out
    assert '"documents"' in out


def test_latency_mode_demo():
    """60,000 x 256 clustered rows: the accelerator's answer is the flat
    scan's (the script asserts it) and its certificate events print."""
    out = _run(["examples/latency_mode_demo_torch.py", "--device", "cpu"])
    assert "accelerated results identical to the flat scan:" in out
    assert out.count("  idx=") == 5
    assert "certificate events: escalations=" in out and "fallbacks=0" in out
    assert "single-query search on cpu: flat" in out


def test_sharded_streaming_demo():
    """Four slots on one device: a transient failure keeps them, a
    persistent one re-shards over three with the same top hit; the
    streamed ingestion reports its embeddings and progress."""
    out = _run(["examples/sharded_streaming_demo_torch.py", "--device", "cpu"])
    layout = json.loads(out.split("   layout: ", 1)[1].splitlines()[0])
    assert layout["mesh"] == {"data": 1, "model": 4} and layout["elastic"]
    top = out.split("   top hit: ", 1)[1].splitlines()[0]
    assert f"rebuilds=0, still 4 shards, same top hit: {top}" in out
    assert f"survived a device loss: rebuilds=1, now 3 shards, same top hit: {top}" in out
    assert "ingested: 3 embeddings" in out and "progress events streamed" in out
    assert out.rstrip().endswith("demo complete")


_EVAL = """
import importlib.util, json
spec = importlib.util.spec_from_file_location("m", "scripts/eval_distilled_torch.py")
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
m.EVAL_OVERRIDES.update(n_episodes=8, queries_per_chunk=1, candidates=8)
m.main(["--weights", "artifacts/cross_encoder", "--device", "cpu"{val}])
"""


@pytest.mark.parametrize("val", [False, True])
def test_eval_distilled(val):
    """The shipped cross-encoder as the "student": both rankers score the
    cut protocol's cases alike; the bi-encoder's cosine beside them."""
    out = json.loads(_run([], code=_EVAL.format(val=', "--val"' if val else "")))
    assert out["cases"] == 16 and out["device"] == "cpu"
    for name in ("distilled_student", "shipped_cross_encoder", "cosine_trained_bi_encoder"):
        assert set(out[name]) == {"top1", "mrr", "ndcg@10"}, name
        assert all(0.0 <= v <= 1.0 for v in out[name].values())
    assert out["distilled_student"] == out["shipped_cross_encoder"]


def test_accel_real_embed():
    out = _run(["scripts/accel_real_embed_torch.py", "--device", "cpu", "--episodes", "32",
                "--queries", "16"])
    assert "embedded (256, 128) on cpu" in out
    assert "real-embedding accel: 160/160 oracle-identical hits" in out
    assert "fallback batches " in out and "/2, escalated " in out


_NO_CUDA = """
import importlib.util
for path in {paths!r}:
    spec = importlib.util.spec_from_file_location("m", path)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    args = ["--weights", "artifacts/cross_encoder"] if "eval_distilled" in path else []
    try:
        m.main(args)
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), (path, e)
    else:
        raise AssertionError(path + " ran without CUDA and without --device")
print("refused")
"""


def test_ported_files_refuse_the_cpu_unasked():
    out = _run([], code=_NO_CUDA.format(paths=PORTED), env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.strip() == "refused"
