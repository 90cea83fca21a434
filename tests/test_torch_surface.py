"""The port's public surface against ``qrag_tpu``'s.

(i) Read with ``ast`` (no import), module by module over both packages:
the public top-level names, the public methods of public classes, the
parameters of each public function and method, and ``__all__``.  Every
name of ``qrag_tpu`` the port lacks is in ``REF_ONLY`` with its reason,
every file either package has alone is in ``REF_ONLY_FILES`` /
``PORT_ONLY_FILES``, and every public name the port adds to a namesake
module is in ``PORT_ONLY``; the lists are exact, so a name added to
either package without its counterpart fails, and so does an entry that
is no longer a gap.  Then the names this surface added, against the
reference on the same inputs: ``l2_topk`` / ``ip_topk``,
``serve_in_thread``, ``TrainedEmbedder.load``, ``params`` as an
attribute, ``device_matrix`` and the package re-exports.
"""

import ast
import importlib
import json
import os
import pathlib
import urllib.request

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "qrag_tpu", ROOT / "qrag_tpu_torch"
BI_DIR = str(ROOT / "artifacts" / "bi_encoder")
CROSS_DIR = str(ROOT / "artifacts" / "cross_encoder")

_FUSED_KW = {
    "bounded_bufs", "bounded_backend", "bounded_kind", "bounded_query_store",
    "cluster_bufs", "cluster_group_rows", "cluster_budget", "cluster_probe",
}
_FUSED_WHY = ("jit arguments carrying the index's buffers into one traced graph; "
              "the port passes them as **candidate_kw")
_PALLAS_WHY = ("Pallas or XLA and Mosaic's interpret mode; the port runs the kernel on a "
               "CUDA tensor and its plain twin on a CPU tensor")
_FUNCTIONAL_WHY = "the reference's models are functions of a params tree; the port's are nn.Modules"

# the complete list of the port's gaps: {module: {name: reason}}; a
# parameter is "function(param)"
REF_ONLY = {
    "engine.py": {
        **{f"fused_search_rerank({p})": _FUSED_WHY for p in _FUSED_KW},
        **{f"fused_search_rerank_routed({p})": _FUSED_WHY for p in _FUSED_KW},
        "QragEngine.warmup(doc_buckets)": "the doc-count ladder exists only to compile XLA shapes ahead",
    },
    "models/bi_encoder.py": {
        "encode": _FUNCTIONAL_WHY + " (BiEncoder.forward)",
        "init_params(key)": "a jax.random key; the port draws from torch.Generator(seed)",
        "info_nce_loss(params)": _FUNCTIONAL_WHY,
        "info_nce_loss(cfg)": _FUNCTIONAL_WHY,
        "make_train_step(cfg)": _FUNCTIONAL_WHY + " that carry their config",
    },
    "models/cross_encoder.py": {
        "forward": _FUNCTIONAL_WHY + " (CrossEncoder.forward)",
        "init_params(key)": "a jax.random key; the port draws from torch.Generator(seed)",
        "bce_loss(params)": _FUNCTIONAL_WHY,
        "bce_loss(cfg)": _FUNCTIONAL_WHY,
        "make_train_step(cfg)": _FUNCTIONAL_WHY + " that carry their config",
    },
    "models/checkpoint.py": {
        "STATE_DIR": "orbax's directory; orbax needs jax, the port writes state.npz (STATE_NAME)",
        "save_train_state(params)": _FUNCTIONAL_WHY + " (the port takes the module and optimizer)",
        "save_train_state(opt_state)": "optax's state; the port takes the torch optimizer",
        "load_train_state(params_like)": _FUNCTIONAL_WHY + " (restored into the module in place)",
        "load_train_state(opt_state_like)": "optax's state; restored into the torch optimizer",
    },
    "ops/bounded_topk.py": {
        f"{fn}({p})": _PALLAS_WHY
        for fn in ("bounded_exact_topk", "window_bounds_bf16", "bounded_exact_topk_int8",
                   "window_bounds_int8")
        for p in ("backend", "interpret")
    },
    "ops/int8_domain.py": {
        "exact_topk_int8_domain(backend)": _PALLAS_WHY,
        "exact_topk_int8_domain(interpret)": _PALLAS_WHY,
    },
    "ops/topk.py": {"flat_scan_topk(use_pallas)": "the Pallas scan switch; " + _PALLAS_WHY},
    "ops/window_scan.py": {
        "windowed_scan_topk(selector)": "approx_max_k or a sort; the port's selection is "
                                        "always the exact stable sort",
        "windowed_scan_topk(backend)": _PALLAS_WHY,
    },
    "parallel/elastic.py": {
        f"ElasticShardedIndex.{fn}(device)": "a jax device; the port addresses a Slot(id, device)"
        for fn in ("probe_device", "inject_device_failure", "inject_device_hang")
    },
    "serving/batcher.py": {
        "SearchBatcher.__init__(bucket_floor)": "power-of-two padding so XLA reuses compiled shapes",
    },
}

REF_ONLY_FILES = {
    "ops/pallas/__init__.py": "the Pallas kernels' package; the port's kernels are csrc/*.cu",
    "ops/pallas/fused_scan.py": "TPU kernels K1-K4: csrc/fused_scan.cu, ops/cuda/fused_scan.py",
    "ops/pallas/gather_rows.py": "TPU kernels K5-K6: csrc/gather_rows.cu, ops/cuda/gather_rows.py",
    "ops/pallas/scan_topk.py": "TPU kernel K7: csrc/scan_topk.cu, ops/cuda/scan_topk.py",
    "utils/buckets.py": "power-of-two padding so XLA reuses compiled shapes",
    "utils/compilation_cache.py": "XLA's persistent compilation cache",
}

PORT_ONLY_FILES = {
    "device.py": "resolve_device: entry points go to the card unless told otherwise",
    "models/weights.py": "the reference's p0 ... pN files as {dotted name: array}, without jax",
    "ops/cuda/__init__.py": "the Hopper kernels' wrappers",
    "ops/cuda/_build.py": "nvcc build of csrc/*.cu at first launch",
    "ops/cuda/_launch.py": "the shared launch path and its counters",
    "ops/cuda/fused_scan.py": "wrapper of K1-K4",
    "ops/cuda/gather_rows.py": "wrapper of K5-K6",
    "ops/cuda/scan_topk.py": "wrapper of K7",
    "ops/cuda/launch_ab.py": "times the launch path of two checkouts",
    "ops/cuda/scan_ab.py": "holds and times two versions of the scan kernels",
    "ops/gather_rows.py": "K5's entry point and plain twin (the reference's is in ops/pallas/)",
    "ops/scan_topk.py": "K7's entry point and plain twin (the reference's is in ops/pallas/)",
    "parallel/collectives.py": "the collectives the reference leaves to XLA",
}

_MODULES_AS_LAYERS = "the tower's layers as nn.Modules"
_BF16_BOUNDS = "bf16 bounds the card is held to"
PORT_ONLY = {
    "__init__.py": {"__all__:resolve_device": "the port's device choice"},
    "index/__init__.py": {"__all__:QuantizedFlatIndex": "the quantized index, exported beside the flat one"},
    "parallel/__init__.py": {
        "__all__:process_count": "jax.process_count's counterpart on torch.distributed",
        "__all__:process_index": "jax.process_index's counterpart on torch.distributed",
    },
    "reranker/__init__.py": {"__all__:rerank_response_dict": "the /rerank body, shared by HTTP and MCP"},
    "serving/__init__.py": {"__all__:main": "the CLI entry point under its module name"},
    "serving/http_app.py": {"API_DOCS": "GET /docs body"},
    "index/flat_index.py": {"CLUSTER_ASSIGN_NAME": "the accelerator's bundle file"},
    "index/native_store.py": {
        name: "g++ build of native/indexstore.cpp at first use (the reference ships a Makefile)"
        for name in ("BUILD_ROOT", "CXX_FLAGS", "LIB_NAME", "SOURCE", "build_library", "library_path")
    },
    "models/bi_encoder.py": {
        "BF16_COSINE_FLOOR": _BF16_BOUNDS,
        "BF16_GRAD_COSINE_FLOOR": _BF16_BOUNDS,
        "BF16_STEP_LOSS_RTOL": _BF16_BOUNDS,
        "BiEncoder": "the bi-encoder as an nn.Module",
        "BiEncoder.forward": "the reference's encode",
        "TrainedEmbedder.encode": "token arrays in, device embeddings out",
        "TrainedEmbedder.params": "the reference's params attribute, as a property",
    },
    "models/checkpoint.py": {"STATE_NAME": "state.npz, in place of orbax's directory"},
    "models/cross_encoder.py": {
        **{name: _MODULES_AS_LAYERS for name in (
            "Attention", "Block", "CrossEncoder", "DenseFFN", "LayerNorm", "Linear", "MoEFFN",
            "Tower", "Attention.attend", "Attention.forward", "Attention.project", "Block.ffn",
            "Block.forward", "CrossEncoder.forward", "DenseFFN.forward", "LayerNorm.forward",
            "Linear.forward", "MoEFFN.forward", "Tower.encode_plain")},
        **{name: _BF16_BOUNDS for name in (
            "BF16_GRAD_COSINE_FLOOR", "BF16_SCORE_ATOL", "BF16_STEP_LOSS_RTOL",
            "bf16_step_deviation")},
        "ADAMW_DECAY": "optax's AdamW decay mask on torch.optim",
        "apply_gradients": "one optimizer step of a loss",
        "default_dtype": "bf16 activations on the card, f32 elsewhere",
        "device_batch": "numpy batches onto the device",
        "load_module": "{dotted name: array} into a module",
        "module_params": "a module as {dotted name: array}",
        "trainable": "a module on a device with gradients on",
        "CrossEncoderScorer.logits": "the forward's logits on the device",
        "CrossEncoderScorer.params": "the reference's params attribute, as a property",
    },
    "models/distill.py": {"mse_loss": "the distillation loss on a module"},
    "models/rerank_eval.py": {
        "group_grids": "the listwise step's batches",
        "listwise_loss": "the listwise loss on a module",
        "make_listwise_step": "the listwise train step on a module",
        "pair_grid": "one query's pair grid",
    },
    "ops/quantize.py": {
        "INV_127": "the f32 quantization scale factor",
        "int8_matmul": "the exact int8 product of the int8 paths",
    },
    "ops/topk.py": {
        "selection_routes": "counts of the candidate selection routes (/stats)",
        "top_k": "lax.top_k's stable tie order (torch.topk does not promise it)",
    },
    "ops/window_scan.py": {
        "exact_int_dots": "exact int32 dots of the int8 twin",
        "pad_cols": "column padding to the kernels' width",
    },
    "parallel/elastic.py": {"Slot": "a device slot of the mesh"},
    "parallel/mesh.py": {
        **{name: "a mesh of device slots on torch.distributed" for name in (
            "Mesh", "Mesh.device", "Mesh.is_local", "Mesh.local_slots", "Mesh.rank",
            "Mesh.shape", "Mesh.spans_processes", "local_device", "mesh_devices")},
        **{name: "the rendezvous store's heartbeat" for name in (
            "HEARTBEAT_PERIOD_S", "HEARTBEAT_WAIT_S", "TIMEOUT_S", "peers_alive", "shutdown")},
        "process_count": "jax.process_count's counterpart",
        "process_index": "jax.process_index's counterpart",
    },
    "parallel/train.py": {
        name: "the sharded trainer on nn.Modules (the reference shards a params tree with pjit)"
        for name in ("gather_train_state", "load_sharded_state", "make_trainer", "param_specs",
                     "sharded_module")
    },
    "tools/ingest_tools.py": {"EMBED_GROUP": "texts embedded a call"},
    "tools/interface.py": {
        name: "the tool schemas without pydantic"
        for name in ("Model", "ValidationError", "Model.model_dump", "Model.model_json_schema")
    },
    "utils/profiling.py": {"TRACE_NAME": "the torch.profiler trace file"},
}


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _surface(path):
    """{public name, "Class.method", "fn(param)", "__all__:name"} of a
    module, read with ast."""
    out = set()

    def function(name, node):
        out.add(name)
        out.update(f"{name}({p})" for p in _params(node) if p not in ("self", "cls"))

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and not node.name.startswith("_"):
            function(node.name, node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.add(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                    sub.name == "__init__" or not sub.name.startswith("_")
                ):
                    function(f"{node.name}.{sub.name}", sub)
            # an __init__ is the class's signature, not a method of its own
            out.discard(f"{node.name}.__init__")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    out.update(f"__all__:{n}" for n in ast.literal_eval(node.value))
                elif not t.id.startswith("_"):
                    out.add(t.id)
    return out


def _rel(root):
    return {str(p.relative_to(root)) for p in root.rglob("*.py")}


MODULES = sorted(_rel(REF) | _rel(PORT))


def _gaps(ref, port):
    """Reference names the port lacks; the parameters of a function the
    port lacks as a whole go with its name."""
    def owner(n):
        fn = n.split("(")[0]
        return fn[: -len(".__init__")] if fn.endswith(".__init__") else fn

    return {n for n in ref - port if "(" not in n or owner(n) in port}


def _extras(port, ref):
    """Port names a reference module lacks; a port-only parameter
    (``device=``, ``dtype=``) is not a gap of either."""
    return {n for n in port - ref if "(" not in n}


@pytest.mark.parametrize("module", MODULES)
def test_surface_parity(module):
    ref, port = REF / module, PORT / module
    if not port.exists():
        assert module in REF_ONLY_FILES, f"qrag_tpu/{module} has no namesake in the port"
        return
    if not ref.exists():
        assert module in PORT_ONLY_FILES, f"qrag_tpu_torch/{module} has no namesake in qrag_tpu"
        return
    assert module not in REF_ONLY_FILES and module not in PORT_ONLY_FILES, module
    rs, ps = _surface(ref), _surface(port)
    assert _gaps(rs, ps) == set(REF_ONLY.get(module, {})), "gaps of the port (REF_ONLY)"
    assert _extras(ps, rs) == set(PORT_ONLY.get(module, {})), "names of the port alone (PORT_ONLY)"


def test_surface_lists_are_live():
    """Every listed module exists, and every reason is a line of text."""
    for listing in (REF_ONLY, PORT_ONLY):
        assert set(listing) <= set(MODULES)
        for reasons in listing.values():
            assert all(isinstance(r, str) and r and "\n" not in r for r in reasons.values())
    assert set(REF_ONLY_FILES) <= _rel(REF) and set(PORT_ONLY_FILES) <= _rel(PORT)


# ------------------------------------------------------------ re-exports

PACKAGES = ["", ".index", ".ops", ".serving", ".parallel", ".pipeline", ".reranker", ".tools"]


@pytest.mark.parametrize("package", PACKAGES)
def test_reexports_include_reference(package):
    ref = importlib.import_module("qrag_tpu" + package)
    port = importlib.import_module("qrag_tpu_torch" + package)
    assert set(ref.__all__) <= set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_quick_start_names():
    from qrag_tpu_torch import Document, QragConfig
    from qrag_tpu_torch.index import read_flat_index, write_flat_index
    from qrag_tpu_torch.ops import ip_topk, l2_topk
    from qrag_tpu_torch.ops import topk
    from qrag_tpu_torch.serving import http_app, serve_in_thread, serve_main

    assert (l2_topk, ip_topk) == (topk.l2_topk, topk.ip_topk)
    assert (serve_in_thread, serve_main) == (http_app.serve_in_thread, http_app.main)
    assert Document("a", "b").content == "b" and QragConfig().to_dict()
    assert callable(read_flat_index) and callable(write_flat_index)


# ------------------------------------------------------ l2_topk / ip_topk


def _topk_inputs(seed=0, b=8, n=4096, d=64):
    """Unit rows with planted duplicates; the first queries are corpus
    rows, so every k (1 included) sees a tie."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    for src, dst in ((3, 100), (3, 2000), (50, 4094), (50, 7), (700, 701)):
        x[dst] = x[src]
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0], q[1], q[2] = x[3], x[50], x[700]
    valid = np.ones(n, bool)
    valid[::7] = False  # masks row 7 (a copy of 50) and row 2002
    valid[100] = False
    return q, x, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sqnorms", [False, True])
@pytest.mark.parametrize("k", [1, 10, 200])
def test_l2_ip_topk_parity(k, sqnorms, masked):
    import jax.numpy as jnp

    from qrag_tpu.ops import topk as jtopk
    from qrag_tpu_torch.ops import topk as ttopk

    q, x, valid = _topk_inputs()
    sq = np.sum(x * x, axis=1) if sqnorms else None
    vr = valid if masked else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    jv, ji = jtopk.l2_topk(j(q), j(x), k, corpus_sqnorms=j(sq), valid_rows=j(vr))
    tv, ti = ttopk.l2_topk(t(q), t(x), k, corpus_sqnorms=t(sq), valid_rows=t(vr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert bool(torch.all(tv[:, 1:] >= tv[:, :-1]))  # ascending distances
    jv, ji = jtopk.ip_topk(j(q), j(x), k, valid_rows=j(vr))
    tv, ti = ttopk.ip_topk(t(q), t(x), k, valid_rows=t(vr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    if k >= 10:  # the planted copies, lower index first
        want = [3, 2000] if masked else [3, 100, 2000]
        assert ti[0, : len(want)].tolist() == want
        assert ti[1, :3].tolist()[: 2 if masked else 3] == ([50, 4094] if masked else [7, 50, 4094])


def test_l2_topk_masked_past_k():
    """Fewer valid rows than k: the rest are +inf distances (l2) or
    -inf scores (ip), in index order, as the reference gives them."""
    import jax.numpy as jnp

    from qrag_tpu.ops import topk as jtopk
    from qrag_tpu_torch.ops import topk as ttopk

    q, x, _ = _topk_inputs(seed=1)
    valid = np.zeros(x.shape[0], bool)
    valid[::40] = True  # 103 rows
    for fn in ("l2_topk", "ip_topk"):
        jv, ji = getattr(jtopk, fn)(jnp.asarray(q), jnp.asarray(x), 200, valid_rows=jnp.asarray(valid))
        tv, ti = getattr(ttopk, fn)(torch.from_numpy(q), torch.from_numpy(x), 200,
                                   valid_rows=torch.from_numpy(valid))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        assert bool(torch.isinf(tv[:, 103:]).all())


def test_l2_topk_bf16_store():
    """A bf16 corpus is upcast exactly (in row blocks), as the
    reference's ``_goodness`` upcasts it."""
    import jax.numpy as jnp

    from qrag_tpu.ops import topk as jtopk
    from qrag_tpu_torch.ops import topk as ttopk

    q, x, _ = _topk_inputs(seed=2)
    xb = torch.from_numpy(x).bfloat16()
    jv, ji = jtopk.l2_topk(jnp.asarray(q), jnp.asarray(x).astype(jnp.bfloat16), 10)
    tv, ti = ttopk.l2_topk(torch.from_numpy(q), xb, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- serve_in_thread

N_SERVE, D_SERVE = 16384, 64
SERVE_CFG = {"embedding": {"provider": "hash", "dim": D_SERVE}}


@pytest.fixture(scope="module")
def serve_engines(tmp_path_factory):
    """A JAX-written bundle of 16,384 x 64 rows, loaded by both engines
    (QRAG_* overrides cleared, as the engine parity tests do)."""
    from qrag_tpu.config import QragConfig
    from qrag_tpu.engine import QragEngine as JEngine
    from qrag_tpu_torch.engine import QragEngine as TEngine

    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("QRAG_")}
    try:
        x = np.random.default_rng(0).standard_normal((N_SERVE, D_SERVE)).astype(np.float32)
        eng = JEngine(config=QragConfig.from_dict(SERVE_CFG))
        eng.index.add(x, [f"doc{i}" for i in range(N_SERVE)])
        path = str(tmp_path_factory.mktemp("serve_bundle"))
        eng.save(path)
        yield JEngine.load(path), TEngine.load(path, device="cpu")
    finally:
        os.environ.update(saved)


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read().decode())


def _answers(server):
    port = server.server_address[1]
    q = np.random.default_rng(5).standard_normal((4, D_SERVE)).astype(np.float32)
    try:
        return [
            _post(port, "/search", {"vectors": q.tolist(), "k": 10}),
            _post(port, "/search", {"query": "find the advertisement", "k": 10}),
            _post(port, "/search_rerank", {"vectors": q.tolist(), "k": 10, "candidates": 100}),
            _post(port, "/search_rerank", {"query": "discount code offer", "k": 10,
                                           "candidates": 100}),
        ]
    finally:
        server.shutdown()
        server.server_close()
        if getattr(server, "batcher", None) is not None:
            server.batcher.close()


def _hits(resp, key):
    return [[h[key] for h in row] for row in resp["results"]]


@pytest.mark.parametrize("batching", [False, True])
def test_serve_in_thread_matches_reference(serve_engines, batching):
    from qrag_tpu.serving import serve_in_thread as j_serve
    from qrag_tpu_torch.serving import serve_in_thread as t_serve

    je, te = serve_engines
    want = _answers(j_serve(je))
    got = _answers(t_serve(te, batching=batching, max_wait_s=0.002) if batching else t_serve(te))
    for g, w in zip(got, want):
        assert _hits(g, "index") == _hits(w, "index")
        if "reranker_used" in w:
            assert g["reranker_used"] == w["reranker_used"] == "quantum"
            np.testing.assert_allclose(_hits(g, "score"), _hits(w, "score"), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(_hits(g, "retrieval_score"), _hits(w, "retrieval_score"),
                                       rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(_hits(g, "score"), _hits(w, "score"), rtol=1e-5, atol=1e-6)


# ------------------------------------------- TrainedEmbedder.load, params

TEXTS = ["find the advertisement segments", "", "a sponsor read " * 20, "climate debate"]


def test_trained_embedder_load_matches_reference():
    from qrag_tpu.models import bi_encoder as jbi
    from qrag_tpu_torch.models import bi_encoder as tbi

    j = jbi.TrainedEmbedder(cfg=jbi._load_config(BI_DIR), seed=3)
    j.load(BI_DIR)
    t = tbi.TrainedEmbedder(cfg=tbi._load_config(BI_DIR), seed=3, device="cpu")
    before = t(TEXTS)
    t.load(BI_DIR)
    np.testing.assert_allclose(t(TEXTS), j(TEXTS), atol=1e-5)
    assert not np.allclose(before, t(TEXTS), atol=1e-3)  # the weights moved
    # the loaded embedder is the one built from the weights directory
    np.testing.assert_array_equal(
        t(TEXTS), tbi.TrainedEmbedder(weights_dir=BI_DIR, device="cpu")(TEXTS)
    )


def test_trained_embedder_load_geometry_mismatch():
    from qrag_tpu_torch.models import bi_encoder as tbi
    from qrag_tpu_torch.models.cross_encoder import CrossEncoderConfig

    shipped = tbi._load_config(BI_DIR).tower
    for tower in (
        CrossEncoderConfig(max_len=128, dim=64, n_heads=4, n_layers=2, n_experts=4),  # shapes
        CrossEncoderConfig(max_len=128, dim=shipped.dim, n_heads=4, n_layers=1,
                           n_experts=4),  # fewer arrays than the file
        CrossEncoderConfig(max_len=128, dim=shipped.dim, n_heads=4, n_layers=3,
                           n_experts=4),  # more arrays than the file
    ):
        emb = tbi.TrainedEmbedder(tbi.BiEncoderConfig(tower=tower, out_dim=128), device="cpu")
        before = emb.params
        with pytest.raises(ValueError):
            emb.load(BI_DIR)
        for name, a in emb.params.items():  # nothing was half-loaded
            np.testing.assert_array_equal(a, before[name])


def test_params_is_an_attribute(tmp_path):
    from qrag_tpu.models import bi_encoder as jbi
    from qrag_tpu_torch.models import bi_encoder as tbi
    from qrag_tpu_torch.models import cross_encoder as tce
    from qrag_tpu_torch.models.weights import params_from_jax_tree, params_from_npz

    emb = tbi.TrainedEmbedder(weights_dir=BI_DIR, device="cpu")
    scorer = tce.CrossEncoderScorer(device="cpu")
    scorer.load(CROSS_DIR)
    for model, npz in ((emb, os.path.join(BI_DIR, "bi_encoder.npz")),
                       (scorer, os.path.join(CROSS_DIR, "params.npz"))):
        assert isinstance(model.params, dict) and not callable(model.params)
        with np.load(npz) as data:
            want = params_from_npz(data, model.cfg)
        assert sorted(model.params) == sorted(want)
        for name, a in want.items():
            np.testing.assert_array_equal(model.params[name], a)
        with pytest.raises(AttributeError):
            model.params = {}
    # a saved model reads back as its own params
    emb.save(str(tmp_path))
    with np.load(tmp_path / "bi_encoder.npz") as data:
        back = params_from_npz(data, emb.cfg)
    assert all(np.array_equal(back[n], a) for n, a in emb.params.items())
    # the reference's attribute, mapped through params_from_jax_tree
    j = jbi.TrainedEmbedder(cfg=jbi._load_config(BI_DIR))
    j.load(BI_DIR)
    tree = params_from_jax_tree(j.params, emb.cfg)
    assert all(np.array_equal(tree[n], a) for n, a in emb.params.items())


# ----------------------------------------------------------- device_matrix


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_device_matrix_matches_reference(store):
    import jax.numpy as jnp

    from qrag_tpu.index.flat_index import DeviceFlatIndex as JIndex
    from qrag_tpu_torch.index import DeviceFlatIndex as TIndex

    x = np.random.default_rng(4).standard_normal((1000, 32)).astype(np.float32)
    j = JIndex.from_numpy(x, store_dtype=store)
    t = TIndex.from_numpy(x, store_dtype=store, device="cpu")
    for extra in (None, x[:40] * 0.5):  # first upload, then an append in capacity
        if extra is not None:
            j.add(extra)
            t.add(extra)
        jm, tm = np.asarray(j.device_matrix.astype(jnp.float32)), t.device_matrix
        # the same capacity rule (round up to 128, 25% headroom) in both
        assert tuple(tm.shape) == jm.shape
        assert tm.dtype == (torch.bfloat16 if store == "bfloat16" else torch.float32)
        n = t.ntotal
        np.testing.assert_array_equal(tm[:n].float().numpy(), jm[:n])
        assert tm.data_ptr() == t.device_buffers().matrix.data_ptr()  # no copy
