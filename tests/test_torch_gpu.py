"""GPU-only checks of the Hopper kernels (the packed window scan's float
and int8 domains, each in its general and its wide arm, the row gather,
every arm of scan_topk) against their
plain twins, and of the shared launch path (marked ``gpu``; they skip
without a CUDA device).  This file
imports no jax, so it runs on the GPU host, which has none:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

They do not replace ``chip_smoke.py``, which drives the main path.
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Hopper kernel runs only there)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [2, 3])
@pytest.mark.parametrize("bsize", [1, 7, 64])
def test_gpu_kernel_matches_plain_twin(cuda, planes, bsize):
    from qrag_tpu_torch.ops import bounded_topk as tbt
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.ops.window_scan import make_lane_rank

    rng = np.random.default_rng(bsize)
    n, d = 4224, 128
    q = torch.from_numpy(rng.integers(-8, 9, (bsize, d)).astype(np.float32) / 16)
    x = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32) / 16)
    q, x = q.to(cuda).bfloat16(), x.to(cuda).bfloat16()
    ra = -(x.float() ** 2).sum(1)[None, :]
    ra[:, 5::9] = -torch.inf
    ca = -(q.float() ** 2).sum(1, keepdim=True)
    got = fused_scan.packed_window_scan(q, x, None, ra, ca, 2.0, planes)
    torch.cuda.synchronize()
    twin = tbt.packed_window_scan_top3 if planes == 3 else tbt.packed_window_scan_top2
    ref = twin(q, x, make_lane_rank(n, cuda), ra, ca, 2.0)
    for g, r in zip(got, ref):  # dyadic inputs: every sum exact
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_gpu_kernel_rejects_bad_inputs(cuda):
    from qrag_tpu_torch.ops.cuda import fused_scan

    x = torch.zeros((256, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        fused_scan.packed_window_scan(x.float()[:2], x.float(), None)
    with pytest.raises(ValueError):
        fused_scan.packed_window_scan(x[:2, :24].contiguous(), x[:, :24].contiguous(), None)
    with pytest.raises(ValueError):
        fused_scan.packed_window_scan(x[:2].cpu(), x, None)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("shape", [(1, 4224, 16), (7, 4096, 128), (64, 4224, 768)])
def test_gpu_int8_kernel_bit_equal(cuda, planes, shape):
    """Integer accumulation is exact: the int planes equal the twin's bit
    for bit on random codes."""
    from qrag_tpu_torch.ops import bounded_topk as tbt
    from qrag_tpu_torch.ops import window_scan as tws
    from qrag_tpu_torch.ops.cuda import fused_scan

    b, n, d = shape
    rng = np.random.default_rng(b + d)
    q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8)).to(cuda)
    x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(cuda)
    got = fused_scan.packed_window_scan(q, x, None, planes=planes)
    torch.cuda.synchronize()
    lr = tws.make_lane_rank(n, cuda)
    ref = (
        (tws.packed_window_scan(q, x, lr),)
        if planes == 1
        else tbt.packed_window_scan_top2_int(q, x, lr)
    )
    assert len(got) == planes
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("bsize", [1, 7, 64])
def test_gpu_float_top1_kernel_matches_twin(cuda, bsize):
    from qrag_tpu_torch.ops import window_scan as tws
    from qrag_tpu_torch.ops.cuda import fused_scan

    rng = np.random.default_rng(bsize)
    n, d = 4224, 128
    q = torch.from_numpy(rng.integers(-8, 9, (bsize, d)).astype(np.float32) / 16)
    x = torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(np.float32) / 16)
    q, x = q.to(cuda).bfloat16(), x.to(cuda).bfloat16()
    ra = -(x.float() ** 2).sum(1)[None, :]
    ca = -(q.float() ** 2).sum(1, keepdim=True)
    (got,) = fused_scan.packed_window_scan(q, x, None, ra, ca, 2.0, planes=1)
    torch.cuda.synchronize()
    ref = tws.packed_window_scan(q, x, tws.make_lane_rank(n, cuda), ra, ca, 2.0)
    assert torch.equal(got, ref)  # dyadic inputs: every sum exact


@pytest.mark.gpu
@pytest.mark.parametrize("arm", ["general", "wide"])
@pytest.mark.parametrize("int8,planes", [(False, 1), (False, 2), (False, 3), (True, 1), (True, 2)])
@pytest.mark.parametrize(
    "b,n,d",
    [(1, 4096, 128), (2, 128, 128), (7, 4224, 768), (64, 4096, 128), (129, 4224, 128),
     (300, 4224, 768), (1000, 4352, 128), (5000, 384, 128)],
)
def test_gpu_scan_arms_match_twin(cuda, b, n, d, int8, planes, arm):
    """Each arm of each domain, forced, on shapes both take (a ragged
    last query tile, 1, 3, 33 and 34 windows, 40 query tiles): the int8
    planes bit-equal to the twin's, the float planes within the plane
    contract, and the arm's launch counted."""
    from qrag_tpu_torch.ops import bounded_topk as tbt
    from qrag_tpu_torch.ops import window_scan as tws
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.ops.cuda.scan_ab import plane_contract

    rng = np.random.default_rng(b + n + d + planes)
    lr = tws.make_lane_rank(n, cuda)
    before = fused_scan.arm_launches[arm]
    if int8:
        q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8)).to(cuda)
        x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8)).to(cuda)
        got = fused_scan.packed_window_scan_cuda(q, x, planes=planes, arm=arm)
        torch.cuda.synchronize()
        ref = ((tws.packed_window_scan(q, x, lr),) if planes == 1
               else tbt.packed_window_scan_top2_int(q, x, lr))
        assert len(got) == planes and all(torch.equal(g, r) for g, r in zip(got, ref))
    else:
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(cuda).bfloat16()
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
        x = (x / x.norm(dim=1, keepdim=True)).bfloat16()
        ra = -(x.float() ** 2).sum(1)[None, :]
        ra[:, 5::9] = -torch.inf
        ca = -(q.float() ** 2).sum(1, keepdim=True)
        got = fused_scan.packed_window_scan_cuda(q, x, ra, ca, 2.0, planes, arm)
        torch.cuda.synchronize()
        twin = {1: lambda *a: (tws.packed_window_scan(*a),), 2: tbt.packed_window_scan_top2,
                3: tbt.packed_window_scan_top3}[planes]
        ref = twin(q, x, lr, ra, ca, 2.0)
        assert len(got) == planes
        _, same, keys, _ = plane_contract(got, ref, q, x, 2.0, ra, ca)
        assert keys < 1000 or same >= 0.9 * keys  # a floor for samples of some size
    assert fused_scan.arm_launches[arm] == before + 1


@pytest.mark.gpu
def test_gpu_scan_planned_arm_is_launched(cuda):
    """Unforced, a call launches the arm that ``plan`` names: general up
    to the cut and where d is no whole number of slabs, wide past it."""
    from qrag_tpu_torch.ops.cuda import fused_scan

    for int8 in (False, True):
        cut = fused_scan.WIDE_MIN_B[int8]
        for b, d in ((1, 128), (cut - 1, 128), (cut, 128), (1024, 128), (1024, 48)):
            dtype = torch.int8 if int8 else torch.bfloat16
            q = torch.ones((b, d), device=cuda).to(dtype)
            x = torch.ones((4224, d), device=cuda).to(dtype)
            want = fused_scan.plan(q, x).arm
            assert want == ("wide" if b >= cut and d == 128 else "general")
            before = dict(fused_scan.arm_launches)
            fused_scan.packed_window_scan(q, x, None, planes=2)
            torch.cuda.synchronize()
            rose = {a: c - before[a] for a, c in fused_scan.arm_launches.items()}
            assert rose == {a: int(a == want) for a in rose}


@pytest.mark.gpu
def test_gpu_scan_wide_arm_on_concurrent_streams(cuda):
    """Worker threads launch the persistent wide arm on streams of their
    own at once (as a batching server's do): every result equals the
    twin's, and every launch is counted."""
    import threading

    from qrag_tpu_torch.ops import bounded_topk as tbt
    from qrag_tpu_torch.ops import window_scan as tws
    from qrag_tpu_torch.ops.cuda import fused_scan

    g = torch.Generator(device=cuda).manual_seed(0)
    n, d = 131072, 128
    x = torch.randint(-127, 128, (n, d), generator=g, device=cuda, dtype=torch.int8)
    qs = [torch.randint(-127, 128, (b, d), generator=g, device=cuda, dtype=torch.int8)
          for b in (64, 300, 1024, 129)]
    lr = tws.make_lane_rank(n, cuda)
    want = [tbt.packed_window_scan_top2_int(q, x, lr) for q in qs]
    fused_scan.packed_window_scan(qs[0], x, None, planes=2)  # the build, outside the count
    torch.cuda.synchronize()
    before = fused_scan.arm_launches["wide"]
    got = [None] * len(qs)

    def work(i):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(5):
                got[i] = fused_scan.packed_window_scan(qs[i], x, None, planes=2)
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert fused_scan.arm_launches["wide"] == before + 5 * len(qs)
    for g_, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g_, w))


@pytest.mark.gpu
def test_gpu_scan_forced_arm_that_does_not_fit_raises(cuda):
    from qrag_tpu_torch.ops.cuda import fused_scan

    before = dict(fused_scan.arm_launches)
    for dtype, d in ((torch.bfloat16, 48), (torch.int8, 64)):
        x = torch.ones((256, d), device=cuda).to(dtype)
        with pytest.raises(ValueError, match="wide arm does not take"):
            fused_scan.packed_window_scan_cuda(x[:64], x, planes=2, arm="wide")
        with pytest.raises(ValueError, match="does not take"):
            fused_scan.packed_window_scan_cuda(x[:64], x, planes=2, arm="tiled")
    assert dict(fused_scan.arm_launches) == before


@pytest.mark.gpu
def test_gpu_int8_kernel_rejects_affine_operands(cuda):
    from qrag_tpu_torch.ops.cuda import fused_scan

    x = torch.zeros((256, 32), device=cuda, dtype=torch.int8)
    for kw in (dict(row_add=torch.zeros((1, 256), device=cuda)),
               dict(col_add=torch.zeros((2, 1), device=cuda)), dict(alpha=2.0),
               dict(planes=3)):
        with pytest.raises(ValueError):
            fused_scan.packed_window_scan(x[:2], x, None, **kw)
    with pytest.raises(TypeError):
        fused_scan.packed_window_scan(x[:2].bfloat16(), x, None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("d", [768, 100, 13])
def test_gpu_gather_kernel_bit_equal(cuda, dtype, d):
    from qrag_tpu_torch.ops import gather_rows as tg
    from qrag_tpu_torch.ops.cuda import gather_rows as cg

    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randint(-127, 128, (3000, d), generator=g, device=cuda).to(dtype)
    for m in (1, 100, 6400):
        for it in (torch.int32, torch.int64):
            idx = torch.randint(-40, 3040, (m,), generator=g, device=cuda).to(it)
            before = cg.launches
            got = tg.gather_rows(x, idx)
            torch.cuda.synchronize()
            assert cg.launches == before + 1
            assert torch.equal(got, tg.plain_gather_rows(x, idx))
    idx2 = torch.randint(0, 3000, (8, 16), generator=g, device=cuda)
    assert torch.equal(tg.gather_rows_2d(x, idx2.T), x[idx2.T])  # strided 2-D index


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 129, 1000])
def test_gpu_scan_topk_matches_twin(cuda, compute_dtype, k):
    """Dyadic inputs: every dot is exact in either summation order, so
    indices (ties to the lower row) and values equal the twin's."""
    from qrag_tpu_torch.ops import scan_topk as ts

    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randint(-8, 9, (20000, 64), generator=g, device=cuda) / 16
    x[5::997] = x[3]  # planted duplicates
    valid = torch.rand(20000, generator=g, device=cuda) > 0.2
    for b in (1, 7, 64):
        q = torch.randint(-8, 9, (b, 64), generator=g, device=cuda) / 16
        for metric in ("l2", "ip"):
            for vr in (None, valid):
                got = ts.scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=compute_dtype)
                torch.cuda.synchronize()
                want = ts.plain_scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=compute_dtype)
                assert torch.equal(got[1], want[1])
                assert torch.equal(got[0], want[0])


@pytest.mark.gpu
def test_gpu_scan_topk_k_limit_and_sentinels(cuda):
    from qrag_tpu_torch.ops import scan_topk as ts

    x = torch.randn((3000, 32), device=cuda)
    with pytest.raises(ValueError, match="k <= 1024"):
        ts.scan_topk(x[:2], x, 1025)
    valid = torch.zeros(3000, dtype=torch.bool, device=cuda)
    valid[[4, 2500]] = True
    s, i = ts.scan_topk(x[:2], x, 5, "ip", valid_rows=valid)
    assert torch.isneginf(s[:, 2:]).all() and (i[:, 2:] == -1).all()
    assert set(i[0, :2].tolist()) == {4, 2500}


@pytest.mark.gpu
def test_gpu_build_failure_raises(cuda, tmp_path, monkeypatch):
    """A kernel that does not build raises; nothing falls back to the
    plain twin or a library call."""
    from qrag_tpu_torch.ops import gather_rows as tg
    from qrag_tpu_torch.ops import scan_topk as ts
    from qrag_tpu_torch.ops.cuda import _build, _launch

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_launch, "_fns", {})  # the entry points bound so far
    x = torch.randn((300, 16), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tg.gather_rows(x, torch.arange(4, device=cuda))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ts.scan_topk(x[:2], x, 3)


def _topk_close(got, want, q, x, metric, bf16):
    """The summation-order tolerance of ``chip_smoke.py`` (_check_topk):
    values within rtol 1e-5, or 1e-5 of the terms' scale where the score
    cancels; indices equal except at near-ties within that scale."""
    (kv, ki), (pv, pi) = got, want
    fin = torch.isfinite(pv)
    assert torch.equal(fin, torch.isfinite(kv)) and torch.equal(ki < 0, pi < 0)
    qsq = (q.double() ** 2).sum(1)
    b, t = torch.nonzero(fin, as_tuple=True)
    scale = 1.0 + qsq[b] + (x[pi[b, t].long()].double() ** 2).sum(1)
    ref = pv[b, t].double().abs()
    err = (kv[b, t].double() - pv[b, t].double()).abs()
    cancel = ref < 1e-2 * scale
    assert not bool(torch.where(cancel, err > 1e-5 * scale, err > 1e-5 * ref).any())
    b, t = torch.nonzero(ki != pi, as_tuple=True)
    rows = ki[b, t].long()
    qq, xx = q[b], x[rows]
    if bf16:
        qq, xx = qq.bfloat16(), xx.bfloat16()
    g = (qq.double() * xx.double()).sum(1)
    xsq = (x[rows].double() ** 2).sum(1)
    if metric == "l2":
        g = qsq[b] + xsq - 2 * g
    assert bool(((g - pv[b, t].double()).abs() <= 1e-5 * (1 + qsq[b] + xsq)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,n,d,k",
    [
        (8, 20000, 768, 10), (9, 20000, 768, 10),  # bf16: stream | wgmma64
        (16, 20000, 768, 10), (33, 20000, 768, 10),
        (64, 20000, 768, 10), (65, 20000, 768, 10),  # stream | tiled, wgmma64 | wgmma128
        (1, 20000, 768, 256), (1, 20000, 768, 257),  # the stream buffers
        (1, 20000, 768, 768), (1, 20000, 768, 769), (1, 20000, 768, 1024),
        (200, 20000, 768, 24), (200, 20000, 768, 25),  # the tiled buffers
        (200, 20000, 768, 64), (200, 20000, 768, 65),  # past the tiles: general
        (1, 5000, 100, 100), (200, 5000, 100, 10),  # a depth that is no tile multiple
        (1, 5000, 13, 100), (7, 5000, 13, 10), (200, 5000, 13, 10),  # unaligned rows
        (1, 50, 768, 50), (200, 50, 768, 10),  # fewer rows than one tile
    ],
)
def test_gpu_scan_topk_arms_match_twin(cuda, compute_dtype, b, n, d, k):
    """Every arm at the shapes its tiles and buffers cut at, random
    inputs with planted duplicates across tile boundaries and a whole
    tile masked, under the summation-order tolerance."""
    from qrag_tpu_torch.ops import scan_topk as ts
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    g = torch.Generator(device=cuda).manual_seed(b * 1000 + k + d)
    x = torch.randn((n, d), generator=g, device=cuda)
    for r in (7, 63, 64, 127, 128, 255, 256):
        if r < n:
            x[r] = x[3]
    valid = torch.rand(n, generator=g, device=cuda) > 0.1
    valid[1024:2048] = False
    q = torch.randn((b, d), generator=g, device=cuda)
    q[0] = x[3]
    want_arm = ct.plan(q, x, k, compute_dtype == torch.bfloat16).arm
    for metric in ("l2", "ip"):
        for vr in (None, valid):
            before = ct.arm_launches[want_arm]
            got = ts.scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=compute_dtype)
            torch.cuda.synchronize()
            assert ct.arm_launches[want_arm] == before + 1
            want = ts.plain_scan_topk(q, x, k, metric, valid_rows=vr, compute_dtype=compute_dtype)
            _topk_close(got, want, q, x, metric, compute_dtype == torch.bfloat16)


@pytest.mark.gpu
def test_gpu_gather_under_cuda_graph(cuda):
    """The wrapper launches on PyTorch's current stream, so a CUDA graph
    captures it; replays follow the index tensor's contents."""
    from qrag_tpu_torch.ops import gather_rows as tg

    x = torch.randn((3000, 768), device=cuda)
    idx = torch.randint(0, 3000, (100,), device=cuda)
    tg.gather_rows(x, idx)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
        out = tg.gather_rows(x, idx)
    for seed in (1, 2):
        idx.copy_(torch.randint(0, 3000, (100,), device=cuda,
                                generator=torch.Generator(device=cuda).manual_seed(seed)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, x[idx])


@pytest.mark.gpu
def test_gpu_launch_counter_exact_under_threads(cuda):
    import threading

    from qrag_tpu_torch.ops import gather_rows as tg
    from qrag_tpu_torch.ops.cuda import gather_rows as cg

    x = torch.randn((3000, 64), device=cuda)
    idx = torch.randint(0, 3000, (100,), device=cuda)
    tg.gather_rows(x, idx)  # the build and the first bind, outside the count
    before = cg.launches

    def work():
        for _ in range(100):
            tg.gather_rows(x, idx)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert cg.launches == before + 800


@pytest.mark.gpu
def test_gpu_train_steps_hold_bf16_bounds(cuda):
    """One listwise step of the shipped recipe (warm start, the first
    hard group of Q = 8, 224 tokens) and one InfoNCE step (batch 32, 128
    tokens) on the card, bf16 against f32: within the bounds fixed on the
    CPU (tests/test_torch_train.py::test_bf16_step_bounds)."""
    from qrag_tpu_torch.models import bi_encoder as be
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models import recall_eval as rcl
    from qrag_tpu_torch.models import rerank_eval as rev
    from qrag_tpu_torch.pipeline import corpus_gen

    cfg = rev.RerankEvalConfig(batch=8)
    ce_cfg = rev._make_cfg(cfg)
    warm = rev.warm_start_params(ce_cfg, "artifacts/bi_encoder")
    chunks = corpus_gen.generate_corpus(48, 8, seed=0)
    train_idx, _ = corpus_gen.split_by_episode(chunks, 0.25, seed=1)
    toks, masks = rev.group_grids(cfg, chunks, train_idx, 1)[0]
    batch = ce.device_batch(cuda, toks, masks, np.zeros((8, 8), np.float32))
    dev, cos = ce.bf16_step_deviation(
        lambda: ce.trainable(ce.load_module(ce.CrossEncoder(ce_cfg, pos_rows=128), warm), cuda),
        lambda m, dtype: rev.listwise_loss(m, *batch, dtype),
    )
    assert dev <= ce.BF16_STEP_LOSS_RTOL and cos >= ce.BF16_GRAD_COSINE_FLOOR, (dev, cos)
    rcfg = rcl.RecallEvalConfig(batch=32)
    bi_cfg = rcl._bi_config(rcfg)
    init = be.init_params(bi_cfg, 0)
    pairs = corpus_gen.training_pairs(chunks, train_idx, n_pairs=2000, seed=2)
    qs, ds = next(rcl._doc_batches(rcfg, pairs))
    texts = (*ce.device_batch(cuda, *be.tokenize_texts(qs, 128)),
             *ce.device_batch(cuda, *be.tokenize_texts(ds, 128)))
    dev, cos = ce.bf16_step_deviation(
        lambda: ce.trainable(ce.load_module(be.BiEncoder(bi_cfg), init), cuda),
        lambda m, dtype: be.info_nce_loss(m, *texts, dtype),
    )
    assert dev <= be.BF16_STEP_LOSS_RTOL and cos >= be.BF16_GRAD_COSINE_FLOOR, (dev, cos)


def _clustered_rows(seed, n, d, n_centers=16, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.integers(0, n_centers, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("uniform", [False, True])
def test_gpu_cluster_pruned_topk_matches_cpu(cuda, metric, uniform):
    """The clustered accelerator on the card: the same structure (one
    assignment) and the same identity and flags as on the CPU, exact
    against the f32 oracle; uniform rows take the ladder."""
    from qrag_tpu_torch.ops import cluster_topk as ct
    from qrag_tpu_torch.ops.topk import _goodness, top_k

    x = _clustered_rows(1, 8192, 64)
    if uniform:
        x = np.random.default_rng(2).standard_normal((8192, 64)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = _clustered_rows(3, 8, 64)
    assign = ct.cluster_assignments(x, group_rows=64, kmeans_iters=3, device="cpu")
    g_cpu = ct.build_clustered_groups(x, group_rows=64, assign=assign, device="cpu")
    g_gpu = ct.build_clustered_groups(torch.from_numpy(x).to(cuda), group_rows=64, assign=assign)
    assert torch.equal(g_gpu.orig_idx.cpu(), g_cpu.orig_idx)
    vc, ic, fc, ec = ct.cluster_pruned_topk(q, g_cpu, 10, metric=metric)
    vg, ig, fg, eg = ct.cluster_pruned_topk(torch.from_numpy(q).to(cuda), g_gpu, 10, metric=metric)
    assert ig.device.type == "cuda" and (fg, eg) == (fc, ec)
    ov, oi = top_k(_goodness(torch.from_numpy(q), torch.from_numpy(x), metric, None, None), 10)
    assert torch.equal(ig.cpu(), oi) and torch.equal(ic, oi)
    torch.testing.assert_close(vg.cpu(), ov, rtol=1e-5, atol=1e-5)
    if uniform:
        assert eg


@pytest.mark.gpu
def test_gpu_index_accel_routes_and_kmeans(cuda):
    """The index's accelerator on the card builds its own k-means there
    and equals the bounded search."""
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    x = _clustered_rows(4, 16384, 64)
    accel = DeviceFlatIndex.from_numpy(x, small_batch_accel="clustered", cluster_group_rows=128,
                                       accel_read_cap=0)
    plain = DeviceFlatIndex.from_numpy(x)
    q = _clustered_rows(5, 4, 64)
    assert accel._accel_eligible(4, 10)
    np.testing.assert_array_equal(accel.search(q, 10).indices, plain.search(q, 10).indices)
    assert accel.device_buffers().extras["clustered"].corpus_p.device.type == "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("n_qubits", [4, 10])
def test_gpu_statevector_matches_cpu(cuda, n_qubits):
    """complex64 on the card: the statevector fidelity, the amplitude
    fidelity and a circuit equal their CPU evaluation within 1e-6."""
    from qrag_tpu_torch.ops import circuit, statevector as sv

    rng = np.random.default_rng(n_qubits)
    q = torch.from_numpy(rng.standard_normal(2 * n_qubits).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((32, 2 * n_qubits)).astype(np.float32))
    for fn in (sv.fidelity_statevector, sv.amplitude_fidelity, sv.fidelity_analytic):
        got = fn(q.to(cuda), d.to(cuda), n_qubits)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), fn(q, d, n_qubits), rtol=0, atol=1e-6)
    c_gpu = circuit.Circuit(n_qubits).encode_rotations(q.numpy()).cx_ladder().h(0)
    c_cpu = circuit.Circuit(n_qubits, device="cpu").encode_rotations(q.numpy()).cx_ladder().h(0)
    torch.testing.assert_close(c_gpu.simulate().cpu(), c_cpu.simulate(), rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_gpu_native_store_to_device_index(cuda, tmp_path):
    from qrag_tpu_torch.index import native_store as ns

    x = _clustered_rows(6, 4096, 32)
    with ns.NativeVectorStore(str(tmp_path / "s.qidx"), d=32) as s:
        s.append(x)
        _, want = s.scan_topk(x[:4], 5)
        _, host, _ = s.cluster_topk(x[:4], 5)
        idx = s.to_device_index()
    assert idx.device.type == "cuda"
    np.testing.assert_array_equal(idx.search(x[:4], 5).indices, want)
    np.testing.assert_array_equal(host, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["approx", "verified", "refined"])
def test_gpu_topk_modes_select_through_scan_topk(cuda, mode):
    """approx / verified / refined pick their candidates with the
    scan_topk kernel (f32 compute; bf16 for refined: one launch a call)
    and equal the same call on the CPU, where the twin selects.  Dyadic
    inputs, exact in bf16: every score is exact in any order, so
    indices (ties to the lower row, planted duplicates) and values are
    bit for bit the CPU's."""
    from qrag_tpu_torch.ops import topk as tk
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randint(-8, 9, (20000, 64), generator=g, device=cuda) / 16
    x[5::997] = x[3]
    valid = torch.rand(20000, generator=g, device=cuda) > 0.1
    sq = (x * x).sum(1)
    q = torch.randint(-8, 9, (64, 64), generator=g, device=cuda) / 16
    for metric in ("l2", "ip"):
        for k in (10, 100):
            before = dict(ct.launches)
            if mode == "verified":
                got = tk.scan_topk_verified(q, x, k, metric, sq, valid)
                want = tk.scan_topk_verified(q.cpu(), x.cpu(), k, metric, sq.cpu(), valid.cpu())
                got, want = (got[0], got[1], got[2]), (want[0], want[1], want[2])
                assert got[2] == want[2]
            else:
                got = tk.flat_scan_topk(q, x, k, metric, sq, valid, mode=mode)
                want = tk.flat_scan_topk(q.cpu(), x.cpu(), k, metric, sq.cpu(), valid.cpu(), mode=mode)
                got = [t.cpu().numpy() for t in got]
                want = [t.numpy() for t in want]
            rose = {t: c - before[t] for t, c in ct.launches.items()}
            assert rose == ({"float32": 0, "bfloat16": 1} if mode == "refined"
                            else {"float32": 1, "bfloat16": 0})
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.gpu
def test_gpu_wide_selection_and_verified_jit(cuda):
    """k x oversample past the kernel's 1024 takes the counted product +
    sort route on the card, equal to the CPU's; at or under it, one
    launch."""
    from qrag_tpu_torch.ops import topk as tk
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randint(-8, 9, (30000, 32), generator=g, device=cuda) / 16
    q = torch.randint(-8, 9, (16, 32), generator=g, device=cuda) / 16
    for k, route in ((100, "product_sort"), (10, "scan_topk")):
        routes, before = dict(tk.selection_routes), sum(ct.launches.values())
        v, i, nb = tk.scan_topk_verified_jit(q, x, k)
        assert {r: c - routes[r] for r, c in tk.selection_routes.items()}[route] == 1
        assert sum(ct.launches.values()) - before == (route == "scan_topk")
        wv, wi, wnb = tk.scan_topk_verified_jit(q.cpu(), x.cpu(), k)
        assert int(nb) == int(wnb)
        assert torch.equal(i.cpu(), wi) and torch.equal(v.cpu(), wv)


@pytest.mark.gpu
@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_gpu_sharded_bounded_launches_k1_per_shard(cuda, merge):
    """A 4-slot sharded index on one card (bounded): the packed window
    scan kernel launches on every shard, and the merged result equals
    the same index on the CPU (the twins) and the exact sort."""
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.parallel.mesh import make_mesh
    from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    rng = np.random.default_rng(9)
    x = rng.standard_normal((4 * 8192, 64)).astype(np.float32)
    x[7::4001] = x[11]  # duplicates across shards
    q = rng.standard_normal((33, 64)).astype(np.float32)
    cfg = MeshConfig(data_parallel=1, model_parallel=4)
    gpu = ShardedFlatIndex(x, make_mesh(cfg, device=cuda), topk_mode="bounded", merge=merge)
    cpu = ShardedFlatIndex(x, make_mesh(cfg, device="cpu"), topk_mode="bounded", merge=merge)
    exact = DeviceFlatIndex.from_numpy(x, topk_mode="exact", device="cpu")
    for k in (10, 64):
        before = sum(fused_scan.launches.values())
        got = gpu.search(q, k=k)
        assert sum(fused_scan.launches.values()) - before >= 4
        want = cpu.search(q, k=k)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.indices, exact.search(q, k=k).indices)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["approx", "verified", "refined"])
def test_gpu_bf16_store_selects_a_block_at_a_time(cuda, monkeypatch, mode):
    """A bf16 corpus reaches the kernel as f32 blocks (``f32_blocks``):
    one launch a block, and the answer the same call gives on the CPU
    (dyadic inputs, exact in bf16 and in any summation order: indices
    and values bit for bit)."""
    from qrag_tpu_torch.ops import scan_topk as ts
    from qrag_tpu_torch.ops import topk as tk
    from qrag_tpu_torch.ops.cuda import scan_topk as ct

    monkeypatch.setattr(ts, "CAST_ROWS", 4096)
    g = torch.Generator(device=cuda).manual_seed(10)
    x = (torch.randint(-8, 9, (20000, 64), generator=g, device=cuda) / 16).to(torch.bfloat16)
    x[4095], x[4096] = x[3], x[3]  # twins across a block edge
    q = torch.randint(-8, 9, (16, 64), generator=g, device=cuda) / 16
    q[0] = x[3].float()
    before = dict(ct.launches)
    if mode == "verified":
        got = tk.scan_topk_verified(q, x, 10, "l2")
        want = tk.scan_topk_verified(q.cpu(), x.cpu(), 10, "l2")
        assert got[2] == want[2] == 0
    else:
        got = [t.cpu().numpy() for t in tk.flat_scan_topk(q, x, 10, "l2", mode=mode)]
        want = [t.numpy() for t in tk.flat_scan_topk(q.cpu(), x.cpu(), 10, "l2", mode=mode)]
    rose = {t: c - before[t] for t, c in ct.launches.items()}
    assert rose == ({"float32": 0, "bfloat16": 5} if mode == "refined"
                    else {"float32": 5, "bfloat16": 0})
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert {3, 4095, 4096} <= set(got[1][0].tolist())


_TWO_RANK_SEARCH = """
import os, sys
import numpy as np
import torch
from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.ops.cuda import fused_scan
from qrag_tpu_torch.parallel import mesh
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

rank, tmp = int(sys.argv[1]), sys.argv[2]
mesh.distributed_init("file://" + os.path.join(tmp, "store"), 2, rank, backend="gloo")
with np.load(os.path.join(tmp, "inputs.npz")) as f:
    x, q = f["x"], f["q"]
grid = mesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=2))
out = {}
for merge in ("allgather", "ring"):
    idx = ShardedFlatIndex(x, grid, topk_mode="bounded", merge=merge)
    for k in (10, 64):
        before = sum(fused_scan.launches.values())
        res = idx.search(q, k=k)
        assert sum(fused_scan.launches.values()) > before  # K1 on this rank's shard
        out[f"{merge}_{k}_idx"], out[f"{merge}_{k}_val"] = res.indices, res.scores
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
mesh.shutdown()
"""


@pytest.mark.gpu
def test_gpu_two_rank_gloo_search_matches_unsharded(cuda, tmp_path):
    """Two gloo ranks on this card, one shard each (bounded, K1 on each
    rank's shard): both merges on both ranks equal the unsharded index on
    the card and the exact sort, indices bit for bit."""
    import os
    import subprocess
    import sys

    from qrag_tpu_torch.index.flat_index import DeviceFlatIndex

    rng = np.random.default_rng(11)
    x = rng.standard_normal((2 * 8192, 64)).astype(np.float32)
    x[5::7001] = x[3]  # duplicates across the two shards
    q = rng.standard_normal((33, 64)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", x=x, q=q)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANK_SEARCH, str(r), str(tmp_path)],
                              env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, outs[r][-3000:]
    unsharded = DeviceFlatIndex.from_numpy(x, topk_mode="bounded", device=cuda)
    exact = DeviceFlatIndex.from_numpy(x, topk_mode="exact", device="cpu")
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for k in (10, 64):
            want = unsharded.search(q, k=k)
            for merge in ("allgather", "ring"):
                np.testing.assert_array_equal(got[f"{merge}_{k}_idx"], want.indices)
                np.testing.assert_allclose(got[f"{merge}_{k}_val"], want.scores,
                                           rtol=1e-5, atol=1e-4)
            np.testing.assert_array_equal(got[f"allgather_{k}_val"], got[f"ring_{k}_val"])
            np.testing.assert_array_equal(want.indices, exact.search(q, k=k).indices)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 200])
def test_gpu_l2_ip_topk_match_cpu(cuda, k):
    """``l2_topk`` / ``ip_topk`` (the f32 product and a stable sort, no
    kernel) on the card equal their CPU results: identity and tie order
    on planted duplicates, values within f32 summation-order error."""
    from qrag_tpu_torch.ops import ip_topk, l2_topk

    rng = np.random.default_rng(k)
    x = rng.standard_normal((4096, 64)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[[100, 2000]] = x[3]
    q = rng.standard_normal((8, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = x[3]
    valid = np.ones(4096, bool)
    valid[::7] = False
    for vr in (None, torch.from_numpy(valid)):
        for fn, kw in ((l2_topk, {"corpus_sqnorms": torch.from_numpy((x * x).sum(1))}),
                       (ip_topk, {})):
            want_v, want_i = fn(torch.from_numpy(q), torch.from_numpy(x), k, valid_rows=vr, **kw)
            got_v, got_i = fn(torch.from_numpy(q).to(cuda), torch.from_numpy(x).to(cuda), k,
                              valid_rows=None if vr is None else vr.to(cuda),
                              **{n: t.to(cuda) for n, t in kw.items()})
            assert got_i.is_cuda
            assert torch.equal(got_i.cpu(), want_i)
            torch.testing.assert_close(got_v.cpu(), want_v, rtol=1e-5, atol=1e-5)
            if k >= 10 and fn is l2_topk:
                assert got_i[0, :3].tolist() == [3, 100, 2000]


@pytest.mark.gpu
def test_gpu_device_matrix(cuda):
    from qrag_tpu_torch.index import DeviceFlatIndex

    x = np.random.default_rng(0).standard_normal((1000, 32)).astype(np.float32)
    for store in ("float32", "bfloat16"):
        index = DeviceFlatIndex.from_numpy(x, store_dtype=store, device=cuda)
        m = index.device_matrix
        assert m.is_cuda and m.shape == (1280, 32)
        assert m.dtype == (torch.bfloat16 if store == "bfloat16" else torch.float32)
        assert m.data_ptr() == index.device_buffers().matrix.data_ptr()
        torch.testing.assert_close(m[:1000].float().cpu(), torch.from_numpy(x).to(m.dtype).float(),
                                   rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 100])
def test_gpu_bench_bounded_step_matches_cpu(cuda, k):
    """``bench_torch.bounded_step`` (the headline's step: K1 over a bf16
    corpus used as scan and store) on the card against the same step on
    the CPU (the plain twin): indices equal except between rows whose
    f32 scores lie within 1e-5, values within 1e-5."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import bench_torch as bt
    from qrag_tpu_torch.ops.cuda import fused_scan
    from qrag_tpu_torch.ops.topk import _goodness

    n, d, b = 16384, 256, 64
    rng = np.random.default_rng(k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    xt, qt = torch.from_numpy(x).bfloat16(), torch.from_numpy(q).bfloat16()
    want_v, want_i, _, _ = bt.bounded_step(qt, bt.bounded_buffers(xt), k)
    before = fused_scan.launches[("bf16", 3 if k > 16 else 2)]
    got_v, got_i, _, _ = bt.bounded_step(qt.to(cuda), bt.bounded_buffers(xt.to(cuda)), k)
    assert fused_scan.launches[("bf16", 3 if k > 16 else 2)] == before + 1
    got_v, got_i = got_v.cpu(), got_i.cpu()
    diff = got_i != want_i
    if bool(diff.any()):
        rows, pos = torch.nonzero(diff, as_tuple=True)
        g = _goodness(qt, xt, "l2", None, None)
        assert bool(((g[rows, got_i[rows, pos]] - want_v[rows, pos]).abs() <= 1e-5).all())
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=1e-5)
