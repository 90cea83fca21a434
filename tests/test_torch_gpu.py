"""GPU-only checks of the Hopper packed window-scan kernel against its
plain twin (marked ``gpu``; they skip without a CUDA device).  This file
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
