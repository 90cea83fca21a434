"""The packed window scan's dispatch (``ops/cuda/fused_scan._config``):
which arm of the Hopper kernel a call launches, checked on the CPU,
where no kernel runs.  The kernels themselves are held against their
twins on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qrag_tpu_torch.ops import bounded_topk as tbt
from qrag_tpu_torch.ops import window_scan as tws
from qrag_tpu_torch.ops.cuda import fused_scan as fs

SMS = 132
CUT = fs.WIDE_MIN_B
CSRC = Path(fs.__file__).resolve().parents[2] / "csrc" / "fused_scan.cu"


DOMAIN_PLANES = [(False, 1), (False, 2), (False, 3), (True, 1), (True, 2)]


def _wide_fits(d, int8):
    return d % (128 if int8 else 64) == 0


@pytest.mark.parametrize("int8,planes", DOMAIN_PLANES)
@pytest.mark.parametrize("d", [16, 64, 128, 768, 8192])
@pytest.mark.parametrize("n", [128, 4096, 4224, 1_250_176])
def test_plan_picks_an_arm_for_every_shape(n, d, int8, planes):
    """Every shape the general arm took before the arms (B >= 1, N a
    multiple of 128, d a multiple of 16) is taken by some arm: wide from
    the cut on where d is a whole number of 128-byte slabs, general
    otherwise.  ``planes`` does not enter the plan."""
    cut = CUT[int8]
    for b in (1, 7, 16, 17, cut - 1, cut, 64, 128, 129, 256, 257, 1000, 1024, 5000):
        cfg = fs._config(b, n, d, int8, SMS)
        want = "wide" if b >= cut and _wide_fits(d, int8) else "general"
        assert cfg.arm == want, (b, n, d, int8)
        nw = n // 128
        if cfg.arm == "general":
            assert cfg == fs.Config("general", 1, nw * -(-b // (64 if b > 16 else 16)))
            continue
        qtiles = -(-b // 128)
        assert cfg.cluster == (2 if qtiles >= 2 else 1)
        items = -(-nw // 2) * -(-qtiles // cfg.cluster)
        # persistent blocks: whole clusters, never more than the SMs or the work
        assert cfg.grid % cfg.cluster == 0 and cfg.cluster <= cfg.grid <= SMS
        assert cfg.grid == cfg.cluster * min(items, SMS // cfg.cluster)


def test_cut_leaves_the_single_query_launch_alone():
    """B = 1 stays on the general arm (its 16-query tile), and the
    served batch of 64 and the bulk batch of 1024 go to the wide arm,
    whatever the measured cut."""
    for int8 in (False, True):
        assert CUT[int8] >= 2
        assert fs._config(1, 1_250_176, 768, int8, SMS) == fs.Config("general", 1, 9767)
        assert fs._config(64, 1_250_176, 768, int8, SMS) == fs.Config("wide", 1, SMS)
        assert fs._config(1024, 1_250_176, 768, int8, SMS) == fs.Config("wide", 2, SMS)


@pytest.mark.parametrize("b", [1, 7, 64, 1000])
def test_forced_arm(b):
    """Either arm can be forced on a shape both take; the wide arm takes
    a ragged query tile and any B."""
    for int8, d in ((False, 64), (False, 768), (True, 128), (True, 768)):
        assert fs._config(b, 4224, d, int8, SMS, arm="general").arm == "general"
        wide = fs._config(b, 4224, d, int8, SMS, arm="wide")
        assert wide.arm == "wide" and wide.grid >= wide.cluster


@pytest.mark.parametrize("int8,d", [(False, 16), (False, 96), (True, 16), (True, 64), (True, 192)])
def test_forced_arm_that_does_not_fit_raises(int8, d):
    with pytest.raises(ValueError, match="wide arm does not take"):
        fs._config(1024, 4096, d, int8, SMS, arm="wide")
    assert fs._config(1024, 4096, d, int8, SMS).arm == "general"
    with pytest.raises(ValueError, match="does not take"):
        fs._config(1024, 4096, 768, int8, SMS, arm="wgmma")


def test_config_matches_the_kernel_source():
    """The numbers ``_config`` plans with are those of ``fused_scan.cu``."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kWideQ") == fs.WIDE_QT and const("kWideRows") == fs.WIDE_ROWS
    assert const("kSlabBytes") == fs.SLAB[True] == 2 * fs.SLAB[False]
    assert const("kWindow") == tws.WINDOW
    for name, arm in fs.ARM_IDS.items():
        assert name in ("general", "wide") and arm in (0, 1)
    assert "if (arm == 1)" in src  # the wide arm's number in both entry points
    for entry in ("qrag_window_scan_bf16", "qrag_window_scan_int8"):
        assert f'extern "C" int {entry}(' in src


@pytest.mark.parametrize("int8,planes", DOMAIN_PLANES)
def test_cpu_tensor_runs_the_twin_and_counts_no_launch(int8, planes):
    rng = np.random.default_rng(planes)
    b, n, d = 40, 512, 64
    if int8:
        q = torch.from_numpy(rng.integers(-127, 128, (b, d)).astype(np.int8))
        x = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    else:
        q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).bfloat16()
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).bfloat16()
    lr = tws.make_lane_rank(n, torch.device("cpu"))
    fs.reset_launches()
    got = fs.packed_window_scan(q, x, lr, planes=planes)
    if planes == 1:
        want = (tws.packed_window_scan(q, x, lr),)
    elif int8:
        want = tbt.packed_window_scan_top2_int(q, x, lr)
    else:
        want = (tbt.packed_window_scan_top3 if planes == 3 else tbt.packed_window_scan_top2)(
            q, x, lr)
    assert len(got) == planes and all(torch.equal(g, w) for g, w in zip(got, want))
    assert not any(fs.launches.values()) and not any(fs.arm_launches.values())
    # the CUDA wrapper raises on CPU tensors, forced arm or not
    for arm in (None, "general", "wide"):
        with pytest.raises(ValueError, match="CUDA"):
            fs.packed_window_scan_cuda(q, x, planes=planes, arm=arm)
    assert not any(fs.arm_launches.values())
