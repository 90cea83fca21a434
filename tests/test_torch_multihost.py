"""The port's sharded index across two OS processes (PyTorch port of
``tests/test_multihost.py``), on the CPU over gloo.

Each world is two worker processes that import only ``qrag_tpu_torch``,
join a group through a file store under ``tmp_path``
(``distributed_init("file://...")``), read the inputs the test wrote
there, build the same sharded index on a
1 x 2 mesh (one slot a rank) and write their results to ``.npz`` files.
The pytest process holds them to JAX's ``ShardedFlatIndex`` on a 1 x 2
mesh of its virtual CPU devices (exact mode), to the numpy stable
argsort oracle with planted ties, and to the port's own index on a 1 x 2
mesh of slots in one process: indices equal, tie order included, in
exact and bounded mode at k = 10 and 100, and on a 2 x 1 mesh (a data
row a rank, each row's result passed to the other); allgather equal to
ring bit for bit; the counters summed over the ranks; the cross-rank
row gather equal to the rows; and the collectives' gradients (Megatron's f and g,
the token gather) as their definitions give.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from qrag_tpu.config import MeshConfig as JMeshConfig
from qrag_tpu.parallel import ShardedFlatIndex as JSharded
from qrag_tpu.parallel import make_mesh as j_make_mesh
from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.parallel import mesh as tmesh
from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex as TSharded

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 240

HEADER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from qrag_tpu_torch.parallel import mesh
    RANK, WORLD, STORE, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    mesh.distributed_init("file://" + STORE, WORLD, RANK, device="cpu")
    """
)


def run_world(tmp_path, body: str, world: int = 2, expect_rc=None):
    """Start ``world`` workers of HEADER + ``body`` + a clean leave of
    the group (argv: rank, world, store file, output directory); wait
    for each within the time limit and return their outputs.  Every worker must exit 0 unless
    ``expect_rc`` gives its code by rank."""
    script = tmp_path / "worker.py"
    script.write_text(HEADER + textwrap.dedent(body) + "mesh.shutdown()\n")
    store = tmp_path / "store"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(store), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT,
        )
        for r in range(world)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            pytest.fail(f"worker hung:\n{out[-3000:]}")
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        want = 0 if expect_rc is None else expect_rc[r]
        assert p.returncode == want, f"rank {r} exited {p.returncode}:\n{out[-3000:]}"
    return outs


def corpus(n=8192, d=32, seed=0):
    """Unit-scale rows with planted exact ties: row 9 copies row 3 (one
    shard), row 5000 copies row 100 and row 4096 copies row 4095 (across
    the shard boundary at 4096); queries sit near the copied rows."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    for src, dst in ((3, 9), (100, 5000), (4095, 4096)):
        x[dst] = x[src]
    q = np.concatenate([x[[3, 100, 4095, 7]] + 1e-3, rng.randn(12, d).astype(np.float32)])
    return x, q


SEARCH = """
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.parallel import collectives
    from qrag_tpu_torch.parallel.sharded_index import ShardedFlatIndex

    MODE = sys.argv[5]
    with np.load(os.path.join(OUT, "inputs.npz")) as f:
        x, q = f["x"], f["q"]
    grid = mesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device="cpu")
    assert mesh.process_count() == 2 and grid.rank(0, 1) == 1 and grid.spans_processes
    assert grid.local_slots() == [(0, RANK)]
    out = {}
    for merge in ("allgather", "ring"):
        idx = ShardedFlatIndex(x, grid, metric="l2", topk_mode=MODE, merge=merge)
        for k in (10, 100):
            res = idx.search(q, k=k)
            out[f"{merge}_{k}_idx"], out[f"{merge}_{k}_val"] = res.indices, res.scores
        assert idx._shards[0][1 - RANK] is None  # only this rank's rows uploaded
        out[f"{merge}_counters"] = np.asarray([idx.fallback_rows, idx.bounded_escalations])
    rows = np.asarray([[0, 4095, 4096, 8191], [9, 5000, 1, 2]])
    out["gathered"] = idx.gather_rows_device(torch.from_numpy(rows)).numpy()
    # a 2 x 1 mesh: each rank holds one data row (half the queries) and
    # the whole corpus; each row's result reaches the other rank
    rows_mesh = mesh.make_mesh(MeshConfig(data_parallel=2, model_parallel=1), device="cpu")
    for merge in ("allgather", "ring"):
        by_row = ShardedFlatIndex(x, rows_mesh, metric="l2", topk_mode=MODE, merge=merge)
        out[f"rows_{merge}_idx"] = by_row.search(q, k=10).indices
    out["rows_gathered"] = by_row.gather_rows_device(torch.from_numpy(rows)).numpy()

    # the collectives' gradients on the model axis of this 1 x 2 mesh
    data, model = collectives.axis_groups(grid)
    assert (data.size, model.size, model.index) == (1, 2, RANK)
    w = torch.from_numpy(np.random.RandomState(5).randn(1, 6, 4).astype(np.float32))
    xr = torch.full((1, 3, 4), float(RANK + 1), requires_grad=True)
    y = collectives.gather_tokens(xr, model, dim=1)
    (y * w).sum().backward()
    out["gathered_tokens"], out["token_grad"] = y.detach().numpy(), xr.grad.numpy()
    xf = torch.full((2, 4), float(RANK + 1), requires_grad=True)
    (collectives.copy_to_model(xf, model) * (RANK + 1)).sum().backward()
    out["f_grad"] = xf.grad.numpy()
    xg = torch.full((2, 4), float(RANK + 1), requires_grad=True)
    z = collectives.reduce_from_model(xg, model)
    (z * (RANK + 1)).sum().backward()
    out["g_out"], out["g_grad"] = z.detach().numpy(), xg.grad.numpy()
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **out)
    print("RANK_OK", RANK, flush=True)
"""


@pytest.mark.parametrize("mode", ["exact", "bounded"])
def test_two_rank_sharded_search(mode, tmp_path):
    x, q = corpus()
    np.savez(tmp_path / "inputs.npz", x=x, q=q)
    run_world(tmp_path, SEARCH.replace("sys.argv[5]", repr(mode)))
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    jmesh = j_make_mesh(JMeshConfig(data_parallel=1, model_parallel=2), devices=jax.devices()[:2])
    one = TSharded(x, tmesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=2), device="cpu"),
                   metric="l2", topk_mode=mode)
    for k in (10, 100):
        oracle = np.argsort(d2, axis=1, kind="stable")[:, :k]
        jres = JSharded(x, jmesh, metric="l2", topk_mode="exact").search(q, k=k)
        np.testing.assert_array_equal(jres.indices, oracle)
        base = one.search(q, k=k)
        for r in range(2):
            for merge in ("allgather", "ring"):
                got = res[r][f"{merge}_{k}_idx"]
                np.testing.assert_array_equal(got, oracle, err_msg=f"rank {r} {merge} k={k}")
                np.testing.assert_allclose(res[r][f"{merge}_{k}_val"], jres.scores,
                                           rtol=1e-5, atol=1e-4)
            # allgather equal to ring bit for bit; both ranks the same
            for key in ("idx", "val"):
                np.testing.assert_array_equal(res[r][f"allgather_{k}_{key}"],
                                              res[r][f"ring_{k}_{key}"])
                np.testing.assert_array_equal(res[r][f"allgather_{k}_{key}"],
                                              res[0][f"allgather_{k}_{key}"])
            np.testing.assert_array_equal(res[r][f"allgather_{k}_val"], base.scores)
    # the counters: every rank holds the sum over both shards, which is
    # what one process driving both slots counts
    want = np.asarray([one.fallback_rows, one.bounded_escalations])
    for r in range(2):
        for merge in ("allgather", "ring"):
            np.testing.assert_array_equal(res[r][f"{merge}_counters"], want)
        rows = np.asarray([[0, 4095, 4096, 8191], [9, 5000, 1, 2]])
        np.testing.assert_array_equal(res[r]["gathered"], x[rows])
        np.testing.assert_array_equal(res[r]["rows_gathered"], x[rows])
        oracle = np.argsort(d2, axis=1, kind="stable")[:, :10]
        for merge in ("allgather", "ring"):
            np.testing.assert_array_equal(res[r][f"rows_{merge}_idx"], oracle)
    # collectives: the token gather concatenates rank 0's block, then
    # rank 1's; its backward keeps this rank's block of the gradient
    # summed over both ranks; f sums the gradient, g the forward
    w = np.random.RandomState(5).randn(1, 6, 4).astype(np.float32)
    tokens = np.concatenate([np.full((1, 3, 4), 1.0), np.full((1, 3, 4), 2.0)], axis=1)
    for r in range(2):
        np.testing.assert_array_equal(res[r]["gathered_tokens"], tokens)
        np.testing.assert_allclose(res[r]["token_grad"], 2 * w[:, 3 * r:3 * r + 3], rtol=1e-6)
        np.testing.assert_array_equal(res[r]["f_grad"], np.full((2, 4), 3.0))
        np.testing.assert_array_equal(res[r]["g_out"], np.full((2, 4), 3.0))
        np.testing.assert_array_equal(res[r]["g_grad"], np.full((2, 4), r + 1.0))


def test_distributed_init_without_address_is_noop():
    """One process: no group, rank 0 of 1, meshes of this process's
    slots only — as ``jax.distributed`` without an address."""
    tmesh.distributed_init()
    tmesh.distributed_init(None, 2, 1)
    assert (tmesh.process_index(), tmesh.process_count(), tmesh.local_device()) == (0, 1, None)
    grid = tmesh.make_mesh(MeshConfig(data_parallel=2, model_parallel=2), device="cpu")
    assert not grid.spans_processes and grid.local_slots() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert not torch.distributed.is_initialized()
