"""The port's elastic index across two OS processes (PyTorch port of
``tests/test_multihost_elastic.py``), on the CPU over gloo.

Rank 1 leaves after a healthy cross-process search (``os._exit``, no
shutdown of the group); the survivor walks the ladder explicitly: the
group probe fails, localisation names exactly rank 1's slot (its
heartbeat stopped; the survivor's own slot answers), the eviction
re-shards the whole corpus over the survivor's own slot from the host
master, and the reduced index answers exactly — against the numpy
stable-argsort oracle, checked in the pytest process from the
survivor's ``.npz``.  With two slots a rank, localisation reads rank
1's heartbeat once for both its slots (one wait, not one a slot).
"""

import numpy as np

from test_torch_multihost import corpus, run_world

ELASTIC = """
    import time
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.parallel.elastic import ElasticShardedIndex
    from qrag_tpu_torch.parallel.mesh import HEARTBEAT_WAIT_S

    S = SLOTS  # slots a rank
    with np.load(os.path.join(OUT, "inputs.npz")) as f:
        x, q = f["x"], f["q"]
    idx = ElasticShardedIndex(x, probe_timeout_s=20.0, device="cpu", topk_mode="exact",
                              mesh_config=MeshConfig(data_parallel=1, model_parallel=2 * S))
    assert [(s.id, s.rank) for s in idx.devices] == [(i, i // S) for i in range(2 * S)], idx.devices
    assert idx.rebuilds == 0 and idx.mesh.spans_processes
    res = idx.search(q, k=10)
    np.save(os.path.join(OUT, f"phase1_rank{RANK}.npy"), res.indices)
    print("ELASTIC_PHASE1_OK", RANK, flush=True)
    if RANK == 1:
        time.sleep(1.0)
        os._exit(0)  # leave without shutting the group down

    time.sleep(3.0)
    t0 = time.monotonic()
    assert not idx.probe(), "the group probe must fail with a dead peer"
    t1 = time.monotonic()
    bad = idx.localize_failures()
    localize_s = time.monotonic() - t1
    assert [(s.id, s.rank) for s in bad] == [(i, 1) for i in range(S, 2 * S)], bad
    # rank 1's heartbeat is read once for all its slots: one wait
    assert localize_s < 1.9 * HEARTBEAT_WAIT_S, localize_s
    idx.remove_devices(bad)
    assert idx.rebuilds == 1 and [(s.id, s.rank) for s in idx.devices] == [(i, 0) for i in range(S)]
    assert not idx.mesh.spans_processes and idx.index.ntotal == x.shape[0]
    res = idx.search(q, k=10)
    np.save(os.path.join(OUT, "phase2.npy"), res.indices)
    print("ELASTIC_PHASE2_OK", RANK, "recovery_s", time.monotonic() - t0, flush=True)
    os._exit(0)  # skip the group's teardown: its peer is gone
"""


def _elastic_world(tmp_path, slots):
    x, q = corpus()
    np.savez(tmp_path / "inputs.npz", x=x, q=q)
    outs = run_world(tmp_path, ELASTIC.replace("SLOTS", str(slots)))
    assert "ELASTIC_PHASE1_OK 1" in outs[1] and "ELASTIC_PHASE2_OK" not in outs[1]
    assert "ELASTIC_PHASE1_OK 0" in outs[0] and "ELASTIC_PHASE2_OK 0" in outs[0]
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    oracle = np.argsort(d2, axis=1, kind="stable")[:, :10]
    for name in ("phase1_rank0.npy", "phase1_rank1.npy", "phase2.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / name), oracle, err_msg=name)


def test_two_rank_elastic_reshards_after_rank_death(tmp_path):
    _elastic_world(tmp_path, slots=1)


def test_two_slots_a_rank_localized_over_one_heartbeat_wait(tmp_path):
    """Each rank holds two slots: the survivor names both of rank 1's
    slots over one heartbeat wait, and re-shards over its own two."""
    _elastic_world(tmp_path, slots=2)
