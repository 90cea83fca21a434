"""The port's sharded trainer (``qrag_tpu_torch.parallel.train``: DP x
TP/EP over processes) and the models' ``partition_spec`` against the
JAX package's, on the CPU over gloo.

``partition_spec`` gives the reference's trees (cross-encoder with
either head, MoE and dense; bi-encoder), and ``shard_params`` cuts the
shard shapes of ``tests/test_parallel.py::
test_param_sharding_actually_shards`` at mp = 4.  On one process of one
slot the sharded step is ``make_trainer``'s bit for bit.  In worlds of 1 x 2,
2 x 1 and 2 x 2 (data x model) worker processes, the sharded step from
parameters carried from JAX follows JAX's one-device ``make_train_step``
with ``optax.adamw`` over three steps: losses within rtol 1e-5 on every
rank, the gathered parameters within ``tests/test_torch_train.py``'s
optimizer tolerance (rtol 1e-5 and 1% of an Adam step a step; the key
bias, whose gradient is f32 noise, within one step a step), for a cls
head with MoE and an interaction head with a dense FFN.  A 30-step
run learns (the last ten steps' mean loss below the first ten's), with
the same losses on every rank, as ``train_demo``'s; a batch that does
not split over "data" raises; ``mesh.shutdown`` forgets the axis
groups; ``train_cli``
launched on two ranks as ``torchrun`` would (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) trains over a data x model mesh and
rank 0 alone writes weights that load in the JAX scorer.
"""

import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from qrag_tpu.models import bi_encoder as jbe
from qrag_tpu.models import cross_encoder as jce
from qrag_tpu.parallel import train as jtrain
from qrag_tpu_torch.config import MeshConfig
from qrag_tpu_torch.models import bi_encoder as tbe
from qrag_tpu_torch.models import cross_encoder as tce
from qrag_tpu_torch.models import weights
from qrag_tpu_torch.parallel import mesh as tmesh
from qrag_tpu_torch.parallel import train as ttrain
from test_torch_multihost import ROOT, WORLD_TIMEOUT_S, run_world

LR = 1e-3
STEPS = 3
GEOMETRIES = {
    "moe_cls": dict(dim=32, n_heads=2, n_layers=1, max_len=32, n_experts=2, head_type="cls"),
    "dense_interaction": dict(dim=32, n_heads=2, n_layers=1, max_len=32, n_experts=0,
                              head_type="interaction"),
}


def _tuples(spec):
    return jax.tree_util.tree_map(tuple, spec, is_leaf=lambda x: isinstance(x, P))


@pytest.mark.parametrize("head", ["cls", "interaction"])
@pytest.mark.parametrize("n_experts", [0, 4])
def test_partition_spec_trees_equal_reference(head, n_experts):
    geometry = dict(dim=64, n_heads=4, n_layers=2, n_experts=n_experts, head_type=head)
    jspec = _tuples(jce.partition_spec(jce.CrossEncoderConfig(**geometry)))
    assert tce.partition_spec(tce.CrossEncoderConfig(**geometry)) == jspec
    jbi = jbe.BiEncoderConfig(tower=jce.CrossEncoderConfig(**geometry))
    tbi = tbe.BiEncoderConfig(tower=tce.CrossEncoderConfig(**geometry))
    assert tbe.partition_spec(tbi) == _tuples(jbe.partition_spec(jbi))


def test_param_shards_at_mp4():
    """The reference's shard shapes at mp = 4 (qkv (64, 48), the MoE's
    w1 (1, 64, 256)); q, k and v split each by heads; every block joins
    back to the whole."""
    cfg = tce.CrossEncoderConfig(dim=64, n_heads=4, n_layers=1, n_experts=4)
    params = tce.init_params(cfg, seed=0)
    # rank 0's slot of a 1 x 4 mesh whose other slots belong to ranks 1-3
    grid = tmesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=4),
                           devices=["cpu"] * 4, ranks=[0, 1, 2, 3])
    local = ttrain.shard_params(params, cfg, grid)
    assert local["layers.0.attn.qkv.w"].shape == (64, 3 * 64 // 4)
    assert local["layers.0.moe.w1"].shape == (1, 64, 256)
    qkv = params["layers.0.attn.qkv.w"]
    np.testing.assert_array_equal(local["layers.0.attn.qkv.w"],
                                  np.concatenate([qkv[:, :16], qkv[:, 64:80], qkv[:, 128:144]], 1))
    specs = ttrain.param_specs(cfg)
    for name, a in params.items():
        blocks = [ttrain._shard(name, a, specs[name], 4, j) for j in range(4)]
        np.testing.assert_array_equal(ttrain._unshard(name, blocks, specs[name]), a)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_world_of_one_step_is_make_trainers(geometry):
    """One process, one slot: the sharded step is ``make_trainer``'s bit
    for bit (deterministic algorithms on: the embedding gathers'
    backward otherwise accumulates in a run-to-run order on the CPU)."""
    cfg = tce.CrossEncoderConfig(**GEOMETRIES[geometry])
    grid = tmesh.make_mesh(MeshConfig(data_parallel=1, model_parallel=1), device="cpu")
    rng = np.random.RandomState(1)
    batches = [ttrain.synthetic_batch(rng, 8, cfg.max_len) for _ in range(2)]
    torch.use_deterministic_algorithms(True)
    try:
        one, _, one_step = ttrain.make_trainer(cfg, seed=3, device="cpu")
        shd, _, shd_step = ttrain.make_sharded_trainer(cfg, grid, seed=3)
        for b in batches:
            assert torch.equal(one_step(*b), shd_step(*b))
    finally:
        torch.use_deterministic_algorithms(False)
    for (name, p), (name2, p2) in zip(one.named_parameters(), shd.named_parameters()):
        assert name == name2 and torch.equal(p, p2), name


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """{case: (params carried to the port, batches, JAX losses, JAX
    parameters after STEPS)} from one-device optax.adamw steps."""
    runs = {}
    for seed, (name, geo) in enumerate(GEOMETRIES.items()):
        jcfg = jce.CrossEncoderConfig(**geo, dtype=jnp.float32)
        tcfg = tce.CrossEncoderConfig(**geo)
        p = jax.jit(lambda key, c=jcfg: jce.init_params(key, c))(jax.random.PRNGKey(seed))
        rng = np.random.RandomState(seed)
        p = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), p)
        start = weights.params_from_jax_tree(p, tcfg)
        opt = optax.adamw(LR)
        step = jax.jit(jce.make_train_step(jcfg, opt))
        batches = [jtrain.synthetic_batch(rng, 8, jcfg.max_len) for _ in range(STEPS)]
        state, losses = opt.init(p), []
        for b in batches:
            p, state, loss = step(p, state, *(jnp.asarray(a) for a in b))
            losses.append(float(loss))
        final = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, p), tcfg)
        runs[name] = (start, batches, losses, final)
    return runs


TRAIN = """
    import json
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.parallel import train

    DP, MP = DP_MP
    grid = mesh.make_mesh(MeshConfig(data_parallel=DP, model_parallel=MP), device="cpu")
    with open(os.path.join(OUT, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, geometry in cases.items():
        cfg = ce.CrossEncoderConfig(**geometry)
        with np.load(os.path.join(OUT, name + ".npz")) as f:
            arrays = dict(f)
        params = {k[2:]: v for k, v in arrays.items() if k.startswith("p.")}
        model, opt, step = train.make_sharded_trainer(cfg, grid, learning_rate=LR, params=params)
        losses = [float(step(*(arrays[f"b{s}_{part}"] for part in ("tokens", "mask", "labels"))))
                  for s in range(STEPS)]
        out[name + "_losses"] = np.asarray(losses)
        full, mu, nu, count = train.gather_train_state(model, opt, cfg)
        assert count == STEPS
        out.update({f"{name}.{k}": v for k, v in full.items()})
    small = ce.CrossEncoderConfig(dim=32, n_heads=2, n_layers=1, max_len=48, n_experts=2)
    _, _, step = train.make_sharded_trainer(small, grid)
    rng = np.random.RandomState(0)
    out["learn"] = np.asarray([float(step(*train.synthetic_batch(rng, 16, 48))) for _ in range(30)])
    out["demo"] = np.asarray(train.train_demo(small, grid, steps=2, batch=16))
    if DP > 1:  # a batch that does not split over "data" raises, before any collective
        try:
            step(*train.synthetic_batch(rng, 2 * DP + 1, 48))
        except ValueError as e:
            assert f"does not split over data={DP}" in str(e), e
        else:
            raise AssertionError("an uneven batch was split over data")
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **out)
    mesh.shutdown()
    from qrag_tpu_torch.parallel import collectives
    assert not collectives._AXES  # the axis groups went with the group
"""


def _assert_close_to_jax(got, want, dim):
    """tests/test_torch_train.py's ``_assert_params``: rtol 1e-5 and 1%
    of an Adam step a step; the key bias (zero gradient in exact
    arithmetic) within one step a step."""
    for name, ref in want.items():
        g = got[name]
        if name.endswith("attn.qkv.b"):
            np.testing.assert_array_less(np.abs(g[dim:2 * dim] - ref[dim:2 * dim]),
                                         2.01 * LR * STEPS)
            g, ref = np.delete(g, np.s_[dim:2 * dim]), np.delete(ref, np.s_[dim:2 * dim])
        np.testing.assert_allclose(g, ref, rtol=1e-5, atol=0.01 * LR * STEPS, err_msg=name)


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 1), (2, 2)])
def test_sharded_steps_match_jax(dp, mp, tmp_path):
    runs = _jax_runs()
    for name, (start, batches, _, _) in runs.items():
        arrays = {f"p.{k}": v for k, v in start.items()}
        for s, b in enumerate(batches):
            arrays.update({f"b{s}_{part}": a for part, a in zip(("tokens", "mask", "labels"), b)})
        np.savez(tmp_path / f"{name}.npz", **arrays)
    (tmp_path / "cases.json").write_text(json.dumps(GEOMETRIES))
    body = TRAIN.replace("DP_MP", repr((dp, mp))).replace("LR", repr(LR)).replace(
        "STEPS", repr(STEPS))
    run_world(tmp_path, body, world=dp * mp)
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(dp * mp)]
    for name, (_, _, losses, final) in runs.items():
        for r in range(dp * mp):
            np.testing.assert_allclose(res[r][name + "_losses"], losses, rtol=1e-5,
                                       err_msg=f"{name} rank {r}")
            got = {k[len(name) + 1:]: v for k, v in res[r].items() if k.startswith(name + ".")}
            assert sorted(got) == sorted(final)
            _assert_close_to_jax(got, final, GEOMETRIES[name]["dim"])
    # 30 steps of the synthetic task learn: the last ten steps' mean loss
    # below the first ten's; every rank reports the same losses
    learn = res[0]["learn"]
    assert np.isfinite(learn).all() and learn[-10:].mean() < learn[:10].mean(), learn
    for r in range(dp * mp):
        np.testing.assert_array_equal(res[r]["learn"], learn)
        np.testing.assert_array_equal(res[r]["demo"], res[0]["demo"])


def _launch_cli(args):
    """``train_cli`` on two CPU ranks, launched as ``torchrun`` would."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [
        subprocess.Popen([sys.executable, "-m", "qrag_tpu_torch.models.train_cli", *args],
                         env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-3000:]}"
    return outs


def test_train_cli_two_ranks_rank0_writes(tmp_path):
    out = str(tmp_path / "model")
    args = ["--steps", "4", "--batch", "8", "--dim", "32", "--heads", "2", "--layers", "1",
            "--experts", "2", "--max-len", "48", "--out", out, "--device", "cpu"]
    outs = _launch_cli(args)
    assert "mesh: data=1 x model=2 over 2 processes" in outs[0]
    assert "trained to step 4" in outs[0] and "trained to step" not in outs[1]
    with open(os.path.join(out + ".ckpt", "config.json")) as f:
        assert json.load(f)["step"] == 4
    state = dict(np.load(os.path.join(out + ".ckpt", "state.npz")))
    assert int(state["count"]) == 4 and state["p3"].shape == (32, 1)  # head.w, whole
    jcfg = jce.CrossEncoderConfig(dim=32, n_heads=2, n_layers=1, n_experts=2, max_len=48,
                                  dtype=jnp.float32)
    js = jce.CrossEncoderScorer(jcfg)
    js.load(out)
    ts = tce.CrossEncoderScorer(tce._load_scorer_config(out), device="cpu")
    ts.load(out)
    docs = ["sponsor ads by acme", "weather report", ""]
    np.testing.assert_allclose(ts.score("sponsor ads", docs), js.score("sponsor ads", docs),
                               atol=1e-5)
    assert ts.model.layers[0].moe.w1.shape == (2, 32, 128)  # both experts gathered
    # resume on two ranks: the gathered state shards back and steps on
    outs = _launch_cli(args[:1] + ["2"] + args[2:] + ["--resume", out + ".ckpt"])
    assert f"resumed from {out}.ckpt at step 4" in outs[0] and "trained to step 6" in outs[0]
    resumed = np.load(os.path.join(out + ".ckpt", "state.npz"))
    assert int(resumed["count"]) == 6
    assert not np.array_equal(resumed["mu3"], state["mu3"])
