"""The port's sequence-parallel forward (``qrag_tpu_torch.models.
sequence_parallel``) across processes against the JAX package's
(``tests/test_sequence_parallel.py``'s configurations), on the CPU over
gloo.

The reference's configurations — ``CFG`` (dim 64, 4 heads, 2 layers,
max_len 128, 2 experts) and its dense-FFN one (dim 32, 2 heads, 1
layer, max_len 64) — with JAX's initial parameters carried into the
port run in worlds of 1 x 2 and 2 x 2 (data x model) worker processes.
Every rank's logits must lie within atol 1e-4 (the reference's own
tolerance) of JAX's dense ``forward`` and of its
``forward_sequence_parallel`` on a mesh of the same layout, for
``forward_sequence_parallel`` and ``score_long_documents``; a sequence
length that does not split over the model axis raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qrag_tpu.config import MeshConfig as JMeshConfig
from qrag_tpu.models import cross_encoder as jce
from qrag_tpu.models import sequence_parallel as jsp
from qrag_tpu.parallel import make_mesh as j_make_mesh
from qrag_tpu_torch.models import cross_encoder as tce
from qrag_tpu_torch.models import weights
from test_torch_multihost import run_world

GEOMETRIES = {
    "moe": dict(dim=64, n_heads=4, n_layers=2, max_len=128, n_experts=2),
    "dense": dict(dim=32, n_heads=2, n_layers=1, max_len=64, n_experts=0),
}

SP = """
    import json
    from qrag_tpu_torch.config import MeshConfig
    from qrag_tpu_torch.models import cross_encoder as ce
    from qrag_tpu_torch.models.sequence_parallel import (
        forward_sequence_parallel, score_long_documents)

    DP, MP = DP_MP
    grid = mesh.make_mesh(MeshConfig(data_parallel=DP, model_parallel=MP), device="cpu")
    with open(os.path.join(OUT, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, case in cases.items():
        cfg = ce.CrossEncoderConfig(**case["geometry"])
        with np.load(os.path.join(OUT, name + ".npz")) as f:
            arrays = dict(f)
        params = {k[2:]: v for k, v in arrays.items() if k.startswith("p.")}
        if case["wrapper"]:
            logits = score_long_documents(params, cfg, grid, arrays["tokens"], arrays["mask"])
        else:
            logits = forward_sequence_parallel(params, arrays["tokens"], arrays["mask"], cfg, grid)
        out[name] = logits.detach().numpy()
    try:
        forward_sequence_parallel(params, arrays["tokens"][:, :-1], arrays["mask"][:, :-1], cfg, grid)
    except ValueError as e:
        assert "does not split over the model axis" in str(e), e
        out["raised"] = np.asarray(1)
    np.savez(os.path.join(OUT, f"rank{RANK}.npz"), **out)
"""


def _cases():
    """{name: (geometry, JAX params, tokens, mask, through the wrapper)}."""
    cases = {}
    for name, (geo, seed, query, docs, wrapper) in {
        "moe": ("moe", 0, "what is discussed", ["text " * 40, "other content " * 20], False),
        "dense": ("dense", 1, "q", ["dense ffn path", "x"], False),
        "long": ("moe", 2, "query", ["long transcript " * 100 for _ in range(4)], True),
    }.items():
        jcfg = jce.CrossEncoderConfig(**GEOMETRIES[geo], dtype=jnp.float32)
        params = jax.jit(lambda key, c=jcfg: jce.init_params(key, c))(jax.random.PRNGKey(seed))
        tokens, mask = jce.tokenize_batch(query, docs, jcfg.max_len)
        cases[name] = (geo, jcfg, params, tokens, mask, wrapper)
    return cases


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_sequence_parallel_matches_jax(dp, mp, tmp_path):
    cases = _cases()
    meta = {}
    for name, (geo, jcfg, params, tokens, mask, wrapper) in cases.items():
        tcfg = tce.CrossEncoderConfig(**GEOMETRIES[geo])
        flat = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, params), tcfg)
        np.savez(tmp_path / f"{name}.npz", tokens=tokens, mask=mask,
                 **{f"p.{k}": v for k, v in flat.items()})
        meta[name] = {"geometry": GEOMETRIES[geo], "wrapper": wrapper}
    (tmp_path / "cases.json").write_text(json.dumps(meta))
    run_world(tmp_path, SP.replace("DP_MP", repr((dp, mp))), world=dp * mp)
    jmesh = j_make_mesh(JMeshConfig(data_parallel=dp, model_parallel=mp),
                        devices=jax.devices()[:dp * mp])
    for name, (geo, jcfg, params, tokens, mask, wrapper) in cases.items():
        t, m = jnp.asarray(tokens), jnp.asarray(mask)
        # jit: JAX's eager shard_map takes ~20 s a call on the CPU
        dense = np.asarray(jax.jit(lambda p, a, b: jce.forward(p, a, b, jcfg))(params, t, m))
        jsp_out = np.asarray(jax.jit(
            lambda p, a, b: jsp.forward_sequence_parallel(p, a, b, jcfg, jmesh))(params, t, m))
        np.testing.assert_allclose(jsp_out, dense, atol=1e-4)
        for r in range(dp * mp):
            got = np.load(tmp_path / f"rank{r}.npz")
            assert got[name].shape == (len(tokens),)
            np.testing.assert_allclose(got[name], dense, atol=1e-4, err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(got[name], jsp_out, atol=1e-4, err_msg=f"{name} rank {r}")
            assert int(got["raised"]) == 1
