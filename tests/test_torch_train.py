"""The port's training (``qrag_tpu_torch.models`` losses and train steps,
``parallel/train.py``, ``models/checkpoint.py``, ``models/train_cli.py``)
against the JAX package's, on the CPU in f32.

One set of JAX parameters carried into both packages and one numpy
batch give: losses within rtol 1e-5 and every gradient leaf within rtol
1e-4, atol 1e-6 (pointwise BCE on both heads with MoE and dense FFN,
InfoNCE, the in-batch listwise loss with and without the distill term,
distillation's MSE; atol 1e-5 of the leaf's largest entry where that
is larger, the f32 error of a cancelling sum); ``remat`` changes
neither.  Three updates of the port's AdamW / Adam from the same
gradients match ``optax.adamw`` / ``optax.adam`` within rtol 1e-5;
three train steps match within that and 1% of an Adam step (entries
whose gradient is f32 noise), and optax's state carried after two steps
gives its third.  The
synthetic and JSONL batches are byte-equal to JAX's, the checkpoint
round trip is bit-equal, the CLI trains, resumes and reads JSONL, and
its weights load in the JAX scorer.  bf16 activations stay within
``BF16_STEP_LOSS_RTOL`` / ``BF16_GRAD_COSINE_FLOOR`` of one f32 step at
the shipped recipe's width (the bounds ``chip_smoke.py`` holds the card
to).
"""

import functools
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qrag_tpu.models import bi_encoder as jbe
from qrag_tpu.models import cross_encoder as jce
from qrag_tpu.models import train_cli as jcli
from qrag_tpu.parallel import train as jtrain
from qrag_tpu_torch.models import bi_encoder as tbe
from qrag_tpu_torch.models import checkpoint
from qrag_tpu_torch.models import cross_encoder as tce
from qrag_tpu_torch.models import distill as tdistill
from qrag_tpu_torch.models import recall_eval as trecall
from qrag_tpu_torch.models import rerank_eval as trerank
from qrag_tpu_torch.models import train_cli as tcli
from qrag_tpu_torch.models import weights
from qrag_tpu_torch.parallel import train as ttrain
from qrag_tpu_torch.pipeline import corpus_gen

CPU = torch.device("cpu")
QUERIES = ["what about the vaccine", "", "ünïcode ✓ sponsor"]
DOCS = ["doc a about vaccines", "", "héllo wörld ✓ " * 6, "x" * 60, "sponsor deal " * 9]


def _cfgs(head="cls", n_experts=2, max_len=48, dim=32, heads=4, layers=2):
    geometry = dict(dim=dim, n_heads=heads, n_layers=layers, max_len=max_len,
                    n_experts=n_experts, head_type=head)
    return (jce.CrossEncoderConfig(**geometry, dtype=jnp.float32),
            tce.CrossEncoderConfig(**geometry))


def _bi_cfgs(n_experts=2):
    tower = dict(dim=32, n_heads=4, n_layers=2, max_len=40, n_experts=n_experts)
    return (jbe.BiEncoderConfig(tower=jce.CrossEncoderConfig(**tower, dtype=jnp.float32),
                                out_dim=16),
            tbe.BiEncoderConfig(tower=tce.CrossEncoderConfig(**tower), out_dim=16))


def _carried(init, jcfg, tcfg, seed, jitter=0.05):
    """JAX initial parameters with every leaf moved off its init value
    (closed gates and zero biases take part), and the same as
    {dotted name: array} for the port."""
    p = init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    p = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + jitter * rng.standard_normal(np.shape(a)).astype(np.float32), p
    )
    return p, weights.params_from_jax_tree(p, tcfg)


def _module(cls, tcfg, params):
    return tce.trainable(tce.load_module(cls(tcfg, pos_rows=params["pos_emb"].shape[0]), params),
                         CPU)


def _assert_grads(module, jax_grads, tcfg):
    want = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, jax_grads), tcfg)
    got = {name: p.grad.numpy() for name, p in module.named_parameters()}
    assert sorted(got) == sorted(want)
    for name in weights.param_paths(tcfg):
        # f32 sums in another order: an entry that cancels carries the
        # error of its leaf's largest terms (InfoNCE at temperature 20:
        # 1.7e-6 where the leaf reaches 0.6)
        atol = max(1e-6, 1e-5 * float(np.abs(want[name]).max()))
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=atol, err_msg=name)


def _pair_batch(max_len):
    toks, masks = [], []
    for q in QUERIES:
        t, m = jce.tokenize_batch(q, DOCS, max_len)
        toks.append(t)
        masks.append(m)
    return np.concatenate(toks), np.concatenate(masks)


def _value_and_grad(loss, params, *args):
    loss_val, grads = jax.jit(jax.value_and_grad(loss))(params, *(jnp.asarray(a) for a in args))
    return float(loss_val), grads


# ------------------------------------------------------- losses and gradients


@pytest.mark.parametrize("head,n_experts", [("cls", 2), ("cls", 0), ("interaction", 2),
                                            ("interaction", 0)])
def test_bce_loss_and_grads_match_jax(head, n_experts):
    jcfg, tcfg = _cfgs(head, n_experts)
    jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=3)
    toks, mask = _pair_batch(jcfg.max_len)
    labels = (np.arange(len(toks)) % 3 == 0).astype(np.float32)
    want, grads = _value_and_grad(functools.partial(jce.bce_loss, cfg=jcfg), jp, toks, mask, labels)
    model = _module(tce.CrossEncoder, tcfg, tp)
    loss = tce.bce_loss(model, *tce.device_batch(CPU, toks, mask, labels), torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    _assert_grads(model, grads, tcfg)


@pytest.mark.parametrize("kind", ["cross", "bi"])
def test_remat_changes_neither_loss_nor_grads(kind):
    """``remat`` recomputes the "cls" path's blocks (and the
    bi-encoder's) in the backward pass: the same loss and gradients,
    also against JAX's ``jax.checkpoint`` run."""
    if kind == "cross":
        jcfg, tcfg = _cfgs("cls", 2)
        jcfg.remat = True
        jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=5)
        toks, mask = _pair_batch(jcfg.max_len)
        labels = (np.arange(len(toks)) % 2).astype(np.float32)
        want, jgrads = _value_and_grad(functools.partial(jce.bce_loss, cfg=jcfg), jp, toks,
                                       mask, labels)
        batch = tce.device_batch(CPU, toks, mask, labels)

        def run(remat):
            model = _module(tce.CrossEncoder, tcfg, tp)
            loss = tce.bce_loss(model, *batch, torch.float32, remat=remat)
            loss.backward()
            return model, float(loss.detach())
    else:
        jcfg, tcfg = _bi_cfgs()
        jcfg.tower.remat = True
        jp, tp = _carried(jbe.init_params, jcfg, tcfg, seed=5)
        qt, qm = jbe.tokenize_texts(QUERIES + DOCS[:3], 40)
        dt, dm = jbe.tokenize_texts(DOCS + ["extra"], 40)
        want, jgrads = _value_and_grad(functools.partial(jbe.info_nce_loss, cfg=jcfg), jp, qt,
                                       qm, dt, dm)
        batch = (*tce.device_batch(CPU, qt, qm), *tce.device_batch(CPU, dt, dm))

        def run(remat):
            model = _module(tbe.BiEncoder, tcfg, tp)
            loss = tbe.info_nce_loss(model, *batch, torch.float32, remat=remat)
            loss.backward()
            return model, float(loss.detach())
    (plain, loss0), (remat, loss1) = run(False), run(True)
    assert loss0 == loss1
    np.testing.assert_allclose(loss1, want, rtol=1e-5)
    for (name, a), (_, b) in zip(plain.named_parameters(), remat.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=0, msg=name)
    _assert_grads(remat, jgrads, tcfg)


@pytest.mark.parametrize("n_experts", [2, 0])
def test_info_nce_loss_and_grads_match_jax(n_experts):
    jcfg, tcfg = _bi_cfgs(n_experts)
    jp, tp = _carried(jbe.init_params, jcfg, tcfg, seed=7)
    qt, qm, dt, dm = jbe.synthetic_pairs(np.random.RandomState(1), 6, 40)
    want, grads = _value_and_grad(functools.partial(jbe.info_nce_loss, cfg=jcfg), jp, qt, qm,
                                  dt, dm)
    model = _module(tbe.BiEncoder, tcfg, tp)
    loss = tbe.info_nce_loss(model, *tce.device_batch(CPU, qt, qm),
                             *tce.device_batch(CPU, dt, dm), torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    _assert_grads(model, grads, tcfg)


def _jax_inbatch_loss(p, tokens, mask, teacher, cfg, distill_w):
    """The reference's in-batch listwise loss (``rerank_eval.py``'s
    ``inbatch_loss``, a closure there)."""
    qn, m, tl = tokens.shape
    logits = jce.forward(p, tokens.reshape(qn * m, tl), mask.reshape(qn * m, tl), cfg)
    logits = logits.reshape(qn, m)
    lab = jnp.arange(qn)
    loss = -jnp.mean(jax.nn.log_softmax(logits, axis=1)[lab, lab])
    if distill_w > 0.0:
        loss = loss + distill_w * jnp.mean((jax.nn.sigmoid(logits) - teacher) ** 2)
    return loss


@pytest.mark.parametrize("distill_w", [0.0, 1.0])
def test_listwise_loss_and_grads_match_jax(distill_w):
    jcfg, tcfg = _cfgs("interaction", 2, max_len=64)
    jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=11)
    chunks = corpus_gen.generate_corpus(4, 4, seed=0)
    rng = np.random.RandomState(0)
    qs = [corpus_gen.make_query(c, rng) for c in chunks[:4]]
    toks, masks = trerank.pair_grid(qs, [c.text for c in chunks[:4]], jcfg.max_len)
    teacher = rng.uniform(size=(4, 4)).astype(np.float32)
    want, grads = _value_and_grad(
        functools.partial(_jax_inbatch_loss, cfg=jcfg, distill_w=distill_w), jp, toks, masks,
        teacher,
    )
    model = _module(tce.CrossEncoder, tcfg, tp)
    loss = trerank.listwise_loss(model, *tce.device_batch(CPU, toks, masks, teacher),
                                 torch.float32, distill_w)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    _assert_grads(model, grads, tcfg)


def test_distill_mse_and_grads_match_jax():
    jcfg, tcfg = _cfgs("cls", 2)
    jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=13)
    toks, mask = _pair_batch(jcfg.max_len)
    targets = np.random.RandomState(2).uniform(size=len(toks)).astype(np.float32)

    def mse(p, tokens, mask, targets):
        return jnp.mean((jax.nn.sigmoid(jce.forward(p, tokens, mask, jcfg)) - targets) ** 2)

    want, grads = _value_and_grad(mse, jp, toks, mask, targets)
    model = _module(tce.CrossEncoder, tcfg, tp)
    loss = tdistill.mse_loss(model, *tce.device_batch(CPU, toks, mask, targets), torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    _assert_grads(model, grads, tcfg)


# ------------------------------------------------------------------ optimizer


def _optimizer_runs(kind, steps):
    """``steps`` BCE steps of JAX (``optax.adamw`` / ``optax.adam``) from
    carried parameters; returns the configs, the JAX parameters and
    optimizer state after each step, and the batches."""
    jcfg, tcfg = _cfgs("cls", 2, max_len=32, layers=1, heads=2)
    jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=17)
    opt = optax.adamw(1e-3) if kind == "adamw" else optax.adam(1e-3)
    step = jax.jit(jce.make_train_step(jcfg, opt))
    rng = np.random.RandomState(4)
    batches = [jtrain.synthetic_batch(rng, 8, jcfg.max_len) for _ in range(steps)]
    states = [(jp, opt.init(jp))]
    for b in batches:
        p, s = states[-1]
        p, s, _ = step(p, s, *(jnp.asarray(a) for a in b))
        states.append((p, s))
    return jcfg, tcfg, tp, states, batches


def _torch_optimizer(kind, model, tcfg):
    params = weights.ordered_parameters(model, tcfg)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=1e-3, weight_decay=tce.ADAMW_DECAY)
    return torch.optim.Adam(params, lr=1e-3)


def _assert_params(model, jax_params, tcfg, steps, lr=1e-3):
    """Within rtol 1e-5 and 1% of one Adam step (lr) a step: Adam
    divides each gradient entry by its own RMS, so an entry at f32
    noise takes a step of unknown size in either package.  The key
    bias's gradient is zero in exact arithmetic (a softmax does not see
    a shift shared by all keys), so there both may only move by +-lr a
    step."""
    want = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, jax_params), tcfg)
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name]
        if name.endswith("attn.qkv.b"):
            d = tcfg.dim
            np.testing.assert_array_less(np.abs(got[d:2 * d] - ref[d:2 * d]), 2.01 * lr * steps)
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0.01 * lr * steps, err_msg=name)


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_optimizer_update_rule_matches_optax(kind):
    """Three updates from the same gradients: the port's AdamW (decay
    1e-4 on every leaf) equals ``optax.adamw(lr)``, its Adam
    ``optax.adam(lr)``, parameters within rtol 1e-5 and 1e-5 of lr a
    step (a decay of 1e-2, torch's default, would be 3e-3 off here),
    moments within rtol 1e-4."""
    lr = 0.1
    jcfg, tcfg = _cfgs("interaction", 2, layers=1)
    jp, tp = _carried(jce.init_params, jcfg, tcfg, seed=19, jitter=0.5)
    opt = optax.adamw(lr) if kind == "adamw" else optax.adam(lr)
    model = _module(tce.CrossEncoder, tcfg, tp)
    params = weights.ordered_parameters(model, tcfg)
    topt = (torch.optim.AdamW(params, lr=lr, weight_decay=tce.ADAMW_DECAY)
            if kind == "adamw" else torch.optim.Adam(params, lr=lr))
    rng = np.random.RandomState(0)
    state = opt.init(jp)
    update = jax.jit(opt.update)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(np.shape(a)).astype(np.float32) * 0.01, jp)
        updates, state = update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(params, weights.params_from_jax_tree(grads, tcfg).values()):
            p.grad = torch.from_numpy(g)
        topt.step()
    want = weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, jp), tcfg)
    for name, p in model.named_parameters():
        # optax takes 1 - 0.999**count in f32 (1.3e-5 off at count 1),
        # torch in float64: each update may differ by 1e-5 of lr
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5,
                                   atol=1e-5 * lr * 3, err_msg=name)
    mu, nu, count = weights.adam_state_to_optax(topt.state_dict()["state"], tcfg)
    assert count == int(state[0].count) == 3
    for got, ref in ((mu, state[0].mu), (nu, state[0].nu)):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
            b = np.asarray(b)  # a moment that cancels: the error of its leaf's scale
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_optimizer_steps_match_optax(kind):
    """Three BCE train steps from carried parameters, the port's against
    ``jce.make_train_step`` with optax."""
    _, tcfg, tp, states, batches = _optimizer_runs(kind, 3)
    model = _module(tce.CrossEncoder, tcfg, tp)
    step = tce.make_train_step(model, _torch_optimizer(kind, model, tcfg))
    for b in batches:
        step(*tce.device_batch(CPU, *b))
    _assert_params(model, states[-1][0], tcfg, 3)


def test_optax_state_carried_into_torch():
    """JAX takes two AdamW steps; its parameters and Adam state carried
    across (``adam_state_from_optax``) give the port JAX's third step,
    and ``adam_state_to_optax`` gives back JAX's state after it."""
    _, tcfg, _, states, batches = _optimizer_runs("adamw", 3)
    p2, s2 = states[2]
    adam2 = s2[0]
    assert int(adam2.count) == 2
    model = _module(tce.CrossEncoder, tcfg,
                    weights.params_from_jax_tree(jax.tree_util.tree_map(np.asarray, p2), tcfg))
    opt = _torch_optimizer("adamw", model, tcfg)
    tree = functools.partial(jax.tree_util.tree_map, np.asarray)
    weights.load_adam_state(opt, weights.adam_state_from_optax(
        tree(adam2.mu), tree(adam2.nu), int(adam2.count), tcfg))
    tce.make_train_step(model, opt)(*tce.device_batch(CPU, *batches[2]))
    p3, s3 = states[3]
    _assert_params(model, p3, tcfg, 3)
    mu, nu, count = weights.adam_state_to_optax(opt.state_dict()["state"], tcfg)
    assert count == int(s3[0].count) == 3
    for got, want in ((mu, s3[0].mu), (nu, s3[0].nu)):
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(tree(want))
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            b = np.asarray(b)  # moments of f32 gradients: the gradients' tolerance
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5 * np.abs(b).max())
    with pytest.raises(ValueError):
        weights.adam_state_to_optax({0: opt.state_dict()["state"][0]}, tcfg)


def test_make_trainer_is_the_reference_adamw():
    """One parameter group in the npz order, optax's defaults (decay
    1e-4 on every leaf, betas 0.9/0.999, eps 1e-8), and the demo learns."""
    _, tcfg = _cfgs("interaction", 2)
    model, opt, _ = ttrain.make_trainer(tcfg, learning_rate=2e-4, device="cpu")
    (group,) = opt.param_groups
    assert group["weight_decay"] == 1e-4 and group["lr"] == 2e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert [id(p) for p in group["params"]] == [
        id(model.get_parameter(n)) for n in weights.param_paths(tcfg)]
    assert all(p.requires_grad for p in model.parameters())
    _, small = _cfgs("cls", 2, max_len=48, layers=1, heads=2)
    first = ttrain.train_demo(small, steps=1, batch=16, device="cpu")
    last = ttrain.train_demo(small, steps=25, batch=16, device="cpu")
    assert np.isfinite(last) and last < first


# ---------------------------------------------------------- data and checkpoint


def test_synthetic_batches_byte_equal():
    for n, max_len in ((7, 48), (32, 128)):
        a = jtrain.synthetic_batch(np.random.RandomState(n), n, max_len)
        b = ttrain.synthetic_batch(np.random.RandomState(n), n, max_len)
        c = jbe.synthetic_pairs(np.random.RandomState(n), n, max_len)
        d = tbe.synthetic_pairs(np.random.RandomState(n), n, max_len)
        for x, y in zip(a + c, b + d):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_jsonl_batches_byte_equal(tmp_path):
    data = tmp_path / "train.jsonl"
    rows = [{"query": "sponsor ads", "doc": "sponsor ads by acme", "label": 1},
            {"query": "ünïcode", "doc": "é" * 80, "label": 0},
            {"query": "", "doc": "weather", "label": 1}]
    data.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    a = jcli._jsonl_batches(str(data), 5, 48, np.random.RandomState(0))
    b = tcli._jsonl_batches(str(data), 5, 48, np.random.RandomState(0))
    for _ in range(3):
        for x, y in zip(next(a), next(b)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="no training rows"):
        next(tcli._jsonl_batches(str(tmp_path / "empty.jsonl"), 2, 48, np.random.RandomState(0)))


def test_checkpoint_round_trip_bit_equal(tmp_path):
    """Parameters, both moments and the step come back bit for bit; the
    sidecar holds every field of the reference's config."""
    _, tcfg = _cfgs("interaction", 2)
    model, opt, step = ttrain.make_trainer(tcfg, seed=1, device="cpu", remat=True)
    rng = np.random.RandomState(0)
    for _ in range(3):
        step(*ttrain.synthetic_batch(rng, 4, tcfg.max_len))
    checkpoint.save_train_state(str(tmp_path / "ck"), model, opt, 3, tcfg, torch.bfloat16, True)
    model2, opt2, _ = ttrain.make_trainer(tcfg, seed=2, device="cpu")
    at, config = checkpoint.load_train_state(str(tmp_path / "ck"), model2, opt2, tcfg)
    assert at == 3
    jcfg = jce.CrossEncoderConfig(**{k: v for k, v in config.items() if k != "dtype"})
    assert config["dtype"] == "bfloat16" and jcfg.remat is True and jcfg.dropout == 0.0
    ref_keys = {f.name for f in __import__("dataclasses").fields(jce.CrossEncoderConfig)}
    assert set(config) == ref_keys
    for (name, a), (_, b) in zip(model.named_parameters(), model2.named_parameters()):
        assert torch.equal(a, b), name
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert sorted(s1) == sorted(s2) == list(range(len(weights.param_paths(tcfg))))
    for i in s1:
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[i][key], s2[i][key]), (i, key)
    # resuming continues the same trajectory
    batch = ttrain.synthetic_batch(rng, 4, tcfg.max_len)
    l1 = tce.make_train_step(model, opt)(*tce.device_batch(CPU, *batch))
    l2 = tce.make_train_step(model2, opt2)(*tce.device_batch(CPU, *batch))
    assert torch.equal(l1, l2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_train_cli_synthetic_and_resume(tmp_path, capsys):
    out = str(tmp_path / "model")
    args = ["--steps", "12", "--batch", "8", "--dim", "32", "--heads", "2", "--layers", "1",
            "--experts", "2", "--max-len", "48", "--out", out, "--device", "cpu"]
    tcli.main(args)
    assert os.path.exists(os.path.join(out, "params.npz"))
    with open(os.path.join(out + ".ckpt", "config.json")) as f:
        assert json.load(f)["step"] == 12
    tcli.main(args[:1] + ["3"] + args[2:] + ["--resume", out + ".ckpt", "--remat"])
    captured = capsys.readouterr().out
    assert "device: cpu (single device)" in captured
    assert f"resumed from {out}.ckpt at step 12" in captured and "trained to step 15" in captured
    with open(os.path.join(out + ".ckpt", "config.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 15 and meta["config"]["remat"] is True


def test_train_cli_jsonl_weights_load_in_jax(tmp_path):
    """``--data`` JSONL; the saved ``params.npz`` + config.json load in
    the JAX ``CrossEncoderScorer`` and score as the port's scorer."""
    data = tmp_path / "train.jsonl"
    rows = [{"query": "sponsor ads", "doc": "sponsor ads by acme", "label": 1},
            {"query": "sponsor ads", "doc": "weather report", "label": 0}]
    data.write_text("\n".join(json.dumps(r) for r in rows))
    out = str(tmp_path / "m2")
    tcli.main(["--steps", "5", "--batch", "4", "--dim", "32", "--heads", "2", "--layers", "1",
               "--experts", "0", "--max-len", "48", "--data", str(data), "--out", out,
               "--device", "cpu"])
    jcfg = jce.CrossEncoderConfig(dim=32, n_heads=2, n_layers=1, n_experts=0, max_len=48,
                                  dtype=jnp.float32)
    js = jce.CrossEncoderScorer(jcfg)
    js.load(out)
    ts = tce.CrossEncoderScorer(tce._load_scorer_config(out), device="cpu")
    ts.load(out)
    docs = ["sponsor ads by acme", "weather report", ""]
    np.testing.assert_allclose(ts.score("sponsor ads", docs), js.score("sponsor ads", docs),
                               atol=1e-5)
    with open(os.path.join(out, "config.json")) as f:
        assert sorted(json.load(f)) == sorted(
            ["vocab_size", "max_len", "dim", "n_heads", "n_layers", "mlp_ratio", "n_experts",
             "head_type", "interaction_temp"])


@pytest.mark.parametrize("entry", ["trainer", "train_cli", "recall_eval", "rerank_eval",
                                   "distill"])
def test_training_entry_points_default_to_cuda(entry, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    calls = {
        "trainer": lambda: ttrain.make_trainer(_cfgs()[1]),
        "train_cli": lambda: tcli.main(["--steps", "1"]),
        "recall_eval": lambda: trecall.main(["--steps", "1", "--episodes", "4"]),
        "rerank_eval": lambda: trerank.main(["--steps", "1", "--episodes", "4"]),
        "distill": lambda: tdistill.main(["--steps", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


# ------------------------------------------------------------- bf16 bounds


def _listwise_probe(corpus_seed, group):
    """The shipped recipe's listwise step (interaction head, dim 128, 4
    heads, 2 layers, 4 experts, 224 tokens, warm-started from the
    shipped bi-encoder) on group ``group`` (even: hard, odd: mixed) of
    Q = 8 that ``train_cross_encoder`` draws from corpus ``corpus_seed``."""
    cfg = trerank.RerankEvalConfig(batch=8)
    ce_cfg = trerank._make_cfg(cfg)
    params = trerank.warm_start_params(ce_cfg, "artifacts/bi_encoder")
    chunks = corpus_gen.generate_corpus(48, 8, seed=corpus_seed)
    train_idx, _ = corpus_gen.split_by_episode(chunks, 0.25, seed=corpus_seed + 1)
    toks, masks = trerank.group_grids(cfg, chunks, train_idx, group + 1)[group]
    batch = tce.device_batch(CPU, toks, masks, np.zeros((8, 8), np.float32))
    return (lambda: _module(tce.CrossEncoder, ce_cfg, params),
            lambda m, dtype: trerank.listwise_loss(m, *batch, dtype))


def _info_nce_probe(init_seed, batch_no):
    """The shipped recipe's InfoNCE step (128 tokens, batch 32) from
    random init ``init_seed`` on batch ``batch_no`` of its pairs."""
    rcfg = trecall.RecallEvalConfig(batch=32)
    bi_cfg = trecall._bi_config(rcfg)
    bi_params = tbe.init_params(bi_cfg, init_seed)
    chunks = corpus_gen.generate_corpus(48, 8, seed=0)
    train_idx, _ = corpus_gen.split_by_episode(chunks, 0.25, seed=1)
    pairs = corpus_gen.training_pairs(chunks, train_idx, n_pairs=2000, seed=2 + init_seed)
    qs, ds = next(itertools.islice(trecall._doc_batches(rcfg, pairs), batch_no, None))
    batch = (*tce.device_batch(CPU, *tbe.tokenize_texts(qs, 128)),
             *tce.device_batch(CPU, *tbe.tokenize_texts(ds, 128)))
    return (lambda: _module(tbe.BiEncoder, bi_cfg, bi_params),
            lambda m, dtype: tbe.info_nce_loss(m, *batch, dtype))


@pytest.mark.parametrize("probe,seed,batch_no", [
    *(("listwise", c, g) for c in (0, 1) for g in range(4)),
    *(("info_nce", i, b) for i in (0, 1, 2) for b in range(2)),
])
def test_bf16_step_bounds(probe, seed, batch_no):
    """One train step at the shipped recipe's width, bf16 activations
    against f32, over two corpora x four groups (listwise) and three
    inits x two batches (InfoNCE): within ``BF16_STEP_LOSS_RTOL`` /
    ``BF16_GRAD_COSINE_FLOOR``.  The constants' comments give the
    readings (``-s`` prints them) and the margin; chip_smoke.py holds
    the card to the same constants."""
    mod = tce if probe == "listwise" else tbe
    build, loss_of = (_listwise_probe if probe == "listwise" else _info_nce_probe)(seed, batch_no)
    loss_dev, cos = tce.bf16_step_deviation(build, loss_of)
    print(f"bf16 step {probe} seed {seed} batch {batch_no}: loss rel {loss_dev:.3e}, "
          f"gradient cosine {cos:.6f}")
    assert loss_dev <= mod.BF16_STEP_LOSS_RTOL and cos >= mod.BF16_GRAD_COSINE_FLOOR
