"""The port's quality module (tpu_bootstrap_torch/workload/quality.py) held
to the JAX reference's (tpu_bootstrap/workload/quality.py) on the CPU, at
tests/test_quality.py's sizes: ``markov_batch`` bit for bit; ``score`` and
``eval_quality`` on the reference's trained model, carried over by
``bridge.params_from_numpy``, in float, bf16, int8 and int4 (each
package's own quantizer, bit-equal); then the reference's tests on the
port: the trained model's int8 and int4 ladder, acceptance of the int8
self-draft on trained weights against random ones, a distilled draft's
acceptance and exactness, and the port's own training from the same init
meeting the same limits.

The trained model comes from one module-scoped fixture: the reference's
jitted train step, 400 steps on the chain (p 0.9, vocabulary 128).
Tolerances: argmaxes bitwise, and agreement percentages exactly. Mean
cross-entropies of the float and bf16 trees to 1e-5 relative (f32 sums
taken in another order; perplexities rounded to 4 places then agree to
2e-4). Those of the int8 and int4 trees to 1e-4 relative: their
projections round every activation to bf16 (K1's and K6's arithmetic in
both packages), so a sum that differs in its last f32 bit upstream can
land on the other side of a bf16 rounding, and logits part by up to
7.6e-3 (as in tests/test_torch_decode.py, whose quantized formats hold
logits to 5e-3); over this fixture's 248 positions that measured 1.3e-6
(int8) and 1.8e-5 (int4) relative on the mean."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quality as jquality
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import quality as tquality
from tpu_bootstrap_torch.workload import quant as tquant
from tpu_bootstrap_torch.workload import speculative as tspec
from tpu_bootstrap_torch.workload import train as ttrain

torch.set_num_threads(2)

VOCAB = 128
SEQ = 32
STEPS = 400
MODEL_KW = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, head_dim=16,
                embed_dim=64, mlp_dim=256, max_seq_len=SEQ)
JCFG = jmodel.ModelConfig(**MODEL_KW)
TCFG = tmodel.ModelConfig(**MODEL_KW)
XENT_RTOL = {"float": 1e-5, "bf16": 1e-5, "int8": 1e-4, "int4": 1e-4}


def _batch(step, batch, seq=SEQ):
    return tquality.markov_batch(step, batch, seq, VOCAB, p=0.9)


def _jbf16(params):
    return jax.tree.map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x,
        params)


def _tbf16(params):
    if isinstance(params, dict):
        return {k: _tbf16(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_tbf16(v) for v in params]
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(torch.bfloat16)
    return params


def _to_port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The reference's model trained on the chain, its init (numpy) and
    its losses; the trained params bridged to the port."""
    cfg = jtrain.TrainConfig(model=JCFG, mesh=JMesh())
    mesh = build_mesh(cfg.mesh, jax.devices()[:1])
    params, opt_state, p_sh = jtrain.init_train_state(cfg, mesh,
                                                      jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, params)  # the step donates params
    step = jtrain.make_train_step(cfg, mesh, p_sh)
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(_batch(i, 16)))
        losses.append(loss)
    losses = [float(x) for x in losses]
    # The task was learned (floor ~0.81 nats at p = 0.9, V = 128).
    assert losses[-1] < losses[0] * 0.6 and losses[-1] < 1.6, losses[-1]
    return {"jparams": params, "tparams": _to_port(params), "init": init,
            "losses": losses}


def _pair(trained, kind):
    """(reference params, port params) of a trained-model variant."""
    jp, tp = trained["jparams"], trained["tparams"]
    if kind == "bf16":
        return _jbf16(jp), _tbf16(tp)
    if kind == "int8":
        return jquant.quantize_params(jp), tquant.quantize_params(tp)
    if kind == "int4":
        return jquant.quantize_params4(jp), tquant.quantize_params4(tp)
    return jp, tp


@pytest.mark.parametrize("step,batch,seq,vocab,p,seed", [
    (3, 4, SEQ, VOCAB, 0.9, 0), (600, 16, SEQ, VOCAB, 0.9, 0),
    (10_000, 8, SEQ, VOCAB, 0.9, 0), (0, 8, 1024, 4096, 0.85, 0),
    (10_000, 8, 129, 4096, 0.85, 0), (20_000, 8, 16, 4096, 0.85, 0),
    (5, 8, 1024, 4096, 0.85, 1), (7, 3, 1, 10, 0.5, 2),
    (2, 5, 40, 32768, 0.0, 3), (9, 2, 12, 7, 1.0, 4)])
def test_markov_batch_bitwise(step, batch, seq, vocab, p, seed):
    want = jquality.markov_batch(step, batch, seq, vocab, p=p, seed=seed)
    got = tquality.markov_batch(step, batch, seq, vocab, p=p, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_markov_batch_deterministic_and_learnable():
    a = tquality.markov_batch(3, 4, SEQ, VOCAB, p=0.9)
    np.testing.assert_array_equal(a, tquality.markov_batch(3, 4, SEQ, VOCAB,
                                                           p=0.9))
    assert not np.array_equal(a, tquality.markov_batch(4, 4, SEQ, VOCAB,
                                                       p=0.9))
    # One fixed permutation: successor sets are near-singletons.
    succ: dict = {}
    for row in a:
        for t in range(1, SEQ):
            succ.setdefault(int(row[t - 1]), []).append(int(row[t]))
    follow = sum(np.unique(s, return_counts=True)[1].max()
                 for s in succ.values())
    assert follow / sum(len(s) for s in succ.values()) > 0.7


@pytest.mark.parametrize("kind", ["float", "bf16", "int8", "int4"])
def test_score_matches_reference(trained, kind):
    jp, tp = _pair(trained, kind)
    tokens = _batch(10_000, 8)
    jx, ja = jquality.score(jp, jnp.asarray(tokens), cfg=JCFG)
    tx, ta = tquality.score(tp, tokens, TCFG)
    assert ta.dtype == torch.int32 and tuple(ta.shape) == (8, SEQ - 1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tx.item(), float(jx), rtol=XENT_RTOL[kind])


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_eval_quality_matches_reference(trained, kind):
    tokens = _batch(10_000, 8)
    jb, tb = _pair(trained, "bf16")
    jq, tq = _pair(trained, kind)
    want = jquality.eval_quality(jb, jq, JCFG, jnp.asarray(tokens))
    got = tquality.eval_quality(tb, tq, TCFG, tokens)
    assert set(got) == set(want)
    assert got["argmax_agreement_pct"] == want["argmax_agreement_pct"]
    assert got["ppl_base"] == pytest.approx(want["ppl_base"], abs=2e-4)
    # exp(xent) moves by ppl * xent * rtol, plus the rounding to 4 places.
    ppl = want["ppl_quant"]
    tol = ppl * np.log(ppl) * XENT_RTOL[kind] + 2e-4
    assert got["ppl_quant"] == pytest.approx(ppl, abs=tol)
    assert got["ppl_delta"] == pytest.approx(want["ppl_delta"],
                                             abs=tol + 2e-4)


def test_trained_int8_quality(trained):
    out = tquality.eval_quality(_tbf16(trained["tparams"]),
                                tquant.quantize_params(trained["tparams"]),
                                TCFG, _batch(10_000, 8))
    assert out["argmax_agreement_pct"] > 85, out
    assert abs(out["ppl_delta"]) < 0.5, out
    assert out["ppl_base"] < 5.0, out


def test_trained_int4_quality(trained):
    out = tquality.eval_quality(_tbf16(trained["tparams"]),
                                tquant.quantize_params4(trained["tparams"]),
                                TCFG, _batch(10_000, 8))
    assert out["argmax_agreement_pct"] > 60, out
    assert abs(out["ppl_delta"]) < 2.0, out


def test_trained_spec_acceptance_beats_random_init(trained):
    """The int8 self-draft on trained weights commits more than 1.5
    tokens a round, and at least what it commits on a random init."""
    tp = trained["tparams"]
    prompt = tquality.markov_batch(20_000, 4, 16, VOCAB, p=0.9)
    acc = tquality.spec_acceptance(_tbf16(tp), tquant.quantize_params(tp),
                                   TCFG, prompt, steps=48, gamma=4,
                                   device="cpu")
    assert acc["mean_committed"] > 1.5 and acc["gamma"] == 4, acc
    rand = tmodel.init_params(TCFG, seed=7, device="cpu")
    rand_acc = tquality.spec_acceptance(_tbf16(rand),
                                        tquant.quantize_params(rand), TCFG,
                                        prompt, steps=48, gamma=4,
                                        device="cpu")
    assert acc["mean_committed"] >= rand_acc["mean_committed"], (acc,
                                                                 rand_acc)


def test_spec_acceptance_matches_reference(trained):
    """The same trained target and int8 self-draft in both packages:
    the same committed tokens a round."""
    jp, tp = trained["jparams"], trained["tparams"]
    prompt = tquality.markov_batch(20_000, 4, 16, VOCAB, p=0.9)
    want = jquality.spec_acceptance(_jbf16(jp), jquant.quantize_params(jp),
                                    JCFG, jnp.asarray(prompt), steps=48,
                                    gamma=4)
    got = tquality.spec_acceptance(_tbf16(tp), tquant.quantize_params(tp),
                                   TCFG, prompt, steps=48, gamma=4,
                                   device="cpu")
    assert got == want


def test_distilled_draft_acceptance_and_exactness(trained):
    """distill_draft trains a shallower student whose acceptance on the
    trained teacher clears 1.5 a round; the output stays the teacher's
    own greedy stream whatever the draft."""
    tp = trained["tparams"]
    scfg = dataclasses.replace(TCFG, num_layers=1)
    draft, dloss = tquality.distill_draft(
        tp, TCFG, scfg, steps=200, batch_fn=lambda i: _batch(600 + i, 16),
        device="cpu")
    assert np.isfinite(dloss)
    assert len(draft["blocks"]) == 1
    prompt = tquality.markov_batch(30_000, 4, 8, VOCAB, p=0.9)
    acc = tquality.spec_acceptance(_tbf16(tp), _tbf16(draft), TCFG, prompt,
                                   steps=32, gamma=4, draft_cfg=scfg,
                                   device="cpu")
    assert acc["mean_committed"] > 1.5, acc
    out = tspec.speculative_generate(_tbf16(tp), _tbf16(draft), prompt, TCFG,
                                     scfg, 16, gamma=3, device="cpu")
    solo = tdecode.generate(_tbf16(tp), prompt, TCFG, 16, kv_kernel=False,
                            device="cpu")
    assert torch.equal(out, solo)


def test_port_trains_to_the_same_limits(trained):
    """The port's own train step from the reference's init, on the same
    batches, learns the task to the reference test's limits, its first
    loss the reference's."""
    cfg = ttrain.TrainConfig(model=TCFG)
    params = bridge.params_from_numpy(trained["init"], device="cpu")
    opt_state = ttrain.make_optimizer(cfg).init(params)
    step = ttrain.make_train_step(cfg)
    losses = []
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(_batch(i, 16)))
        losses.append(loss)
    losses = [x.item() for x in losses]
    assert losses[0] == pytest.approx(trained["losses"][0], rel=1e-5)
    assert losses[-1] < losses[0] * 0.6 and losses[-1] < 1.6, losses[-1]
    out = tquality.eval_quality(_tbf16(params),
                                tquant.quantize_params(params), TCFG,
                                _batch(10_000, 8))
    assert out["argmax_agreement_pct"] > 85 and out["ppl_base"] < 5.0, out


def test_public_names_match_reference():
    assert tquality.__all__ == jquality.__all__
