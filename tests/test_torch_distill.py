"""The port's draft distillation (tpu_bootstrap_torch/workload/distill.py)
held to the JAX reference's (tpu_bootstrap/workload/distill.py) on the CPU,
in f32, at tests/test_distill.py's sizes, on the reference's own teacher
and student params carried over by ``bridge.params_from_numpy``:
``distill_loss`` and its gradient, the distillation step in both forms,
its optimizer against optax's plain ``adamw``, and the refusals; then the
reference's behavioural tests on the port alone: the loss falls, the
student tracks the teacher, and a distilled draft raises speculative
acceptance.

Tolerances: the loss to 1e-5 relative (f32 sums taken in another order);
its gradients to 1e-5 relative, with an absolute floor of 1e-7 for
elements that are rounding noise next to the largest (about 1e-2);
optimizer updates as in tests/test_torch_train.py (1e-9 absolute, 1e-5
relative). The reference's sharded test waits for ROADMAP queue 1 item
11; here a mesh of more than one device raises naming it."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_bootstrap.workload import distill as jdistill
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import distill as tdistill
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import speculative as tspec
from tpu_bootstrap_torch.workload import train as ttrain

torch.set_num_threads(2)

TEACHER_KW = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
                  embed_dim=32, mlp_dim=64, max_seq_len=48)
STUDENT_KW = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
                  embed_dim=16, mlp_dim=32, max_seq_len=48)
JTEACHER, TTEACHER = (jmodel.ModelConfig(**TEACHER_KW),
                      tmodel.ModelConfig(**TEACHER_KW))
JSTUDENT, TSTUDENT = (jmodel.ModelConfig(**STUDENT_KW),
                      tmodel.ModelConfig(**STUDENT_KW))
MESH = ttrain.MeshConfig()

_jinit = jax.jit(jmodel.init_params, static_argnums=0)


def _to_port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


@pytest.fixture(scope="module")
def jteacher():
    # A random init is near-uniform over the vocab; the embedding x30
    # sharpens its conditionals (the reference test's stand-in for a
    # trained teacher).
    params = _jinit(JTEACHER, jax.random.PRNGKey(0))
    return {**params, "embed": params["embed"] * 30.0}


@pytest.fixture(scope="module")
def teacher(jteacher):
    return _to_port(jteacher)


@pytest.fixture(scope="module")
def jstudent():
    return _jinit(JSTUDENT, jax.random.PRNGKey(1))


def _batch(i):
    return np.array(jax.random.randint(jax.random.PRNGKey(100 + i), (8, 24),
                                       0, 32))


def _student(seed=1):
    return tmodel.init_params(TSTUDENT, seed=seed, device="cpu")


@pytest.mark.parametrize("temperature", [0.7, 1.0, 2.0])
@pytest.mark.parametrize("hard_weight", [0.0, 0.3])
def test_distill_loss_and_grads_match_reference(jteacher, teacher, jstudent,
                                                temperature, hard_weight):
    tokens = _batch(3)
    want, jgrads = jax.jit(jax.value_and_grad(jdistill.distill_loss),
                           static_argnums=(3, 4, 5, 6))(
        jstudent, jteacher, jnp.asarray(tokens), JSTUDENT, JTEACHER,
        temperature, hard_weight)
    student = _to_port(jstudent)
    leaves = ttrain.tree_leaves(student)
    for p in leaves:
        p.requires_grad_(True)
    got = tdistill.distill_loss(student, teacher, torch.from_numpy(tokens),
                                TSTUDENT, TTEACHER, temperature, hard_weight)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # The bridged tree lists its leaves in the reference's key order.
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    # The teacher is frozen: nothing of it asks for gradients.
    assert not any(p.requires_grad for p in ttrain.tree_leaves(teacher))


@pytest.mark.parametrize("teacher_as_arg", [False, True])
@pytest.mark.parametrize("hard_weight", [0.0, 0.3])
def test_distill_steps_match_reference(jteacher, teacher, jstudent,
                                       teacher_as_arg, hard_weight):
    """Five steps of each package's distillation step from the same
    student: the losses, step by step."""
    kw = dict(learning_rate=3e-3, temperature=2.0, hard_weight=hard_weight,
              teacher_as_arg=teacher_as_arg)
    jstep, jopt = jdistill.make_distill_step(
        JSTUDENT, jteacher, JTEACHER, build_mesh(JMesh()), **kw)
    tstep, topt = tdistill.make_distill_step(TSTUDENT, teacher, TTEACHER,
                                             MESH, **kw)
    js = jax.tree.map(jnp.array, jstudent)  # the step donates its student
    ts = _to_port(jstudent)
    jstate, tstate = jopt.init(js), topt.init(ts)
    want, got = [], []
    for i in range(5):
        tokens = _batch(i % 4)
        if teacher_as_arg:
            js, jstate, jloss = jstep(js, jteacher, jstate,
                                      jnp.asarray(tokens))
            ts, tstate, tloss = tstep(ts, teacher, tstate,
                                      torch.from_numpy(tokens))
        else:
            js, jstate, jloss = jstep(js, jstate, jnp.asarray(tokens))
            ts, tstate, tloss = tstep(ts, tstate, torch.from_numpy(tokens))
        want.append(float(jloss))
        got.append(tloss.item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for p, w in zip(ttrain.tree_leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-4)


def test_optimizer_is_optax_adamw():
    """make_distill_step's optimizer against optax.adamw(lr,
    weight_decay): a constant rate from the first update, no clipping."""
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    _, topt = tdistill.make_distill_step(TSTUDENT, None, TTEACHER, MESH,
                                         learning_rate=3e-3,
                                         weight_decay=0.1)
    jopt = optax.adamw(3e-3, weight_decay=0.1)
    jparams = [jnp.asarray(p) for p in params]
    tparams = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for _ in range(3):
        # Gradients of norm ~30: clipping at any usual norm would show.
        grads = [10 * rng.standard_normal(s).astype(np.float32)
                 for s in shapes]
        jupd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate,
                                   jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd = topt.update([torch.from_numpy(g) for g in grads], tstate,
                           tparams)
        for p, u in zip(tparams, tupd):
            p.add_(u)
        for a, b in zip(tupd, jupd):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9,
                                       rtol=1e-5)
        assert all(float(u.abs().max()) > 0 for u in tupd)


def test_distill_loss_falls_and_student_tracks_teacher(teacher):
    step, opt = tdistill.make_distill_step(TSTUDENT, teacher, TTEACHER, MESH,
                                           learning_rate=3e-3,
                                           temperature=2.0)
    student = _student()
    opt_state = opt.init(student)
    first = None
    for i in range(60):
        student, opt_state, loss = step(student, opt_state,
                                        torch.from_numpy(_batch(i % 4)))
        first = first if first is not None else loss.item()
    assert loss.item() < first - 0.5, (first, loss.item())
    held = torch.from_numpy(_batch(999))
    kl_end = tdistill.distill_loss(student, teacher, held, TSTUDENT,
                                   TTEACHER).item()
    kl_start = tdistill.distill_loss(_student(), teacher, held, TSTUDENT,
                                     TTEACHER).item()
    assert kl_end < kl_start


def test_distilled_draft_raises_speculative_acceptance(teacher):
    """A distilled draft commits more tokens per verify round than its
    random init, and the output stays the teacher's own greedy stream."""
    step, opt = tdistill.make_distill_step(TSTUDENT, teacher, TTEACHER, MESH,
                                           learning_rate=5e-3,
                                           temperature=0.7)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(7), (2, 6), 0,
                                         32))
    solo = tdecode.generate(teacher, prompt, TTEACHER, 30, device="cpu")

    def acceptance(draft):
        out, stats = tspec.speculative_generate(
            teacher, draft, prompt, TTEACHER, TSTUDENT, steps=30, gamma=4,
            with_stats=True, device="cpu")
        assert torch.equal(out, solo)
        return float(stats["mean_committed"])

    student = _student()
    before = acceptance(student)
    opt_state = opt.init(student)
    for i in range(300):
        student, opt_state, _ = step(student, opt_state,
                                     torch.from_numpy(_batch(i % 8)))
    after = acceptance(student)
    assert after > before + 0.5, (before, after)


def test_hard_label_mix(teacher):
    """hard_weight adds the next-token cross-entropy (T = 1, the data's
    labels) to the soft loss, linearly."""
    student = _student()
    tokens = torch.from_numpy(_batch(0))
    soft = tdistill.distill_loss(student, teacher, tokens, TSTUDENT,
                                 TTEACHER, temperature=2.0).item()
    mixed = tdistill.distill_loss(student, teacher, tokens, TSTUDENT,
                                  TTEACHER, temperature=2.0,
                                  hard_weight=0.3).item()
    hard = tmodel.loss_fn(student, tokens, TSTUDENT).item()
    assert mixed == pytest.approx(soft + 0.3 * hard, rel=1e-5)
    step, opt = tdistill.make_distill_step(TSTUDENT, teacher, TTEACHER, MESH,
                                           learning_rate=3e-3,
                                           temperature=2.0, hard_weight=0.3)
    opt_state = opt.init(student)
    first = None
    for i in range(30):
        student, opt_state, loss = step(student, opt_state,
                                        torch.from_numpy(_batch(i % 4)))
        first = first if first is not None else loss.item()
    assert loss.item() < first


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_rejects_bad_configs(jteacher, teacher):
    """The reference's three refusals, with its messages, and
    distill_loss's own temperature guard."""
    jmesh = build_mesh(JMesh())
    for field, value, kw in (("vocab_size", 16, {}),
                             ("vocab_size", 32, {"temperature": 0}),
                             ("num_experts", 2, {})):
        jodd = jmodel.ModelConfig(**{**STUDENT_KW, field: value})
        todd = tmodel.ModelConfig(**{**STUDENT_KW, field: value})
        want = _message(lambda: jdistill.make_distill_step(
            jodd, jteacher, JTEACHER, jmesh, **kw))
        got = _message(lambda: tdistill.make_distill_step(
            todd, teacher, TTEACHER, MESH, **kw))
        assert got == want
    assert "vocab" in want or "MoE" in want
    with pytest.raises(ValueError, match="temperature"):
        tdistill.distill_loss(_student(), teacher, torch.from_numpy(
            _batch(0)), TSTUDENT, TTEACHER, temperature=0)


@pytest.mark.parametrize("mesh", [dict(data=2), dict(fsdp=2), dict(tensor=2),
                                  dict(seq=2), dict(expert=2),
                                  dict(data=2, fsdp=2, tensor=2)])
@pytest.mark.parametrize("teacher_as_arg", [False, True])
def test_multi_device_mesh_raises_item_11(teacher, mesh, teacher_as_arg):
    """Without a process group of the mesh's size a multi-device mesh
    refuses rather than distil on one device; the sharded distillation
    runs on gloo ranks (tests/test_torch_mesh_finetune.py)."""
    with pytest.raises(ValueError, match="mesh needs"):
        tdistill.make_distill_step(TSTUDENT, teacher, TTEACHER,
                                   ttrain.MeshConfig(**mesh),
                                   teacher_as_arg=teacher_as_arg)


def test_public_names_match_reference():
    assert tdistill.__all__ == jdistill.__all__
