"""``make_train_multistep`` on the CPU, where it is K calls of the train
step, and the optimizers' device table of per-step scalars.

(a) A float64 ResNet-50 ``UNetLoc`` on 2 tiles of 64^2, crop 32, K = 2: the
    multistep is EQUAL to two ``make_train_step`` calls (the losses, every
    parameter and buffer, the optimizer state, ``state.step``), under
    ``adamw``, ``radam`` (whose early updates take the unrectified branch) and
    ``adabound`` with the Noam schedule.
(b) The same multistep against JAX's ``make_train_multistep`` (``lax.scan``)
    in float64, the augmentation replaced on both sides by the same prepared
    crops: the gates of ``tests/test_torch_train_step.py``'s float64 K-step
    trajectory (loss 1e-8 relative, parameter deltas 1e-4 of each leaf's
    largest delta, running statistics 1e-7), the deltas also within the
    leaf's float64 resolution (4 ulps of its largest value: a leaf whose
    gradient is cancellation noise moves by an ulp in one package and not
    in the other).
(c) Each of the seven optimizers reading its scalars from the device table
    is EQUAL, in float32 and float64, to the same update with the scalars
    passed as Python floats (the host-scalar form), on the same gradients,
    over eight updates (RAdam rectifies from the sixth) with the schedule.
(d) The CUDA graph path raises, naming its ROADMAP item, under a gloo
    group; it is checked before anything touches a card.
(e) The graph's body without capture under ``--autoaugment``: the same
    float64 ResNet-50 ``UNetLoc`` after one eager train step (which creates
    the optimizer's state, as the graph's eager first call does), K bodies
    (``steps.graph_draws``, the optimizer's K-row table,
    ``steps.graph_body``: AutoAugment in its static form) EQUAL to K
    ``make_train_step`` calls (the grouped form): the losses, every parameter
    and buffer, the optimizer state, ``state.step``; on 3-channel tiles and on
    a ``cat`` pair model with ``--type post`` (AdamW on singles, whose K
    table rows differ; SGD with momentum on pairs).  The run starts at step
    23, whose next two steps' draws fire a shearX and a rotation.
The graph itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_jax_variables import one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu_torch.ops import autoaugment as taa
from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.parallel import steps as jax_steps
from xview2_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.parallel import steps
from xview2_tpu_torch.train.optimizers import OPTIMIZERS, build_optimizer
from xview2_tpu_torch.train.scheduler import noam_schedule

K, TILE, CROP = 2, 64, 32
BASE = dict(type="pre", encoder="resnet50", precision=64, loss_str="focal+dice",
            fused_tail=True, batch_size=2)
NOAM = dict(init_lr=1e-4, max_lr=3e-3, final_lr=2e-4, warmup_epochs=1, total_epochs=3,
            steps_per_epoch=2)


def _raw(seed=0, k=K):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (k, 2, TILE, TILE, 3), np.uint8)
    masks = (rng.random((k, 2, TILE, TILE)) > 0.8).astype(np.uint8)
    return images, masks


def _snapshot(model, opt, state):
    snap = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i, st in enumerate(opt.state.values()):
        snap.update({f"opt{i}/{k}": v.detach().clone() for k, v in st.items()})
    return snap, state.step


@pytest.mark.parametrize("name,scheduled", [("adamw", False), ("radam", False),
                                            ("adabound", True)])
def test_multistep_equals_k_train_steps(name, scheduled):
    cfg = Config(**dict(BASE, optimizer=name, weight_decay=0.05))
    lr = noam_schedule(**NOAM) if scheduled else cfg.lr
    images, masks = _raw()
    runs = {}
    for mode in ("steps", "multi"):
        model, _ = seeded_model(dict(BASE, optimizer=name), seed=1)
        opt = build_optimizer(cfg, model.parameters(), lr)
        state = steps.init_train_state(model, opt, device="cpu")
        if mode == "steps":
            step = steps.make_train_step(cfg, model, opt, crop=CROP, device="cpu",
                                         learning_rate=lr)
            losses = []
            for k in range(K):
                state, loss = step(state, images[k], masks[k],
                                   steps.step_generator(cfg, state.step, "cpu"))
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            multi = steps.make_train_multistep(cfg, model, opt, K, crop=CROP, device="cpu",
                                               learning_rate=lr)
            state, losses = multi(state, images, masks)
        runs[mode] = (losses, *_snapshot(model, opt, state))
    (l0, s0, n0), (l1, s1, n1) = runs["steps"], runs["multi"]
    assert l1.shape == (K,) and torch.equal(l0, l1)
    assert n0 == n1 == K
    assert s0.keys() == s1.keys()
    for key in s0:
        assert torch.equal(s0[key], s1[key]), key


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_multistep_matches_jax_multistep_f64(monkeypatch):
    from xview2_tpu_torch.weights import to_flax

    kw = dict(BASE, optimizer="sgd", lr=3e-4, momentum=0.9)
    model, variables = seeded_model(kw, seed=2)
    rng = np.random.default_rng(5)
    crops = rng.normal(size=(K, 2, TILE, TILE, 3))
    labels = (rng.random((K, 2, TILE, TILE)) > 0.7).astype(np.int32)

    # both packages' augmentation hands the prepared crops through
    monkeypatch.setattr(jax_steps, "_augment_batch", lambda *a: (
        lambda keys, images, masks: (images, masks.astype(jnp.int32))))
    with jax.enable_x64():
        jcfg = JaxConfig(**kw)
        tx = jax_build_optimizer(jcfg, jcfg.lr)
        params = jax.tree.map(jnp.asarray, variables["params"])
        state0 = jax_steps.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                                      batch_stats=jax.tree.map(jnp.asarray,
                                                               variables["batch_stats"]),
                                      opt_state=tx.init(params))
        multi = jax.jit(jax_steps.make_train_multistep(jcfg, jax_build_model(jcfg), tx, K,
                                                       crop=TILE))
        jstate, jlosses = multi(state0, jnp.asarray(crops), jnp.asarray(labels),
                                jax.random.PRNGKey(0))
        jlosses = np.asarray(jlosses)
        jparams, jstats = _flat(jstate.params), _flat(jstate.batch_stats)
    assert int(jstate.step) == K

    cfg = Config(**kw)
    monkeypatch.setattr(steps, "augment_batch", lambda gen, images, masks, crop, bgr, **_: (
        images, masks.to(torch.int32)))
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = steps.init_train_state(model, opt, device="cpu")
    multi = steps.make_train_multistep(cfg, model, opt, K, crop=TILE, device="cpu")
    state, losses = multi(state, torch.from_numpy(crops), torch.from_numpy(labels))
    assert state.step == K
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-8)
    params, stats = (_flat(t) for t in to_flax(model.state_dict()))
    flat0 = _flat(variables["params"])
    assert params.keys() == jparams.keys() and stats.keys() == jstats.keys()
    for key, w in jparams.items():
        got, want = params[key] - flat0[key], w - flat0[key]
        atol = 1e-4 * max(np.abs(want).max(), 1e-12) + 4 * np.finfo(np.float64).eps * np.abs(
            flat0[key]).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=f"param delta {key}")
    for key, w in jstats.items():
        np.testing.assert_allclose(stats[key], w, rtol=1e-7, atol=1e-10, err_msg=key)


SHAPES = ((8, 4, 3, 3), (8,), (8,), (16, 8, 1, 1))


@torch.no_grad()
def _host_scalar_step(opt, lr):
    """The update with its per-step scalars as Python floats: the host
    computes the same values, and nothing is read from the device table."""
    for group in opt.param_groups:
        group["lr"] = lr
        params = [p for p in group["params"] if p.grad is not None]
        for p in params:
            if not opt.state.get(p):
                opt.state[p] = opt._init_state(p, 0)
        states = [opt.state[p] for p in params]
        for st in states:
            if opt.counted:
                st["step"] += 1
        dt = np.float64 if params[0].dtype == torch.float64 else np.float32
        values = opt.host_scalars(group, int(states[0]["step"]) if opt.counted else 0, dt)
        opt._update(group, {n: float(v) for n, v in zip(opt.scalars, values)}, params,
                    [p.grad for p in params],
                    {m: [st[m] for st in states] for m in opt.moments})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", [n for n in OPTIMIZERS if n != "adam"])
def test_table_scalars_equal_host_scalars(name, dtype):
    rng = np.random.default_rng(4)
    init = [rng.normal(size=s) for s in SHAPES]
    grads = [[rng.normal(size=s) * 10.0 ** rng.integers(-3, 1) for s in SHAPES]
             for _ in range(8)]
    cfg = Config(optimizer=name, weight_decay=0.05, lr=3e-3, momentum=0.9, encoder="resnet50")
    lr = noam_schedule(**NOAM)
    out = []
    for host in (False, True):
        params = [torch.nn.Parameter(torch.tensor(v, dtype=dtype)) for v in init]
        opt = build_optimizer(cfg, params, lr)
        for count, g in enumerate(grads):
            for p, gv in zip(params, g):
                p.grad = torch.tensor(gv, dtype=dtype)
            if host:
                _host_scalar_step(opt, lr(count))
            else:
                for group in opt.param_groups:
                    group["lr"] = lr(count)
                opt.step()
        out.append([p.detach().clone() for p in params]
                   + [v.clone() for st in opt.state.values() for v in st.values()])
    assert len(out[0]) == len(out[1])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(out[0][0], torch.tensor(init[0], dtype=dtype))


def _raises_naming_roadmap(cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        steps.make_train_multistep(cfg, None, None, K, device="cuda")


def test_graph_path_raises_under_a_gloo_group(monkeypatch):
    mesh.init_data_parallel(1, 0, backend="gloo", device="cpu", store=dist.HashStore())
    try:
        _raises_naming_roadmap(Config(encoder="resnet50", gpus=1), monkeypatch)
    finally:
        mesh.shutdown()


AA_START = 23  # steps 24 and 25 draw a shearX and a rotation


def _fired_ops(cfg, images, masks, first):
    """The ops AutoAugment fires at steps ``first .. first + K - 1``."""
    fired = set()
    for k in range(K):
        d = steps.graph_draws(cfg, first + k, torch.as_tensor(images[k]),
                              torch.as_tensor(masks[k]), CROP)
        for op, _, fires in taa.slot_plan(d.aa):
            fired |= set(op[fires].tolist())
    return fired


@pytest.mark.parametrize("pairs", [False, True], ids=["singles", "cat-pairs"])
def test_graph_bodies_equal_train_steps_under_autoaugment(pairs):
    kw = dict(BASE, optimizer="adamw", autoaugment=True)
    if pairs:
        kw.update(type="post", dmg_model="cat", optimizer="sgd", momentum=0.9)
    cfg = Config(**kw)
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (1 + K, 2, TILE, TILE, 6 if pairs else 3), np.uint8)
    masks = ((rng.random((1 + K, 2, TILE, TILE)) > 0.8)
             * rng.integers(1, 5 if pairs else 2, (1 + K, 2, TILE, TILE))).astype(np.uint8)
    assert {taa.SHEAR_X, taa.ROTATE} <= _fired_ops(cfg, images[1:], masks[1:], AA_START + 1)
    model, _ = seeded_model(kw, seed=1)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = steps.init_train_state(model, opt, device="cpu")
    state.step = AA_START
    state, _ = steps.make_train_step(cfg, model, opt, crop=CROP, device="cpu")(
        state, images[0], masks[0], steps.step_generator(cfg, state.step, "cpu"))
    runs = {}
    for mode in ("steps", "bodies"):
        model_c = copy.deepcopy(model)
        opt_c = build_optimizer(cfg, model_c.parameters(), cfg.lr)
        for p, p_c in zip(model.parameters(), model_c.parameters()):
            opt_c.state[p_c] = {k: v.clone() for k, v in opt.state[p].items()}
        state_c = steps.TrainState(state.step, model_c, opt_c)
        imgs, msks = torch.from_numpy(images[1:]), torch.from_numpy(masks[1:])
        if mode == "steps":
            step = steps.make_train_step(cfg, model_c, opt_c, crop=CROP, device="cpu")
            losses = []
            for k in range(K):
                state_c, loss = step(state_c, imgs[k], msks[k],
                                     steps.step_generator(cfg, state_c.step, "cpu"))
                losses.append(loss)
        else:
            learn = steps._learner(cfg, model_c)
            draws = [steps.graph_draws(cfg, state_c.step + k, imgs[k], msks[k], CROP)
                     for k in range(K)]
            opt_c.prepare([cfg.lr] * K)
            losses = [steps.graph_body(cfg, learn, opt_c, imgs, msks, draws, k, CROP)
                      for k in range(K)]
            state_c.step += K
        runs[mode] = (torch.stack(losses), *_snapshot(model_c, opt_c, state_c))
    (l0, s0, n0), (l1, s1, n1) = runs["steps"], runs["bodies"]
    assert torch.equal(l0, l1), (l0, l1)
    assert n0 == n1 == AA_START + 1 + K
    assert s0.keys() == s1.keys()
    assert [key for key in s0 if not torch.equal(s0[key], s1[key])] == []
    moved = [key for key, v in model.state_dict().items() if not torch.equal(v, s0[key])]
    assert len(moved) > len(s0) // 4  # the K steps after the copy moved the model
