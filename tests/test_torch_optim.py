"""The port's optimizers and schedule against the JAX package's (optax and
its hand-written AdaBound and AdamP): K updates on synthetic gradients,
float64, the learning rate set per update as the train step does, the conv
kernel leaf in the port's OIHW layout (AdamP's channel view is the flax
leaf's).  Tolerance: 1e-9 of each leaf's movement (the updates are
algebraically the same, evaluated in another order), 1e-5 with the schedule
(float32 rates); the schedule itself at rtol 2e-6 (both compute in float32).
A resumed AdaBound repeats an unbroken one bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from xview2_tpu.train.scheduler import noam_schedule as jax_noam
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.train.optimizers import build_optimizer, lr_at
from xview2_tpu_torch.parallel.checkpoint import load_optimizer_arrays, optimizer_arrays
from xview2_tpu_torch.train.scheduler import noam_schedule

K = 8  # radam rectifies from the sixth update on
SHAPES = {"kernel": (3, 3, 4, 8), "scale": (8,), "bias": (8,)}
ZOO = ("radam", "adabelief", "adabound", "adamp", "novograd")
NOAM = dict(init_lr=1e-4, max_lr=3e-3, final_lr=2e-4, warmup_epochs=1, total_epochs=3,
            steps_per_epoch=2)


def _port(k, v):
    """A flax leaf in the port's layout (HWIO kernels to OIHW)."""
    return np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v


def _flax(k, v):
    return np.transpose(v, (2, 3, 1, 0)) if v.ndim == 4 else v


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s) * 10.0 ** rng.integers(-3, 1) for k, s in SHAPES.items()}
             for _ in range(K)]
    return params, grads


@pytest.mark.parametrize("scheduled", [False, True], ids=["const-lr", "noam"])
@pytest.mark.parametrize("name,wd", [("adamw", 0.0), ("adamw", 0.05), ("adam", 0.05),
                                     ("sgd", 0.0)]
                         + [(n, wd) for n in ZOO for wd in (0.0, 0.05)])
def test_k_updates_match_optax(name, wd, scheduled):
    params, grads = _problem(0)
    kw = dict(optimizer=name, weight_decay=wd, lr=3e-3, momentum=0.9, encoder="resnet50")
    with jax.enable_x64():
        jlr = jax_noam(**NOAM) if scheduled else kw["lr"]
        tx = jax_build_optimizer(JaxConfig(**kw), jlr)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(jp)
        want = []
        for g in grads:
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, updates)
            want.append({k: np.asarray(v) for k, v in jp.items()})

    lr = noam_schedule(**NOAM) if scheduled else kw["lr"]
    tp = {k: torch.nn.Parameter(torch.from_numpy(_port(k, v).copy()))
          for k, v in params.items()}
    opt = build_optimizer(Config(**kw), tp.values(), lr)
    for step, (g, w) in enumerate(zip(grads, want)):
        for k, p in tp.items():
            p.grad = torch.from_numpy(_port(k, g[k]).copy())
        for group in opt.param_groups:
            group["lr"] = lr_at(lr, step)
        opt.step()
        for k, p in tp.items():
            # compare the movement, not the value: one update moves a leaf by
            # ~1e-3 of its scale
            delta_w = w[k] - params[k]
            delta_g = _flax(k, p.detach().numpy()) - params[k]
            tol = (1e-5 if scheduled else 1e-9) * max(np.abs(delta_w).max(), 1e-12)
            np.testing.assert_allclose(delta_g, delta_w, rtol=0, atol=tol,
                                       err_msg=f"{k} after update {step}")


def test_noam_schedule_matches_jax():
    for kw in (NOAM, dict(init_lr=1e-4, max_lr=3e-4, final_lr=1e-4, warmup_epochs=1,
                          total_epochs=250, steps_per_epoch=572)):
        want, got = jax_noam(**kw), noam_schedule(**kw)
        total = kw["total_epochs"] * kw["steps_per_epoch"]
        counts = sorted({0, 1, kw["steps_per_epoch"] - 1, kw["steps_per_epoch"],
                         kw["steps_per_epoch"] + 1, total // 2, total - 1, total, total + 7})
        for c in counts:
            # both evaluate in float32 (gamma rounded to float32 moves the far
            # end of the 143,000-step schedule by 2e-3 against float64)
            np.testing.assert_allclose(got(c), float(want(c)), rtol=2e-6, err_msg=str(c))


def test_adamp_projects_on_the_flax_channel_view():
    """A kernel whose flax rows are each orthogonal to their gradient rows
    is scale-invariant on the HWIO view (rows = kernel height) but not on
    the port's OIHW rows: the update must be JAX's."""
    rng = np.random.default_rng(5)
    p = rng.normal(size=(3, 3, 4, 8))
    g = rng.normal(size=(3, 3, 4, 8))
    pv, gv = p.reshape(3, -1), g.reshape(3, -1)
    gv -= pv * (np.sum(pv * gv, 1, keepdims=True) / np.sum(pv * pv, 1, keepdims=True))
    g = gv.reshape(p.shape)
    kw = dict(optimizer="adamp", weight_decay=0.05, lr=3e-3, encoder="resnet50")
    with jax.enable_x64():
        tx = jax_build_optimizer(JaxConfig(**kw), kw["lr"])
        jp = {"kernel": jnp.asarray(p)}
        upd, _ = tx.update({"kernel": jnp.asarray(g)}, tx.init(jp), jp)
        want = np.asarray(upd["kernel"])
    tp = torch.nn.Parameter(torch.from_numpy(_port("kernel", p).copy()))
    opt = build_optimizer(Config(**kw), [tp], kw["lr"])
    tp.grad = torch.from_numpy(_port("kernel", g).copy())
    opt.step()
    got = _flax("kernel", tp.detach().numpy()) - p
    # projected: on every flax row the update is radial only through the
    # weight decay, scaled by wd_ratio = 0.1
    direction = want + np.float32(np.float32(3e-3 * 0.05) * np.float32(0.1)) * p
    radial = np.sum(direction.reshape(3, -1) * p.reshape(3, -1), 1)
    assert np.abs(radial).max() < 1e-3 * np.abs(want).max() * np.abs(p).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


def test_adabound_resumes_bit_for_bit():
    """AdaBound's state through ``optimizer_arrays`` / ``load_optimizer_arrays``
    (what a checkpoint holds): K updates unbroken equal K/2, a rebuilt
    optimizer, then K/2."""
    params, grads = _problem(1)
    cfg = Config(optimizer="adabound", weight_decay=0.05, lr=3e-3, encoder="resnet50")
    lr = noam_schedule(**NOAM)

    def model_of():
        m = torch.nn.Module()
        for k, v in params.items():
            m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(_port(k, v).copy())))
        return m

    def run(m, opt, steps):
        for step in steps:
            for k, p in m.named_parameters():
                p.grad = torch.from_numpy(_port(k, grads[step][k]).copy())
            for group in opt.param_groups:
                group["lr"] = lr_at(lr, step)
            opt.step()

    whole = model_of()
    run(whole, build_optimizer(cfg, whole.parameters(), lr), range(K))
    half = model_of()
    opt = build_optimizer(cfg, half.parameters(), lr)
    run(half, opt, range(K // 2))
    saved = optimizer_arrays(half, opt)
    opt = build_optimizer(cfg, half.parameters(), lr)
    load_optimizer_arrays(half, opt, saved)
    run(half, opt, range(K // 2, K))
    for (k, a), (_, b) in zip(whole.named_parameters(), half.named_parameters()):
        assert torch.equal(a, b), k
