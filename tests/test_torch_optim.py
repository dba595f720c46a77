"""The port's optimizers and schedule against the JAX package's (optax):
K updates on synthetic gradients, float64, the learning rate set per update
as the train step does.  Tolerance: 1e-9 of each leaf's movement (AdamW's
update is algebraically the same, evaluated in another order), 1e-5 with the
schedule (float32 rates); the schedule itself at rtol 2e-6 (both compute in
float32)."""

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
from xview2_tpu_torch.train.scheduler import noam_schedule

K = 5
SHAPES = {"kernel": (3, 3, 4, 8), "scale": (8,), "bias": (8,)}
NOAM = dict(init_lr=1e-4, max_lr=3e-3, final_lr=2e-4, warmup_epochs=1, total_epochs=3,
            steps_per_epoch=2)


def _problem(seed):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s) * 10.0 ** rng.integers(-3, 1) for k, s in SHAPES.items()}
             for _ in range(K)]
    return params, grads


@pytest.mark.parametrize("scheduled", [False, True], ids=["const-lr", "noam"])
@pytest.mark.parametrize("name,wd", [("adamw", 0.0), ("adamw", 0.05), ("adam", 0.05),
                                     ("sgd", 0.0)])
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
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = build_optimizer(Config(**kw), tp.values(), lr)
    for step, (g, w) in enumerate(zip(grads, want)):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = lr_at(lr, step)
        opt.step()
        for k, p in tp.items():
            # compare the movement, not the value: one update moves a leaf by
            # ~1e-3 of its scale
            delta_w = w[k] - params[k]
            delta_g = p.detach().numpy() - params[k]
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


@pytest.mark.parametrize("name", ["radam", "adabelief", "adabound", "adamp", "novograd"])
def test_other_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(Config(optimizer=name), [torch.nn.Parameter(torch.zeros(1))], 1e-3)
