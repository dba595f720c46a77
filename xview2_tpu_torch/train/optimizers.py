"""Optimizers of the train step (port of ``build_optimizer`` of
``xview2_tpu/train/optimizers.py``).

* ``adamw`` / ``adam``: ``torch.optim.AdamW`` with betas (0.9, 0.999), eps
  1e-8 and decoupled weight decay on every parameter, which is what
  ``optax.adamw`` computes (the JAX package maps apex FusedAdam's
  ``adam_w_mode`` onto the same rule, so both names are one optimizer);
* ``sgd``: ``torch.optim.SGD`` with momentum, no Nesterov, no weight decay
  (``optax.sgd`` takes none);
* ``radam``, ``adabelief``, ``adabound``, ``adamp``, ``novograd``: the JAX
  package's updates written here as ``torch.optim.Optimizer`` classes:
  optax's ``scale_by_radam`` (rectification threshold 5) and
  ``scale_by_belief`` (eps 1e-16, eps_root 1e-16), each followed by
  ``add_decayed_weights`` and the learning rate; the JAX package's
  hand-written AdaBound and AdamP, whose scalar coefficients it computes in
  float32 (``count.astype(float32)``), so these compute them in float32
  too; ``optax.novograd`` with betas (0.95, 0.98), whose second moment is
  ONE scalar per parameter (every port parameter is one flax leaf).

AdamP takes its per-channel view on the flax leaf: ``x.reshape(x.shape[0],
-1)`` of an HWIO kernel groups by kernel ROW, so a 4-D port weight (OIHW,
or a transposed conv's (in, out, kh, kw), the same permutation in
``weights.py``) is viewed as ``weight.permute(2, 3, 1, 0)``.

The elementwise updates run over all the parameters of a group at once
(``torch._foreach_*``); AdamP's projection is per 4-D parameter, with no
host synchronisation.  Each parameter's state holds ``step`` (a CPU scalar)
and its moments as tensors, which ``parallel/checkpoint.py`` saves and
restores (NovoGrad's per-leaf second moment has shape (1,)).  The learning
rate is a float or a schedule ``count -> lr``; the train step sets it once
per update.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Union

import numpy as np
import torch

from xview2_tpu_torch.config import Config

LearningRate = Union[float, Callable[[int], float]]

_f32 = np.float32


def lr_at(learning_rate: LearningRate, count: int) -> float:
    """The learning rate of update ``count`` (0-based)."""
    return float(learning_rate(count)) if callable(learning_rate) else float(learning_rate)


def check_optimizer(cfg: Config) -> str:
    """The lower-cased optimizer name."""
    name = cfg.optimizer.lower()
    if name not in ("sgd", "adam", "adamw") + tuple(_ZOO):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return name


def flax_view(p: torch.Tensor) -> torch.Tensor:
    """A port parameter in its flax leaf's axis order (4-D weights to HWIO
    or (kh, kw, out, in); 1-D leaves as they are)."""
    return p.permute(2, 3, 1, 0) if p.dim() == 4 else p


class _Zoo(torch.optim.Optimizer):
    """Frame of the five: gathers each group's parameters with a gradient,
    creates their state on first use and advances the shared count."""

    moments = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))

    def _init_state(self, p: torch.Tensor) -> dict:
        st = {"step": torch.tensor(0.0)}
        for name in self.moments:
            st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                if not self.state[p]:
                    self.state[p] = self._init_state(p)
                states.append(self.state[p])
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            count = int(steps[0])
            grads = [p.grad for p in params]
            bufs = {name: [st[name] for st in states] for name in self.moments}
            self._update(group, count, params, grads, bufs)
        return None

    def _update(self, group, count: int, params: List[torch.Tensor],
                grads: List[torch.Tensor], bufs: dict) -> None:
        raise NotImplementedError


def _adam_moments(mu, nu, grads, b1: float, b2: float) -> None:
    """``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2`` in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)


def _decay_and_apply(params, updates, lr: float, wd: float) -> None:
    """optax ``add_decayed_weights(wd)`` then ``scale_by_learning_rate``:
    ``p -= lr * (u + wd * p)``."""
    if wd:
        torch._foreach_add_(updates, params, alpha=wd)
    torch._foreach_add_(params, updates, alpha=-lr)


class RAdam(_Zoo):
    """optax ``scale_by_radam(b1, b2, eps)``: rectified Adam, the plain
    bias-corrected momentum while ``rho_t < 5``."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                 threshold=5.0):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         threshold=threshold)

    def _update(self, group, count, params, grads, bufs):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, b1, b2)
        dt = np.float64 if params[0].dtype == torch.float64 else _f32
        bc1, b2t = dt(1) - dt(b1) ** dt(count), dt(b2) ** dt(count)
        bc2 = dt(1) - b2t
        ro_inf = dt(2.0 / (1.0 - b2) - 1.0)
        ro = ro_inf - dt(2) * dt(count) * b2t / bc2
        upd = torch._foreach_div(mu, float(bc1))
        if ro >= group["threshold"]:
            r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
            den = torch._foreach_div(nu, float(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_mul_(upd, float(r))
            torch._foreach_div_(upd, den)
        _decay_and_apply(params, upd, group["lr"], group["weight_decay"])


class AdaBelief(_Zoo):
    """optax ``scale_by_belief(b1, b2, eps=1e-16)``: the second moment of
    the prediction error ``g - mu``, plus ``eps_root`` at every update."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-16,
                 eps_root=1e-16):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         eps_root=eps_root)

    def _update(self, group, count, params, grads, bufs):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        err = torch._foreach_sub(grads, mu)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, err, err, value=1 - b2)
        torch._foreach_add_(nu, group["eps_root"])
        dt = np.float64 if params[0].dtype == torch.float64 else _f32
        bc1 = float(dt(1) - dt(b1) ** dt(count))
        bc2 = float(dt(1) - dt(b2) ** dt(count))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        _decay_and_apply(params, upd, group["lr"], group["weight_decay"])


class AdaBound(_Zoo):
    """The JAX package's ``adabound`` (torch_optimizer semantics): L2
    weight decay into the gradient, Adam moments, then ``p -= clip(step /
    (sqrt(nu) + eps), lower, upper) * mu`` with the bounds closing in on
    ``final_lr * lr / base_lr``.  ``scheduled``: the learning rate is a
    float32 schedule value, as JAX's ``final_lr * lr / base`` then is."""

    def __init__(self, params, lr, base_lr, weight_decay=0.0, final_lr=0.1, b1=0.9,
                 b2=0.999, gamma=1e-3, eps=1e-8, scheduled=False):
        super().__init__(params, lr, base_lr=base_lr, weight_decay=weight_decay,
                         final_lr=final_lr, b1=b1, b2=b2, gamma=gamma, eps=eps,
                         scheduled=scheduled)

    def _update(self, group, count, params, grads, bufs):
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, b1, b2)
        t, lr = _f32(count), group["lr"]
        bc1, bc2 = _f32(1) - _f32(b1) ** t, _f32(1) - _f32(b2) ** t
        step_size = _f32(lr) * np.sqrt(bc2) / bc1
        if group["scheduled"]:
            flr = _f32(group["final_lr"]) * _f32(lr) / _f32(group["base_lr"])
        else:
            flr = _f32(group["final_lr"] * lr / group["base_lr"])
        gt = _f32(group["gamma"]) * t
        lower = flr * (_f32(1) - _f32(1) / (gt + _f32(1)))
        upper = flr * (_f32(1) + _f32(1) / gt)
        eta = torch._foreach_sqrt(nu)
        torch._foreach_add_(eta, group["eps"])
        torch._foreach_reciprocal_(eta)
        torch._foreach_mul_(eta, float(step_size))
        torch._foreach_clamp_min_(eta, float(lower))
        torch._foreach_clamp_max_(eta, float(upper))
        torch._foreach_mul_(eta, mu)
        torch._foreach_sub_(params, eta)


class AdamP(_Zoo):
    """The JAX package's ``adamp`` (torch_optimizer semantics): the Adam
    direction with its radial part projected out of parameters that look
    scale-invariant (the largest per-channel cosine between the parameter
    and its gradient under ``delta / sqrt(dim)``), and decoupled weight
    decay scaled by ``wd_ratio`` on those.  Per-channel views on the flax
    leaf (:func:`flax_view`)."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                 delta=0.1, wd_ratio=0.1, scheduled=False):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         delta=delta, wd_ratio=wd_ratio, scheduled=scheduled)

    def _update(self, group, count, params, grads, bufs):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        lr, wd = group["lr"], group["weight_decay"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, b1, b2)
        t = _f32(count)
        bc1, bc2 = _f32(1) - _f32(b1) ** t, _f32(1) - _f32(b2) ** t
        den = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        perturb = torch._foreach_div(mu, float(bc1))
        torch._foreach_div_(perturb, den)
        lr_wd = _f32(_f32(lr) * _f32(wd)) if group["scheduled"] else _f32(lr * wd)
        flat = [i for i, p in enumerate(params) if p.dim() < 2]
        if flat:
            fp = [params[i] for i in flat]
            if wd:  # the decay reads p before the step moves it
                torch._foreach_mul_(fp, 1.0 - float(lr_wd))
            torch._foreach_add_(fp, [perturb[i] for i in flat], alpha=-lr)
        for p, g, u in zip(params, grads, perturb):
            if p.dim() < 2:
                continue
            u, invariant = self._project(p, g, u, eps, group["delta"])
            step = u * -lr
            if wd:
                coef = torch.where(invariant, float(lr_wd * _f32(group["wd_ratio"])),
                                   float(lr_wd))
                step = step - coef * p
            p.add_(step)

    @staticmethod
    def _project(p, g, u, eps, delta):
        pv = flax_view(p)
        shape = pv.shape
        pv = pv.reshape(shape[0], -1)
        gv = flax_view(g).reshape(shape[0], -1)
        pn = pv / (torch.linalg.vector_norm(pv, dim=1, keepdim=True) + eps)
        gn = gv / (torch.linalg.vector_norm(gv, dim=1, keepdim=True) + eps)
        cosim = torch.abs(torch.sum(pn * gn, dim=1))
        invariant = torch.max(cosim) < delta / math.sqrt(pv.shape[1])
        tv = flax_view(u).reshape(shape[0], -1)
        projected = tv - pn * torch.sum(pn * tv, dim=1, keepdim=True)
        out = torch.where(invariant, projected, tv).reshape(shape).permute(3, 2, 0, 1)
        return out, invariant


class NovoGrad(_Zoo):
    """``optax.novograd(lr, b1=0.95, b2=0.98, eps=1e-8, weight_decay)``: a
    scalar second moment per parameter, ``nu = |g|^2`` at the first update
    and ``b2 nu + (1 - b2) |g|^2`` after; ``mu = g / (sqrt(nu) + eps) + wd
    p`` at the first and ``b1 mu + (that)`` after; ``p -= lr mu``."""

    def __init__(self, params, lr, weight_decay=0.0, b1=0.95, b2=0.98, eps=1e-8):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)

    def _init_state(self, p):
        return {"step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros((1,), dtype=p.dtype, device=p.device)}

    def _update(self, group, count, params, grads, bufs):
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        norms = torch._foreach_norm(grads)
        sq = [n.reshape(1) for n in torch._foreach_mul(norms, norms)]
        if count == 1:
            torch._foreach_copy_(nu, sq)
        else:
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq, alpha=1 - b2)
        den = torch._foreach_sqrt(nu)
        torch._foreach_add_(den, group["eps"])
        add = torch._foreach_div(grads, den)
        if wd:
            torch._foreach_add_(add, params, alpha=wd)
        if count == 1:
            torch._foreach_copy_(mu, add)
        else:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, add)
        torch._foreach_add_(params, mu, alpha=-group["lr"])


_ZOO = {"radam": RAdam, "adabelief": AdaBelief, "adabound": AdaBound, "adamp": AdamP,
        "novograd": NovoGrad}


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                    learning_rate: LearningRate) -> torch.optim.Optimizer:
    """Optimizer factory keyed on ``--optimizer`` (reference plt.py:150-160)."""
    name = check_optimizer(cfg)
    lr0 = lr_at(learning_rate, 0)
    wd = cfg.weight_decay
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum, nesterov=False)
    if name in ("adam", "adamw"):
        return torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=wd)
    if name == "adabound":
        return AdaBound(params, lr0, base_lr=cfg.lr, weight_decay=wd,
                        scheduled=callable(learning_rate))
    if name == "adamp":
        return AdamP(params, lr0, weight_decay=wd, scheduled=callable(learning_rate))
    return _ZOO[name](params, lr0, weight_decay=wd)
