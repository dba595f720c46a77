"""Optimizers of the train step (port of ``build_optimizer`` of
``xview2_tpu/train/optimizers.py``).

* ``adamw`` / ``adam``: ``optax.adamw`` with betas (0.9, 0.999), eps 1e-8
  and decoupled weight decay on every parameter (the JAX package maps apex
  FusedAdam's ``adam_w_mode`` onto the same rule, so both names are one
  optimizer; ``torch.optim.AdamW`` computes it in another order);
* ``sgd``: ``optax.sgd`` with momentum, no Nesterov, no weight decay (the
  state is torch's ``momentum_buffer``);
* ``radam``, ``adabelief``, ``adabound``, ``adamp``, ``novograd``: the JAX
  package's updates: optax's ``scale_by_radam`` (rectification threshold 5)
  and ``scale_by_belief`` (eps 1e-16, eps_root 1e-16), each followed by
  ``add_decayed_weights`` and the learning rate; the JAX package's
  hand-written AdaBound and AdamP, whose scalar coefficients it computes in
  float32 (``count.astype(float32)``), so these compute them in float32
  too; ``optax.novograd`` with betas (0.95, 0.98), whose second moment is
  ONE scalar per parameter (every port parameter is one flax leaf).

All seven are ``torch.optim.Optimizer`` classes on one frame, :class:`_Zoo`:
the host computes each update's scalars (learning rate, bias corrections,
the branches that the count decides) and writes them into a small device
table, and the update reads them from there, in the eager step as in a CUDA
graph of K steps (``parallel/steps.make_train_multistep``), which replays
the same device operations on new table rows.

AdamP takes its per-channel view on the flax leaf: ``x.reshape(x.shape[0],
-1)`` of an HWIO kernel groups by kernel ROW, so a 4-D port weight (OIHW,
or a transposed conv's (in, out, kh, kw), the same permutation in
``weights.py``) is viewed as ``weight.permute(2, 3, 1, 0)``.

The elementwise updates run over all the parameters of a group at once
(``torch._foreach_*``); AdamP's projection is per 4-D parameter, with no
host synchronisation.  Each parameter's state holds ``step`` (a CPU scalar,
advanced by the host; SGD's none, as torch's) and its moments as tensors, which
``parallel/checkpoint.py`` saves and restores (NovoGrad's per-leaf second
moment has shape (1,)).  The learning rate is a float or a schedule ``count
-> lr``; the train step sets it once per update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

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
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return name


def flax_view(p: torch.Tensor) -> torch.Tensor:
    """A port parameter in its flax leaf's axis order (4-D weights to HWIO
    or (kh, kw, out, in); 1-D leaves as they are)."""
    return p.permute(2, 3, 1, 0) if p.dim() == 4 else p


class _Zoo(torch.optim.Optimizer):
    """Frame of the seven: gathers each group's parameters with a gradient,
    creates their state on first use, advances the shared count and hands
    each update its per-step scalars as 0-dim views of a device table.

    An update is split in two.  :meth:`prepare` runs on the host: it
    computes the scalars of the next ``n`` updates of every group (the
    learning rate, the bias corrections, whatever the count decides) in the
    parameters' dtype, copies them into the group's ``(n, len(scalars))``
    table on the parameters' device and advances the counts.
    :meth:`apply` runs update ``k`` of the prepared ones with device
    operations only, reading row ``k``; a branch on the count is a select
    by table entries.  :meth:`step` is ``prepare`` of one update and
    ``apply(0)``; a CUDA graph of K train steps captures ``apply(0..K-1)``
    once, and before each replay ``prepare`` writes the K rows (the same
    table, the same numbers as K calls of :meth:`step`)."""

    moments = ("exp_avg", "exp_avg_sq")
    scalars: Tuple[str, ...] = ()
    counted = True  # the state holds the update count, "step" (SGD's has none, as torch's)

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))
        self._tables: Dict[Tuple[int, int], torch.Tensor] = {}
        self._prepared: List[Tuple[int, torch.Tensor]] = []

    def _init_state(self, p: torch.Tensor, count: int) -> dict:
        st = {"step": torch.tensor(float(count))} if self.counted else {}
        for name in self.moments:
            st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return st

    def host_scalars(self, group: dict, count: int, dt) -> tuple:
        """The values of :attr:`scalars` for update ``count`` (1-based) of
        ``group`` at ``group["lr"]``, as ``dt`` (numpy float32 or float64)."""
        raise NotImplementedError

    def _table(self, gi: int, n: int, like: torch.Tensor) -> torch.Tensor:
        t = self._tables.get((gi, n))
        if t is None or t.device != like.device or t.dtype != like.dtype:
            t = torch.zeros((n, len(self.scalars)), dtype=like.dtype, device=like.device)
            self._tables[(gi, n)] = t
        return t

    @torch.no_grad()
    def prepare(self, lrs: Optional[Sequence[float]] = None, advance: bool = True) -> None:
        """Write the scalars of the next ``len(lrs)`` updates (one at each
        group's ``lr`` when ``lrs`` is None) into the device tables and, with
        ``advance``, count them."""
        n = 1 if lrs is None else len(lrs)
        self._prepared = []
        for gi, group in enumerate(self.param_groups):
            p0 = group["params"][0]
            dt = np.float64 if p0.dtype == torch.float64 else _f32
            states = [self.state[p] for p in group["params"] if self.state.get(p)]
            if not self.counted:
                states = []
            for st in states:
                st.setdefault("step", torch.tensor(0.0))
            c0 = int(states[0]["step"]) if states else 0
            rows = [self.host_scalars(group if lrs is None else dict(group, lr=lrs[k]),
                                      c0 + k + 1, dt) for k in range(n)]
            if lrs is not None:
                group["lr"] = lrs[-1]
            table = self._table(gi, n, p0)
            host = torch.from_numpy(np.asarray(rows, dt))
            if table.is_cuda:  # pinned: the copy is ordered on the stream
                host = host.pin_memory()
            table.copy_(host, non_blocking=True)
            if advance and states:
                torch._foreach_add_([st["step"] for st in states], float(n))
            self._prepared.append((c0, table))

    @torch.no_grad()
    def apply(self, k: int = 0) -> None:
        """Update ``k`` of the prepared ones, on the gradients as they are."""
        for group, (c0, table) in zip(self.param_groups, self._prepared):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state.get(p):
                    if p.is_cuda and torch.cuda.is_current_stream_capturing():
                        raise RuntimeError(f"{type(self).__name__}: a parameter without "
                                           "optimizer state inside a CUDA graph capture "
                                           "(run an eager step first)")
                    self.state[p] = self._init_state(p, c0 + k + 1)
            states = [self.state[p] for p in params]
            bufs = {name: [st[name] for st in states] for name in self.moments}
            self._update(group, dict(zip(self.scalars, table[k].unbind())), params,
                         [p.grad for p in params], bufs)

    def step(self, closure=None):
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        self.prepare()
        self.apply(0)
        return None

    def _update(self, group, sc: dict, params: List[torch.Tensor],
                grads: List[torch.Tensor], bufs: dict) -> None:
        """One update; ``sc`` maps :attr:`scalars` to 0-dim device tensors
        (or to the same values as Python floats: the host-scalar form)."""
        raise NotImplementedError


def _adam_moments(mu, nu, grads, b1: float, b2: float) -> None:
    """``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2`` in place."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)


def _bias_corrections(b1: float, b2: float, count: int, dt) -> Tuple:
    """``1 - b1^t`` and ``1 - b2^t`` in ``dt``."""
    return dt(1) - dt(b1) ** dt(count), dt(1) - dt(b2) ** dt(count)


def _decay_and_apply(params, updates, lr, wd: float) -> None:
    """optax ``add_decayed_weights(wd)`` then ``scale_by_learning_rate``:
    ``p -= lr * (u + wd * p)``."""
    if wd:
        torch._foreach_add_(updates, params, alpha=wd)
    torch._foreach_mul_(updates, lr)
    torch._foreach_sub_(params, updates)


class AdamW(_Zoo):
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``: the bias-corrected
    Adam direction plus decoupled weight decay, times the learning rate."""

    scalars = ("lr", "bc1", "bc2")

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)

    def host_scalars(self, group, count, dt):
        return (dt(group["lr"]),) + _bias_corrections(group["b1"], group["b2"], count, dt)

    def _update(self, group, sc, params, grads, bufs):
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, group["b1"], group["b2"])
        den = torch._foreach_div(nu, sc["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, sc["bc1"])
        torch._foreach_div_(upd, den)
        _decay_and_apply(params, upd, sc["lr"], group["weight_decay"])


class SGD(_Zoo):
    """``optax.sgd(lr, momentum)``: ``m = momentum m + g``, ``p -= lr m``
    (no Nesterov, no weight decay; torch's ``momentum_buffer``)."""

    moments = ("momentum_buffer",)
    scalars = ("lr",)
    counted = False

    def __init__(self, params, lr, momentum=0.0):
        super().__init__(params, lr, momentum=momentum)

    def host_scalars(self, group, count, dt):
        return (dt(group["lr"]),)

    def _update(self, group, sc, params, grads, bufs):
        m = bufs["momentum_buffer"]
        torch._foreach_mul_(m, group["momentum"])
        torch._foreach_add_(m, grads)
        upd = torch._foreach_mul(m, sc["lr"])
        torch._foreach_sub_(params, upd)


class RAdam(_Zoo):
    """optax ``scale_by_radam(b1, b2, eps)``: rectified Adam, the plain
    bias-corrected momentum while ``rho_t < 5``.  The branch is a select by
    the table: ``r`` is the rectification (1 while unrectified), and ``on``
    and ``off`` (1 and 0, or 0 and 1) keep the update ``upd r / den`` or
    ``upd`` exactly."""

    scalars = ("lr", "bc1", "bc2", "r", "on", "off")

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                 threshold=5.0):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         threshold=threshold)

    def host_scalars(self, group, count, dt):
        b2 = group["b2"]
        bc1, bc2 = _bias_corrections(group["b1"], b2, count, dt)
        ro_inf = dt(2.0 / (1.0 - b2) - 1.0)
        ro = ro_inf - dt(2) * dt(count) * (dt(b2) ** dt(count)) / bc2
        if ro >= group["threshold"]:
            r = np.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
            return dt(group["lr"]), bc1, bc2, dt(r), dt(1), dt(0)
        return dt(group["lr"]), bc1, bc2, dt(1), dt(0), dt(1)

    def _update(self, group, sc, params, grads, bufs):
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, group["b1"], group["b2"])
        upd = torch._foreach_div(mu, sc["bc1"])
        den = torch._foreach_div(nu, sc["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        # the select, by multiplications (torch 2.11's _foreach_add_ of a device scalar
        # refuses CUDA graph capture): rectified upd r / den plus upd 0, or upd plus 0
        rect = torch._foreach_mul(upd, sc["r"])
        torch._foreach_div_(rect, den)
        torch._foreach_mul_(rect, sc["on"])
        torch._foreach_mul_(upd, sc["off"])
        torch._foreach_add_(upd, rect)
        _decay_and_apply(params, upd, sc["lr"], group["weight_decay"])


class AdaBelief(_Zoo):
    """optax ``scale_by_belief(b1, b2, eps=1e-16)``: the second moment of
    the prediction error ``g - mu``, plus ``eps_root`` at every update."""

    scalars = ("lr", "bc1", "bc2")

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-16,
                 eps_root=1e-16):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         eps_root=eps_root)

    def host_scalars(self, group, count, dt):
        return (dt(group["lr"]),) + _bias_corrections(group["b1"], group["b2"], count, dt)

    def _update(self, group, sc, params, grads, bufs):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        err = torch._foreach_sub(grads, mu)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, err, err, value=1 - b2)
        torch._foreach_add_(nu, group["eps_root"])
        den = torch._foreach_div(nu, sc["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        upd = torch._foreach_div(mu, sc["bc1"])
        torch._foreach_div_(upd, den)
        _decay_and_apply(params, upd, sc["lr"], group["weight_decay"])


class AdaBound(_Zoo):
    """The JAX package's ``adabound`` (torch_optimizer semantics): L2
    weight decay into the gradient, Adam moments, then ``p -= clip(step /
    (sqrt(nu) + eps), lower, upper) * mu`` with the bounds closing in on
    ``final_lr * lr / base_lr``.  ``scheduled``: the learning rate is a
    float32 schedule value, as JAX's ``final_lr * lr / base`` then is."""

    scalars = ("step_size", "lower", "upper")

    def __init__(self, params, lr, base_lr, weight_decay=0.0, final_lr=0.1, b1=0.9,
                 b2=0.999, gamma=1e-3, eps=1e-8, scheduled=False):
        super().__init__(params, lr, base_lr=base_lr, weight_decay=weight_decay,
                         final_lr=final_lr, b1=b1, b2=b2, gamma=gamma, eps=eps,
                         scheduled=scheduled)

    def host_scalars(self, group, count, dt):
        t, lr = _f32(count), group["lr"]
        bc1, bc2 = _bias_corrections(group["b1"], group["b2"], count, _f32)
        step_size = _f32(lr) * np.sqrt(bc2) / bc1
        if group["scheduled"]:
            flr = _f32(group["final_lr"]) * _f32(lr) / _f32(group["base_lr"])
        else:
            flr = _f32(group["final_lr"] * lr / group["base_lr"])
        gt = _f32(group["gamma"]) * t
        lower = flr * (_f32(1) - _f32(1) / (gt + _f32(1)))
        upper = flr * (_f32(1) + _f32(1) / gt)
        return dt(step_size), dt(lower), dt(upper)

    def _update(self, group, sc, params, grads, bufs):
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        if wd:
            grads = torch._foreach_add(grads, params, alpha=wd)
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, b1, b2)
        # eta in one flat buffer, so the clamp by device scalars is one launch
        # (the _foreach clamps take Python numbers only)
        flat = torch.cat([n.reshape(-1) for n in nu])
        flat.sqrt_().add_(group["eps"]).reciprocal_().mul_(sc["step_size"])
        flat.clamp_(min=sc["lower"], max=sc["upper"])
        eta = [e.view_as(n) for e, n in zip(flat.split([n.numel() for n in nu]), nu)]
        torch._foreach_mul_(eta, mu)
        torch._foreach_sub_(params, eta)


class AdamP(_Zoo):
    """The JAX package's ``adamp`` (torch_optimizer semantics): the Adam
    direction with its radial part projected out of parameters that look
    scale-invariant (the largest per-channel cosine between the parameter
    and its gradient under ``delta / sqrt(dim)``), and decoupled weight
    decay scaled by ``wd_ratio`` on those.  Per-channel views on the flax
    leaf (:func:`flax_view`)."""

    scalars = ("lr", "bc1", "bc2", "keep", "decay", "decay_invariant")

    def __init__(self, params, lr, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8,
                 delta=0.1, wd_ratio=0.1, scheduled=False):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                         delta=delta, wd_ratio=wd_ratio, scheduled=scheduled)

    def host_scalars(self, group, count, dt):
        lr, wd = group["lr"], group["weight_decay"]
        bc1, bc2 = _bias_corrections(group["b1"], group["b2"], count, _f32)
        lr_wd = _f32(_f32(lr) * _f32(wd)) if group["scheduled"] else _f32(lr * wd)
        return (dt(lr), dt(bc1), dt(bc2), dt(1.0 - float(lr_wd)), dt(lr_wd),
                dt(lr_wd * _f32(group["wd_ratio"])))

    def _update(self, group, sc, params, grads, bufs):
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        wd = group["weight_decay"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        _adam_moments(mu, nu, grads, b1, b2)
        den = torch._foreach_div(nu, sc["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        perturb = torch._foreach_div(mu, sc["bc1"])
        torch._foreach_div_(perturb, den)
        flat = [i for i, p in enumerate(params) if p.dim() < 2]
        if flat:
            fp = [params[i] for i in flat]
            if wd:  # the decay reads p before the step moves it
                torch._foreach_mul_(fp, sc["keep"])
            upd = torch._foreach_mul([perturb[i] for i in flat], sc["lr"])
            torch._foreach_sub_(fp, upd)
        for p, g, u in zip(params, grads, perturb):
            if p.dim() < 2:
                continue
            u, invariant = self._project(p, g, u, eps, group["delta"])
            step = u * sc["lr"]
            if wd:
                coef = torch.where(invariant, sc["decay_invariant"], sc["decay"])
                step = step + coef * p
            p.sub_(step)

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
    p`` at the first and ``b1 mu + (that)`` after; ``p -= lr mu``.  The
    first update is a select by the table: the old moments are scaled by 0
    (``nu_keep``, ``mu_keep``) and ``|g|^2`` by 1 (``nu_new``)."""

    scalars = ("lr", "nu_keep", "nu_new", "mu_keep")

    def __init__(self, params, lr, weight_decay=0.0, b1=0.95, b2=0.98, eps=1e-8):
        super().__init__(params, lr, weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)

    def _init_state(self, p, count):
        return {"step": torch.tensor(float(count)),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros((1,), dtype=p.dtype, device=p.device)}

    def host_scalars(self, group, count, dt):
        if count == 1:
            return dt(group["lr"]), dt(0), dt(1), dt(0)
        return dt(group["lr"]), dt(group["b2"]), dt(1 - group["b2"]), dt(group["b1"])

    def _update(self, group, sc, params, grads, bufs):
        wd = group["weight_decay"]
        mu, nu = bufs["exp_avg"], bufs["exp_avg_sq"]
        norms = torch._foreach_norm(grads)
        sq = [n.reshape(1) for n in torch._foreach_mul(norms, norms)]
        torch._foreach_mul_(nu, sc["nu_keep"])
        torch._foreach_mul_(sq, sc["nu_new"])
        torch._foreach_add_(nu, sq)
        den = torch._foreach_sqrt(nu)
        torch._foreach_add_(den, group["eps"])
        add = torch._foreach_div(grads, den)
        if wd:
            torch._foreach_add_(add, params, alpha=wd)
        torch._foreach_mul_(mu, sc["mu_keep"])
        torch._foreach_add_(mu, add)
        upd = torch._foreach_mul(mu, sc["lr"])
        torch._foreach_sub_(params, upd)


_ZOO = {"radam": RAdam, "adabelief": AdaBelief, "adabound": AdaBound, "adamp": AdamP,
        "novograd": NovoGrad}
OPTIMIZERS = ("sgd", "adam", "adamw") + tuple(_ZOO)


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                    learning_rate: LearningRate) -> torch.optim.Optimizer:
    """Optimizer factory keyed on ``--optimizer`` (reference plt.py:150-160)."""
    name = check_optimizer(cfg)
    lr0 = lr_at(learning_rate, 0)
    wd = cfg.weight_decay
    if name == "sgd":
        return SGD(params, lr0, momentum=cfg.momentum)
    if name in ("adam", "adamw"):
        return AdamW(params, lr0, weight_decay=wd)
    if name == "adabound":
        return AdaBound(params, lr0, base_lr=cfg.lr, weight_decay=wd,
                        scheduled=callable(learning_rate))
    if name == "adamp":
        return AdamP(params, lr0, weight_decay=wd, scheduled=callable(learning_rate))
    return _ZOO[name](params, lr0, weight_decay=wd)
