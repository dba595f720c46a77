"""Optimizers of the train step (port of ``build_optimizer`` of
``xview2_tpu/train/optimizers.py``).

* ``adamw`` / ``adam``: ``torch.optim.AdamW`` with betas (0.9, 0.999), eps
  1e-8 and decoupled weight decay on every parameter, which is what
  ``optax.adamw`` computes (the JAX package maps apex FusedAdam's
  ``adam_w_mode`` onto the same rule, so both names are one optimizer);
* ``sgd``: ``torch.optim.SGD`` with momentum, no Nesterov, no weight decay
  (``optax.sgd`` takes none).

The other five (radam, adabelief, adabound, adamp, novograd) are not ported
yet (ROADMAP Queue 1, optimizers).  The learning rate is a float or a
schedule ``count -> lr``; the train step sets it once per update.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

from xview2_tpu_torch.config import Config

LearningRate = Union[float, Callable[[int], float]]


def lr_at(learning_rate: LearningRate, count: int) -> float:
    """The learning rate of update ``count`` (0-based)."""
    return float(learning_rate(count)) if callable(learning_rate) else float(learning_rate)


def check_optimizer(cfg: Config) -> str:
    """The lower-cased optimizer name, or ``NotImplementedError`` for the
    ones that are not ported."""
    name = cfg.optimizer.lower()
    if name not in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"--optimizer {cfg.optimizer} is not ported to "
                                  "xview2_tpu_torch yet (ROADMAP Queue 1, optimizers)")
    return name


def build_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                    learning_rate: LearningRate) -> torch.optim.Optimizer:
    """Optimizer factory keyed on ``--optimizer`` (reference plt.py:150-160)."""
    name = check_optimizer(cfg)
    lr0 = lr_at(learning_rate, 0)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr0, momentum=cfg.momentum, nesterov=False)
    return torch.optim.AdamW(params, lr=lr0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)
