"""What the benchmark takes from the program under test, ``xview2_tpu_torch``:
its ``Config``, a ``Runner`` with the trainer's own per-batch calls, the
step generator ``fit`` hands each train call, and the F1 state the eval
calls thread.  Nothing else of the port is imported by the harness."""

from __future__ import annotations

from typing import Dict

import torch


def make_config(spec: dict, seed: int, eval_mode: bool):
    """The port's ``Config`` of a configuration file's ``program`` fields;
    ``eval_mode`` sets what ``test`` sets for ``--eval_tta on
    --eval_fused_tail on``."""
    from xview2_tpu_torch.config import Config

    fields = dict(spec, seed=seed)
    if eval_mode:
        fields.update(exec_mode="eval", tta=True)
    return Config(**fields)


def make_runner(cfg, device: torch.device):
    """``Runner(cfg)`` with the device as the default device while it builds,
    so that its initial model is drawn there and not on the host."""
    from xview2_tpu_torch.train.trainer import Runner

    with torch.device(device):
        return Runner(cfg, 1, device=device)


@torch.no_grad()
def load_state(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> None:
    model.load_state_dict(state, strict=True)


def train_call(runner, images, masks) -> torch.Tensor:
    """One batch of ``fit``'s loop; returns the loss (on the device)."""
    from xview2_tpu_torch.parallel.steps import step_generator

    rng = step_generator(runner.cfg, runner.state.step, runner.device)
    runner.state, loss = runner.train_step(runner.state, images, masks, rng)
    return loss


def init_f1(runner):
    from xview2_tpu_torch.ops.metrics import init_f1_state

    return init_f1_state(runner.cfg.n_metric_class, device=runner.device)


def eval_call(runner, f1_state, images, masks, valid):
    """One batch of ``run_eval`` / ``test``: ``(f1_state, loss, logits)``."""
    return runner.eval_step(f1_state, images, masks, valid)


def f1_tensor(f1_state) -> torch.Tensor:
    """tp, fp, fn as one (3, classes) tensor."""
    return torch.stack([f1_state.tp, f1_state.fp, f1_state.fn])
