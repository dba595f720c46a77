"""The port's spans (``xview2_tpu_torch/utils/spans.py``) on the CPU: off
outside a profiler, and inside one the train step's and the eval step's
phases in order, each once a step, in the registry and in the profiler's
chrome trace as host ``user_annotation`` events.  The device side (the event
pairs, a CUDA graph's capture and replay) runs only on the card
(``tests/test_torch_cuda.py``, ``xv2bench``'s traced runs)."""

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xview2_tpu_torch.config import Config, apply_precision
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.metrics import init_f1_state
from xview2_tpu_torch.parallel import steps
from xview2_tpu_torch.train.optimizers import build_optimizer
from xview2_tpu_torch.utils import spans

TILE, CROP = 64, 32
TRAIN = ["train.step", "train.h2d", "train.augment", "augment.sync", "train.forward",
         "train.backward", "train.update"]
EVAL = ["eval.step", "eval.h2d", "eval.forward", "eval.score"]


def _raw(k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (k, 2, TILE, TILE, 3), np.uint8),
            (rng.random((k, 2, TILE, TILE)) > 0.8).astype(np.uint8))


@pytest.fixture(scope="module")
def program():
    """A float32 ResNet-50 ``UNetLoc`` (fused tail, ``--autoaugment``), its
    train step, its eval step and its multistep of 2 steps."""
    cfg = Config(type="pre", encoder="resnet50", precision=32, fused_tail=True,
                 autoaugment=True, batch_size=2)
    apply_precision(cfg)
    torch.manual_seed(0)
    model = build_model(cfg)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    state = steps.init_train_state(model, opt, device="cpu")
    train = steps.make_train_step(cfg, model, opt, crop=CROP, device="cpu")
    evaluate = steps.make_eval_step(cfg.replace(tta=True), model, device="cpu")
    multi = steps.make_train_multistep(cfg, model, opt, 2, crop=CROP, device="cpu")
    return cfg, state, train, evaluate, multi


def _train(program, seed=0):
    cfg, state, train, _, _ = program
    images, masks = _raw(1, seed)
    train(state, images[0], masks[0], steps.step_generator(cfg, state.step, "cpu"))


def _eval(program):
    cfg, _, _, evaluate, _ = program
    images, masks = _raw(1, 1)
    evaluate(init_f1_state(cfg.n_metric_class), images[0], masks[0], np.ones(2, np.float32))


def _profiled(fn, path=None):
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = spans.summary()
    names = None
    if path is not None:
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
    return got, names


def test_spans_are_off_outside_a_profiler(program):
    spans.reset()
    assert spans.span("train.step") is spans.span("eval.step")  # the shared no-op
    _train(program)
    _eval(program)
    assert spans.summary() == {}


def _holds_its_children(got, names):
    step = got[names[0]]
    assert step.parent is None and step.calls == step.steps == 1
    children = [n for n in names[1:] if got[n].parent == names[0]]
    assert step.self_host_s == pytest.approx(
        step.host_s - sum(got[n].host_s for n in children), abs=1e-9)
    assert sum(got[n].host_s for n in children) <= step.host_s


def test_the_train_step_records_its_phases_in_order(program, tmp_path):
    got, annotated = _profiled(lambda: _train(program, 3), tmp_path / "trace.json")
    assert list(got) == TRAIN
    assert all(got[n].calls == 1 and got[n].steps == 1 for n in TRAIN)
    assert [got[n].parent for n in TRAIN] == [None] + ["train.step"] * 2 + \
        ["train.augment"] + ["train.step"] * 3
    assert all(got[n].device_s is None and got[n].host_s > 0 for n in TRAIN)
    _holds_its_children(got, TRAIN)
    assert set(TRAIN) <= annotated


def test_the_eval_step_records_its_phases_in_order(program, tmp_path):
    got, annotated = _profiled(lambda: _eval(program), tmp_path / "trace.json")
    assert list(got) == EVAL
    assert [got[n].parent for n in EVAL] == [None] + ["eval.step"] * 3
    assert all(got[n].calls == 1 and got[n].device_s is None for n in EVAL)
    _holds_its_children(got, EVAL)
    assert set(EVAL) <= annotated


def test_a_cpu_step_records_no_events_where_cuda_is_initialised(program, monkeypatch):
    """A span times the device only where its step runs on CUDA, not
    wherever CUDA is initialised in the process."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    got, _ = _profiled(lambda: _train(program, 4))
    assert list(got) == TRAIN and all(got[n].device_s is None for n in TRAIN)


def test_the_multistep_on_the_cpu_records_k_train_steps(program):
    cfg, state, _, _, multi = program
    images, masks = _raw(2, 5)
    got, _ = _profiled(lambda: multi(state, images, masks))
    assert got["train.step"].calls == got["train.step"].steps == 2
    assert all(got[n].calls == 2 and got[n].steps == 2 for n in TRAIN[1:])


def test_nesting_self_time_steps_and_reset():
    """Spans nest, each outermost span is a step, a name's calls over
    several steps count once a step, a thread the profiler does not collect
    records nothing, and ``reset`` forgets them."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with spans.span("a"):
                with spans.span("b"):
                    with spans.span("c"):
                        pass
                    with spans.span("c"):
                        pass
        seen = []
        worker = threading.Thread(target=lambda: seen.append(_in_thread()))
        with spans.span("x"):
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive() and seen == [None]
    got = spans.summary()
    assert list(got) == ["a", "b", "c", "x"]
    assert (got["a"].calls, got["a"].steps, got["a"].parent) == (3, 3, None)
    assert (got["b"].calls, got["b"].steps, got["b"].parent) == (3, 3, "a")
    assert (got["c"].calls, got["c"].steps, got["c"].parent) == (6, 3, "b")
    assert got["b"].self_host_s == pytest.approx(got["b"].host_s - got["c"].host_s, abs=1e-9)
    assert got["c"].self_host_s == pytest.approx(got["c"].host_s, abs=1e-9)
    spans.reset()
    assert spans.summary() == {}


def _in_thread():
    with spans.span("t"):
        return None
