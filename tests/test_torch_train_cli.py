"""The port's train CLI on the CPU, on a tiny synthetic tree: one epoch
writes the ``best``/``last`` checkpoints (with optimizer state) and the epoch
line of ``logs.json``; the checkpoint reloads through the eval CLI; and 1 + 1
resumed epochs equal 2 unbroken ones BIT FOR BIT (same host, same thread
count: the port's CPU path is deterministic, and a step's random stream
depends only on the seed and the global step).  The same with
``--autoaugment`` (the crop, one AutoAugment draw per sample through the
row-shift kernel's plain version, normalize)."""

import json
import os
import shutil

import numpy as np
import pytest

from xview2_tpu_torch.data.synthetic import make_synthetic_dataset
from xview2_tpu_torch.main import main
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib

SIZE = 96
BASE = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50", "--precision", "32",
        "--fused_tail", "1", "--batch_size", "2", "--val_batch_size", "2", "--num_workers", "2",
        "--train_crop", "64", "--use_scheduler", "--warmup", "1", "--epochs", "2"]


def _logs(results):
    with open(os.path.join(results, "logs.json")) as f:
        return [json.loads(line) for line in f]


def _drop_best(results):
    """Remove a leg's ``best`` checkpoint, which no test reads."""
    shutil.rmtree(os.path.join(results, "checkpoints", "best"))


def _differing(want, got):
    """Keys whose arrays are not equal as ``np.testing.assert_array_equal``
    compares them."""
    out = []
    for key in want:
        try:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        except AssertionError:
            out.append(key)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two unbroken epochs, one epoch that stops, one epoch resumed from it,
    and the eval CLI on the stopped run's ``last`` checkpoint.  What the
    tests assert is read here, and the tree is removed at once: each
    checkpoint with optimizer state is about 470 MB."""
    root = str(tmp_path_factory.mktemp("xbd"))
    make_synthetic_dataset(root, n_train=4, n_val=2, n_test=2, size=SIZE, seed=3)
    res = {k: os.path.join(root, k) for k in ("unbroken", "first", "resumed")}
    common = BASE + ["--data", root]
    out = {"rc": {}}
    out["rc"]["unbroken"] = main(common + ["--results", res["unbroken"]], device="cpu")
    _drop_best(res["unbroken"])
    # the Noam schedule depends on --epochs, so the first leg declares two
    # epochs as well; --patience 0 stops it after the first, which leaves the
    # `last` checkpoint an interrupted two-epoch run would resume from
    out["rc"]["first"] = main(common + ["--results", res["first"], "--patience", "0",
                                        "--profile"], device="cpu")
    out["first_logs"] = _logs(res["first"])
    out["first_ckpts"] = {}
    for name in ("best", "last"):
        path = os.path.join(res["first"], "checkpoints", name)
        entry = {"exists": ckpt_lib.checkpoint_exists(path)}
        if entry["exists"]:
            payload, meta = ckpt_lib.restore_raw(path)
            bufs = payload["opt_state"]["unet.enc_l1.conv1.weight"]
            entry.update(epoch=meta["epoch"], fused_tail=bool(meta["config"]["fused_tail"]),
                         step=int(payload["train"]["step"]), buffers=set(bufs),
                         exp_avg_max=float(np.abs(bufs["exp_avg"]).max()))
        out["first_ckpts"][name] = entry
    # --profile: a torch.profiler trace of the first steps, stopped at loop exit
    out["trace_bytes"] = os.path.getsize(os.path.join(res["first"], "profile", "trace.json"))
    with open(os.path.join(res["first"], "profile", "spans.json")) as f:
        out["spans"] = json.load(f)
    _drop_best(res["first"])

    ev = os.path.join(root, "eval_out")
    out["eval_rc"] = main(["--exec_mode", "eval", "--type", "pre", "--data", root, "--results",
                           ev, "--ckpt", os.path.join(res["first"], "checkpoints", "last"),
                           "--val_batch_size", "2", "--num_workers", "2"], device="cpu")
    out["eval_probs"] = len(os.listdir(os.path.join(ev, "probs")))
    out["eval_logs"] = _logs(ev)

    out["rc"]["resumed"] = main(common + ["--results", res["resumed"], "--ckpt",
                                          os.path.join(res["first"], "checkpoints", "last")],
                                device="cpu")
    _drop_best(res["resumed"])
    want, _ = ckpt_lib.restore_raw(os.path.join(res["unbroken"], "checkpoints", "last"))
    got, out["meta_resumed"] = ckpt_lib.restore_raw(os.path.join(res["resumed"], "checkpoints",
                                                                 "last"))
    out["step_resumed"] = int(got["train"]["step"])
    want, got = dict(_flat(want)), dict(_flat(got))
    out["same_keys"] = set(want) == set(got)
    out["has_opt_state"] = any(k.startswith("opt_state/") for k in got)
    out["differing"] = _differing(want, got)
    out["logs"] = {k: _logs(res[k]) for k in ("unbroken", "resumed")}
    shutil.rmtree(root)
    return out


def test_one_epoch_writes_checkpoints_and_log(runs):
    assert runs["rc"]["first"] == 0
    logs = runs["first_logs"]
    assert [entry["step"] for entry in logs] == [0]
    data = logs[0]["data"]
    assert set(data) == {"f1", "val_loss", "top_f1", "imgs_per_sec", "loader_wait_s"}
    assert np.isfinite(data["val_loss"]) and data["imgs_per_sec"] > 0
    for name in ("best", "last"):
        ck = runs["first_ckpts"][name]
        assert ck["exists"]
        assert ck["epoch"] == 0 and ck["fused_tail"]
        assert ck["step"] == 2  # 4 tiles / batch 2
        assert ck["buffers"] == {"step", "exp_avg", "exp_avg_sq"}
        assert ck["exp_avg_max"] > 0
    assert runs["trace_bytes"] > 0


def test_profile_writes_the_spans_and_the_epoch_line_the_loader_wait(runs):
    """``--profile`` writes ``profile/spans.json`` beside the trace: the
    spans of the profiled steps (both of the epoch's train steps, then the
    validation's eval step, since the run ends before 6 steps), and the
    epoch line counts the seconds the steps waited for the loader."""
    assert runs["first_logs"][0]["data"]["loader_wait_s"] >= 0
    spans = runs["spans"]
    assert spans["train.step"]["calls"] == 2 and spans["train.step"]["parent"] is None
    for name in ("train.h2d", "train.augment", "train.forward", "train.backward",
                 "train.update"):
        assert spans[name]["calls"] == 2 and spans[name]["parent"] == "train.step", name
    assert spans["eval.step"]["calls"] == 1
    assert all(v["device_s"] is None and v["host_s"] >= v["self_host_s"] >= 0
               for v in spans.values())


def test_checkpoint_reloads_through_the_eval_cli(runs):
    assert runs["eval_rc"] == 0
    assert runs["eval_probs"] == 2
    assert np.isfinite(runs["eval_logs"][-1]["data"]["f1"])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_resumed_run_equals_unbroken_run_bit_for_bit(runs):
    assert runs["rc"]["unbroken"] == 0 and runs["rc"]["resumed"] == 0
    assert runs["meta_resumed"]["epoch"] == 1 and runs["step_resumed"] == 4
    assert runs["same_keys"]
    assert runs["has_opt_state"]
    assert runs["differing"] == []
    assert [e["step"] for e in runs["logs"]["resumed"]] == [1]
    timings = ("imgs_per_sec", "loader_wait_s")
    assert {k: v for k, v in runs["logs"]["resumed"][-1]["data"].items() if k not in timings} \
        == {k: v for k, v in runs["logs"]["unbroken"][-1]["data"].items() if k not in timings}


@pytest.fixture(scope="module")
def aa_runs(tmp_path_factory):
    """Two unbroken ``--autoaugment`` epochs, and one epoch resumed for a
    second, on 8 tiles (4 steps an epoch, so spatial ops are drawn).  The
    checkpoints are compared here and their trees removed at once (six
    checkpoints with optimizer state are 2.8 GB; each leg's ``best``, which
    no test reads, goes as soon as the leg ends); the tests read the
    outcome."""
    root = str(tmp_path_factory.mktemp("xbd_aa"))
    make_synthetic_dataset(root, n_train=8, n_val=2, n_test=2, size=SIZE, seed=5)
    res = {k: os.path.join(root, k) for k in ("unbroken", "first", "resumed")}
    common = BASE + ["--autoaugment", "--data", root]
    assert main(common + ["--results", res["unbroken"]], device="cpu") == 0
    _drop_best(res["unbroken"])
    assert main(common + ["--results", res["first"], "--patience", "0"], device="cpu") == 0
    _drop_best(res["first"])
    assert main(common + ["--results", res["resumed"], "--ckpt",
                          os.path.join(res["first"], "checkpoints", "last")], device="cpu") == 0
    _drop_best(res["resumed"])
    out = {"logs": {k: _logs(v) for k, v in res.items()}}
    first, out["meta_first"] = ckpt_lib.restore_raw(os.path.join(res["first"], "checkpoints",
                                                                 "last"))
    want, out["meta_unbroken"] = ckpt_lib.restore_raw(os.path.join(res["unbroken"],
                                                                   "checkpoints", "last"))
    got, out["meta_resumed"] = ckpt_lib.restore_raw(os.path.join(res["resumed"], "checkpoints",
                                                                 "last"))
    out["steps"] = {k: int(v["train"]["step"])
                    for k, v in (("first", first), ("unbroken", want), ("resumed", got))}
    a, b = dict(_flat(first["params"])), dict(_flat(want["params"]))
    out["n_params"] = len(a)
    out["finite"] = all(np.isfinite(v).all() for v in b.values())
    out["moved"] = sum(not np.array_equal(a[k], b[k]) for k in a)
    want, got = dict(_flat(want)), dict(_flat(got))
    out["same_keys"] = set(want) == set(got)
    out["has_opt_state"] = any(k.startswith("opt_state/") for k in got)
    out["differing"] = [k for k in want if k in got and not np.array_equal(got[k], want[k])]
    shutil.rmtree(root)
    return out


def test_autoaugment_run_trains(aa_runs):
    """Finite validation loss, the flag in the checkpoint's config, every
    parameter moved from the first epoch's to the second's."""
    logs = aa_runs["logs"]["unbroken"]
    assert [entry["step"] for entry in logs] == [0, 1]
    assert all(np.isfinite(entry["data"]["val_loss"]) for entry in logs)
    assert bool(aa_runs["meta_first"]["config"]["autoaugment"])
    assert bool(aa_runs["meta_unbroken"]["config"]["autoaugment"])
    assert aa_runs["steps"]["first"] == 4 and aa_runs["steps"]["unbroken"] == 8
    assert aa_runs["finite"] and aa_runs["moved"] == aa_runs["n_params"] > 100


def test_autoaugment_draws_reach_the_row_shift(monkeypatch):
    """The flag reaches the AutoAugment branch: over the seeds of eight
    steps a spatial op is drawn and goes through ``row_shift``."""
    import torch

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.ops import augment, autoaugment
    from xview2_tpu_torch.parallel.steps import step_generator

    calls = []
    real = autoaugment.row_shift
    monkeypatch.setattr(autoaugment, "row_shift",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    cfg = Config(autoaugment=True)
    masks = torch.zeros((8, SIZE, SIZE), dtype=torch.uint8)
    images = torch.zeros((8, SIZE, SIZE, 3), dtype=torch.uint8)
    for step in range(8):
        x, y = augment.augment_batch(step_generator(cfg, step, "cpu"), images, masks, 64,
                                     use_autoaugment=True)
        assert x.shape == (8, 64, 64, 3) and y.shape == (8, 64, 64)
    assert calls and all(len(s) == 4 and s[-1] == 4 for s in calls)


def test_autoaugment_resumed_run_equals_unbroken_run_bit_for_bit(aa_runs):
    assert aa_runs["meta_resumed"]["epoch"] == 1 and aa_runs["steps"]["resumed"] == 8
    assert aa_runs["same_keys"] and aa_runs["has_opt_state"]
    assert aa_runs["differing"] == []
    last = {k: [e["step"] for e in v] for k, v in aa_runs["logs"].items()}
    assert last["resumed"] == [1] and last["first"] == [0]
    strip = lambda e: {k: v for k, v in e["data"].items()  # noqa: E731
                       if k not in ("imgs_per_sec", "loader_wait_s")}
    assert strip(aa_runs["logs"]["resumed"][-1]) == strip(aa_runs["logs"]["unbroken"][-1])
