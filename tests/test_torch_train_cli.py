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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("xbd"))
    make_synthetic_dataset(root, n_train=4, n_val=2, n_test=2, size=SIZE, seed=3)
    res = {k: os.path.join(root, k) for k in ("unbroken", "first", "resumed")}
    common = BASE + ["--data", root]
    assert main(common + ["--results", res["unbroken"]], device="cpu") == 0
    # the Noam schedule depends on --epochs, so the first leg declares two
    # epochs as well; --patience 0 stops it after the first, which leaves the
    # `last` checkpoint an interrupted two-epoch run would resume from
    assert main(common + ["--results", res["first"], "--patience", "0", "--profile"],
                device="cpu") == 0
    assert main(common + ["--results", res["resumed"], "--ckpt",
                          os.path.join(res["first"], "checkpoints", "last")], device="cpu") == 0
    return root, res


def test_one_epoch_writes_checkpoints_and_log(runs):
    _, res = runs
    logs = _logs(res["first"])
    assert [entry["step"] for entry in logs] == [0]
    data = logs[0]["data"]
    assert set(data) == {"f1", "val_loss", "top_f1", "imgs_per_sec"}
    assert np.isfinite(data["val_loss"]) and data["imgs_per_sec"] > 0
    for name in ("best", "last"):
        path = os.path.join(res["first"], "checkpoints", name)
        assert ckpt_lib.checkpoint_exists(path)
        payload, meta = ckpt_lib.restore_raw(path)
        assert meta["epoch"] == 0 and bool(meta["config"]["fused_tail"])
        assert int(payload["train"]["step"]) == 2  # 4 tiles / batch 2
        bufs = payload["opt_state"]["unet.enc_l1.conv1.weight"]
        assert set(bufs) == {"step", "exp_avg", "exp_avg_sq"}
        assert np.abs(bufs["exp_avg"]).max() > 0
    # --profile: a torch.profiler trace of the first steps, stopped at loop exit
    assert os.path.getsize(os.path.join(res["first"], "profile", "trace.json")) > 0


def test_checkpoint_reloads_through_the_eval_cli(runs):
    root, res = runs
    out = os.path.join(root, "eval_out")
    rc = main(["--exec_mode", "eval", "--type", "pre", "--data", root, "--results", out,
               "--ckpt", os.path.join(res["first"], "checkpoints", "last"),
               "--val_batch_size", "2", "--num_workers", "2"], device="cpu")
    assert rc == 0
    assert len(os.listdir(os.path.join(out, "probs"))) == 2
    assert np.isfinite(_logs(out)[-1]["data"]["f1"])


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_resumed_run_equals_unbroken_run_bit_for_bit(runs):
    _, res = runs
    want, _ = ckpt_lib.restore_raw(os.path.join(res["unbroken"], "checkpoints", "last"))
    got, meta = ckpt_lib.restore_raw(os.path.join(res["resumed"], "checkpoints", "last"))
    assert meta["epoch"] == 1 and int(got["train"]["step"]) == 4
    want, got = dict(_flat(want)), dict(_flat(got))
    assert set(want) == set(got)
    assert any(k.startswith("opt_state/") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert [e["step"] for e in _logs(res["resumed"])] == [1]
    assert {k: v for k, v in _logs(res["resumed"])[-1]["data"].items() if k != "imgs_per_sec"} \
        == {k: v for k, v in _logs(res["unbroken"])[-1]["data"].items() if k != "imgs_per_sec"}


@pytest.fixture(scope="module")
def aa_runs(tmp_path_factory):
    """Two unbroken ``--autoaugment`` epochs, and one epoch resumed for a
    second, on 8 tiles (4 steps an epoch, so spatial ops are drawn).  The
    checkpoints are compared here and their trees removed at once (six
    checkpoints with optimizer state are 2 GB); the tests read the outcome."""
    import shutil

    root = str(tmp_path_factory.mktemp("xbd_aa"))
    make_synthetic_dataset(root, n_train=8, n_val=2, n_test=2, size=SIZE, seed=5)
    res = {k: os.path.join(root, k) for k in ("unbroken", "first", "resumed")}
    common = BASE + ["--autoaugment", "--data", root]
    assert main(common + ["--results", res["unbroken"]], device="cpu") == 0
    assert main(common + ["--results", res["first"], "--patience", "0"], device="cpu") == 0
    assert main(common + ["--results", res["resumed"], "--ckpt",
                          os.path.join(res["first"], "checkpoints", "last")], device="cpu") == 0
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
    strip = lambda e: {k: v for k, v in e["data"].items() if k != "imgs_per_sec"}  # noqa: E731
    assert strip(aa_runs["logs"]["resumed"][-1]) == strip(aa_runs["logs"]["unbroken"][-1])
