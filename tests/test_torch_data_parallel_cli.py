"""``--gpus 2`` through the port's CLI on the CPU: ``main`` spawns its two
ranks itself (gloo), on a tiny synthetic tree, against one process on the
same global batch.

Train: ``--batch_size 2 --gpus 2`` against ``--batch_size 4`` alone (and
the validation batches likewise), one epoch of two steps (float32, SGD): one
``index.csv`` and one ``best``/``last`` pair, every tensor of the checkpoint
within 1e-5 of its scale (at least 1) of the single process's, the same step
count and epoch log (its F1 and validation loss, rounded to 3 decimals,
equal).  Eval: ``--gpus 2`` on an odd holdout of 5 tiles (the second global
batch is one tile and three rows of padding, a rank's all padding) writes
the single process's file set, its dumps within 1e-6 and its metrics equal.
"""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from torch_jax_variables import one_torch_thread  # noqa: F401 (one CPU thread a worker)
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.data.synthetic import make_synthetic_dataset
from xview2_tpu_torch.main import main
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib
from xview2_tpu_torch.train.trainer import initial_model
from xview2_tpu_torch.weights import to_flax

SIZE = 96
TRAIN = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50", "--precision", "32",
         "--fused_tail", "1", "--optimizer", "sgd", "--num_workers", "2", "--train_crop", "64",
         "--epochs", "1"]
# the same global batches: 4 rows alone, 2 rows on each of 2 ranks
ONE, TWO = ["--batch_size", "4", "--val_batch_size", "4"], \
    ["--batch_size", "2", "--val_batch_size", "2", "--gpus", "2"]


def _files(results):
    return sorted(os.path.relpath(p, results)
                  for p in glob.glob(os.path.join(results, "**", "*"), recursive=True)
                  if os.path.isfile(p))


def _logs(results):
    with open(os.path.join(results, "logs.json")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The train CLI alone and at two ranks, then the eval CLI likewise on a
    seeded checkpoint; what the tests read is read here and the trees are
    removed (checkpoints with optimizer state)."""
    root = str(tmp_path_factory.mktemp("xbd"))
    make_synthetic_dataset(root, n_train=8, n_val=3, n_test=5, size=SIZE, seed=4)
    out = {}
    for name, extra in (("one", ONE), ("two", TWO)):
        res = os.path.join(root, f"train_{name}")
        assert main(TRAIN + extra + ["--data", root, "--results", res], device="cpu") == 0
        ckpts = {c: ckpt_lib.restore_raw(os.path.join(res, "checkpoints", c))
                 for c in ("best", "last")}
        out[name] = {"files": _files(res), "logs": _logs(res), "ckpts": ckpts}

    cfg = Config(type="pre", encoder="resnet50", precision=32, fused_tail=True)
    ckpt = os.path.join(root, "ckpt")
    ckpt_lib.save_checkpoint(ckpt, *to_flax(initial_model(cfg).state_dict()), epoch=0,
                             best_f1=0.0, best_epoch=0, cfg=cfg)
    for name, extra in (("one", ONE[2:]), ("two", TWO[2:])):
        res = os.path.join(root, f"eval_{name}")
        argv = ["--exec_mode", "eval", "--type", "pre", "--data", root, "--results", res,
                "--ckpt", ckpt, "--num_workers", "2"] + extra
        assert main(argv, device="cpu") == 0
        out[f"eval_{name}"] = {
            "files": _files(res), "logs": _logs(res),
            "probs": {os.path.basename(p): np.load(p) for p in
                      glob.glob(os.path.join(res, "probs", "*.npy"))}}
    shutil.rmtree(root)
    return out


def test_train_cli_at_two_ranks_writes_one_index_and_one_checkpoint_pair(runs):
    assert runs["two"]["files"] == runs["one"]["files"]
    assert runs["two"]["files"].count("index.csv") == 1
    for c in ("best", "last"):
        assert f"checkpoints/{c}/state.npz" in runs["two"]["files"]


def test_train_cli_at_two_ranks_equals_one_process_on_the_global_batch(runs):
    one, two = runs["one"], runs["two"]
    for c in ("best", "last"):
        (want, want_meta), (got, got_meta) = one["ckpts"][c], two["ckpts"][c]
        assert got_meta["epoch"] == want_meta["epoch"]
        assert int(got["train"]["step"]) == int(want["train"]["step"]) == 2
        for top in ("params", "batch_stats"):
            w, g = _flat(want[top]), _flat(got[top])
            assert set(g) == set(w)
            for key, arr in w.items():
                scale = max(float(np.abs(arr).max()), 1.0)
                np.testing.assert_allclose(g[key], arr, rtol=0, atol=1e-5 * scale, err_msg=key)
    (log_one,), (log_two,) = one["logs"], two["logs"]
    assert log_two["data"]["f1"] == log_one["data"]["f1"]
    assert log_two["data"]["val_loss"] == log_one["data"]["val_loss"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_eval_cli_at_two_ranks_writes_the_single_process_files(runs):
    one, two = runs["eval_one"], runs["eval_two"]
    assert two["files"] == one["files"]
    assert len(one["probs"]) == 5
    for name, want in one["probs"].items():
        np.testing.assert_allclose(two["probs"][name], want, rtol=0, atol=1e-6, err_msg=name)
    assert two["logs"] == one["logs"]

