"""The recipe's options through the port's CLI on the CPU, on a tiny
synthetic tree: every ``--optimizer`` but ``adamw`` (which
``tests/test_torch_train_cli.py`` runs), each ``--remat`` mode, a
``--pretrained_enc`` written by the port's converter (and one that does not
exist, which is skipped as in JAX), and the eval with ``--fold_eval_bn 0``
beside the fold.  Each run trains one epoch of two steps and leaves finite,
moved parameters and its optimizer's state in the checkpoint.  What the tests
assert is read in the fixture, and the tree is removed at once (each
checkpoint with optimizer state is about 470 MB)."""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from torch_jax_variables import one_torch_thread  # noqa: F401 (one CPU thread a worker)
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.data.synthetic import make_synthetic_dataset
from xview2_tpu_torch.main import main
from xview2_tpu_torch.models.convert_weights import main as convert_main
from xview2_tpu_torch.models.convert_weights import release_key
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib

BASE = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50", "--precision", "32",
        "--fused_tail", "1", "--batch_size", "2", "--val_batch_size", "2", "--num_workers", "2",
        "--train_crop", "64", "--epochs", "1", "--weight_decay", "1e-4"]
RUNS = {"radam": ["--remat", "tail", "--pretrained_enc", "ENC"],
        "adabelief": ["--remat", "dots"],
        "adabound": ["--remat", "full", "--pretrained_enc", "MISSING"],
        "adamp": ["--fold_eval_bn", "0"],
        "novograd": [], "sgd": [], "adam": []}
STATE = {"radam": {"step", "exp_avg", "exp_avg_sq"}, "adabelief": {"step", "exp_avg", "exp_avg_sq"},
         "adabound": {"step", "exp_avg", "exp_avg_sq"}, "adamp": {"step", "exp_avg", "exp_avg_sq"},
         "novograd": {"step", "exp_avg", "exp_avg_sq"}, "sgd": {"momentum_buffer"},
         "adam": {"step", "exp_avg", "exp_avg_sq"}}


def _encoder_npz(root):
    """A ResNet-50 release state dict from a seed, converted by the CLI;
    returns the ``.npz`` and its number of encoder tensors."""
    with torch.device("meta"):
        shapes = build_model(Config(type="pre", encoder="resnet50")).state_dict()
    rng = np.random.default_rng(0)
    sd = {release_key(k[len("unet."):], "resnet50"): torch.from_numpy(
        (rng.uniform(0.5, 1.5, t.shape) if k.endswith("running_var")
         else rng.normal(0, 0.05, t.shape)).astype(np.float32))
        for k, t in shapes.items() if k.startswith("unet.enc_l")}
    torch.save(sd, os.path.join(root, "enc.pth"))
    out = os.path.join(root, "enc.npz")
    assert convert_main(["--arch", "resnet50", "--pth", os.path.join(root, "enc.pth"),
                         "--out", out]) == 0
    return out, len(sd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recipe"))
    make_synthetic_dataset(root, n_train=4, n_val=2, n_test=2, size=96, seed=3)
    npz, n_enc = _encoder_npz(root)
    with np.load(npz) as z:
        conv1 = np.transpose(z["params/enc_l1/conv1/kernel"], (3, 2, 0, 1))
    out = {"n_enc": n_enc, "conv1": conv1}
    for name, extra in RUNS.items():
        extra = [{"ENC": npz, "MISSING": os.path.join(root, "missing.npz")}.get(a, a)
                 for a in extra]
        res = os.path.join(root, name)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            rc = main(BASE + ["--data", root, "--results", res, "--optimizer", name] + extra,
                      device="cpu")
        payload, meta = ckpt_lib.restore_raw(os.path.join(res, "checkpoints", "last"))
        params = {"/".join(p): v for p, v in _leaves(payload["params"])}
        opt = payload["opt_state"]
        out[name] = dict(rc=rc, log=log.getvalue(), meta=meta, step=int(payload["train"]["step"]),
                         finite=all(np.isfinite(v).all() for v in params.values()),
                         conv1=params["unet/enc_l1/conv1/kernel"],
                         state=set(opt["unet.enc_l1.conv1.weight"]),
                         nu_shape=np.shape(opt["unet.enc_l1.conv1.weight"].get("exp_avg_sq")))
        if name == "novograd":  # the eval CLI with and without the fold
            for fold in ("1", "0"):
                ev = os.path.join(root, f"eval{fold}")
                main(["--exec_mode", "eval", "--type", "pre", "--data", root, "--results", ev,
                      "--ckpt", os.path.join(res, "checkpoints", "last"), "--val_batch_size",
                      "2", "--num_workers", "2", "--fold_eval_bn", fold], device="cpu")
                probs = sorted(os.listdir(os.path.join(ev, "probs")))
                out[f"eval{fold}"] = [np.load(os.path.join(ev, "probs", p)) for p in probs]
        shutil.rmtree(res)
    shutil.rmtree(root)
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", list(RUNS))
def test_run_trains_and_saves_its_optimizer_state(runs, name):
    run = runs[name]
    assert run["rc"] == 0 and run["finite"]
    assert run["step"] == 2 and run["meta"]["config"]["optimizer"] == name
    assert run["state"] == STATE[name]
    if name == "novograd":
        assert run["nu_shape"] == (1,)  # one second moment per flax leaf
    assert run["meta"]["config"]["remat"] == (RUNS[name][1] if RUNS[name][:1] == ["--remat"]
                                              else "none")


def test_pretrained_enc_is_grafted_and_a_missing_one_skipped(runs):
    assert "loaded pretrained encoder from" in runs["radam"]["log"]
    assert f"({runs['n_enc']} tensors)" in runs["radam"]["log"]
    assert "pretrained" not in runs["adabound"]["log"]
    # two steps move the grafted stem a little, not back to a fresh draw
    grafted = np.transpose(runs["radam"]["conv1"], (3, 2, 0, 1))
    fresh = np.transpose(runs["adabound"]["conv1"], (3, 2, 0, 1))
    want = runs["conv1"]
    assert np.abs(grafted - want).max() < 0.1 * np.abs(want).max()
    assert np.abs(fresh - want).max() > 0.5 * np.abs(want).max()


def test_eval_without_the_fold_agrees_with_the_fold(runs):
    """float32: flax's stock eval normalize and the fold are the same affine
    in another order."""
    assert len(runs["eval0"]) == len(runs["eval1"]) == 2
    for a, b in zip(runs["eval0"], runs["eval1"]):
        assert a.shape == (96, 96) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
