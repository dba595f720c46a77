"""The port's eval CLI against the JAX package's, end to end on the CPU.

A JAX checkpoint (orbax, ``xview2_tpu.parallel.checkpoint``) is converted
into a port checkpoint (``state.npz`` + ``meta.json``) with numpy alone;
then ``xview2_tpu.train.trainer.test`` and the port's ``main(..., device=
"cpu")`` evaluate the same synthetic holdout.  The probability dumps agree
at atol 2e-4 (float32), the target PNGs are identical and the F1 is equal."""

import glob
import json
import os
import shutil

import jax
import numpy as np
import optax
import pytest
from PIL import Image

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.data.synthetic import make_synthetic_dataset
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.parallel import checkpoint as jax_ckpt
from xview2_tpu.parallel.steps import init_train_state
from xview2_tpu.train import trainer as jax_trainer
from xview2_tpu_torch.config import Config, parse_args
from xview2_tpu_torch.main import main
from xview2_tpu_torch.parallel import checkpoint as port_ckpt
from xview2_tpu_torch.train import trainer as port_trainer

SIZE = 96


def _perturb(tree, rng):
    """BN statistics from a numpy seed so the eval is not at the trivial
    fresh-init point (running mean 0, var 1)."""
    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['mean']"):
            return rng.normal(0, 0.1, leaf.shape).astype(leaf.dtype)
        if key.endswith("['var']"):
            return rng.uniform(0.5, 2.0, leaf.shape).astype(leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("xbd"))
    make_synthetic_dataset(root, n_train=1, n_val=1, n_test=3, size=SIZE, seed=4)
    cfg = JaxConfig(type="pre", encoder="resnet50", precision=32, tta=True, fused_tail=True,
                    data=root, val_batch_size=2, num_workers=2, gpus=1)
    model = jax_build_model(cfg)
    state = init_train_state(cfg, model, optax.sgd(0.0), jax.random.PRNGKey(0), (64, 64, 3))
    state = state.replace(batch_stats=_perturb(jax.device_get(state.batch_stats),
                                               np.random.default_rng(0)))
    jax_path = os.path.join(root, "ckpt_jax")
    jax_ckpt.save_checkpoint(jax_path, jax.device_get(state), epoch=0, best_f1=0.0,
                             best_epoch=0, cfg=cfg)

    # conversion: orbax tree -> state.npz keyed by flax paths, same meta.json
    payload, meta = jax_ckpt.restore_raw(jax_path)
    port_path = os.path.join(root, "ckpt_port")
    port_ckpt.save_checkpoint(port_path, payload["params"], payload["batch_stats"],
                              epoch=meta["epoch"], best_f1=meta["best_f1"],
                              best_epoch=meta["best_epoch"], cfg=Config(**meta["config"]))

    res_jax = os.path.join(root, "res_jax")
    res_port = os.path.join(root, "res_port")
    jax_trainer.test(cfg.replace(exec_mode="eval", results=res_jax, ckpt=jax_path))
    rc = main(["--exec_mode", "eval", "--type", "pre", "--data", root, "--results", res_port,
               "--ckpt", port_path, "--val_batch_size", "2", "--num_workers", "2"],
              device="cpu")
    # the tests read the results only: the two checkpoints (150 MB each) go
    shutil.rmtree(jax_path)
    shutil.rmtree(port_path)
    assert rc == 0
    return res_jax, res_port


def _files(res, sub, pattern):
    return sorted(glob.glob(os.path.join(res, sub, pattern)))


def test_probs_agree(evaluated):
    res_jax, res_port = evaluated
    want, got = _files(res_jax, "probs", "*.npy"), _files(res_port, "probs", "*.npy")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3  # the padded tail sample is not dumped
    for w, g in zip(want, got):
        a, b = np.load(w), np.load(g)
        assert b.shape == (SIZE, SIZE) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4, err_msg=os.path.basename(g))


def test_targets_identical(evaluated):
    res_jax, res_port = evaluated
    want, got = _files(res_jax, "targets", "*.png"), _files(res_port, "targets", "*.png")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(Image.open(g)), np.asarray(Image.open(w)))


def test_f1_equal(evaluated):
    res_jax, res_port = evaluated
    logs = [json.loads(open(os.path.join(r, "logs.json")).readlines()[-1])
            for r in (res_jax, res_port)]
    assert logs[1] == logs[0]
    assert np.isfinite(logs[1]["data"]["f1"])


def test_train_mode_raises(tmp_path):
    """Train mode is ported (tests/test_torch_train_cli.py) with every
    option: the checks that run before any data is read or any rank is
    spawned let them through.  The decoder options, ``fused --ppm`` and
    ``--autoaugment --dec_interp`` on pairs among them, the recipe's options
    (``--remat``, every ``--optimizer``, ``--pretrained_enc``,
    ``--fold_eval_bn 0``), ``--gpus`` and ``--spatial_shards`` (with the
    decoder options and the damage variants too) pass."""
    base = ["--exec_mode", "train", "--type", "pre", "--encoder", "resnet50",
            "--results", str(tmp_path)]
    for extra in (["--gpus", "4", "--spatial_shards", "2", "--ppm"],
                  ["--type", "post", "--dmg_model", "fused", "--gpus", "2",
                   "--spatial_shards", "2"]):
        assert port_trainer._check_supported(parse_args(base + extra)) is None, extra
    for extra in (["--type", "post", "--dmg_model", "fused", "--ppm"], ["--interpolate"],
                  ["--deep_supervision"], ["--type", "post", "--loss_str", "coral",
                                           "--attention"],
                  ["--type", "post", "--autoaugment", "--dec_interp"],
                  ["--remat", "tail"], ["--optimizer", "radam"],
                  ["--pretrained_enc", "enc.npz"],
                  ["--type", "post", "--loss_str", "coral", "--attention", "--remat", "dots"],
                  ["--type", "post", "--dmg_model", "fused", "--ppm", "--fold_eval_bn", "0"],
                  ["--gpus", "2"], ["--gpus", "4", "--spatial_shards", "2"],
                  ["--type", "post", "--gpus", "2", "--spatial_shards", "2"]):
        cfg = parse_args(base + extra)
        assert port_trainer._check_fit_supported(cfg) is None, extra
