"""The README's damage pipeline through the port's CLI on the CPU, on a tiny
synthetic tree: localization training (ResNeSt-50), damage training of the
Siamese model initialized from it with ``--ckpt_pre`` (``ohem+dice``), then
the damage eval with TTA writing the channel-first class-probability dumps.

The damage leg runs at ``--lr 0``, so its parameters stay as the transplant
left them (the BN running statistics still move) and every ``unet.enc_l*``
parameter must EQUAL the localization checkpoint's.  What the tests assert
is read inside the fixture and the tree is removed at once (each checkpoint
with optimizer state is about 0.5 GB)."""

import glob
import json
import os
import shutil

import numpy as np
import pytest

from torch_jax_variables import one_torch_thread  # noqa: F401
from xview2_tpu_torch.config import parse_args
from xview2_tpu_torch.data.synthetic import make_synthetic_dataset
from xview2_tpu_torch.main import main
from xview2_tpu_torch.models.resnest import ResNeStBottleneck, ResNeStStem
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.parallel import checkpoint as ckpt_lib

SIZE = 96
COMMON = ["--encoder", "resnest50", "--precision", "32", "--fused_tail", "1", "--batch_size",
          "2", "--val_batch_size", "2", "--num_workers", "2", "--train_crop", "64", "--epochs",
          "1"]


def _params(path):
    payload, meta = ckpt_lib.restore_raw(path)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(payload["params"], ("params",))
    walk(payload["batch_stats"], ("batch_stats",))
    return flat, meta


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("xbd_dmg"))
    make_synthetic_dataset(root, n_train=2, n_val=1, n_test=2, size=SIZE, seed=5)
    res_pre, res_post = os.path.join(root, "pre"), os.path.join(root, "post")
    out = {}
    out["rc_pre"] = main(["--exec_mode", "train", "--type", "pre", "--data", root, "--results",
                          res_pre] + COMMON, device="cpu")
    shutil.rmtree(os.path.join(res_pre, "checkpoints", "last"))
    loc_best = os.path.join(res_pre, "checkpoints", "best")
    out["loc"], _ = _params(loc_best)
    out["rc_post"] = main(["--exec_mode", "train", "--type", "post", "--dmg_model", "siamese",
                           "--loss_str", "ohem+dice", "--ckpt_pre", loc_best, "--lr", "0",
                           "--data", root, "--results", res_post] + COMMON, device="cpu")
    shutil.rmtree(os.path.join(res_pre, "checkpoints"))
    shutil.rmtree(os.path.join(res_post, "checkpoints", "best"))
    last = os.path.join(res_post, "checkpoints", "last")
    out["dmg"], out["dmg_meta"] = _params(last)
    with open(os.path.join(res_post, "logs.json")) as f:
        out["post_log"] = json.loads(f.readlines()[-1])
    out["rc_eval"] = main(["--exec_mode", "eval", "--type", "post", "--data", root, "--results",
                           res_post, "--ckpt", last, "--val_batch_size", "2", "--eval_tta", "on",
                           "--num_workers", "2"], device="cpu")
    out["probs"] = {os.path.basename(p): np.load(p)
                    for p in sorted(glob.glob(os.path.join(res_post, "probs", "*.npy")))}
    out["targets"] = sorted(os.path.basename(p) for p in
                            glob.glob(os.path.join(res_post, "targets", "*.png")))
    with open(os.path.join(res_post, "logs.json")) as f:
        out["eval_log"] = json.loads(f.readlines()[-1])
    shutil.rmtree(root)
    return out


def test_every_leg_returns_0(pipeline):
    assert (pipeline["rc_pre"], pipeline["rc_post"], pipeline["rc_eval"]) == (0, 0, 0)
    cfg = pipeline["dmg_meta"]["config"]
    assert (cfg["type"], cfg["dmg_model"], cfg["loss_str"]) == ("post", "siamese", "ohem+dice")
    assert np.isfinite(pipeline["post_log"]["data"]["val_loss"])


def test_ckpt_pre_copies_every_encoder_leaf(pipeline):
    loc, dmg = pipeline["loc"], pipeline["dmg"]
    enc = [k for k in loc if k.startswith("params/unet/enc_l")]
    stats = [k for k in loc if k.startswith("batch_stats/unet/enc_l")]
    assert len(enc) > 100 and len(stats) > 100
    for k in enc:  # --lr 0: the damage run's parameters are the transplant's
        np.testing.assert_array_equal(dmg[k], loc[k], err_msg=k)
    # the running statistics started from the localization ones and moved on
    assert all(dmg[k].shape == loc[k].shape for k in stats)
    assert sum(not np.array_equal(dmg[k], loc[k]) for k in stats) > 0.9 * len(stats)
    # the head and the decoder are the damage model's own
    assert dmg["params/output_block/output_block/conv/kernel"].shape == (1, 1, 64, 4)


def test_damage_dumps_are_channel_first_probabilities(pipeline):
    probs = pipeline["probs"]
    assert sorted(probs) == [f"test_damage_{i:05d}.npy" for i in range(2)]
    assert pipeline["targets"] == [f"test_damage_{i:05d}_target.png" for i in range(2)]
    for p in probs.values():
        assert p.shape == (4, SIZE, SIZE) and p.dtype == np.float32
        assert np.isfinite(p).all() and p.min() >= 0.0
        np.testing.assert_allclose(p.sum(axis=0), 1.0, atol=1e-5)
    # the damage F1: its aggregate and one score per damage class
    assert {"f1", "D1", "D2", "D3", "D4"} <= set(pipeline["eval_log"]["data"])


def test_post_loaders_give_pairs_and_damage_labels(tmp_path):
    """``--type post`` loaders: uint8 (B, H, W, 6) tiles, the pre image's
    pixels then the post image's, and the post target's damage labels; the
    holdout's last partial batch padded and marked invalid."""
    from PIL import Image

    from xview2_tpu_torch.config import Config
    from xview2_tpu_torch.data.pipeline import make_test_loader, make_train_loaders

    root = str(tmp_path / "xbd")
    make_synthetic_dataset(root, n_train=2, n_val=1, n_test=3, size=SIZE, seed=6)
    cfg = Config(type="post", data=root, results=str(tmp_path / "res"), batch_size=2,
                 val_batch_size=2, num_workers=2)
    train, _ = make_train_loaders(cfg)
    holdout = make_test_loader(cfg)
    batches = {"train": list(train), "holdout": list(holdout)}
    for split, got in batches.items():
        assert got[0].image.shape == (2, SIZE, SIZE, 6) and got[0].image.dtype == np.uint8
        assert set(np.unique(got[0].mask)) <= set(range(5)) and got[0].mask.max() > 1
    (pre, post), label = holdout.ds.item_paths(0)
    assert "post" in os.path.basename(label)
    want = np.concatenate([np.asarray(Image.open(pre).convert("RGB")),
                           np.asarray(Image.open(post).convert("RGB"))], axis=2)
    np.testing.assert_array_equal(batches["holdout"][0].image[0], want)
    np.testing.assert_array_equal(batches["holdout"][0].mask[0], np.asarray(Image.open(label)))
    assert len(batches["holdout"]) == 2 and list(batches["holdout"][-1].valid) == [1.0, 0.0]


def test_default_flags_build_resnest200():
    """``--exec_mode train --type pre`` with no other flag: the CLI's default
    encoder is ResNeSt-200 at its published depth (3, 24, 36, 3)."""
    cfg = parse_args(["--exec_mode", "train", "--type", "pre"])
    assert cfg.encoder == "resnest200"
    model = build_model(cfg)
    blocks = [m for m in model.modules() if isinstance(m, ResNeStBottleneck)]
    assert len(blocks) == 66 and isinstance(model.unet.enc_l1, ResNeStStem)
    post = build_model(cfg.replace(type="post", loss_str="ohem+dice"))
    assert type(post).__name__ == "SiameseUNet"
