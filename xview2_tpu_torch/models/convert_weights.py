"""Pretrained-weight converter: torchvision ResNet / ResNeSt release
``.pth`` state dicts -> the encoder ``.npz`` that ``--pretrained_enc`` reads
(the port's own copy of the JAX package's ``tools/convert_weights.py``,
writing the same keys and arrays).

Conventions:
* conv kernels: torch OIHW -> flax HWIO (``transpose(2, 3, 1, 0)``); grouped
  convs keep the same group-major output layout in both frameworks.
* BatchNorm: ``weight/bias -> scale/bias`` (params) and
  ``running_mean/running_var -> mean/var`` (batch_stats).

Usage:
  python -m xview2_tpu_torch.models.convert_weights --arch resnet50 \
      --pth resnet50.pth --out resnet50.npz
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch

from xview2_tpu_torch.models.resnest import RESNEST_LAYERS
from xview2_tpu_torch.models.resnet import RESNET_LAYERS
from xview2_tpu_torch.weights import flatten_tree


def _conv(sd, key):
    return np.transpose(np.asarray(sd[key]), (2, 3, 1, 0))


def _bn(sd, prefix) -> Tuple[Dict, Dict]:
    params = {"scale": np.asarray(sd[f"{prefix}.weight"]),
              "bias": np.asarray(sd[f"{prefix}.bias"])}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"]),
             "var": np.asarray(sd[f"{prefix}.running_var"])}
    return params, stats


def _conv_bias(sd, key_w, key_b):
    return {"kernel": _conv(sd, key_w), "bias": np.asarray(sd[key_b])}


def convert_resnet(sd: Dict, arch: str) -> Tuple[Dict, Dict]:
    """torchvision ResNet state dict -> (params, batch_stats) encoder trees."""
    params: Dict = {}
    stats: Dict = {}
    bn_p, bn_s = _bn(sd, "bn1")
    params["enc_l1"] = {"conv1": {"kernel": _conv(sd, "conv1.weight")}, "bn1": bn_p}
    stats["enc_l1"] = {"bn1": bn_s}

    for li, blocks in enumerate(RESNET_LAYERS[arch]):
        stage_p, stage_s = {}, {}
        for b in range(blocks):
            pref = f"layer{li + 1}.{b}"
            bp, bs = {}, {}
            for ci in (1, 2, 3):
                bp[f"conv{ci}"] = {"kernel": _conv(sd, f"{pref}.conv{ci}.weight")}
                bnp, bns = _bn(sd, f"{pref}.bn{ci}")
                bp[f"bn{ci}"] = bnp
                bs[f"bn{ci}"] = bns
            if f"{pref}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {"kernel": _conv(sd, f"{pref}.downsample.0.weight")}
                bnp, bns = _bn(sd, f"{pref}.downsample.1")
                bp["downsample_bn"] = bnp
                bs["downsample_bn"] = bns
            stage_p[f"block{b}"] = bp
            stage_s[f"block{b}"] = bs
        name = f"enc_l{li + 2}"
        if li == 0:  # stage 2 wraps layer1 under MaxPoolStage
            params[name] = {"stage": stage_p}
            stats[name] = {"stage": stage_s}
        else:
            params[name] = stage_p
            stats[name] = stage_s
    return params, stats


def convert_resnest(sd: Dict, arch: str) -> Tuple[Dict, Dict]:
    """ResNeSt (zhanghang1989 release) state dict -> encoder trees."""
    params: Dict = {}
    stats: Dict = {}
    # deep stem: conv1.{0,3,6} convs with conv1.{1,4} BNs, then bn1
    p1, s1 = {}, {}
    p1["conv1a"] = {"kernel": _conv(sd, "conv1.0.weight")}
    bnp, bns = _bn(sd, "conv1.1")
    p1["bn1a"], s1["bn1a"] = bnp, bns
    p1["conv1b"] = {"kernel": _conv(sd, "conv1.3.weight")}
    bnp, bns = _bn(sd, "conv1.4")
    p1["bn1b"], s1["bn1b"] = bnp, bns
    p1["conv1c"] = {"kernel": _conv(sd, "conv1.6.weight")}
    bnp, bns = _bn(sd, "bn1")
    p1["bn1"], s1["bn1"] = bnp, bns
    params["enc_l1"], stats["enc_l1"] = p1, s1

    for li, blocks in enumerate(RESNEST_LAYERS[arch]):
        stage_p, stage_s = {}, {}
        for b in range(blocks):
            pref = f"layer{li + 1}.{b}"
            bp, bs = {}, {}
            bp["conv1"] = {"kernel": _conv(sd, f"{pref}.conv1.weight")}
            bnp, bns = _bn(sd, f"{pref}.bn1")
            bp["bn1"], bs["bn1"] = bnp, bns
            # SplAtConv2d
            sp, ss = {}, {}
            sp["conv"] = {"kernel": _conv(sd, f"{pref}.conv2.conv.weight")}
            bnp, bns = _bn(sd, f"{pref}.conv2.bn0")
            sp["bn0"], ss["bn0"] = bnp, bns
            sp["fc1"] = _conv_bias(sd, f"{pref}.conv2.fc1.weight", f"{pref}.conv2.fc1.bias")
            bnp, bns = _bn(sd, f"{pref}.conv2.bn1")
            sp["bn1"], ss["bn1"] = bnp, bns
            sp["fc2"] = _conv_bias(sd, f"{pref}.conv2.fc2.weight", f"{pref}.conv2.fc2.bias")
            bp["conv2"], bs["conv2"] = sp, ss
            bp["conv3"] = {"kernel": _conv(sd, f"{pref}.conv3.weight")}
            bnp, bns = _bn(sd, f"{pref}.bn3")
            bp["bn3"], bs["bn3"] = bnp, bns
            # avg_down downsample: .0 avgpool (no params), .1 conv, .2 bn
            if f"{pref}.downsample.1.weight" in sd:
                bp["downsample_conv"] = {"kernel": _conv(sd, f"{pref}.downsample.1.weight")}
                bnp, bns = _bn(sd, f"{pref}.downsample.2")
                bp["downsample_bn"], bs["downsample_bn"] = bnp, bns
            stage_p[f"block{b}"] = bp
            stage_s[f"block{b}"] = bs
        name = f"enc_l{li + 2}"
        if li == 0:
            params[name] = {"stage": stage_p}
            stats[name] = {"stage": stage_s}
        else:
            params[name] = stage_p
            stats[name] = stage_s
    return params, stats


_RESNEST_STEM = {"conv1a": "conv1.0", "bn1a": "conv1.1", "conv1b": "conv1.3",
                 "bn1b": "conv1.4", "conv1c": "conv1.6", "bn1": "bn1"}


def release_key(name: str, arch: str) -> str:
    """The release ``.pth`` key of the port's encoder tensor ``name``
    (``enc_l*...`` of a ``UNetLoc``'s ``unet``): the converter's mapping
    read backwards, to fabricate release-shaped state dicts from a seed."""
    stage, *rest = [p for p in name.split(".") if p != "stage"]
    if stage == "enc_l1":
        if arch.startswith("resnest"):
            rest[0] = _RESNEST_STEM[rest[0]]
        return ".".join(rest)
    block, module, *leaf = rest
    shift = 1 if arch.startswith("resnest") else 0  # ResNeSt's .0 is the avg pool
    module = {"downsample_conv": f"downsample.{shift}",
              "downsample_bn": f"downsample.{shift + 1}"}.get(module, module)
    return ".".join([f"layer{int(stage[-1]) - 1}", block[len("block"):], module] + leaf)


def save_npz(path: str, params: Dict, stats: Dict) -> None:
    """One array per leaf, keyed ``params/...`` and ``batch_stats/...``."""
    np.savez(path, **{"/".join(p): np.asarray(v)
                      for top, tree in (("params", params), ("batch_stats", stats))
                      for p, v in flatten_tree(tree, (top,))})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=list(RESNET_LAYERS) + list(RESNEST_LAYERS))
    ap.add_argument("--pth", required=True, help="torch .pth state dict")
    ap.add_argument("--out", required=True, help="output .npz")
    args = ap.parse_args(argv)

    sd = torch.load(args.pth, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}

    if args.arch.startswith("resnest"):
        params, stats = convert_resnest(sd, args.arch)
    else:
        params, stats = convert_resnet(sd, args.arch)
    save_npz(args.out, params, stats)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
