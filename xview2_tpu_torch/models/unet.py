"""The localization U-Net and the eight damage U-Nets (port of
``xview2_tpu/models/unet.py``).

``build_model(cfg)`` builds ``UNetLoc`` for ``--type pre`` and, for
``--type post``, the ``--dmg_model`` variant of :data:`DMG_UNETS`; either with
a ResNet or a ResNeSt encoder and the s2d-packed decoder tail feeding the
packed head.  Inputs are NHWC ``(B, H, W, 3)`` (localization) or ``(B, H, W,
6)`` (pre ++ post channels), logits NHWC ``(B, H, W, n_class)``; in train
mode the logits come out in the packed loss view ``(B, H/2, 2W, n_class)``
(:func:`emits_packed_loss_view`).  ``n_class`` follows the loss head rule
(``Config.n_class``: 3 for the CORAL head, 1 for MSE).  Module names follow
the flax tree (``unet.enc_l1``, ``unet.dec_layers_4.conv_block.conv1.Conv_0``,
``enc_fusion_0.pre_layer``, ``enc_pre_0``, ``output_block.output_block.conv``);
list members are registered one by one as ``name_i``, as flax names them.

The JAX package's deliberate fixes are kept: ``ParallelUNet`` runs
``unet_post`` on the post image, and the fused variants wire ``dec_interp``
to its own parameter.  Not ported yet, each raising ``NotImplementedError``
that names its ROADMAP item: PPM/ASPP, attention, deep supervision,
``--dec_interp`` and ``--interpolate``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.encoder import make_encoder_stages
from xview2_tpu_torch.models.layers import (FusionBlock, OutputBlock, UpsampleBlock,
                                           concat_registered)

DECODER_CHANNELS = (512, 256, 128, 64, 32)  # reference unet.py:90


def _unsupported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to xview2_tpu_torch yet "
                               f"(ROADMAP Queue 1, {item})")


def check_supported(cfg: Config) -> None:
    """Raise for every model option outside this slice of the port."""
    if cfg.ppm or cfg.aspp:
        raise _unsupported("--ppm/--aspp", "decoder options")
    if cfg.attention:
        raise _unsupported("--attention", "decoder options")
    if cfg.deep_supervision:
        raise _unsupported("--deep_supervision", "decoder options")
    if cfg.interpolate or cfg.dec_interp:
        raise _unsupported("--interpolate/--dec_interp", "decoder options")


def _register(module: nn.Module, name: str, members) -> None:
    """Register list members as ``name_i`` (flax's names for a list
    attribute), skipping the ``None`` of truncated decoders."""
    for i, m in enumerate(members):
        if m is not None:
            module.add_module(f"{name}_{i}", m)


def make_decoder_stages(encf: List[int], dilation: int, no_skip: bool,
                        dtype: torch.dtype) -> List[Optional[UpsampleBlock]]:
    """The 5 decoder UpsampleBlocks with dilation-aware truncation (leading
    ``None``s where dilation removes stages); the last stage is s2d-packed."""
    decf = DECODER_CHANNELS
    skips = [encf[-2], encf[-3], encf[-4], encf[-5], 0]
    first = {1: 0, 2: 1, 4: 2}[dilation]
    stages: List[Optional[UpsampleBlock]] = [None] * first
    cin = encf[-1]
    for i in range(first, 5):
        skip = 0 if no_skip else skips[i]
        stages.append(UpsampleBlock(cin, decf[i], skip, packed_out=i == 4, dtype=dtype))
        cin = decf[i]
    return stages


def _run_decoder(dec_layers, dilation: int, no_skip: bool, encs, train: bool):
    """Shared decoder chain (reference ``UNetTemplate.forward``)."""
    enc1, enc2, enc3, enc4, enc5 = encs
    dec_l1, dec_l2, dec_l3, dec_l4, dec_l5 = dec_layers
    if no_skip:
        enc1 = enc2 = enc3 = enc4 = None
    if dilation == 1:
        dec3_in = dec_l2(dec_l1(enc5, enc4, train), enc3, train)
    elif dilation == 2:
        dec3_in = dec_l2(enc5, enc3, train)
    else:
        dec3_in = enc5
    dec3 = dec_l3(dec3_in, enc2, train)
    dec4 = dec_l4(dec3, enc1, train)
    dec5 = dec_l5(dec4, None, train)
    return dec5, dec4, dec3


class UNetTemplate(nn.Module):
    """Shared encoder + decoder on one image of ``in_channels`` channels;
    returns ``(dec5, dec4, dec3)``."""

    def __init__(self, cfg: Config, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, stages = make_encoder_stages(cfg.encoder, cfg.dilation, in_channels, dtype)
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        self.dec_layers = make_decoder_stages(chans, cfg.dilation, cfg.no_skip, dtype)
        _register(self, "dec_layers", self.dec_layers)

    def forward(self, data: torch.Tensor, train: bool = False):
        stages = [self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5]
        return _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip,
                            _encode(stages, data, train), train)


def _encode(stages, data: torch.Tensor, train: bool) -> List[torch.Tensor]:
    """The five encoder features of ``data``."""
    feats = []
    for stage in stages:
        data = stage(data, train)
        feats.append(data)
    return feats


class OutputTemplate(nn.Module):
    """Final head (reference unet.py:175-197); the deep-supervision heads
    are not ported (see :func:`check_supported`)."""

    def __init__(self, n_class: int, fine_in: int, dtype: torch.dtype, packed_groups: int = 1):
        super().__init__()
        self.output_block = OutputBlock(n_class, fine_in, dtype, packed_groups)

    def forward(self, dec5, train: bool = False) -> torch.Tensor:
        return self.output_block(dec5, train)


class UNetLoc(nn.Module):
    """Localization U-Net (reference unet.py:200-215).  ``train`` is an
    explicit argument, as in the JAX package; ``nn.Module.training`` is not
    read.  ``in_channels``: 6 for ``CatUNet``."""

    def __init__(self, cfg: Config, n_class: int = 2, in_channels: int = 3):
        super().__init__()
        check_supported(cfg)
        self.unet = UNetTemplate(cfg, in_channels)
        self.output_block = OutputTemplate(n_class, DECODER_CHANNELS[-1], cfg.compute_dtype)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        dec5, _, _ = self.unet(data, train)
        return self.output_block(dec5, train)


class SiameseUNet(nn.Module):
    """True siamese (reference unet.py:218-236): ONE shared UNetTemplate run
    separately on the pre and the post image, the two dec5 maps
    concatenated, and a head over both (``packed_groups=2``).  In train mode
    each BatchNorm normalizes each branch by that branch's batch statistics
    and updates its running statistics twice, pre then post, as flax does
    when one module is applied twice."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        self.unet = UNetTemplate(cfg)
        self.output_block = OutputTemplate(n_class, 2 * DECODER_CHANNELS[-1],
                                           cfg.compute_dtype, packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        p5, _, _ = self.unet(data[..., :3], train)
        q5, _, _ = self.unet(data[..., 3:], train)
        return self.output_block(concat_registered(p5, q5), train)


class SiameseEncUNet(nn.Module):
    """One shared encoder on pre and post, the features concatenated per
    scale, one decoder over the doubled channels (reference unet.py:241-288;
    each encoder BatchNorm updates its running statistics pre then post)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, stages = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        self.dec_layers = make_decoder_stages([2 * c for c in chans], cfg.dilation, cfg.no_skip,
                                              dtype)
        _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(n_class, DECODER_CHANNELS[-1], dtype)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        stages = [self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5]
        pre = _encode(stages, data[..., :3], train)
        post = _encode(stages, data[..., 3:], train)
        encs = [concat_registered(a, b) for a, b in zip(pre, post)]
        dec5, _, _ = _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip, encs,
                                  train)
        return self.output_block(dec5, train)


class FusedUNet(nn.Module):
    """Two encoders and two decoders with cross-branch fusion after every
    stage (reference unet.py:291-349); dilation is forced to 1 and the
    decoders keep their skips.  The last decoder stage fuses in the packed
    domain, and the head consumes the concat of its two packed outputs
    (``packed_groups=2``)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        dtype = cfg.compute_dtype
        chans, pre = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        _, post = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        self.enc_fusion = [FusionBlock(pre[i], post[i], chans[i], dtype) for i in range(5)]
        _register(self, "enc_fusion", self.enc_fusion)
        pre_dec = make_decoder_stages(chans, 1, False, dtype)
        post_dec = make_decoder_stages(chans, 1, False, dtype)
        self.dec_fusion = [FusionBlock(pre_dec[i], post_dec[i], DECODER_CHANNELS[i], dtype,
                                       decoder_mode=True, packed_last=i == 4) for i in range(5)]
        _register(self, "dec_fusion", self.dec_fusion)
        self.output_block = OutputTemplate(n_class, 2 * DECODER_CHANNELS[-1], dtype,
                                           packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        pre, post = data[..., :3], data[..., 3:]
        e_pre, e_post = [], []
        for fb in self.enc_fusion:
            pre, post = fb(pre, post, train=train)
            e_pre.append(pre)
            e_post.append(post)
        d_pre, d_post = e_pre[4], e_post[4]
        for i, fb in enumerate(self.dec_fusion):
            if i < 4:
                d_pre, d_post = fb(d_pre, d_post, e_pre[3 - i], e_post[3 - i], train=train)
            else:
                d_pre, d_post = fb(d_pre, d_post, last_dec=True, train=train)
        return self.output_block(concat_registered(d_pre, d_post), train)


class FusedEncUNet(nn.Module):
    """Fused encoders, one decoder on the post branch's features (reference
    unet.py:352-382); dilation 1, skips kept."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        dtype = cfg.compute_dtype
        chans, pre = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        _, post = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        self.enc_fusion = [FusionBlock(pre[i], post[i], chans[i], dtype) for i in range(5)]
        _register(self, "enc_fusion", self.enc_fusion)
        self.dec_layers = make_decoder_stages(chans, 1, False, dtype)
        _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(n_class, DECODER_CHANNELS[-1], dtype)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        pre, post = data[..., :3], data[..., 3:]
        e_post = []
        for fb in self.enc_fusion:
            pre, post = fb(pre, post, train=train)
            e_post.append(post)
        dec5, _, _ = _run_decoder(self.dec_layers, 1, False, e_post, train)
        return self.output_block(dec5, train)


class ParallelUNet(nn.Module):
    """Two independent UNetTemplates, ``unet_pre`` on the pre image and
    ``unet_post`` on the post image (the JAX package's fix of the
    reference, unet.py:385-406), their dec5 maps concatenated for the
    head."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        self.unet_pre = UNetTemplate(cfg)
        self.unet_post = UNetTemplate(cfg)
        self.output_block = OutputTemplate(n_class, 2 * DECODER_CHANNELS[-1],
                                           cfg.compute_dtype, packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        p5, _, _ = self.unet_pre(data[..., :3], train)
        q5, _, _ = self.unet_post(data[..., 3:], train)
        return self.output_block(concat_registered(p5, q5), train)


class ParallelEncUNet(nn.Module):
    """Two independent encoders, the features concatenated per scale, one
    decoder over the doubled channels (reference unet.py:409-461)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, self.enc_pre = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        _, self.enc_post = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        _register(self, "enc_pre", self.enc_pre)
        _register(self, "enc_post", self.enc_post)
        self.dec_layers = make_decoder_stages([2 * c for c in chans], cfg.dilation, cfg.no_skip,
                                              dtype)
        _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(n_class, DECODER_CHANNELS[-1], dtype)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        pre = _encode(self.enc_pre, data[..., :3], train)
        post = _encode(self.enc_post, data[..., 3:], train)
        encs = [concat_registered(a, b) for a, b in zip(pre, post)]
        dec5, _, _ = _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip, encs,
                                  train)
        return self.output_block(dec5, train)


class DiffUNet(nn.Module):
    """UNetLoc on the pre - post difference (reference unet.py:464-475)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet = UNetLoc(cfg, n_class)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.unet(data[..., :3] - data[..., 3:], train)


class CatUNet(nn.Module):
    """UNetLoc on the 6 stacked channels (reference unet.py:478-488)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet = UNetLoc(cfg, n_class, in_channels=6)

    def forward(self, data: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.unet(data, train)


DMG_UNETS = {
    "siamese": SiameseUNet,
    "siameseEnc": SiameseEncUNet,
    "fused": FusedUNet,
    "fusedEnc": FusedEncUNet,
    "parallel": ParallelUNet,
    "parallelEnc": ParallelEncUNet,
    "diff": DiffUNet,
    "cat": CatUNet,
}


def _tail_packed(cfg: Config) -> bool:
    """dec_l5 is s2d-packed unless the decoder is absent (--interpolate) or
    interpolates (--dec_interp); both raise in the port."""
    return not cfg.interpolate and not cfg.dec_interp


def emits_packed_loss_view(cfg: Config) -> bool:
    """True when the model's TRAIN-mode logits come out in the packed loss
    view (B, H/2, 2W, n) instead of the fine grid; the loss consumer pairs it
    with ``ops.losses.packed_loss_view_labels``.  The fused variants ignore
    ``--interpolate`` (reference unet.py:98-108)."""
    if cfg.type == "post" and cfg.dmg_model in ("fused", "fusedEnc"):
        return not cfg.dec_interp
    return _tail_packed(cfg)


def fused_head_defer_ok(cfg: Config) -> bool:
    """The fused chain may defer dec5's final fold into the packed head: the
    head receives dec5 unchanged, or a branch concat whose folds
    ``concat_registered`` joins (siamese, parallel, and fused, whose packed
    FusionBlock defers both group convs' folds)."""
    return _tail_packed(cfg)


def get_dmg_unet(cfg: Config) -> nn.Module:
    """Damage-variant factory (reference unet.py:29-42) with ``n_class`` from
    the loss head rule (``Config.n_class``)."""
    return DMG_UNETS[cfg.dmg_model](cfg, cfg.n_class)


def build_model(cfg: Config) -> nn.Module:
    """Task-level model factory (reference plt.py:26); ``.eval()`` mode."""
    model = UNetLoc(cfg) if cfg.type == "pre" else get_dmg_unet(cfg)
    return model.eval()
