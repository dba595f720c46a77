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

Every model option of the JAX zoo is here: PPM or ASPP on enc5
(``ppm``, ``aspp``; ``ppm_pre``/``ppm_post`` in ``ParallelEncUNet``), the
attention gates on the skips, ``--dec_interp`` (the tail is then fine, not
packed), ``--deep_supervision`` (fine heads ``output_block_ds4`` and
``output_block_ds3`` on dec4 and dec3; train mode returns ``[out, ds4,
ds3]``) and ``--interpolate`` (no decoder; the head on enc5 resized to a
fixed 512^2 in train mode and 1024^2 at eval).  The JAX package's wiring
quirks are kept: ``SiameseEncUNet`` builds its decoder under
``--interpolate`` and its head is then fine and not resized; the fused
variants ignore ``ppm``, ``aspp`` and ``interpolate``.  Its deliberate
fixes are kept too: ``ParallelUNet`` runs ``unet_post`` on the post image,
and the fused variants wire ``dec_interp`` to its own parameter.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.encoder import make_encoder_stages
from xview2_tpu_torch.models.layers import (ASPP, PPM, FusionBlock, OutputBlock,
                                           UpsampleBlock, concat_registered)

DECODER_CHANNELS = (512, 256, 128, 64, 32)  # reference unet.py:90


def _register(module: nn.Module, name: str, members) -> None:
    """Register list members as ``name_i`` (flax's names for a list
    attribute), skipping the ``None`` of truncated decoders."""
    for i, m in enumerate(members):
        if m is not None:
            module.add_module(f"{name}_{i}", m)


def make_decoder_stages(encf: List[int], dilation: int, attention: bool, no_skip: bool,
                        dec_interp: bool, dtype: torch.dtype,
                        packed_tail: bool = True) -> List[Optional[UpsampleBlock]]:
    """The 5 decoder UpsampleBlocks with dilation-aware truncation (leading
    ``None``s where dilation removes stages).  The last stage is s2d-packed
    when ``packed_tail`` and not ``dec_interp``, else fine."""
    decf = DECODER_CHANNELS
    skips = [encf[-2], encf[-3], encf[-4], encf[-5], 0]
    first = {1: 0, 2: 1, 4: 2}[dilation]
    packed = packed_tail and not dec_interp
    stages: List[Optional[UpsampleBlock]] = [None] * first
    cin = encf[-1]
    for i in range(first, 5):
        skip = 0 if no_skip else skips[i]
        stages.append(UpsampleBlock(cin, decf[i], skip, packed_out=packed and i == 4,
                                    dtype=dtype, attention=attention, dec_interp=dec_interp))
        cin = decf[i]
    return stages


def _add_bottleneck(module: nn.Module, cfg: Config, channels: int, dtype: torch.dtype,
                    suffix: str = "") -> None:
    """Register ``ppm{suffix}`` or ``aspp{suffix}`` on enc5 when the config
    asks for it (reference unet.py:124-127)."""
    if cfg.ppm:
        module.add_module(f"ppm{suffix}", PPM(channels, dtype))
    elif cfg.aspp:
        module.add_module(f"aspp{suffix}", ASPP(channels, cfg.dilation, dtype))


def _bottleneck(module: nn.Module, cfg: Config, enc5: torch.Tensor, train: bool,
                suffix: str = "") -> torch.Tensor:
    """enc5 through the module's PPM or ASPP, if it has one."""
    if not (cfg.ppm or cfg.aspp):
        return enc5
    return getattr(module, ("ppm" if cfg.ppm else "aspp") + suffix)(enc5, train)


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
    """Shared encoder + PPM/ASPP bottleneck + decoder on one image of
    ``in_channels`` channels; returns ``(dec5, dec4, dec3)``, or ``(enc5,
    None, None)`` under ``--interpolate`` (no decoder is built)."""

    def __init__(self, cfg: Config, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, stages = make_encoder_stages(cfg.encoder, cfg.dilation, in_channels, dtype)
        self.enc_channels = chans[-1]
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        _add_bottleneck(self, cfg, chans[-1], dtype)
        if not cfg.interpolate:
            self.dec_layers = make_decoder_stages(chans, cfg.dilation, cfg.attention,
                                                  cfg.no_skip, cfg.dec_interp, dtype)
            _register(self, "dec_layers", self.dec_layers)

    def forward(self, data: torch.Tensor, train: bool = False):
        stages = [self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5]
        encs = _encode(stages, data, train)
        encs[4] = _bottleneck(self, self.cfg, encs[4], train)
        if self.cfg.interpolate:
            return encs[4], None, None
        return _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip, encs, train)


def _encode(stages, data: torch.Tensor, train: bool) -> List[torch.Tensor]:
    """The five encoder features of ``data``."""
    feats = []
    for stage in stages:
        data = stage(data, train)
        feats.append(data)
    return feats


def _concat(a, b):
    """Branch concat of two maps, ``None`` where a branch has none."""
    if a is None or b is None:
        return None
    return concat_registered(a, b)


class OutputTemplate(nn.Module):
    """Final head and the train-only deep-supervision heads (reference
    unet.py:175-197) of a model whose heads read ``branches`` concatenated
    maps.  ``packed``: the main head consumes the s2d-packed tail (in
    ``packed_groups`` branches); otherwise it is fine, and under
    ``interpolate`` it reads enc5 (``enc_channels`` a branch) and resizes.
    With ``cfg.deep_supervision`` (and not ``interpolate``) the fine heads
    ``output_block_ds4`` and ``output_block_ds3`` read dec4 and dec3 and
    train mode returns ``[out, ds4, ds3]``."""

    def __init__(self, cfg: Config, n_class: int, branches: int, packed: bool,
                 interpolate: bool, enc_channels: int, packed_groups: int = 1):
        super().__init__()
        dtype = cfg.compute_dtype
        self.ds_active = cfg.deep_supervision and not interpolate
        if self.ds_active:
            self.output_block_ds3 = OutputBlock(n_class, branches * DECODER_CHANNELS[2], dtype,
                                                packed=False)
            self.output_block_ds4 = OutputBlock(n_class, branches * DECODER_CHANNELS[3], dtype,
                                                packed=False)
        fine_in = branches * (enc_channels if interpolate else DECODER_CHANNELS[-1])
        self.output_block = OutputBlock(n_class, fine_in, dtype, packed_groups,
                                        packed=packed and not interpolate,
                                        interpolate=interpolate)

    def forward(self, dec5, dec4=None, dec3=None, train: bool = False):
        out = self.output_block(dec5, train)
        if train and self.ds_active:
            return [out, self.output_block_ds4(dec4, train), self.output_block_ds3(dec3, train)]
        return out


class UNetLoc(nn.Module):
    """Localization U-Net (reference unet.py:200-215).  ``train`` is an
    explicit argument, as in the JAX package; ``nn.Module.training`` is not
    read.  ``in_channels``: 6 for ``CatUNet``."""

    def __init__(self, cfg: Config, n_class: int = 2, in_channels: int = 3):
        super().__init__()
        self.unet = UNetTemplate(cfg, in_channels)
        self.output_block = OutputTemplate(cfg, n_class, 1, _tail_packed(cfg),
                                             cfg.interpolate, self.unet.enc_channels)

    def forward(self, data: torch.Tensor, train: bool = False):
        dec5, dec4, dec3 = self.unet(data, train)
        return self.output_block(dec5, dec4, dec3, train)


class SiameseUNet(nn.Module):
    """True siamese (reference unet.py:218-236): ONE shared UNetTemplate run
    separately on the pre and the post image, the two maps concatenated per
    scale, and heads over both (``packed_groups=2``).  In train mode each
    BatchNorm normalizes each branch by that branch's batch statistics and
    updates its running statistics twice, pre then post, as flax does when
    one module is applied twice."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet = UNetTemplate(cfg)
        self.output_block = OutputTemplate(cfg, n_class, 2, _tail_packed(cfg),
                                             cfg.interpolate, self.unet.enc_channels,
                                             packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False):
        p5, p4, p3 = self.unet(data[..., :3], train)
        q5, q4, q3 = self.unet(data[..., 3:], train)
        return self.output_block(_concat(p5, q5), _concat(p4, q4), _concat(p3, q3), train)


class SiameseEncUNet(nn.Module):
    """One shared encoder (and PPM/ASPP) on pre and post, the features
    concatenated per scale, one decoder over the doubled channels (reference
    unet.py:241-288; each encoder BatchNorm updates its running statistics
    pre then post).  The decoder is built under ``--interpolate`` too: its
    tail and head are then fine, and the head is not resized."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, stages = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        _add_bottleneck(self, cfg, chans[-1], dtype)
        packed = _tail_packed(cfg)
        self.dec_layers = make_decoder_stages([2 * c for c in chans], cfg.dilation,
                                              cfg.attention, cfg.no_skip, cfg.dec_interp, dtype,
                                              packed_tail=packed)
        _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(cfg, n_class, 1, packed, False, chans[-1])

    def _encode(self, data: torch.Tensor, train: bool) -> List[torch.Tensor]:
        encs = _encode([self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5],
                       data, train)
        encs[4] = _bottleneck(self, self.cfg, encs[4], train)
        return encs

    def forward(self, data: torch.Tensor, train: bool = False):
        pre = self._encode(data[..., :3], train)
        post = self._encode(data[..., 3:], train)
        encs = [concat_registered(a, b) for a, b in zip(pre, post)]
        dec5, dec4, dec3 = _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip,
                                        encs, train)
        return self.output_block(dec5, dec4, dec3, train)


class FusedUNet(nn.Module):
    """Two encoders and two decoders with cross-branch fusion after every
    stage (reference unet.py:291-349); dilation is forced to 1, the decoders
    keep their skips, and ``ppm``, ``aspp`` and ``interpolate`` are ignored.
    The last decoder stage fuses in the packed domain, and the head consumes
    the concat of its two packed outputs (``packed_groups=2``); under
    ``--dec_interp`` the last stage and the head are fine."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        dtype = cfg.compute_dtype
        chans, pre = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        _, post = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        self.enc_fusion = [FusionBlock(pre[i], post[i], chans[i], dtype) for i in range(5)]
        _register(self, "enc_fusion", self.enc_fusion)
        packed = not cfg.dec_interp
        pre_dec, post_dec = (make_decoder_stages(chans, 1, cfg.attention, False, cfg.dec_interp,
                                                 dtype, packed_tail=packed) for _ in range(2))
        self.dec_fusion = [FusionBlock(pre_dec[i], post_dec[i], DECODER_CHANNELS[i], dtype,
                                       decoder_mode=True, packed_last=packed and i == 4)
                           for i in range(5)]
        _register(self, "dec_fusion", self.dec_fusion)
        self.output_block = OutputTemplate(cfg, n_class, 2, packed,
                                             False, chans[-1], packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False):
        pre, post = data[..., :3], data[..., 3:]
        e_pre, e_post = [], []
        for fb in self.enc_fusion:
            pre, post = fb(pre, post, train=train)
            e_pre.append(pre)
            e_post.append(post)
        d_pre, d_post = e_pre[4], e_post[4]
        decs = []
        for i, fb in enumerate(self.dec_fusion):
            if i < 4:
                d_pre, d_post = fb(d_pre, d_post, e_pre[3 - i], e_post[3 - i], train=train)
            else:
                d_pre, d_post = fb(d_pre, d_post, last_dec=True, train=train)
            decs.append((d_pre, d_post))
        return self.output_block(_concat(*decs[4]), _concat(*decs[3]), _concat(*decs[2]), train)


class FusedEncUNet(nn.Module):
    """Fused encoders, one decoder on the post branch's features (reference
    unet.py:352-382); dilation 1, skips kept, ``ppm``, ``aspp`` and
    ``interpolate`` ignored."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        dtype = cfg.compute_dtype
        chans, pre = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        _, post = make_encoder_stages(cfg.encoder, 1, 3, dtype)
        self.enc_fusion = [FusionBlock(pre[i], post[i], chans[i], dtype) for i in range(5)]
        _register(self, "enc_fusion", self.enc_fusion)
        self.dec_layers = make_decoder_stages(chans, 1, cfg.attention, False, cfg.dec_interp,
                                              dtype)
        _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(cfg, n_class, 1,
                                             not cfg.dec_interp, False, chans[-1])

    def forward(self, data: torch.Tensor, train: bool = False):
        pre, post = data[..., :3], data[..., 3:]
        e_post = []
        for fb in self.enc_fusion:
            pre, post = fb(pre, post, train=train)
            e_post.append(post)
        dec5, dec4, dec3 = _run_decoder(self.dec_layers, 1, False, e_post, train)
        return self.output_block(dec5, dec4, dec3, train)


class ParallelUNet(nn.Module):
    """Two independent UNetTemplates, ``unet_pre`` on the pre image and
    ``unet_post`` on the post image (the JAX package's fix of the
    reference, unet.py:385-406), their maps concatenated per scale for the
    heads."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet_pre = UNetTemplate(cfg)
        self.unet_post = UNetTemplate(cfg)
        self.output_block = OutputTemplate(cfg, n_class, 2, _tail_packed(cfg),
                                             cfg.interpolate, self.unet_pre.enc_channels,
                                             packed_groups=2)

    def forward(self, data: torch.Tensor, train: bool = False):
        p5, p4, p3 = self.unet_pre(data[..., :3], train)
        q5, q4, q3 = self.unet_post(data[..., 3:], train)
        return self.output_block(_concat(p5, q5), _concat(p4, q4), _concat(p3, q3), train)


class ParallelEncUNet(nn.Module):
    """Two independent encoders, each with its own PPM/ASPP (``ppm_pre``,
    ``ppm_post``, ``aspp_pre``, ``aspp_post``), the features concatenated
    per scale, one decoder over the doubled channels (reference
    unet.py:409-461).  Under ``--interpolate`` there is no decoder and the
    head reads the concat of both enc5 maps."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        chans, self.enc_pre = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        _, self.enc_post = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        _register(self, "enc_pre", self.enc_pre)
        _register(self, "enc_post", self.enc_post)
        for suffix in ("_pre", "_post"):
            _add_bottleneck(self, cfg, chans[-1], dtype, suffix)
        if not cfg.interpolate:
            self.dec_layers = make_decoder_stages([2 * c for c in chans], cfg.dilation,
                                                  cfg.attention, cfg.no_skip, cfg.dec_interp,
                                                  dtype)
            _register(self, "dec_layers", self.dec_layers)
        self.output_block = OutputTemplate(cfg, n_class, 1, _tail_packed(cfg),
                                             cfg.interpolate, 2 * chans[-1])

    def forward(self, data: torch.Tensor, train: bool = False):
        cfg = self.cfg
        pre = _encode(self.enc_pre, data[..., :3], train)
        post = _encode(self.enc_post, data[..., 3:], train)
        pre[4] = _bottleneck(self, cfg, pre[4], train, "_pre")
        post[4] = _bottleneck(self, cfg, post[4], train, "_post")
        if cfg.interpolate:
            return self.output_block(_concat(pre[4], post[4]), train=train)
        encs = [concat_registered(a, b) for a, b in zip(pre, post)]
        dec5, dec4, dec3 = _run_decoder(self.dec_layers, cfg.dilation, cfg.no_skip, encs,
                                        train)
        return self.output_block(dec5, dec4, dec3, train)


class DiffUNet(nn.Module):
    """UNetLoc on the pre - post difference (reference unet.py:464-475)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet = UNetLoc(cfg, n_class)

    def forward(self, data: torch.Tensor, train: bool = False):
        return self.unet(data[..., :3] - data[..., 3:], train)


class CatUNet(nn.Module):
    """UNetLoc on the 6 stacked channels (reference unet.py:478-488)."""

    def __init__(self, cfg: Config, n_class: int = 4):
        super().__init__()
        self.unet = UNetLoc(cfg, n_class, in_channels=6)

    def forward(self, data: torch.Tensor, train: bool = False):
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
    interpolates (--dec_interp)."""
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
