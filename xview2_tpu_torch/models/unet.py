"""The localization U-Net and the Siamese damage U-Net (port of
``xview2_tpu/models/unet.py``).

``build_model(cfg)`` builds ``UNetLoc`` for ``--type pre`` and, for
``--type post --dmg_model siamese``, ``SiameseUNet``; either with a ResNet
or a ResNeSt encoder and the s2d-packed decoder tail feeding the packed
head.  Inputs are NHWC ``(B, H, W, 3)`` (localization) or ``(B, H, W, 6)``
(pre ++ post channels), logits NHWC ``(B, H, W, n_class)``; in train mode
the logits come out in the packed loss view ``(B, H/2, 2W, n_class)``
(:func:`emits_packed_loss_view`).  Module names follow the flax tree
(``unet.enc_l1``, ``unet.dec_layers_4.conv_block.conv1.Conv_0``,
``output_block.output_block.conv``).

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the other seven damage variants, the CORAL and MSE heads, PPM/ASPP,
attention, deep supervision, ``--dec_interp`` and ``--interpolate``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.encoder import make_encoder_stages
from xview2_tpu_torch.models.layers import OutputBlock, UpsampleBlock, concat_registered

DECODER_CHANNELS = (512, 256, 128, 64, 32)  # reference unet.py:90


def _unsupported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to xview2_tpu_torch yet "
                               f"(ROADMAP Queue 1, {item})")


def check_supported(cfg: Config) -> None:
    """Raise for every model option outside this slice of the port."""
    if cfg.type == "post" and cfg.dmg_model != "siamese":
        raise _unsupported(f"--dmg_model {cfg.dmg_model}", "damage variants")
    if cfg.type == "post" and cfg.n_class != 4:
        raise _unsupported(f"--loss_str {cfg.loss_str} (the MSE and CORAL heads)",
                           "damage variants")
    if cfg.ppm or cfg.aspp:
        raise _unsupported("--ppm/--aspp", "decoder options")
    if cfg.attention:
        raise _unsupported("--attention", "decoder options")
    if cfg.deep_supervision:
        raise _unsupported("--deep_supervision", "decoder options")
    if cfg.interpolate or cfg.dec_interp:
        raise _unsupported("--interpolate/--dec_interp", "decoder options")


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
    """Shared encoder + decoder on one 3-channel image; returns
    ``(dec5, dec4, dec3)``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        # 3 channels: the Siamese model runs the template on each half of a pair
        chans, stages = make_encoder_stages(cfg.encoder, cfg.dilation, 3, dtype)
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        self.dec_layers = make_decoder_stages(chans, cfg.dilation, cfg.no_skip, dtype)
        for i, stage in enumerate(self.dec_layers):
            if stage is not None:
                self.add_module(f"dec_layers_{i}", stage)

    def forward(self, data: torch.Tensor, train: bool = False):
        enc1 = self.enc_l1(data, train)
        enc2 = self.enc_l2(enc1, train)
        enc3 = self.enc_l3(enc2, train)
        enc4 = self.enc_l4(enc3, train)
        enc5 = self.enc_l5(enc4, train)
        return _run_decoder(self.dec_layers, self.cfg.dilation, self.cfg.no_skip,
                            (enc1, enc2, enc3, enc4, enc5), train)


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
    read."""

    def __init__(self, cfg: Config, n_class: int = 2):
        super().__init__()
        check_supported(cfg)
        self.unet = UNetTemplate(cfg)
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


def emits_packed_loss_view(cfg: Config) -> bool:
    """True when the model's TRAIN-mode logits come out in the packed loss
    view (B, H/2, 2W, n) instead of the fine grid; the loss consumer pairs it
    with ``ops.losses.packed_loss_view_labels``.  The tail is packed unless
    the decoder is absent or interpolating (both raise in the port)."""
    return not cfg.interpolate and not cfg.dec_interp


def fused_head_defer_ok(cfg: Config) -> bool:
    """The fused chain may defer dec5's final fold into the packed head: the
    tail is packed unless the decoder is absent or interpolating."""
    return not cfg.interpolate and not cfg.dec_interp


def get_dmg_unet(cfg: Config) -> nn.Module:
    """Damage-variant factory (reference unet.py:29-42) with ``n_class`` from
    the loss head rule (``Config.n_class``); only ``siamese`` is ported
    (:func:`check_supported` raises for the others)."""
    return SiameseUNet(cfg, cfg.n_class)


def build_model(cfg: Config) -> nn.Module:
    """Task-level model factory (reference plt.py:26); ``.eval()`` mode."""
    model = UNetLoc(cfg) if cfg.type == "pre" else get_dmg_unet(cfg)
    return model.eval()
