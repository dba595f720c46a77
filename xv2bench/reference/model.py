"""Plain PyTorch reference of the benchmark's two models: the localization
U-Net (``type pre``) and the ``fused`` damage U-Net (``type post``), each on a
ResNeSt encoder (Zhang et al. 2020, arXiv:2004.08955), with the attention
gates (arXiv:1804.03999) and the deep-supervision heads where the
configuration asks for them, and the CORAL head (arXiv:1901.07884) for the
damage model.

Written from the architecture alone: NCHW maps, library convolutions, the
last decoder stage at full resolution, no hand-written kernel, no fused or
packed path.  Parameter names follow the program's variable tree, so the
benchmark loads one seeded state dict into both and ``strict`` loading holds
the two trees to each other.

Precision is the configuration's: parameters and BatchNorm statistics in
float32, every convolution and matrix product on operands in the compute
dtype (bfloat16 at ``precision 16``), BatchNorm normalizing in float32 and
rounding once.  :class:`Precision` also carries the control's rounding
(``lowp.py``): every tensor the compute dtype would round, each
convolution's operands and output, each BatchNorm output and each
elementwise result, then passes through it.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9          # running = 0.9 * running + 0.1 * batch statistic
DECODER = (512, 256, 128, 64, 32)
RESNEST = {"resnest50": ((3, 4, 6, 3), 32), "resnest101": ((3, 4, 23, 3), 64),
           "resnest200": ((3, 24, 36, 3), 64), "resnest269": ((3, 30, 48, 8), 64)}


class Precision:
    """The compute dtype, an optional rounding applied to every tensor that
    the compute dtype rounds, and the dtype of the losses (float32; the
    control's are one step lower)."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                 loss_dtype: torch.dtype = torch.float32):
        self.dtype, self.quant, self.loss_dtype = dtype, quant, loss_dtype
        # LeakyReLU's 0.01 in the compute dtype (a bfloat16 map multiplies by
        # its nearest bfloat16, 0.010009765625)
        self.leaky = float(torch.tensor(0.01, dtype=dtype, device="cpu"))

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return self.round(t.to(self.dtype))

    def round(self, t: torch.Tensor) -> torch.Tensor:
        return self.quant(t) if self.quant is not None else t


def conv(p: Precision, x, w, bias=None, stride=1, padding=0, dilation=1, groups=1):
    y = F.conv2d(p.operand(x), p.operand(w), None, stride, padding, dilation, groups)
    return p.round(y if bias is None else y + bias.to(y.dtype)[:, None, None])


def avg_pool(x, window, stride, padding=0, ceil_mode=False):
    """torch ``AvgPool2d`` summed in float32: ``count_include_pad`` unless
    ``ceil_mode`` (the shortcut's pool divides by the window inside)."""
    y = F.avg_pool2d(x.float(), window, stride, padding, ceil_mode=ceil_mode,
                     count_include_pad=not ceil_mode)
    return y.to(x.dtype)


class BatchNorm(nn.Module):
    def __init__(self, p: Precision, n: int):
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x, train: bool, dtype: torch.dtype):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.var(dim=(0, 2, 3), unbiased=False)
            n = xf.numel() // xf.shape[1]
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(var * (n / max(n - 1, 1)),
                                                        alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(xf.dtype)[:, None, None]
        return self.p.round(y.to(dtype))


# --------------------------------------------------------------- ResNeSt


class SplAtConv2d(nn.Module):
    """Radix-2 split attention, cardinality 1."""

    def __init__(self, p: Precision, cin: int, ch: int, stride: int):
        super().__init__()
        self.p, self.ch, self.stride = p, ch, stride
        inter = max(ch * 2 // 4, 32)
        self.conv = nn.Conv2d(cin, ch * 2, 3, groups=2, bias=False)
        self.bn0 = BatchNorm(p, ch * 2)
        self.fc1 = nn.Conv2d(ch, inter, 1)
        self.bn1 = BatchNorm(p, inter)
        self.fc2 = nn.Conv2d(inter, ch * 2, 1)

    def forward(self, x, train):
        p, ch, dt = self.p, self.ch, self.p.dtype
        y = F.relu(self.bn0(conv(p, x, self.conv.weight, stride=self.stride, padding=1,
                                 groups=2), train, dt))
        y0, y1 = y[:, :ch], y[:, ch:]
        gap = p.round((y0 + y1).float().mean(dim=(2, 3), keepdim=True).to(dt))
        gap = F.relu(self.bn1(conv(p, gap, self.fc1.weight, self.fc1.bias), train, dt))
        att = conv(p, gap, self.fc2.weight, self.fc2.bias).float()
        w0 = p.round(torch.sigmoid(att[:, :ch] - att[:, ch:]).to(dt))   # softmax over the radix
        return p.round(y0 * w0 + y1 * (1 - w0))


class Bottleneck(nn.Module):
    def __init__(self, p: Precision, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, is_first: bool = False):
        super().__init__()
        self.p, self.stride, self.downsample = p, stride, downsample
        self.use_avd = stride > 1 or is_first
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(p, planes)
        self.conv2 = SplAtConv2d(p, planes, planes, 1 if self.use_avd else stride)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(p, planes * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(cin, planes * 4, 1, bias=False)
            self.downsample_bn = BatchNorm(p, planes * 4)

    def forward(self, x, train):
        p, dt = self.p, self.p.dtype
        out = F.relu(self.bn1(conv(p, x, self.conv1.weight), train, dt))
        out = self.conv2(out, train)
        if self.use_avd:
            out = p.round(avg_pool(out, 3, self.stride, padding=1))
        out = self.bn3(conv(p, out, self.conv3.weight), train, dt)
        identity = x
        if self.downsample:
            if self.stride > 1:
                identity = p.round(avg_pool(identity, self.stride, self.stride, ceil_mode=True))
            identity = self.downsample_bn(conv(p, identity, self.downsample_conv.weight),
                                          train, dt)
        return p.round(F.relu(out + identity))


class Stage(nn.Module):
    def __init__(self, p: Precision, cin: int, planes: int, blocks: int, stride: int,
                 is_first: bool):
        super().__init__()
        self.blocks = blocks
        self.block0 = Bottleneck(p, cin, planes, stride, downsample=True, is_first=is_first)
        for i in range(1, blocks):
            setattr(self, f"block{i}", Bottleneck(p, planes * 4, planes))

    def forward(self, x, train):
        for i in range(self.blocks):
            x = getattr(self, f"block{i}")(x, train)
        return x


class PooledStage(nn.Module):
    """3x3 stride-2 max pool, then the first residual stage."""

    def __init__(self, stage: nn.Module):
        super().__init__()
        self.stage = stage

    def forward(self, x, train):
        return self.stage(F.max_pool2d(x, 3, stride=2, padding=1), train)


class Stem(nn.Module):
    def __init__(self, p: Precision, cin: int, sw: int):
        super().__init__()
        self.p = p
        self.conv1a = nn.Conv2d(cin, sw, 3, bias=False)
        self.bn1a = BatchNorm(p, sw)
        self.conv1b = nn.Conv2d(sw, sw, 3, bias=False)
        self.bn1b = BatchNorm(p, sw)
        self.conv1c = nn.Conv2d(sw, 2 * sw, 3, bias=False)
        self.bn1 = BatchNorm(p, 2 * sw)

    def forward(self, x, train):
        p, dt = self.p, self.p.dtype
        x = F.relu(self.bn1a(conv(p, x, self.conv1a.weight, stride=2, padding=1), train, dt))
        x = F.relu(self.bn1b(conv(p, x, self.conv1b.weight, padding=1), train, dt))
        return F.relu(self.bn1(conv(p, x, self.conv1c.weight, padding=1), train, dt))


def encoder(p: Precision, arch: str, cin: int):
    """The five stages and their output channels."""
    if arch not in RESNEST:
        raise ValueError(f"the reference has the ResNeSt encoders {sorted(RESNEST)} only, "
                         f"not {arch!r}")
    layers, sw = RESNEST[arch]
    chans = [2 * sw, 256, 512, 1024, 2048]
    stages: List[nn.Module] = [Stem(p, cin, sw)]
    prev = 2 * sw
    for i, blocks in enumerate(layers):
        stage = Stage(p, prev, 64 * 2 ** i, blocks, 1 if i == 0 else 2, is_first=i > 0)
        stages.append(PooledStage(stage) if i == 0 else stage)
        prev = 256 * 2 ** i
    return chans, stages


# --------------------------------------------------------------- decoder


class ConvLayer(nn.Module):
    """3x3 conv, BatchNorm, LeakyReLU(0.01)."""

    def __init__(self, p: Precision, cin: int, cout: int):
        super().__init__()
        self.p = p
        self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm(p, cout)

    def forward(self, x, train):
        y = self.BatchNorm_0(conv(self.p, x, self.Conv_0.weight, padding=1), train, self.p.dtype)
        return self.p.round(F.leaky_relu(y, self.p.leaky))


class ConvBlock(nn.Module):
    def __init__(self, p: Precision, cin: int, cout: int):
        super().__init__()
        self.conv1 = ConvLayer(p, cin, cout)
        self.conv2 = ConvLayer(p, cout, cout)

    def forward(self, x, train):
        return self.conv2(self.conv1(x, train), train)


class AttentionLayer(nn.Module):
    """1x1 conv and BatchNorm, no activation."""

    def __init__(self, p: Precision, cin: int, cout: int):
        super().__init__()
        self.p = p
        self.Conv_0 = nn.Conv2d(cin, cout, 1, bias=False)
        self.BatchNorm_0 = BatchNorm(p, cout)

    def forward(self, x, train):
        return self.BatchNorm_0(conv(self.p, x, self.Conv_0.weight), train, self.p.dtype)


class Transpose2x2(nn.Module):
    """2x2 stride-2 transposed convolution, no bias; weight (in, out, 2, 2)."""

    def __init__(self, p: Precision, cin: int, cout: int):
        super().__init__()
        self.p = p
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))

    def forward(self, x):
        return self.p.round(F.conv_transpose2d(self.p.operand(x), self.p.operand(self.weight),
                                               stride=2))


class UpsampleBlock(nn.Module):
    """Upsample, the optional attention gate on the skip, concat, ConvBlock."""

    def __init__(self, p: Precision, cin: int, cout: int, skip: int, attention: bool):
        super().__init__()
        self.p, self.skip, self.attention = p, skip, attention and bool(skip)
        self.conv_transpose = Transpose2x2(p, cin, cout)
        if self.attention:
            self.conv_o = AttentionLayer(p, cout, cout // 2)
            self.conv_s = AttentionLayer(p, skip, cout // 2)
            self.psi = AttentionLayer(p, cout // 2, 1)
        self.conv_block = ConvBlock(p, cout + skip, cout)

    def forward(self, x, skip, train):
        out = self.conv_transpose(x)
        if self.skip:
            if self.attention:
                gate = self.p.round(F.relu(self.conv_o(out, train) + self.conv_s(skip, train)))
                skip = self.p.round(skip * self.p.round(torch.sigmoid(self.psi(gate, train))))
            out = torch.cat([out, skip], dim=1)
        return self.conv_block(out, train)


def decoder(p: Precision, chans, attention: bool) -> List[UpsampleBlock]:
    skips = [chans[3], chans[2], chans[1], chans[0], 0]
    cin, out = chans[4], []
    for f, skip in zip(DECODER, skips):
        out.append(UpsampleBlock(p, cin, f, skip, attention))
        cin = f
    return out


class Head(nn.Module):
    """1x1 head; the CORAL head is one logit without a bias plus the shared
    ordinal bias, broadcast to three levels."""

    def __init__(self, p: Precision, cin: int, n_class: int):
        super().__init__()
        self.p, self.coral = p, n_class == 3
        self.conv = nn.Conv2d(cin, 1 if self.coral else n_class, 1, bias=not self.coral)
        if self.coral:
            self.coral_bias = nn.Parameter(torch.tensor([1.0, 0.0, -1.0]))

    def forward(self, x):
        out = conv(self.p, x, self.conv.weight, self.conv.bias)
        if self.coral:
            out = self.p.round(out + self.coral_bias.to(out.dtype)[:, None, None])
        return out


class Heads(nn.Module):
    def __init__(self, p: Precision, branches: int, n_class: int, deep_supervision: bool):
        super().__init__()
        self.ds = deep_supervision
        if deep_supervision:
            self.output_block_ds3 = Head(p, branches * DECODER[2], n_class)
            self.output_block_ds4 = Head(p, branches * DECODER[3], n_class)
        self.output_block = Head(p, branches * DECODER[4], n_class)

    def forward(self, dec5, dec4, dec3, train):
        out = self.output_block(dec5)
        if train and self.ds:
            return [out, self.output_block_ds4(dec4), self.output_block_ds3(dec3)]
        return out


def _register(module: nn.Module, name: str, members) -> None:
    for i, m in enumerate(members):
        module.add_module(f"{name}_{i}", m)


class Template(nn.Module):
    def __init__(self, p: Precision, arch: str, attention: bool):
        super().__init__()
        chans, stages = encoder(p, arch, 3)
        self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5 = stages
        self.dec = decoder(p, chans, attention)
        _register(self, "dec_layers", self.dec)

    def forward(self, x, train):
        encs = []
        for stage in (self.enc_l1, self.enc_l2, self.enc_l3, self.enc_l4, self.enc_l5):
            x = stage(x, train)
            encs.append(x)
        d = self.dec[1](self.dec[0](encs[4], encs[3], train), encs[2], train)
        dec3 = self.dec[2](d, encs[1], train)
        dec4 = self.dec[3](dec3, encs[0], train)
        return self.dec[4](dec4, None, train), dec4, dec3


class UNetLoc(nn.Module):
    """Localization U-Net: two logits a pixel."""

    def __init__(self, p: Precision, arch: str, attention: bool, deep_supervision: bool):
        super().__init__()
        self.unet = Template(p, arch, attention)
        self.output_block = Heads(p, 1, 2, deep_supervision)

    def forward(self, x, train: bool = False):
        return self.output_block(*self.unet(x, train), train)


class Fusion(nn.Module):
    """Run the pre and post sub-layers, concatenate the branches and re-mix
    them with two ConvLayers."""

    def __init__(self, p: Precision, pre: nn.Module, post: nn.Module, features: int):
        super().__init__()
        self.pre_layer, self.post_layer = pre, post
        self.conv_pre = ConvLayer(p, 2 * features, features)
        self.conv_post = ConvLayer(p, 2 * features, features)

    def forward(self, pre, post, train, skips=None):
        if skips is None:
            pre, post = self.pre_layer(pre, train), self.post_layer(post, train)
        else:
            pre = self.pre_layer(pre, skips[0], train)
            post = self.post_layer(post, skips[1], train)
        fmap = torch.cat([pre, post], dim=1)
        return self.conv_pre(fmap, train), self.conv_post(fmap, train)


class FusedUNet(nn.Module):
    """Two encoders and two decoders, fused after every stage; the heads read
    the concat of both branches."""

    def __init__(self, p: Precision, arch: str, attention: bool, deep_supervision: bool,
                 n_class: int):
        super().__init__()
        chans, pre = encoder(p, arch, 3)
        _, post = encoder(p, arch, 3)
        self.enc = [Fusion(p, a, b, c) for a, b, c in zip(pre, post, chans)]
        _register(self, "enc_fusion", self.enc)
        self.dec = [Fusion(p, a, b, c) for a, b, c in
                    zip(decoder(p, chans, attention), decoder(p, chans, attention), DECODER)]
        _register(self, "dec_fusion", self.dec)
        self.output_block = Heads(p, 2, n_class, deep_supervision)

    def forward(self, x, train: bool = False):
        pre, post = x[:, :3], x[:, 3:]
        e_pre, e_post = [], []
        for fb in self.enc:
            pre, post = fb(pre, post, train)
            e_pre.append(pre)
            e_post.append(post)
        d_pre, d_post = e_pre[4], e_post[4]
        decs = []
        for i, fb in enumerate(self.dec):
            skips = (e_pre[3 - i], e_post[3 - i]) if i < 4 else (None, None)
            d_pre, d_post = fb(d_pre, d_post, train, skips)
            decs.append(torch.cat([d_pre, d_post], dim=1))
        return self.output_block(decs[4], decs[3], decs[2], train)


def build(spec: dict, p: Precision) -> nn.Module:
    """The model of a configuration's ``program`` fields."""
    attention, ds = bool(spec.get("attention")), bool(spec.get("deep_supervision"))
    if spec["type"] == "pre":
        return UNetLoc(p, spec["encoder"], attention, ds)
    if spec.get("dmg_model") != "fused":
        raise ValueError(f"the reference has the fused damage model only, not "
                         f"{spec.get('dmg_model')!r}")
    n_class = {"coral": 3, "mse": 1}.get(spec["loss_str"], 4)
    return FusedUNet(p, spec["encoder"], attention, ds, n_class)


def forward_nhwc(model: nn.Module, x: torch.Tensor, train: bool = False):
    """``model`` on an NHWC batch; NHWC logits (a list under deep
    supervision in train mode)."""
    out = model(x.permute(0, 3, 1, 2), train)
    if isinstance(out, list):
        return [o.permute(0, 2, 3, 1) for o in out]
    return out.permute(0, 2, 3, 1)


def tta_logits(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The mean of the four flips' logits (NHWC), each flip's forward run on
    its own (eval-mode BatchNorm treats every image alone), averaged in the
    compute dtype, then float32."""
    outs = [forward_nhwc(model, v) for v in (x, x.flip(1), x.flip(2), x.flip((1, 2)))]
    mean = (outs[0] + outs[1].flip(1) + outs[2].flip(2) + outs[3].flip((1, 2))) / 4.0
    return mean.float()
