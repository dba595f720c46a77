"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and the CUDA toolkit; elsewhere they skip.
On the card (no JAX needed)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Small shapes; ``chip_smoke.py`` holds the kernels at the main paths' shapes.
"""

import copy
import itertools
import math

import pytest
import torch

from torch_relayout_views import RELAYOUT_DTYPES, RELAYOUT_SIZES, relayout_views
from xview2_tpu_torch.models import layers as tl
from xview2_tpu_torch.models import resnest, resnet
from xview2_tpu_torch.ops import autoaugment as taa
from xview2_tpu_torch.ops import layout
from xview2_tpu_torch.ops import norm_act as na
from xview2_tpu_torch.ops import packed_fused_conv as pfc
from xview2_tpu_torch.ops import rowshift
from xview2_tpu_torch.ops import small_conv as sc
from xview2_tpu_torch.train.optimizers import OPTIMIZERS

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _fold(c, gen):
    return (torch.randn(c, generator=gen, device="cuda") * 0.5,
            torch.rand(c, generator=gen, device="cuda") + 0.5,
            torch.randn(c, generator=gen, device="cuda") * 0.5)


# (B, H, W, C, Co) of the redesigned bf16 kernels: the six layers of the
# decoder tail at reduced batch (W = 64 fills a 4 x 64 tile, C = 768, Co =
# 256), then ragged ones: a W that is no multiple of any tile width, an H that
# is no multiple of the rows per block, a W below the narrowest tile, one
# column strip and a half
_PATH_SHAPES = [(1, 64, 64, 768, 256), (1, 64, 64, 256, 256), (1, 128, 128, 384, 128),
                (1, 128, 128, 128, 128), (1, 256, 256, 128, 128), (2, 13, 70, 128, 128),
                (1, 37, 200, 64, 256), (2, 9, 7, 32, 128), (1, 5, 97, 192, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_relayout_bit_exact(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((3, 5, 33, 17), generator=gen, device="cuda") * 100).to(dtype)
    for view in (x, x.permute(0, 2, 3, 1), x[:, 1:4, ::2], x[0]):
        got = layout.relayout_cuda(view)
        assert got.is_contiguous() and torch.equal(got, view)


def _bytes(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("n", RELAYOUT_SIZES)
@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
def test_relayout_paths_are_bit_exact(dtype, n):
    """K1 on both of its paths, byte for byte."""
    for kind, (view, path) in relayout_views(dtype, n, "cuda").items():
        assert layout.relayout_plan(view.shape, view.stride())[0] == path, kind
        got = layout.relayout_cuda(view)
        torch.cuda.synchronize()
        assert got.is_contiguous() and got.shape == view.shape, kind
        assert torch.equal(_bytes(got), _bytes(view)), kind


@pytest.mark.parametrize("dtype", RELAYOUT_DTYPES)
def test_relayout_paths_at_many_blocks(dtype):
    """Sizes that spread over many blocks and leave ragged tails: each path
    byte for byte."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn((5, 3, 301, 207), generator=gen, device="cuda") * 100).to(dtype)
    flat = x.view(-1)
    views = {layout.FLAT: (flat, flat[3:-5]),
             layout.STRIDED: (x[:, :, 1:-1], x.permute(0, 2, 1, 3), x.permute(0, 2, 3, 1),
                              x[:, :2].permute(0, 2, 3, 1), x[:, :, ::2, ::3],
                              x.permute(0, 2, 1, 3)[..., ::2])}
    for path, vs in views.items():
        for view in vs:
            assert layout.relayout_plan(view.shape, view.stride())[0] == path
            got = layout.relayout_cuda(view)
            torch.cuda.synchronize()
            assert torch.equal(_bytes(got), _bytes(view)), (path, tuple(view.shape))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_relayout_damage_logits_bit_exact(dtype):
    """K1 at the damage task's 4 classes: the eval logits and the train
    loss view (and its labels, 3-D), contiguous and NCHW viewed NHWC."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((2, 4, 24, 40), generator=gen, device="cuda") * 100).to(dtype)
    for view in (x.permute(0, 2, 3, 1).contiguous(), x.permute(0, 2, 3, 1), x[:, 0]):
        got = layout.relayout_cuda(view)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(_bytes(got), _bytes(view))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [3, 1], ids=["coral", "mse"])
def test_relayout_coral_and_mse_logits_bit_exact(n, dtype):
    """K1 at the CORAL head's 3 level logits and the MSE head's 1: the eval
    logits and the train loss view, contiguous and NCHW viewed NHWC."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = (torch.randn((2, n, 24, 40), generator=gen, device="cuda") * 100).to(dtype)
    for view in (x.permute(0, 2, 3, 1).contiguous(), x.permute(0, 2, 3, 1)):
        got = layout.relayout_cuda(view)
        torch.cuda.synchronize()
        # reshape: at n = 1 the permuted view counts as contiguous with a last stride of 960
        assert got.is_contiguous() and torch.equal(got.reshape(-1).view(torch.uint8),
                                                   view.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("mode", [(3, 2, 1, False, True), (3, 1, 1, False, True),
                                  (2, 2, 0, True, False)], ids=["avd", "avd-s1", "avg-down"])
def test_resnest_pools_forward_and_backward_equal_the_cpu(mode):
    """The ResNeSt pools (a library call, no kernel of the port) on the card
    against the CPU, forward and backward, on channels-last maps of even and
    odd size.  (torch's CUDA backward of ``avg_pool2d`` on a channels-last
    map with padding disagrees with its CPU backward by the gradient's whole
    size, so the port pools an NCHW copy.)"""
    from xview2_tpu_torch.models.resnest import avg_pool_torch

    gen = torch.Generator().manual_seed(6)
    for hw in ((32, 32), (33, 31)):
        x = torch.randn((4,) + hw + (16,), generator=gen)
        w = None
        res = {}
        for dev in ("cpu", "cuda"):
            xd = x.clone().to(dev).requires_grad_()
            y = avg_pool_torch(xd, *mode)
            w = torch.randn(y.shape, generator=gen) if w is None else w
            (y * w.to(dev)).sum().backward()
            res[dev] = (y.detach().cpu(), xd.grad.cpu())
        for got, want in zip(res["cuda"], res["cpu"]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


_RESNEST_MODULES = {
    # radix 2, cardinality 1: the 3x3 conv is one grouped conv (groups = 2)
    "splat-s2": lambda: resnest.SplAtConv2d(32, 32, stride=2),
    # the general path: radix 2 x cardinality 2 (groups = 4), dilated
    "splat-card2-d2": lambda: resnest.SplAtConv2d(32, 32, dilation=2, cardinality=2),
    # avd at stride 2 and the avg-down shortcut (odd map: ceil mode)
    "bottleneck-s2": lambda: resnest.ResNeStBottleneck(32, 16, stride=2, downsample=True,
                                                        downsample_pool_stride=2, is_first=True),
    "bottleneck-d2": lambda: resnest.ResNeStBottleneck(64, 16, dilation=2),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(_RESNEST_MODULES))
def test_resnest_modules_forward_and_backward_equal_the_cpu(name, train, monkeypatch):
    """The split-attention conv and the bottleneck (library calls, no kernel
    of the port) on channels-last maps on the card, float32 with TF32 off,
    against the CPU: the output, the gradient of every parameter and of the
    input, and the running statistics within 1e-4 of each tensor's scale
    (at least 1e-4 of the largest gradient: fc1's bias feeds train-mode
    ``bn1``, so its true gradient is zero and what remains is rounding).
    Each sample has its own contrast and brightness, so that ``bn1``'s
    statistics over the batch's pooled values are well conditioned."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.manual_seed(0)
    mod = _RESNEST_MODULES[name]()
    gen = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for k, t in mod.state_dict().items():
            if k.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif k.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    cin = mod.conv.in_channels if hasattr(mod, "conv") else mod.conv1.in_channels
    x = (torch.randn((8, 17, 19, cin), generator=gen) * (torch.rand((8, 1, 1, cin), generator=gen)
                                                          * 1.7 + 0.3)
         + torch.randn((8, 1, 1, cin), generator=gen))
    w, res = None, {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(mod).to(dev, torch.float32)
        xd = x.detach().to(dev).requires_grad_()
        y = m(xd, train)
        w = torch.randn(y.shape, generator=gen) if w is None else w
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad((y * w.to(dev)).sum(), params + (xd,))
        stats = {k: v for k, v in m.state_dict().items() if "running" in k}
        res[dev] = (y.detach().cpu(), dict(zip(names + ("x",), (g.cpu() for g in grads))),
                    {k: v.cpu() for k, v in stats.items()})
    (yg, gg, sg), (yc, gc, sc) = res["cuda"], res["cpu"]
    gmax = max(g.abs().max().item() for g in gc.values())
    for got, want, floor in [(yg, yc, 0.0)] + [(gg[k], gc[k], gmax) for k in gc] \
            + [(sg[k], sc[k], 0.0) for k in sc]:
        tol = 1e-4 * max(want.abs().max().item(), floor, 1e-6)
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


def test_relayout_gradient_runs_the_kernel():
    x = torch.randn(2, 8, 8, 2, device="cuda", requires_grad=True)
    before = layout.relayout_cuda.launches
    (layout.relayout_standard(x) * 3).sum().backward()
    assert layout.relayout_cuda.launches == before + 2
    assert torch.equal(x.grad, torch.full_like(x, 3.0))


def test_kernel_variants_follow_the_static_shape():
    """The dispatch inside the C entry points: the decoder tail's shapes take
    the pipelined mma.sync kernels, the others the earlier tiles."""
    bf, f32 = torch.bfloat16, torch.float32
    assert "wgmma" in pfc.kernel_variant("conv_bn_fused", 64, 64, 768, 256, bf)
    assert "4x64" in pfc.kernel_variant("conv_bn_fused", 64, 64, 256, 256, bf)
    assert "2x128" in pfc.kernel_variant("conv_bn_fused", 512, 512, 128, 128, bf)
    assert "16x16" in pfc.kernel_variant("conv_bn_fused", 9, 7, 32, 128, bf)
    assert "wmma" in pfc.kernel_variant("conv_bn_fused", 24, 136, 384, 192, bf)
    assert pfc.kernel_variant("conv_bn_fused", 64, 64, 128, 128, f32) == "f32 FMA"
    assert "wgmma" in pfc.kernel_variant("conv_bn_wgrad", 64, 64, 768, 256, bf)
    assert "wmma" in pfc.kernel_variant("conv_bn_wgrad", 9, 7, 32, 64, bf)
    assert pfc.kernel_variant("conv_bn_wgrad", 9, 7, 32, 64, f32) == "f32 FMA"
    with pytest.raises(ValueError):
        pfc.kernel_variant("conv_bn_fused", 8, 8, 100, 64, bf)


@pytest.mark.parametrize("has_fold", [False, True])
def test_conv_bn_fused_out_is_bit_equal_between_runs(has_fold):
    """out has no atomics in its way: two runs on the same input are EQUAL
    (s1 and s2 are added with atomics and only agree to f32 sum order)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((2, 37, 200, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k = (torch.randn((3, 3, 128, 256), generator=gen, device="cuda") / 34).to(torch.bfloat16)
    fold = _fold(128, gen)
    first = pfc.conv_bn_fused(x, k, fold, has_fold)
    second = pfc.conv_bn_fused(x, k, fold, has_fold)
    assert torch.equal(first[0], second[0])
    for a, b in zip(first[1:], second[1:]):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("shape", [(2, 37, 70, 128, 128), (1, 9, 7, 64, 128), (1, 9, 7, 32, 64)])
def test_fused_prologue_is_bit_equal_through_the_kernels(shape):
    """The prologue inside K2 and K4 against the plain one, EQUAL: an identity
    centre tap makes K2's out the activated map itself (a * 1 and zeros, one
    exact rounding), and a cotangent that is 1 at one pixel makes K4's dW the
    activated 3x3 neighbourhood of that pixel (zero in the SAME halo).  The
    inputs span 12 binades so that every rounding of the prologue is met."""
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    x = (x * torch.exp2(torch.randint(-6, 6, x.shape, generator=gen, device="cuda").float()))
    x = x.to(torch.bfloat16)
    fold = _fold(c, gen)
    a = pfc.prologue(x, fold)
    k = torch.zeros((3, 3, c, co), device="cuda", dtype=torch.bfloat16)
    k[1, 1, torch.arange(min(c, co)), torch.arange(min(c, co))] = 1
    out, _, _ = pfc.conv_bn_fused(x, k, fold, True)
    assert torch.equal(out[..., :min(c, co)], a[..., :min(c, co)])
    for (y0, x0) in ((0, 0), (h - 1, w - 1), (h // 2, w // 2)):
        g = torch.zeros((b, h, w, co), device="cuda", dtype=torch.bfloat16)
        g[b - 1, y0, x0] = 1
        dw = pfc.conv_bn_wgrad(x, g, fold, True).reshape(3, 3, c, co)
        ap = torch.nn.functional.pad(a[b - 1].float(), (0, 0, 1, 1, 1, 1))
        want = ap[y0:y0 + 3, x0:x0 + 3]
        assert torch.equal(dw, want[..., None].expand(3, 3, c, co))


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)])
@pytest.mark.parametrize("has_fold", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (1, 24, 136, 384, 192),
                                   (2, 9, 7, 32, 64)] + _PATH_SHAPES)
def test_conv_bn_fused_matches_plain(shape, has_fold, dtype, tol, monkeypatch):
    b, h, w, c, co = shape
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # full-f32 plain version
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    fold = _fold(c, gen)
    out, s1, s2 = pfc.conv_bn_fused(x, k, fold, has_fold)
    ref, r1, r2 = pfc.reference_conv_bn(x, k, fold if has_fold else None)
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2 * tol * ref.float().abs() + 1e-3 * scale).all()), err.max().item()
    abs_sum = ref.float().abs().sum(dim=(0, 1, 2))
    assert bool(((s1 - r1).abs() <= 1e-3 * abs_sum + 1e-4).all())
    assert bool(((s2 - r2).abs() <= 1e-3 * r2 + 1e-4).all())


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2 ** -7), (torch.float32, 1e-5)])
@pytest.mark.parametrize("pads", [(1, 0), (0, 1), (0, 0)])
@pytest.mark.parametrize("shape", [(2, 16, 256, 128, 128), (2, 9, 7, 64, 128),
                                   (1, 24, 136, 384, 192)])
def test_conv_bn_fused_band_matches_plain_and_the_whole_height(shape, pads, dtype, tol,
                                                               monkeypatch):
    """K2 in band mode (``--spatial_shards``): H output rows from an input
    that carries a halo row where a pad flag is 0, against its plain version
    and EQUAL to the whole-height K2's rows on the same input."""
    b, h, w, c, co = shape
    pt, pb = pads
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((b, h + 2 - pt - pb, w, c), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    fold = _fold(c, gen)
    out, s1, s2 = pfc.conv_bn_fused(x, k, fold, True, pt, pb)
    ref, r1, r2 = pfc.reference_conv_bn(x, k, fold, pt, pb)
    assert out.shape == (b, h, w, co)
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2 * tol * ref.float().abs() + 1e-3 * scale).all()), err.max().item()
    assert bool(((s1 - r1).abs() <= 1e-3 * ref.float().abs().sum(dim=(0, 1, 2)) + 1e-4).all())
    assert bool(((s2 - r2).abs() <= 1e-3 * r2 + 1e-4).all())
    whole = pfc.conv_bn_fused(x, k, fold, True)[0]
    assert torch.equal(out, whole[:, 1 - pt:1 - pt + h])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("co", [4, 8, 16])
def test_head_conv_fused_matches_plain(co, dtype):
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 16, 20, 128), generator=gen, device="cuda").to(dtype)
    kmat = torch.randn((128, co), generator=gen, device="cuda") / math.sqrt(128)
    hbias = torch.randn(co, generator=gen, device="cuda")
    fold = _fold(128, gen)
    got = pfc.head_conv_fused(x, kmat, hbias, fold).float()
    want = pfc.reference_head(x, kmat, hbias, fold).float()
    gemm = torch.matmul(pfc.prologue(x, fold), kmat.to(dtype)).float()
    # one rounding after the GEMM (the bias may cancel its magnitude), one after the bias
    tol = 2 * torch.finfo(dtype).eps * (gemm.abs() + want.abs()) + 1e-3 * want.abs().max()
    assert bool(((got - want).abs() <= tol).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    x = torch.zeros((1, 16, 16, 100), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pfc.conv_bn_fused(x, torch.zeros((3, 3, 100, 64), device="cuda"), _fold(100, None), True)
    with pytest.raises(ValueError):
        pfc.conv_bn_fused(torch.zeros((1, 8, 8, 32), device="cuda", dtype=torch.float64),
                          torch.zeros((3, 3, 32, 64), device="cuda"), None, False)
    with pytest.raises(ValueError):
        pfc.head_conv_fused(torch.zeros((1, 4, 4, 128), device="cuda").permute(0, 2, 1, 3),
                            torch.zeros((128, 8)), torch.zeros(8), _fold(128, None))


def _bwd_case(shape, dtype, seed=3):
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((3, 3, c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    return x, g, k, _fold(c, gen)


_BWD_SHAPES = [(2, 16, 16, 128, 128), (1, 24, 136, 384, 192), (2, 9, 7, 32, 64),
               (1, 8, 70, 64, 64)] + _PATH_SHAPES


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("has_fold", [False, True])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_conv_bn_wgrad_matches_plain(shape, has_fold, dtype):
    """dW stays f32 in the kernel and in the plain version: they differ by
    the f32 order of the sums only (atomics across the pixel splits), held
    to 1e-3 of max |dW|."""
    x, g, _, fold = _bwd_case(shape, dtype)
    got = pfc.conv_bn_wgrad(x, g, fold, has_fold)
    want = pfc.reference_wgrad(x, g, fold if has_fold else None)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("has_fold", [False, True])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_conv_bn_dgrad_matches_plain(shape, has_fold, dtype):
    """dx within one rounding of its dtype plus 1e-3 of the scale (f32 sums
    in another order); the fold sums within 1e-3 * max(1, max |sum|)."""
    b, h, w, c, co = shape
    if c % 64:
        pytest.skip("the dgrad kernel tiles the produced channels (C) by 64")
    x, g, k, fold = _bwd_case(shape, dtype)
    kf = pfc.flip_kernel(k)
    dx, db, dm = pfc.conv_bn_dgrad(g, kf, x, fold, has_fold)
    rx, rb, rm = pfc.reference_dgrad(g, kf, x, fold if has_fold else None)
    eps = torch.finfo(dtype).eps
    scale = rx.float().abs().max().item()
    err = (dx.float() - rx.float()).abs()
    assert bool((err <= 2 * eps * rx.float().abs() + 1e-3 * scale).all()), err.max().item()
    for got, want in ((db, rb), (dm, rm)):
        assert (got - want).abs().max().item() <= 1e-3 * max(want.abs().max().item(), 1.0)


# (B, H, W, C, Co) that the pipelined K5 takes (C % 128 == 0), at ragged H and
# W: a W that is no multiple of any tile width, an H that is no multiple of
# the rows per tile, a W below the narrowest tile, C = 384 from Co = 128, and
# Co = 32 (two chunks of g, fewer than the ring's stages)
_DGRAD_RAGGED = [(2, 13, 70, 256, 128), (3, 37, 200, 128, 256), (1, 5, 97, 128, 128),
                 (2, 9, 7, 384, 128), (1, 24, 136, 128, 32)]


@pytest.mark.parametrize("has_fold", [False, True])
@pytest.mark.parametrize("shape", _DGRAD_RAGGED)
def test_conv_bn_dgrad_pipelined_matches_plain_and_repeats(shape, has_fold):
    """The pipelined K5 against its plain version under the tolerance of
    test_conv_bn_dgrad_matches_plain; dx has no atomics in its way, so two
    runs on the same input are EQUAL."""
    b, h, w, c, co = shape
    assert "wgmma pipelined" in pfc.kernel_variant("conv_bn_dgrad", h, w, c, co, torch.bfloat16)
    x, g, k, fold = _bwd_case(shape, torch.bfloat16, seed=5)
    kf = pfc.flip_kernel(k)
    dx, db, dm = pfc.conv_bn_dgrad(g, kf, x, fold, has_fold)
    again = pfc.conv_bn_dgrad(g, kf, x, fold, has_fold)
    rx, rb, rm = pfc.reference_dgrad(g, kf, x, fold if has_fold else None)
    eps = torch.finfo(torch.bfloat16).eps
    scale = rx.float().abs().max().item()
    err = (dx.float() - rx.float()).abs()
    assert bool((err <= 2 * eps * rx.float().abs() + 1e-3 * scale).all()), err.max().item()
    for got, want in ((db, rb), (dm, rm)):
        assert (got - want).abs().max().item() <= 1e-3 * max(want.abs().max().item(), 1.0)
    assert torch.equal(dx, again[0])


@pytest.mark.parametrize("shape", [(2, 37, 70, 128), (1, 9, 7, 256)])
def test_dgrad_epilogue_is_bit_equal_through_the_kernel(shape):
    """K5's epilogue (gate, scale, roundings on bf16 pairs) against the plain
    version, EQUAL: a flipped kernel that is the identity at its centre tap
    makes da = g exactly in both, so dx must agree bit for bit.  The inputs
    span 12 binades so that every rounding is met."""
    b, h, w, c = shape
    gen = torch.Generator(device="cuda").manual_seed(13)

    def wide():
        t = torch.randn((b, h, w, c), generator=gen, device="cuda")
        e = torch.randint(-6, 6, t.shape, generator=gen, device="cuda").float()
        return (t * torch.exp2(e)).to(torch.bfloat16)

    x, g = wide(), wide()
    fold = _fold(c, gen)
    kf = torch.zeros((9 * c, c), device="cuda", dtype=torch.bfloat16)
    kf[4 * c + torch.arange(c), torch.arange(c)] = 1
    dx, db, dm = pfc.conv_bn_dgrad(g, kf, x, fold, True)
    rx, rb, rm = pfc.reference_dgrad(g, kf, x, fold)
    assert torch.equal(dx, rx)
    for got, want in ((db, rb), (dm, rm)):
        assert (got - want).abs().max().item() <= 1e-4 * max(want.abs().max().item(), 1.0)


@pytest.mark.parametrize("shape", [(1, 37, 53, 128, 8), (1, 37, 53, 128, 16), (2, 5, 7, 64, 32),
                                   (3, 11, 13, 32, 64), (1, 1, 1, 16, 8), (1, 40, 96, 128, 8),
                                   (1, 37, 53, 256, 16), (2, 16, 20, 256, 8), (1, 1, 1, 256, 16)])
def test_head_conv_fused_mma_matches_plain(shape):
    """The head's mma.sync kernel at ragged pixel counts (a last tile of 1 to
    127 pixels, and a single pixel) under test_head_conv_fused_matches_plain's
    tolerance; C = 256 is the Siamese head (two packed branches), on the
    3-stage ring."""
    b, h, w, c, co = shape
    assert "mma.sync" in pfc.kernel_variant("head_conv_fused", h, w, c, co, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    kmat = torch.randn((c, co), generator=gen, device="cuda") / math.sqrt(c)
    hbias = torch.randn(co, generator=gen, device="cuda")
    fold = _fold(c, gen)
    got = pfc.head_conv_fused(x, kmat, hbias, fold).float()
    want = pfc.reference_head(x, kmat, hbias, fold).float()
    gemm = torch.matmul(pfc.prologue(x, fold), kmat.to(torch.bfloat16)).float()
    tol = 2 * torch.finfo(torch.bfloat16).eps * (gemm.abs() + want.abs()) + 1e-3 * want.abs().max()
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("zero_bias", [False, True], ids=["bias", "coral"])
@pytest.mark.parametrize("shape", [(1, 37, 53, 128, 4), (2, 64, 64, 128, 4), (1, 1, 1, 128, 4),
                                   (1, 37, 53, 256, 4), (2, 64, 64, 256, 4), (1, 1, 1, 256, 4),
                                   (3, 16, 21, 256, 4)])
def test_head_conv_fused_co4_equals_plain(shape, zero_bias):
    """K3 at Co = 4, the single-logit CORAL and MSE heads (C = 128: one
    branch; 256: two), on the mma.sync kernel with four zero columns in its
    n8 tile: EQUAL to the plain version, at tiles of 128 pixels and at
    ragged counts down to one pixel; the CORAL head's zero bias too."""
    b, h, w, c, co = shape
    assert "mma.sync" in pfc.kernel_variant("head_conv_fused", h, w, c, co, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    kmat = torch.randn((c, co), generator=gen, device="cuda") / math.sqrt(c)
    hbias = torch.zeros(co, device="cuda") if zero_bias else torch.randn(co, generator=gen,
                                                                           device="cuda")
    fold = _fold(c, gen)
    before = pfc.head_conv_fused.launches
    got = pfc.head_conv_fused(x, kmat, hbias, fold)
    assert pfc.head_conv_fused.launches == before + 1
    assert torch.equal(got, pfc.reference_head(x, kmat, hbias, fold))


def _cross_fusion_case(shape, seed):
    """(x, g, packed kernel, fold) of the fused variant's packed cross-fusion:
    a fine (3, 3, 2*cg, Co/4) kernel embedded by s2d and row-permuted to the
    group-major concat of two packed branches (``PackedConvLayer(groups=2)``)."""
    from xview2_tpu_torch.models.layers import group_major_rows, s2d_conv_kernel

    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(torch.bfloat16)
    fine = torch.randn((3, 3, c // 4, co // 4), generator=gen, device="cuda") / math.sqrt(9 * c / 4)
    k = group_major_rows(s2d_conv_kernel(fine), 2).to(torch.bfloat16)
    return x, g, k, _fold(c, gen)


@pytest.mark.parametrize("has_fold", [False, True])
@pytest.mark.parametrize("shape", [(1, 32, 32, 256, 128), (2, 13, 70, 256, 128)])
def test_cross_fusion_kernels_match_plain(shape, has_fold):
    """K2, K4 and K5 at the packed cross-fusion's C = 256 -> 128 with the
    group-major kernel, on the wgmma kernels, against their plain versions
    at the tolerances of test_conv_bn_fused_matches_plain,
    test_conv_bn_wgrad_matches_plain and test_conv_bn_dgrad_matches_plain."""
    b, h, w, c, co = shape
    for kern in ("conv_bn_fused", "conv_bn_wgrad", "conv_bn_dgrad"):
        assert "wgmma" in pfc.kernel_variant(kern, h, w, c, co, torch.bfloat16)
    x, g, k, fold = _cross_fusion_case(shape, 8)
    f = fold if has_fold else None
    out, s1, s2 = pfc.conv_bn_fused(x, k, fold, has_fold)
    ref, r1, r2 = pfc.reference_conv_bn(x, k, f)
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2 * 2 ** -7 * ref.float().abs() + 1e-3 * scale).all()), err.max().item()
    assert bool(((s1 - r1).abs() <= 1e-3 * ref.float().abs().sum(dim=(0, 1, 2)) + 1e-4).all())
    assert bool(((s2 - r2).abs() <= 1e-3 * r2 + 1e-4).all())
    dw, rw = pfc.conv_bn_wgrad(x, g, fold, has_fold), pfc.reference_wgrad(x, g, f)
    assert (dw - rw).abs().max().item() <= 1e-3 * rw.abs().max().item()
    kf = pfc.flip_kernel(k)
    dx, db, dm = pfc.conv_bn_dgrad(g, kf, x, fold, has_fold)
    rx, rb, rm = pfc.reference_dgrad(g, kf, x, f)
    rf = rx.float()
    assert bool(((dx.float() - rf).abs() <= 2 * 2 ** -7 * rf.abs()
                 + 1e-3 * rf.abs().max()).all())
    for got, want in ((db, rb), (dm, rm)):
        assert (got - want).abs().max().item() <= 1e-3 * max(want.abs().max().item(), 1.0)


def test_path_shapes_take_the_redesigned_kernels():
    """The six train-path layers take the pipelined K5 and the eval and train
    heads the mma.sync K3; the shapes and types these do not take keep the
    earlier kernels."""
    bf, f32 = torch.bfloat16, torch.float32
    for h, w, c, co in ((64, 64, 768, 256), (64, 64, 256, 256), (128, 128, 384, 128),
                        (128, 128, 128, 128), (256, 256, 128, 128)):
        assert "wgmma pipelined" in pfc.kernel_variant("conv_bn_dgrad", h, w, c, co, bf)
    assert "4x64" in pfc.kernel_variant("conv_bn_dgrad", 64, 64, 768, 256, bf)
    assert "wmma row tile" in pfc.kernel_variant("conv_bn_dgrad", 24, 136, 192, 128, bf)
    assert pfc.kernel_variant("conv_bn_dgrad", 64, 64, 128, 128, f32) == "f32 FMA"
    for h, w in ((512, 512), (256, 256)):
        assert "mma.sync" in pfc.kernel_variant("head_conv_fused", h, w, 128, 8, bf)
    assert "FMA" in pfc.kernel_variant("head_conv_fused", 512, 512, 128, 8, f32)
    # the single-logit CORAL and MSE heads: Co = 4 at C = 128 and 256
    assert "4-stage" in pfc.kernel_variant("head_conv_fused", 512, 512, 128, 4, bf)
    assert "FMA" in pfc.kernel_variant("head_conv_fused", 512, 512, 128, 4, f32)
    for co in (4, 8, 16):  # the two-branch heads: C = 256 on the 3-stage ring
        assert "3-stage" in pfc.kernel_variant("head_conv_fused", 512, 512, 256, co, bf)
    assert "FMA" in pfc.kernel_variant("head_conv_fused", 512, 512, 256, 32, bf)
    assert "FMA" in pfc.kernel_variant("head_conv_fused", 512, 512, 192, 8, bf)


def test_fused_conv_backward_runs_the_kernels():
    x, g, k, fold = _bwd_case((2, 16, 16, 128, 128), torch.bfloat16)
    x.requires_grad_()
    k.requires_grad_()
    fold = tuple(f.requires_grad_() for f in fold)
    before = (pfc.conv_bn_wgrad.launches, pfc.conv_bn_dgrad.launches)
    out, s1, s2 = pfc.conv_bn_fused(x, k, fold, True)
    ((out.float() * g.float()).sum() + s1.sum() + 0.1 * s2.sum()).backward()
    assert (pfc.conv_bn_wgrad.launches, pfc.conv_bn_dgrad.launches) == \
        (before[0] + 1, before[1] + 1)
    assert x.grad.shape == x.shape and k.grad.shape == k.shape
    assert all(f.grad is not None and torch.isfinite(f.grad).all() for f in fold)


@pytest.mark.parametrize("axis", [2, 1])
@pytest.mark.parametrize("c", [4, 7, 1])
@pytest.mark.parametrize("shape", [(3, 38, 54), (2, 64, 86), (1, 5, 3), (16, 512, 654)])
def test_row_shift_bit_exact(shape, c, axis):
    """K6 against its plain version on the card: EQUAL (the kernel forbids
    the FMA contraction of the lerp), for lerp and nearest samples in one
    batch, shifts past both edges included; the last shape is the rotation
    passes' at a batch of 16, where C = 4 takes the 16-byte pixel path."""
    b, h, w = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda") * 50 + 100
    n, lines = (w, h) if axis == 2 else (h, w)
    shift = (torch.rand((b, lines), generator=gen, device="cuda") - 0.5) * 2.5 * n
    shift[:, ::3] = torch.round(shift[:, ::3] * 2) / 2  # exact halves and integers too
    sel = torch.arange(b, device="cuda") % 2
    before = rowshift.row_shift_cuda.launches
    got = rowshift.row_shift(x, shift, sel, axis=axis)
    assert rowshift.row_shift_cuda.launches == before + 1
    want = rowshift.row_shift_reference(x, shift, sel, axis=axis)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), rowshift.row_shift(x.cpu(), shift.cpu(), sel.cpu(), axis=axis))


def test_autoaugment_pairs_on_the_card_equal_the_cpu():
    """--autoaugment on 6-channel pre/post pairs (7-channel pixels in K6, the
    mask riding along) on the card against the same draws on the CPU, under
    test_autoaugment_on_the_card_equals_the_cpu's tolerance."""
    gen = torch.Generator().manual_seed(8)
    img = torch.randint(0, 256, (32, 64, 64, 6), generator=gen).float()
    mask = torch.randint(0, 5, (32, 64, 64), generator=gen).to(torch.uint8)
    d = taa.draw_autoaugment(gen, 32, "cpu")
    want_img, want_mask = taa.apply_autoaugment(img, mask, d)
    dc = taa.AutoAugmentDraws(d.policy.cuda(), d.u1.cuda(), d.u2.cuda(), d.neg1.cuda(),
                              d.neg2.cuda())
    before = rowshift.row_shift_cuda.launches
    got_img, got_mask = taa.apply_autoaugment(img.cuda(), mask.cuda(), dc)
    assert rowshift.row_shift_cuda.launches > before
    assert torch.equal(got_mask.cpu(), want_mask)
    assert (got_img.cpu() - want_img).abs().max().item() <= 1e-3


def test_autoaugment_on_the_card_equals_the_cpu():
    """The whole AutoAugment batch on the card against the same draws on the
    CPU: masks EQUAL; the image within 1e-3 of 255 (every op is the same
    float32 arithmetic on both devices; contrast's per-sample mean is an
    integer sum, the same in any order)."""
    gen = torch.Generator().manual_seed(6)
    img = torch.randint(0, 256, (32, 64, 64, 3), generator=gen).float()
    mask = (torch.rand((32, 64, 64), generator=gen) > 0.8).to(torch.uint8)
    d = taa.draw_autoaugment(gen, 32, "cpu")
    want_img, want_mask = taa.apply_autoaugment(img, mask, d)
    dc = taa.AutoAugmentDraws(d.policy.cuda(), d.u1.cuda(), d.u2.cuda(), d.neg1.cuda(),
                              d.neg2.cuda())
    before = rowshift.row_shift_cuda.launches
    got_img, got_mask = taa.apply_autoaugment(img.cuda(), mask.cuda(), dc)
    assert rowshift.row_shift_cuda.launches > before
    assert torch.equal(got_mask.cpu(), want_mask)
    assert (got_img.cpu() - want_img).abs().max().item() <= 1e-3


def _every_draw_pattern(device):
    """AutoAugment draws of every subpolicy with each slot firing or not and
    each sign: 25 x 4 x 4 samples."""
    pol, u1, u2, neg1, neg2 = zip(*itertools.product(
        range(taa.N_POLICIES), (0.0, 0.999), (0.0, 0.999), (False, True), (False, True)))
    return taa.AutoAugmentDraws(
        torch.tensor(pol, device=device), *(torch.tensor(u, dtype=torch.float32, device=device)
                                            for u in (u1, u2)),
        *(torch.tensor(n, device=device) for n in (neg1, neg2)))


@pytest.mark.parametrize("channels", [3, 6])
def test_autoaugment_static_form_equals_the_grouped_form_on_the_card(channels):
    """AutoAugment's static form (the CUDA graph's: fixed shapes, seven K6
    launches a batch) EQUAL to the grouped form on the card, on the same
    draws: every subpolicy, fires pattern and sign, singles and pairs."""
    d = _every_draw_pattern("cuda")
    gen = torch.Generator().manual_seed(9)
    n = d.policy.shape[0]
    img = torch.randint(0, 256, (n, 64, 64, channels), generator=gen).float().cuda()
    mask = torch.randint(0, 5, (n, 64, 64), generator=gen).to(torch.uint8).cuda()
    want_img, want_mask = taa.apply_autoaugment(img, mask, d)
    before = rowshift.row_shift_cuda.launches
    got_img, got_mask = taa.apply_autoaugment_static(img, mask, d)
    assert rowshift.row_shift_cuda.launches - before == 7
    assert got_img.is_contiguous() and got_mask.dtype == torch.uint8
    assert torch.equal(got_mask, want_mask)
    assert torch.equal(got_img, want_img)


_SMALL = [(2, 16, 128, 32, 32), (1, 19, 70, 8, 8), (2, 9, 130, 24, 40), (1, 33, 257, 64, 64),
          (1, 8, 16, 48, 16), (1, 16, 64, 16, 56)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _SMALL)
def test_small_conv_fwd_matches_plain(shape, dtype):
    """K7: within one rounding of the output dtype plus 1e-3 of the scale
    (f32 sums in another order)."""
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    kmat = (torch.randn((9 * c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(dtype)
    got = sc.small_conv_fwd(x, kmat).float()
    want = sc.reference_conv3x3(x, kmat).float()
    err = (got - want).abs()
    tol = 2 * torch.finfo(dtype).eps * want.abs() + 1e-3 * want.abs().max()
    assert bool((err <= tol).all()), err.max().item()


# the redesigned bf16 forward: a band of rows (two 256-pixel segments), the
# smoke's odd shape (ragged last segment, C and Co padded inside), the
# channel extremes, and a single row
_SMALL_BF16 = [(2, 64, 512, 32, 32), (2, 70, 200, 24, 40), (1, 33, 100, 8, 64),
               (1, 45, 90, 64, 8), (3, 1, 300, 16, 24)]


@pytest.mark.parametrize("shape", _SMALL_BF16)
def test_small_conv_fwd_bf16_matches_plain_and_repeats(shape):
    """K7 in bf16 within one rounding plus 1e-3 of the scale, and EQUAL
    between two runs (each output element is summed by one thread in a fixed
    order)."""
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(17)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    kmat = (torch.randn((9 * c, co), generator=gen, device="cuda") / math.sqrt(9 * c)).to(
        torch.bfloat16)
    got = sc.small_conv_fwd(x, kmat)
    again = sc.small_conv_fwd(x, kmat)
    want = sc.reference_conv3x3(x, kmat).float()
    err = (got.float() - want).abs()
    tol = 2 * torch.finfo(torch.bfloat16).eps * want.abs() + 1e-3 * want.abs().max()
    assert bool((err <= tol).all()), err.max().item()
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", _SMALL)
def test_small_conv_wgrad_matches_plain(shape, dtype):
    """K8: dW stays f32 in the kernel and in the plain version; they differ
    by the order of the f32 sums (pixels split over blocks, partials added
    in another order than the plain version's): 1e-3 of max |dW|."""
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dtype)
    got = sc.small_conv_wgrad(x, g)
    want = sc.reference_wgrad(x, g)
    assert got.dtype == torch.float32 and got.shape == (9 * c, co)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


_WGRAD_CHANNELS = [8, 24, 32, 40, 64]


@pytest.mark.parametrize("co", _WGRAD_CHANNELS)
@pytest.mark.parametrize("c", _WGRAD_CHANNELS)
@pytest.mark.parametrize("hw", [(1, 17), (70, 200)])
def test_small_conv_wgrad_bf16_channels_and_ragged_maps(hw, c, co):
    """The redesigned bf16 K8 over the channel domain (one or two output
    tiles a warp, copies of the roles over the pixel steps, C and Co padded
    to 16 inside) on a single row of a ragged width and on ragged bands:
    within 1e-3 of max |dW| of the plain version (sums in another order)."""
    h, w = hw
    gen = torch.Generator(device="cuda").manual_seed(c * 100 + co)
    x = torch.randn((2, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((2, h, w, co), generator=gen, device="cuda").to(torch.bfloat16)
    got = sc.small_conv_wgrad(x, g)
    want = sc.reference_wgrad(x, g)
    assert got.dtype == torch.float32 and got.shape == (9 * c, co)
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()


@pytest.mark.parametrize("shape", [(16, 64, 512, 32, 32), (2, 70, 200, 24, 40),
                                   (3, 33, 90, 64, 64), (1, 5, 300, 8, 16)])
def test_small_conv_wgrad_bf16_is_bit_equal_between_runs(shape):
    """No atomics: every block writes its partial to its own slot and the
    slots are added in a fixed order, so two runs give EQUAL dW."""
    b, h, w, c, co = shape
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, h, w, co), generator=gen, device="cuda").to(torch.bfloat16)
    first = sc.small_conv_wgrad(x, g)
    assert torch.equal(first, sc.small_conv_wgrad(x, g))
    assert torch.equal(first, sc.small_conv_wgrad(x.clone(), g.clone()))


def test_conv3x3_small_backward_runs_the_kernels():
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn((2, 16, 128, 32), generator=gen, device="cuda").to(torch.bfloat16)
    k = (torch.randn((3, 3, 32, 32), generator=gen, device="cuda") / 17).to(torch.bfloat16)
    x.requires_grad_()
    k.requires_grad_()
    before = (sc.small_conv_fwd.launches, sc.small_conv_wgrad.launches)
    out = sc.conv3x3_small(x, k)
    (out.float() ** 2).sum().backward()
    assert (sc.small_conv_fwd.launches, sc.small_conv_wgrad.launches) == \
        (before[0] + 2, before[1] + 1)
    xc = x.detach().cpu().requires_grad_()
    kc = k.detach().cpu().requires_grad_()
    (sc.conv3x3_small(xc, kc).float() ** 2).sum().backward()
    for got, want in ((out, sc.conv3x3_small(xc, kc)), (x.grad, xc.grad), (k.grad, kc.grad)):
        want = want.detach().float()
        tol = 2 ** -6 * want.abs() + 1e-2 * want.abs().max()
        assert bool(((got.detach().float().cpu() - want).abs() <= tol).all())
    with pytest.raises(ValueError):
        sc.small_conv_fwd(torch.zeros((1, 8, 8, 12), device="cuda"), torch.zeros((108, 8)))


def test_fold_from_sums_of_k2_over_two_ranks_on_one_card(tmp_path):
    """Two ranks on the one card in a gloo group (gloo carries the card's
    tensors through the host; NCCL refuses two ranks on one device): each
    runs K2 on its half of a bf16 batch and ``fold_from_sums`` sums K2's
    ``s1``/``s2`` over the ranks.  The fold and the running statistics are
    EQUAL on both ranks and within 1e-5 of their scale of one process's on
    the whole batch (K2's float32 sums in another order)."""
    import torch_data_parallel_jobs as jobs

    ranks = jobs.join(jobs.start("fold_on_card", 2, tmp_path), tmp_path, timeout=300)
    want = jobs.fold_on_card_job(0, 1)
    for r in ranks:
        assert r["launches"] == 1
    for key in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][key], ranks[1][key])
        scale = want[key].abs().max()
        assert float((ranks[0][key] - want[key]).abs().max()) <= 1e-5 * float(scale), key
    for got0, got1, w in zip(ranks[0]["fold"], ranks[1]["fold"], want["fold"]):
        assert torch.equal(got0, got1)
        assert float((got0 - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_train_multistep_graph_equals_eager_steps():
    """``make_train_multistep`` on the card (one CUDA graph of K = 2 train
    steps) against 2K eager ``make_train_step`` calls on a small ResNet-50
    ``UNetLoc`` (batch 2 of 64^2 crops, the fused tail, SGD, float32): the
    first call runs its steps eagerly and captures, the second replays.
    The losses within 1e-5 relative and the 2K-step update within 5e-2
    relative L2 (K4 adds its dW by atomics, in another order in every run;
    SGD's update is linear in the gradients, where AdamW's normalization
    would turn that noise into moves of the learning rate's size),
    ``state.step`` equal, and the replay's launches inside the graph: the
    counters move at the capture only."""
    import numpy as np

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.parallel import steps
    from xview2_tpu_torch.train.optimizers import build_optimizer

    k_steps = 2
    cfg = Config(type="pre", encoder="resnet50", precision=32, fused_tail=True,
                 optimizer="sgd", batch_size=2)
    apply_precision(cfg)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2 * k_steps, 2, 128, 128, 3),
                                           np.uint8)).cuda()
    masks = torch.from_numpy((rng.random((2 * k_steps, 2, 128, 128)) > 0.8)
                             .astype(np.uint8)).cuda()
    torch.manual_seed(0)
    init = build_model(cfg).state_dict()
    runs = {}
    for mode in ("eager", "graph"):
        model = build_model(cfg)
        model.load_state_dict(init)
        opt = build_optimizer(cfg, model.parameters(), cfg.lr)
        state = steps.init_train_state(model, opt, device="cuda")
        if mode == "eager":
            step = steps.make_train_step(cfg, model, opt, crop=64, device="cuda")
            losses = []
            for i in range(2 * k_steps):
                state, loss = step(state, images[i], masks[i],
                                   steps.step_generator(cfg, state.step, "cuda"))
                losses.append(loss)
            losses = torch.stack(losses)
        else:
            multi = steps.make_train_multistep(cfg, model, opt, k_steps, crop=64, device="cuda")
            state, first = multi(state, images[:k_steps], masks[:k_steps])
            captured = pfc.conv_bn_wgrad.launches
            state, second = multi(state, images[k_steps:], masks[k_steps:])
            assert pfc.conv_bn_wgrad.launches == captured  # replayed, not launched anew
            losses = torch.cat([first, second])
        runs[mode] = (losses, state.step, {k: v.detach().clone()
                                           for k, v in model.named_parameters()})
    (l0, n0, p0), (l1, n1, p1) = runs["eager"], runs["graph"]
    assert n0 == n1 == 2 * k_steps
    assert bool(((l1 - l0).abs() <= 1e-5 * l0.abs()).all()), (l0, l1)
    moved = torch.cat([(p0[k] - init[k].cuda()).reshape(-1) for k in p0])
    diff = torch.cat([(p1[k] - p0[k]).reshape(-1) for k in p0])
    assert float(diff.norm() / moved.norm()) <= 5e-2


def _small_graph_program(k_steps: int):
    """A bf16 ResNet-50 ``--fused_tail`` ``UNetLoc`` with AdamW, its state
    on the card and K stacked batches of 128^2 tiles."""
    import numpy as np

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.parallel import steps
    from xview2_tpu_torch.train.optimizers import build_optimizer

    cfg = Config(type="pre", encoder="resnet50", precision=16, fused_tail=True,
                 optimizer="adamw", batch_size=2)
    apply_precision(cfg)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (k_steps, 2, 128, 128, 3), np.uint8)).cuda()
    masks = torch.from_numpy((rng.random((k_steps, 2, 128, 128)) > 0.8)
                             .astype(np.uint8)).cuda()
    torch.manual_seed(0)
    model = build_model(cfg)
    opt = build_optimizer(cfg, model.parameters(), cfg.lr)
    return cfg, model, opt, steps.init_train_state(model, opt, device="cuda"), images, masks


def test_replayed_launches_count_each_replay_of_a_graph():
    """After the first call of ``make_train_multistep`` (K eager warm-up
    steps, then the capture) and R replays of a ResNet-50 ``--fused_tail``
    graph, each K1-K8 wrapper has counted 2 x K x its launches in one eager
    ``make_train_step`` (the warm-up's and the capture's: it counts where it
    launches), the graph's ``replayed_launches()`` R x K x them, and so the
    launches that reached the device, the counted less the captured plus
    the replayed, are (R + 1) x K x them."""
    from xview2_tpu_torch.parallel import steps

    k_steps, replays = 2, 3
    cfg, model, opt, state, images, masks = _small_graph_program(k_steps)
    counters = steps.launch_counters()
    before = [fn.launches for fn in counters]
    step = steps.make_train_step(cfg, model, opt, crop=64, device="cuda")
    state, _ = step(state, images[0], masks[0], steps.step_generator(cfg, state.step, "cuda"))
    eager = {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}
    assert eager["conv_bn_fused"] > 0 and eager["conv_bn_wgrad"] > 0  # K2, K4: the fused tail
    multi = steps.make_train_multistep(cfg, model, opt, k_steps, crop=64, device="cuda")
    assert multi.replayed_launches() == {}
    before = [fn.launches for fn in counters]
    for _ in range(replays + 1):
        state, losses = multi(state, images, masks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(losses).all())
    counted = {fn.__name__: fn.launches - n for fn, n in zip(counters, before)}
    replayed = multi.replayed_launches()
    assert counted == {n: 2 * k_steps * e for n, e in eager.items()}
    assert replayed == {n: replays * k_steps * e for n, e in eager.items()}
    assert {n: counted[n] - k_steps * e + replayed[n] for n, e in eager.items()} == \
        {n: (replays + 1) * k_steps * e for n, e in eager.items()}


def test_spans_of_a_graph_under_a_profiler():
    """A CPU+CUDA profiler collects while ``make_train_multistep`` warms up,
    captures and replays once: both calls succeed, the warm-up records K
    eager ``train.step``s with their five phases, the capture records
    nothing, the replay records one ``train.step`` holding ``train.h2d`` and
    ``train.replay``, every span has its device seconds, and the replay's
    two children hold at least 95% of its step's device extent."""
    from torch.profiler import ProfilerActivity, profile

    from xview2_tpu_torch.parallel import steps
    from xview2_tpu_torch.utils import spans

    k_steps = 2
    cfg, model, opt, state, images, masks = _small_graph_program(k_steps)
    multi = steps.make_train_multistep(cfg, model, opt, k_steps, crop=64, device="cuda")
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, first = multi(state, images, masks)
        warm = spans.summary()
        state, second = multi(state, images, masks)
    got = spans.summary()
    spans.reset()
    assert bool(torch.isfinite(first).all()) and bool(torch.isfinite(second).all())
    phases = ["train.h2d", "train.augment", "train.forward", "train.backward", "train.update"]
    assert list(warm) == ["train.step"] + phases
    assert all(warm[n].calls == warm[n].steps == k_steps for n in warm)
    assert list(got) == ["train.step"] + phases + ["train.replay"]
    assert (got["train.step"].calls, got["train.step"].steps) == (k_steps + 1, k_steps + 1)
    assert got["train.h2d"].calls == k_steps + 1
    assert all(got[n].calls == warm[n].calls for n in phases[1:])  # none from the capture
    assert (got["train.replay"].calls, got["train.replay"].parent) == (1, "train.step")
    assert all(got[n].device_s is not None and got[n].device_s > 0 for n in got)
    replay_step = got["train.step"].device_s - warm["train.step"].device_s
    children = (got["train.h2d"].device_s - warm["train.h2d"].device_s
                + got["train.replay"].device_s)
    assert 0.95 * replay_step <= children <= replay_step + 1e-5  # events resolve to 0.5 us


# the graph against eager steps on the stock tail (no atomics): each optimizer,
# --remat tail|full and the decoder options; AdaBound under the Noam schedule
_GRAPH_EXACT = ([(dict(optimizer=o), o == "adabound") for o in OPTIMIZERS if o != "adam"]
                + [(dict(optimizer="adamw", remat=m), False) for m in ("tail", "full")]
                + [(dict(optimizer="adamw", attention=True, deep_supervision=True, ppm=True),
                    False)]
                + [(dict(optimizer="adamw", autoaugment=True), False),
                   (dict(optimizer="adamw", autoaugment=True, type="post", dmg_model="cat"),
                    False)])


@pytest.mark.parametrize("kw,scheduled", _GRAPH_EXACT,
                         ids=lambda v: "-".join(f"{k}={x}" for k, x in v.items())
                         if isinstance(v, dict) else ("noam" if v else "constant"))
def test_train_multistep_graph_is_equal_to_eager_steps(kw, scheduled):
    """``make_train_multistep`` on the card against eager ``make_train_step``
    calls on the stock tail under cuDNN's deterministic algorithms: a small
    ResNet-50 ``UNetLoc`` (batch 2 of 64^2 crops of 128^2 tiles, bf16), K = 4,
    two calls (the first runs its steps eagerly and captures, the second
    replays), so RAdam's rectified updates (from the sixth) replay too.  Two
    eager runs are EQUAL, and the graph is EQUAL to them: the losses, every
    parameter and buffer, every optimizer moment and ``state.step``.  Under
    ``--autoaugment`` (on 3-channel tiles, and on 6-channel pairs with labels
    0..4 for a ``cat`` model) the eager steps group the samples by op on the
    host and the graph replays AutoAugment's static form."""
    import numpy as np

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.parallel import steps
    from xview2_tpu_torch.train.optimizers import build_optimizer
    from xview2_tpu_torch.train.scheduler import noam_schedule

    k_steps = 4
    cfg = Config(**{**dict(type="pre", encoder="resnet50", fused_tail=False, batch_size=2,
                           weight_decay=0.05), **kw})
    apply_precision(cfg)
    lr = noam_schedule(1e-4, 3e-3, 2e-4, 1, 3, 4) if scheduled else cfg.lr
    rng = np.random.default_rng(0)
    pairs = cfg.type == "post"
    images = torch.from_numpy(rng.integers(0, 256, (2 * k_steps, 2, 128, 128, 6 if pairs else 3),
                                           np.uint8)).cuda()
    masks = torch.from_numpy(((rng.random((2 * k_steps, 2, 128, 128)) > 0.8)
                              * rng.integers(1, 5 if pairs else 2, (2 * k_steps, 2, 128, 128)))
                             .astype(np.uint8)).cuda()
    torch.manual_seed(0)
    init = build_model(cfg).state_dict()
    taa._device_tables.cache_clear()  # the graph makes the static form's constants itself
    taa._luma_divisor.cache_clear()

    def run(graph):
        model = build_model(cfg)
        model.load_state_dict(init)
        opt = build_optimizer(cfg, model.parameters(), lr)
        state = steps.init_train_state(model, opt, device="cuda")
        losses = []
        if graph:
            multi = steps.make_train_multistep(cfg, model, opt, k_steps, crop=64,
                                               device="cuda", learning_rate=lr)
            for c in range(2):
                state, loss = multi(state, images[c * k_steps:(c + 1) * k_steps],
                                    masks[c * k_steps:(c + 1) * k_steps])
                losses.append(loss)
        else:
            step = steps.make_train_step(cfg, model, opt, crop=64, device="cuda",
                                         learning_rate=lr)
            for i in range(2 * k_steps):
                state, loss = step(state, images[i], masks[i],
                                   steps.step_generator(cfg, state.step, "cuda"))
                losses.append(loss.reshape(1))
        snap = {f"model/{k}": v.detach().clone() for k, v in model.state_dict().items()}
        names = {id(p): n for n, p in model.named_parameters()}
        snap.update({f"opt/{names[id(p)]}/{k}": v.detach().clone()
                     for p, st in opt.state.items() for k, v in st.items()})
        return torch.cat(losses), state.step, snap

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        (l0, n0, s0), (l1, n1, s1), (lg, ng, sg) = run(False), run(False), run(True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    assert n0 == n1 == ng == 2 * k_steps
    assert s0.keys() == s1.keys() == sg.keys()
    assert torch.equal(l0, l1), (l0, l1)
    assert [k for k in s0 if not torch.equal(s0[k], s1[k])] == []
    assert torch.equal(l0, lg), (l0, lg)
    assert [k for k in s0 if not torch.equal(s0[k], sg[k])] == []


# The eval BatchNorm epilogue (ops/norm_act.py): bit-equal to the eager chain
# it replaces, at the channel counts of the encoders and decoders (the vector
# form where C is a multiple of 8 bf16 or 4 f32, the scalar form below it),
# on contiguous NHWC maps and on NCHW maps seen as NHWC, in their layout.
_NA_CHANNELS = [4, 24, 32, 64, 128, 256, 512, 1024, 2048]


def _na_case(shape, dtype, residual, seed=0, phases=1, nchw=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, w, c = shape
    laid = (b, c, h, w) if nchw else shape

    def draw(scale=1.0):
        t = (torch.randn(laid, generator=gen, device="cuda") * scale).to(dtype)
        return t.permute(0, 2, 3, 1) if nchw else t

    x = draw(2.0)
    fold = tuple(v.repeat(phases) for v in _fold(c // phases, gen))
    return x, fold, draw() if residual else None


def _na_equal(x, fold, act, r):
    got = na.norm_act_cuda(x, *fold, act, r)
    want = na.norm_act_reference(x, *fold, act, r)
    torch.cuda.synchronize()
    return torch.equal(_bytes(got), _bytes(want)) and got.stride() == want.stride()


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("act", ["relu", "leaky", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", _NA_CHANNELS)
def test_norm_act_is_bit_equal_to_plain(c, dtype, act, residual):
    """Byte for byte the eager chain, in its layout: a map of many blocks
    with a ragged last one, the split attention's (52, 1, 1, C) map, a fold
    tiled over 4 phases (``fold(4)``), NCHW maps seen as NHWC (planes of 4,
    a multiple of no vector, and of 35 x 64), and a map one element off
    16-byte alignment (the scalar form, where it takes the channels).  A
    residual comes only with relu: with another activation the wrapper
    raises."""
    if residual and act != "relu":
        x, fold, r = _na_case((2, 3, 4, c), dtype, True)
        with pytest.raises(ValueError, match="only with relu"):
            na.norm_act_cuda(x, *fold, act, r)
        return
    cases = [((2, 33, 65, c), 1, False), ((52, 1, 1, c), 1, False), ((2, 5, 6, c), 4, False),
             ((3, 2, 2, c), 1, True), ((2, 35, 64, c), 1, True)]
    for i, (shape, phases, nchw) in enumerate(cases):
        x, fold, r = _na_case(shape, dtype, residual, seed=i, phases=phases, nchw=nchw)
        assert _na_equal(x, fold, act, r), (shape, nchw)
    x, fold, r = _na_case((3, 7, 9, c), dtype, residual)
    flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    off = flat[1:].view(x.shape)
    off.copy_(x)
    if na.takes(off, *fold, r):
        got = na.norm_act_cuda(off, *fold, act, r)
        assert torch.equal(_bytes(got), _bytes(na.norm_act_reference(x, *fold, act, r)))
    else:  # the scalar form holds at most MAX_VECTORS channels a row
        assert c > na.MAX_VECTORS


@pytest.mark.parametrize("act", ["relu", "leaky", "none"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [16, 12])
def test_norm_act_special_values_come_out_as_eager(c, dtype, act):
    """NaN, +-inf, -0.0 and +0.0 in x (and, with relu, in the residual), and
    folds that make -0.0 before the activation (x == mean, a negative mul,
    bias -0.0), in the vector (C = 16) and the scalar (C = 12) form, with
    the channels innermost and in an NCHW layout."""
    specials = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0, 1.0, -1.0, 3.0]
    for nchw in (False, True):
        x, (m, s, b), r = _na_case((4, 3, 5, c), dtype, True, seed=11, nchw=nchw)
        for i, v in enumerate(specials):
            x[i % 4, 0, i % 5, :] = v
            r[(i + 1) % 4, 1, i % 5, :] = v
        m[: c // 2], s[: c // 2], b[: c // 2] = 1.0, -1.0, -0.0
        for res in ((None, r) if act == "relu" else (None,)):
            assert _na_equal(x, (m, s, b), act, res), (nchw, res is None)


def _na_seeded(mod):
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for k, t in mod.state_dict().items():
            if k.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
            elif k.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return mod.cuda()


def _na_plain_kernel(monkeypatch):
    """Put the plain version where the kernel launches (the same dispatch,
    the same layouts): the oracle of a forward that launches the kernel."""
    monkeypatch.setattr(na, "norm_act_cuda", na.norm_act_reference)


_NA_MODULES = {  # the module and its eval BatchNorm sites
    "resnest-bottleneck": (lambda dt: resnest.ResNeStBottleneck(
        64, 32, stride=2, downsample=True, downsample_pool_stride=2, is_first=True,
        dtype=dt), 5),  # bn1, the split attention's bn0 and bn1, downsample, tail
    "resnet-bottleneck": (lambda dt: resnet.Bottleneck(64, 32, stride=2, downsample=True,
                                                       dtype=dt), 4),
    "resnest-stem": (lambda dt: resnest.ResNeStStem(3, 32, dt), 3),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(_NA_MODULES))
def test_eval_forward_takes_the_kernel_bit_equal(name, dtype, monkeypatch):
    """Modules at eval: under ``inference_mode`` every BatchNorm site is one
    launch, and the output is bit-equal to the same forward with the plain
    version in the kernel's place, in the same layout; under autograd no
    site launches.  In bfloat16 (the pools' copy back is a cast) the
    inference forward is also bit-equal to the one under autograd; in
    float32 a pool under autograd hands the next conv its NCHW view, as the
    train step always had."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    make, sites = _NA_MODULES[name]
    mod = _na_seeded(make(dtype))
    cin = 3 if name == "resnest-stem" else 64
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((4, 33, 35, cin), generator=gen, device="cuda").to(dtype)
    before = na.norm_act_cuda.launches
    eager = mod(x, False)
    assert eager.requires_grad and na.norm_act_cuda.launches == before
    with torch.inference_mode():
        got = mod(x, False)
    torch.cuda.synchronize()
    assert na.norm_act_cuda.launches - before == sites
    _na_plain_kernel(monkeypatch)
    with torch.inference_mode():
        want = mod(x, False)
    assert torch.equal(got, want) and got.stride() == want.stride()
    if dtype == torch.bfloat16:
        assert torch.equal(got, eager.detach()) and got.stride() == eager.stride()


def _count_sites(monkeypatch):
    """Count the calls of the models' dispatch (``layers.norm_act``) and of
    the plain version."""
    calls = {"sites": 0, "plain": 0}
    site, plain = tl.norm_act, na.norm_act_reference

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tl, "norm_act", counted("sites", site))
    monkeypatch.setattr(na, "norm_act_reference", counted("plain", plain))
    return calls


def test_norm_act_counts_every_eval_site_and_none_in_a_train_step(monkeypatch):
    """The ResNet-50 ``--fused_tail`` ``UNetLoc``: its eval step launches the
    kernel once for every call of ``layers.norm_act`` and runs no plain
    version; its train step launches it never."""
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel import steps

    cfg, model, opt, state, images, masks = _small_graph_program(1)
    calls = _count_sites(monkeypatch)
    step = steps.make_train_step(cfg, model, opt, crop=64, device="cuda")
    before = na.norm_act_cuda.launches
    state, loss = step(state, images[0], masks[0], steps.step_generator(cfg, state.step, "cuda"))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss)) and na.norm_act_cuda.launches == before
    calls.update(sites=0, plain=0)
    eval_step = steps.make_eval_step(cfg, model, device="cuda")
    valid = torch.ones(images.shape[1], device="cuda")
    eval_step(init_f1_state(cfg.n_metric_class, "cuda"), images[0], masks[0], valid)
    torch.cuda.synchronize()
    assert calls["sites"] > 50 and calls["plain"] == 0
    assert na.norm_act_cuda.launches - before == calls["sites"]


@pytest.mark.parametrize("name,over", [
    ("loc-rs50-attn-ds", {}), ("dmg-fused-rs200", {}),
    ("loc-rs50-attn-ds", {"precision": 32}),
    ("loc-rs50-attn-ds", {"encoder": "resnet50", "ppm": True, "dec_interp": True})],
    ids=["D", "C", "D-f32", "ppm-dec_interp"])
def test_eval_step_of_the_eval_cells_launches_at_every_site(name, over, monkeypatch):
    """The eval step (4-flip TTA) of the models of the benchmark's eval
    cells, D (ResNeSt-50 with attention gates and deep supervision) and C
    (the fused ResNeSt-200 damage model), of D in float32, and of a
    ResNet-50 with ``--ppm --dec_interp`` (maps in an NCHW layout) on 128^2
    tiles: one launch for every call of ``layers.norm_act``, no plain
    version, and logits bit-equal to the same step with the plain version
    in the kernel's place."""
    from xview2_tpu_torch.ops.metrics import init_f1_state
    from xview2_tpu_torch.parallel import steps

    cfg, model = _bench_eval_model(name, over)
    ch = 6 if cfg.type == "post" else 3
    gen = torch.Generator().manual_seed(21)
    images = torch.randint(0, 256, (2, 128, 128, ch), generator=gen, dtype=torch.uint8)
    masks = torch.randint(0, 5 if cfg.type == "post" else 2, (2, 128, 128), generator=gen,
                          dtype=torch.uint8)
    valid = torch.ones(2)
    step = steps.make_eval_step(cfg, model, device="cuda")
    calls = _count_sites(monkeypatch)
    before = na.norm_act_cuda.launches
    _, _, got = step(init_f1_state(cfg.n_metric_class, "cuda"), images, masks, valid)
    torch.cuda.synchronize()
    assert calls["sites"] > 50 and calls["plain"] == 0
    assert na.norm_act_cuda.launches - before == calls["sites"]
    _na_plain_kernel(monkeypatch)
    _, _, want = step(init_f1_state(cfg.n_metric_class, "cuda"), images, masks, valid)
    assert torch.equal(_bytes(got), _bytes(want))


def _bench_eval_model(name, over):
    """The model of a benchmark configuration (``xv2bench/configs``), with
    ``over`` set, at eval as ``test`` runs it, drawn from a fixed seed on
    the card."""
    import json
    import os

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "xv2bench", "configs", f"{name}.json")
    with open(path) as f:
        program = dict(json.load(f)["program"], **over)
    cfg = Config(**program, exec_mode="eval", tta=True)
    apply_precision(cfg)
    torch.manual_seed(0)
    return cfg, _na_seeded(build_model(cfg))


def test_norm_act_wrapper_raises_on_what_the_kernel_does_not_take():
    x, fold, r = _na_case((2, 4, 4, 32), torch.bfloat16, True)
    before = na.norm_act_cuda.launches
    with pytest.raises(ValueError):  # float64
        na.norm_act_cuda(x.double(), *fold, "relu")
    with pytest.raises(ValueError):  # a residual of another dtype
        na.norm_act_cuda(x, *fold, "relu", r.float())
    with pytest.raises(ValueError):  # a residual in another layout
        na.norm_act_cuda(x, *fold, "relu", r.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    with pytest.raises(ValueError):  # a residual with another activation
        na.norm_act_cuda(x, *fold, "leaky", r)
    with pytest.raises(ValueError):  # elements that do not fill their span
        na.norm_act_cuda(x[:, ::2], *fold, "relu")
    with pytest.raises(ValueError):  # fold vectors on the CPU
        na.norm_act_cuda(x, *(v.cpu() for v in fold), "relu")
    with pytest.raises(ValueError):  # fold vectors of another length
        na.norm_act_cuda(x, *(v[:16] for v in fold), "relu")
    with pytest.raises(ValueError):
        na.norm_act_cuda(x, *fold, "gelu")
    wide = torch.zeros((1, 1, 1, 8200), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):  # 1025 vectors a row
        na.norm_act_cuda(wide, *(torch.zeros(8200, device="cuda"),) * 3, "relu")
    assert na.norm_act_cuda.launches == before
