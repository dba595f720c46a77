"""The eval BatchNorm epilogue (``ops/norm_act.py``) on the CPU: its plain
version is the eager chain the models ran before the kernel, and equals the
JAX ``_norm_act``; the models' dispatch runs it only where autograd records
nothing; the bottleneck's tail (``layers.bn_add_relu``) in train mode is the
two ops it was, gradients included.  The kernel itself is held bit-equal to
the plain version on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xview2_tpu.models import layers as jl
from xview2_tpu_torch.models import layers as tl
from xview2_tpu_torch.models import resnest, resnet
from xview2_tpu_torch.ops import norm_act as na
from xview2_tpu_torch.ops.packed_fused_conv import leaky_slope
from xview2_tpu_torch.parallel import steps

ACTS = ["relu", "leaky", "none"]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(shape, dtype, seed=0, residual=False):
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(shape, generator=gen) * 2).to(dtype)
    fold = (torch.randn(c, generator=gen) * 0.5, torch.rand(c, generator=gen) + 0.5,
            torch.randn(c, generator=gen) * 0.5)
    r = (torch.randn(shape, generator=gen)).to(dtype) if residual else None
    return x, fold, r


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _specials(x):
    """x with NaN, +-inf, -0.0 and +0.0 in its first row."""
    x = x.clone()
    row = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0])
    n = min(row.numel(), x.shape[-1])
    x.reshape(-1, x.shape[-1])[0, :n] = row[:n].to(x.dtype)
    return x


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plain_version_is_the_eager_chain(dtype, act, residual):
    """Bit for bit the chain the models ran: three ops rounding to x's dtype
    after casting the fold vectors, the residual add, the activation."""
    x, (m, s, b), r = _inputs((2, 5, 7, 24), dtype, residual=residual)
    x = _specials(x)
    dt = x.dtype
    y = (x - m.to(dt)) * s.to(dt) + b.to(dt)
    if r is not None:
        y = y + r
    want = {"relu": F.relu, "leaky": lambda v: F.leaky_relu(v, leaky_slope(dt)),
            "none": lambda v: v}[act](y)
    got = na.norm_act_reference(x, m, s, b, act, r)
    assert got.dtype == dt
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_plain_version_equals_jax_norm_act(dtype, act):
    """The plain version against the JAX ``_norm_act`` it ports, and with a
    residual against JAX's ``relu(_norm_act(x, ..., "none") + identity)``."""
    x, fold, r = _inputs((2, 6, 5, 32), dtype, seed=1, residual=True)
    f32 = lambda t: t.to(torch.float32).numpy()  # noqa: E731
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jr = jnp.asarray(f32(x)).astype(jdt), jnp.asarray(f32(r)).astype(jdt)
    jf = [jnp.asarray(v.numpy()) for v in fold]
    got = na.norm_act_reference(x, *fold, act)
    want = jl._norm_act(jx, *jf, act=act)
    np.testing.assert_array_equal(f32(got), np.asarray(want.astype(jnp.float32)))
    got = na.norm_act_reference(x, *fold, "relu", r)
    want = jnp.maximum(jl._norm_act(jx, *jf, act="none") + jr, 0)
    np.testing.assert_array_equal(f32(got), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
def test_models_dispatch_on_autograd(residual):
    """``layers.norm_act``: under autograd the plain version (gradients flow
    to x and the fold); with nothing recorded the op's wrapper, which on a
    CPU tensor is the plain version too, and the kernel never counts."""
    x, fold, r = _inputs((2, 3, 4, 16), torch.float32, seed=2, residual=residual)
    before = na.norm_act_cuda.launches
    xg = x.clone().requires_grad_()
    fg = [v.clone().requires_grad_() for v in fold]
    y = tl.norm_act(xg, *fg, act="relu", residual=r)
    y.sum().backward()
    assert xg.grad is not None and all(v.grad is not None for v in fg)
    with torch.inference_mode():
        z = tl.norm_act(x, *fold, act="relu", residual=r)
    with torch.no_grad():
        w = tl.norm_act(xg, *fg, act="relu", residual=r)
    want = na.norm_act_reference(x, *fold, "relu", r)
    for got in (y.detach(), z, w):
        assert torch.equal(got, want)
    assert na.norm_act_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bn_add_relu_in_train_is_the_two_ops_and_passes_gradients(dtype):
    """Train mode: ``bn_act(..., "none")`` then ``relu(out + identity)``, the
    running statistics updated once, every gradient the same."""
    torch.manual_seed(3)
    bn = tl.BatchNorm(16).to(dtype)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 5, 6, 16), generator=gen, dtype=dtype)
    ident = torch.randn((4, 5, 6, 16), generator=gen, dtype=dtype)
    res = []
    for fused in (True, False):
        b = tl.BatchNorm(16).to(dtype)
        b.load_state_dict(bn.state_dict())
        xg, ig = x.clone().requires_grad_(), ident.clone().requires_grad_()
        if fused:
            y = tl.bn_add_relu(b, xg, ig, True, dtype)
        else:
            y = F.relu(tl.bn_act(b, xg, True, "none", dtype) + ig)
        (y * torch.arange(y.numel(), dtype=dtype).reshape(y.shape).sin()).sum().backward()
        res.append((y.detach(), xg.grad, ig.grad, b.weight.grad, b.bias.grad,
                    b.running_mean.clone(), b.running_var.clone()))
    assert res[0][2].abs().sum() > 0 and res[0][3].abs().sum() > 0
    for got, want in zip(*res):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_bn_add_relu_at_eval_is_the_fold_then_the_add(dtype):
    """Eval: the fold's chain without activation, then ``relu(out +
    identity)``, under inference mode and under autograd."""
    torch.manual_seed(5)
    bn = tl.BatchNorm(32)
    with torch.no_grad():
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 2)
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    x, _, ident = _inputs((2, 4, 4, 32), dtype, seed=6, residual=True)
    want = F.relu(tl.bn_act(bn, x, False, "none", dtype) + ident)
    with torch.inference_mode():
        got = tl.bn_add_relu(bn, x, ident, False, dtype)
    assert torch.equal(_bits(got), _bits(want.detach()))
    got = tl.bn_add_relu(bn, x, ident, False, dtype)
    assert torch.equal(_bits(got.detach()), _bits(want.detach()))


def _bottleneck(kind):
    torch.manual_seed(7)
    if kind == "resnest":
        block = resnest.ResNeStBottleneck(32, 16, stride=2, downsample=True,
                                          downsample_pool_stride=2, is_first=True)
    else:
        block = resnet.Bottleneck(32, 16, stride=2, downsample=True)
    with torch.no_grad():
        for k, t in block.state_dict().items():
            if k.endswith("running_var"):
                t.uniform_(0.5, 2)
            elif k.endswith("running_mean"):
                t.normal_(0, 0.2)
    return block


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", ["resnest", "resnet"])
def test_bottlenecks_keep_their_outputs(kind, train, monkeypatch):
    """A downsampling ResNeSt and ResNet bottleneck in float32: the forward
    (eval under inference mode) and, in train mode, the running statistics
    equal those of a twin whose tail is the two ops it was,
    ``relu(bn_act(bn3, conv3, "none") + identity)``."""
    block, twin = _bottleneck(kind), _bottleneck(kind)
    x = torch.randn((2, 9, 11, 32), generator=torch.Generator().manual_seed(8))
    with torch.inference_mode(not train):
        got = block(x, train)
        mod = resnest if kind == "resnest" else resnet
        monkeypatch.setattr(mod, "bn_add_relu", lambda bn, out, identity, train_, dt, **kw:
                            F.relu(tl.bn_act(bn, out, train_, "none", dt, **kw) + identity))
        want = twin(x, train)
    assert torch.equal(got, want)
    for (k, a), b in zip(block.state_dict().items(), twin.state_dict().values()):
        assert torch.equal(a, b), k


def test_takes_says_what_the_kernel_takes():
    x, fold, r = _inputs((2, 3, 4, 16), torch.bfloat16, residual=True)
    assert na.takes(x, *fold) and na.takes(x, *fold, r)
    assert na.takes(x.float(), *fold, r.float())
    assert not na.takes(x.double(), *fold)  # float64: the plain version
    assert not na.takes(x, *fold, r.float())  # the add would promote
    assert not na.takes(x, *fold, r[:1])
    assert not na.takes(x, *(v.double() for v in fold))
    assert not na.takes(x, fold[0][:8], *fold[1:])
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # taken in its layout
    assert na.takes(nchw, *fold) and na.takes(x.transpose(1, 2), *fold)
    assert na.takes(nchw, *fold, r.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))
    assert not na.takes(x, *fold, r.transpose(1, 2).contiguous().transpose(1, 2))
    assert not na.takes(nchw, *fold, r)  # the residual in another layout
    assert not na.takes(x[:, ::2], *fold)  # elements that do not fill their span
    assert na.takes(torch.zeros((1, 4, 4, 8200), dtype=torch.bfloat16).permute(0, 3, 1, 2)
                    .contiguous().permute(0, 2, 3, 1), *(torch.zeros(8200),) * 3)
    wide = torch.zeros((1, 8200), dtype=torch.bfloat16)  # 1025 vectors of 8 channels
    assert not na.takes(wide, *(torch.zeros(8200),) * 3)
    odd = torch.zeros((1, 1025), dtype=torch.bfloat16)  # the scalar form: 1025 > 1024
    assert not na.takes(odd, *(torch.zeros(1025),) * 3)
    assert na.takes(torch.zeros((52, 1, 1, 1)), *(torch.zeros(1),) * 3)


def test_channel_stride_reads_the_layout():
    """1 for rows of C channels (size-1 axes and an order of N, H, W
    aside), H * W for an NCHW map seen as NHWC, None where the elements
    leave gaps or overlap."""
    x = torch.zeros((2, 3, 4, 5))
    assert na.channel_stride(x) == 1 and na.channel_stride(x.transpose(1, 2)) == 1
    assert na.channel_stride(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)) == 12
    assert na.channel_stride(torch.zeros((52, 5, 1, 1)).permute(0, 2, 3, 1)) == 1
    assert na.channel_stride(torch.zeros((2, 1, 1, 1)).expand(2, 3, 4, 1)) is None
    assert na.channel_stride(x[:, :, ::2]) is None
    assert na.channel_stride(x[..., :4]) is None


def test_dispatch_takes_a_residual_only_with_relu():
    """The bottleneck's tail is the only call site with a residual: the
    dispatch refuses another activation with one, on every device."""
    x, fold, r = _inputs((2, 3, 4, 16), torch.float32, seed=9, residual=True)
    for act in ("leaky", "none"):
        with pytest.raises(ValueError, match="only with relu"):
            na.norm_act(x, *fold, act, r)
        with pytest.raises(ValueError, match="only with relu"):
            tl.norm_act(x, *fold, act=act, residual=r)
    with pytest.raises(ValueError):
        na.norm_act(x, *fold, "gelu")


def test_records_follows_autograd():
    x = torch.zeros(3)
    w = torch.zeros(3, requires_grad=True)
    assert na.records(x, w) and not na.records(x, None)
    with torch.no_grad():
        assert not na.records(x, w)
    with torch.inference_mode():
        assert not na.records(torch.zeros(3), w)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
def test_avd_pool_copies_back_to_nhwc_only_where_nothing_records(dtype):
    """``resnest.avg_pool_torch``: under autograd a float32 pool returns
    the NCHW view the train step always had; where nothing records (the
    eval step) a contiguous NHWC map, the kernel's fast form, with the same
    values; bfloat16 is a contiguous cast either way."""
    x = torch.randn((2, 9, 10, 16), generator=torch.Generator().manual_seed(10)).to(dtype)
    with torch.inference_mode():
        got = resnest.avg_pool_torch(x, 3, 2, padding=1)
    xg = x.clone().requires_grad_()
    under = resnest.avg_pool_torch(xg, 3, 2, padding=1)
    assert got.is_contiguous() and torch.equal(got, under.detach())
    assert under.is_contiguous() == (dtype == torch.bfloat16)
    assert na.channel_stride(under) == (1 if dtype == torch.bfloat16 else 5 * 5)


# The models of the benchmark's eval cells (xv2bench/configs), and options
# whose convs hand the fold an NCHW layout on some devices
_EVAL_MODELS = [("loc-rs50-attn-ds", {}), ("dmg-fused-rs200", {}),
                ("loc-rs50-attn-ds", {"precision": 32}),
                ("loc-rs50-attn-ds", {"encoder": "resnet50", "ppm": True, "dec_interp": True})]


@pytest.mark.parametrize("name,over", _EVAL_MODELS, ids=["D", "C", "D-f32", "ppm-dec_interp"])
def test_every_eval_site_hands_the_kernel_what_it_takes(name, over, monkeypatch):
    """The eval step (4-flip TTA) of each model on a 64^2 tile: every call
    of ``layers.norm_act`` under ``inference_mode`` passes operands that
    the kernel takes, so that on the card it launches at each and raises
    at none (the card test counts the launches)."""
    import json
    import os

    from xview2_tpu_torch.config import Config, apply_precision
    from xview2_tpu_torch.models.unet import build_model
    from xview2_tpu_torch.ops.metrics import init_f1_state

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "xv2bench", "configs", f"{name}.json")
    with open(path) as f:
        program = dict(json.load(f)["program"], **over)
    cfg = Config(**program, exec_mode="eval", tta=True)
    apply_precision(cfg)
    torch.manual_seed(0)
    model = build_model(cfg)
    seen, refused = [], []
    site = tl.norm_act

    def checked(x, mean, mul, bias, act, residual=None):
        seen.append(act)
        if torch.is_inference_mode_enabled() and not na.takes(x, mean, mul, bias, residual):
            refused.append((tuple(x.shape), x.dtype, x.stride(), act))
        return site(x, mean, mul, bias, act, residual)

    monkeypatch.setattr(tl, "norm_act", checked)
    ch = 6 if cfg.type == "post" else 3
    gen = torch.Generator().manual_seed(21)
    images = torch.randint(0, 256, (1, 64, 64, ch), generator=gen, dtype=torch.uint8)
    masks = torch.randint(0, 2, (1, 64, 64), generator=gen, dtype=torch.uint8)
    step = steps.make_eval_step(cfg, model, device="cpu")
    step(init_f1_state(cfg.n_metric_class, "cpu"), images, masks, torch.ones(1))
    assert len(seen) > 50 and refused == []


def test_cuda_wrapper_raises_off_the_card():
    x, fold, _ = _inputs((2, 3, 4, 16), torch.float32)
    before = na.norm_act_cuda.launches
    with pytest.raises(ValueError):
        na.norm_act_cuda(x, *fold, "relu")
    assert na.norm_act_cuda.launches == before
    assert torch.equal(na.norm_act(x, *fold, "relu"), na.norm_act_reference(x, *fold, "relu"))


def test_launch_counters_list_the_kernel():
    assert na.norm_act_cuda in steps.launch_counters()
