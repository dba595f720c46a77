"""The work of K9, the port's eval BatchNorm epilogue (``csrc/norm_act.cu``):
its launches in one eval call and each launch's least time on one H100.

K9 computes ``act((x - mean) * mul + bias [+ residual])`` in one pass over an
NHWC map, once at each BatchNorm of the eval forward that the program does
not fold into another kernel.  Its least time is bytes over the HBM rate:
the map read once and written once in the compute dtype, the residual read
once where the bottleneck's tail adds it, and the three float32 fold vectors
(mean, mul, bias) read once.

The sites come from the cell's reference on the meta device: every
BatchNorm that the four flips' forward (one batch of ``4 * batch`` tiles, as
the program runs them) passes through, at its output's shape.  The program's
fusions then apply, stated here from its decoder:

- a bottleneck's last BatchNorm (``bn3``) is one launch that also reads the
  residual;
- a decoder ConvBlock that the fused tail takes (:func:`supported`, the
  program's routing rule) folds its first BatchNorm into K2's prologue, and
  its second is one launch;
- the last decoder stage, taken by the fused tail, defers its folds (and,
  in the ``fused`` damage model, the cross-fusion's) into K3's head: no
  launch.  Where the fused tail would not take it, there is no plan.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import torch

from xv2bench.reference.model import BatchNorm, Precision
from xv2bench.work.kernels import bound_s

NAMES = ("norm_act_elementwise_kernel", "norm_act_strided_elementwise_kernel")
ITEMSIZE = {16: 2, 32: 4, 64: 8}
HC = 8   # rows of the fused tail's row blocks
BLOCK = re.compile(r"dec_(?:layers|fusion)_(\d+)\.(?:(?:pre|post)_layer\.)?conv_block\.conv([12])"
                   r"\.BatchNorm_0$")
REMIX = re.compile(r"dec_fusion_(\d+)\.conv_(?:pre|post)\.BatchNorm_0$")
LAST = 4   # the last decoder stage (no skip; s2d-packed in the program)


def supported(shape: Tuple[int, int, int, int], c_out: int, itemsize: int = 2) -> bool:
    """Whether the fused tail takes a 3x3 conv of the NHWC input ``shape`` to
    ``c_out`` channels (the program's routing rule, kept unchanged from
    the JAX module's budgets)."""
    _, h, w, c = shape
    if c % 128 or c_out % 128 or h % HC or h < 16 or w < 8:
        return False
    rows = 2 * HC * (w + 8) * c * itemsize
    return (9 * c * c_out * itemsize <= (6 << 20) and 9 * c * c_out * 4 <= (7 << 20)
            and rows + HC * w * c_out * 4 <= (8 << 20))


def _bn_outputs(build, spec: dict, batch: int, tile: int) -> Tuple[torch.nn.Module, list]:
    """The reference model and (name, NCHW shape) of each BatchNorm's output
    in the eval forward of ``4 * batch`` tiles, on the meta device."""
    seen = []
    with torch.device("meta"):
        model = build(spec, Precision(torch.bfloat16))
        for name, m in model.named_modules():
            if isinstance(m, BatchNorm):
                m.register_forward_hook(
                    lambda _m, _a, out, name=name: seen.append((name, tuple(out.shape))))
        channels = 3 if spec["type"] == "pre" else 6
        with torch.no_grad():
            model(torch.empty(4 * batch, channels, tile, tile), False)
    return model, seen


def sites(build, spec: dict, batch: int, tile: int) -> Optional[List[Tuple[int, int, bool]]]:
    """(map elements, channels, residual) of each K9 launch of one eval
    call, or None where the plan does not hold (no fused tail, or a last
    decoder stage that it would not take)."""
    if not spec.get("fused_tail"):
        return None
    model, seen = _bn_outputs(build, spec, batch, tile)
    item = ITEMSIZE[spec.get("precision", 16)]
    out = []
    for name, (n, c, h, w) in seen:
        stage = BLOCK.search(name) or REMIX.search(name)
        if stage is not None:
            i = int(stage.group(1))
            if stage.re is BLOCK:
                block = model.get_submodule(name[:name.index("conv_block") + len("conv_block")])
                cin = block.conv1.Conv_0.weight.shape[1]
            else:
                cin = 2 * c  # the concat of both branches
            if i == LAST:   # s2d-packed: the program checks it at bfloat16's size
                if not supported((n, h // 2, w // 2, 4 * cin), 4 * c):
                    return None
                continue
            taken = supported((n, h, w, cin), c, item) and supported((n, h, w, c), c, item)
            if stage.re is BLOCK and taken and stage.group(2) == "1":
                continue
        out.append((n * c * h * w, c, name.endswith(".bn3")))
    return out


def launch_bounds(build, spec: dict, batch: int, tile: int) -> Optional[List[float]]:
    """The least time of each K9 launch of one eval call, or None."""
    got = sites(build, spec, batch, tile)
    if got is None:
        return None
    item = ITEMSIZE[spec.get("precision", 16)]
    return [bound_s(elems * item * (3 if residual else 2) + 3 * c * 4)
            for elems, c, residual in got]
