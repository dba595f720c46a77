"""Random weights from a seed, drawn on the device in a few large calls.

The scheme of the port's smoke test, kept for the benchmark: convolution
weights at torch's default init (uniform within ``1 / sqrt(fan_in)``) times
``kernel_scale``, so that activations stay O(1) through the encoder's depth;
every bias N(0, 0.1); BatchNorm scales U[0.5, 1.5), running means N(0, 0.1)
and running variances U[0.5, 2.0), so that the folds do real work; each CORAL
head's ordinal bias [1, 0, -1] plus N(0, 0.1), so that no two levels tie in
bfloat16.  ``residual_scale`` multiplies every leaf that ends a residual
branch (by default the last BatchNorm of every bottleneck, ``bn3``; a
reference may name its own, such as a transformer block's output
projections), its running statistics aside: a random ResNeSt-200 is
otherwise so sensitive to its weights that one rounding moves its gradients
by order one.  A reference may also give the draw of a leaf that no rule
here covers.

One uniform and one normal draw of the whole tree's size, in float32 on the
device, cut into the leaves in the order of the reference's state dict.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

RESIDUAL = (".bn3.",)   # leaf-name fragments that end a residual branch


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    if name.endswith("coral_bias"):
        return "coral"
    if name.endswith("running_mean"):
        return "mean"
    if name.endswith("running_var"):
        return "var"
    if name.endswith("bias"):
        return "bias"
    if name.endswith("weight") and len(shape) == 1:
        return "scale"
    if name.endswith("weight"):
        return "kernel"
    raise ValueError(f"no rule to draw {name} {shape}")


def draw(leaves: List[Tuple[str, Tuple[int, ...]]], seed: int, device, kernel_scale: float,
         residual_scale: float = 1.0, residual: Tuple[str, ...] = RESIDUAL,
         kinds: Optional[Dict[str, Tuple[float, float, float]]] = None
         ) -> Dict[str, torch.Tensor]:
    """The float32 state dict of ``leaves`` ((name, shape) in order) for
    ``seed``: views into one buffer.  ``residual``: fragments of the names
    of the leaves that ``residual_scale`` scales; ``kinds``: a name suffix
    -> the ``(a, b, c)`` of ``a * uniform + b * normal + c``, for a leaf
    that ends with it."""
    sizes = [math.prod(s) for _, s in leaves]
    total = sum(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    # per element: value = a * uniform + b * normal + c
    a, b, c = (torch.zeros(len(leaves), dtype=torch.float32) for _ in range(3))
    for i, (name, shape) in enumerate(leaves):
        res = residual_scale if any(f in name for f in residual) else 1.0
        own = next((v for k, v in (kinds or {}).items() if name.endswith(k)), None)
        if own is not None:
            a[i], b[i], c[i] = (res * v for v in own)
            continue
        kind = _kind(name, shape)
        if kind == "kernel":
            bound = res * kernel_scale / math.sqrt(math.prod(shape[1:]))
            a[i], c[i] = 2 * bound, -bound
        elif kind in ("bias", "mean", "coral"):
            b[i] = 0.1 * (res if kind == "bias" else 1.0)
        elif kind == "var":
            a[i], c[i] = 1.5, 0.5
        else:  # a BatchNorm scale
            a[i], c[i] = res, 0.5 * res
    counts = torch.tensor(sizes, device=device)
    a, b, c = (v.to(device).repeat_interleave(counts, output_size=total) for v in (a, b, c))
    flat = uni.mul_(a).add_(nrm.mul_(b)).add_(c)
    del nrm
    out, start = {}, 0
    for (name, shape), n in zip(leaves, sizes):
        out[name] = flat[start:start + n].view(shape)
        start += n
        if name.endswith("coral_bias"):
            out[name] += torch.tensor([1.0, 0.0, -1.0], device=device)
    return out


def leaves_of(model: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
