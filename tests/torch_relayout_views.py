"""Views of each layout kind for the port's relayout copy (K1), shared by
its CPU tests (``test_torch_relayout.py``) and its on-card tests
(``test_torch_cuda.py``).  Imports torch and the port only."""

import torch

from xview2_tpu_torch.ops import layout

RELAYOUT_DTYPES = (torch.uint8, torch.int32, torch.bfloat16, torch.float32, torch.float64)
RELAYOUT_SIZES = (1, 15, 16, 17)
RELAYOUT_KINDS = ("contiguous", "misaligned", "inner", "permuted", "general")


def relayout_views(dtype, n, device):
    """One view of each kind whose innermost run holds ``n`` elements: the
    contiguous tensor, a contiguous view one element off its storage's start
    (``flat[1:]``), an inner-stride-1 view, an NCHW buffer viewed NHWC (3
    channels) and a view with no stride of 1; with the path each should
    take.  At n = 1 the unit dim drops out, so the permuted view is
    contiguous (flat)."""
    gen = torch.Generator(device=device).manual_seed(n)

    def base(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 100).to(dtype)

    return {
        "contiguous": (base(2, n), layout.FLAT),
        "misaligned": (base(2 * n + 1).view(-1)[1:], layout.FLAT),
        "inner": (base(3, n + 1)[:, :n], layout.STRIDED),
        "permuted": (base(2, 3, n).permute(0, 2, 1), layout.STRIDED if n > 1 else layout.FLAT),
        "general": (base(3, n, 4)[..., ::2], layout.STRIDED),
    }
