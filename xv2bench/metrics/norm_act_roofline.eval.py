"""K9, the eval BatchNorm epilogue (kernels layer, ``ops/norm_act.py``,
``csrc/norm_act.cu``), in an eval call: the least time of its launches in
the traced slice (``work/norm_act.py``, from the cell's shapes) over their
device time, in %."""

from xv2bench.readers import named_roofline
from xv2bench.work import norm_act


def read(r):
    if r.kind != "eval":
        return None
    spec = r.cell.config["program"]
    return named_roofline(r, norm_act.NAMES,
                          norm_act.launch_bounds(r.cell.reference.build, spec, r.batch, r.tile))
