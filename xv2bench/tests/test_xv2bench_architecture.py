"""A configuration whose architecture the reference lacks comes as new files
and entries only: its reference model (found by the configuration's
``reference`` name), its weight rules, a loss term of its own, a per-layer
metric with the work file it reads, its traffic and its limits.  The
harness, the reference of the other cells and every file that was there stay
as they are; and the tiny cells of ``tiny.py`` read, through the cell's own
reference, what the harness read before a reference could be named."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from xv2bench import harness, weights
from xv2bench.tests import tiny
from xv2bench.work import flops, kernels

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE = '''"""A tiny hierarchical-transformer segmenter: an overlapping patch
embedding, one pre-LayerNorm block whose attention takes its keys and values
from a strided reduction (a conv, then a LayerNorm) and a GELU MLP, a 1x1
head and a 4x bilinear upsample."""

import torch
import torch.nn as nn
import torch.nn.functional as F

from xv2bench.reference.model import Precision, conv

RESIDUAL = ("attn.proj.", "mlp.fc2.")
LEAF_KINDS = {"level_embed": (0.0, 0.02, 0.0)}


def linear(p, x, m):
    return p.round(F.linear(p.operand(x), p.operand(m.weight), m.bias.to(p.dtype)))


def layer_norm(p, x, m):
    y = F.layer_norm(x.float(), m.normalized_shape, m.weight, m.bias, m.eps)
    return p.round(y.to(p.dtype))


class Attention(nn.Module):
    def __init__(self, p, dim, heads, sr):
        super().__init__()
        self.p, self.heads, self.sr_ratio = p, heads, sr
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.sr = nn.Conv2d(dim, dim, sr, stride=sr)
        self.norm = nn.LayerNorm(dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, h, w):
        p, (b, n, c) = self.p, x.shape
        q = linear(p, x, self.q).view(b, n, self.heads, -1).transpose(1, 2)
        r = conv(p, x.transpose(1, 2).reshape(b, c, h, w), self.sr.weight, self.sr.bias,
                 stride=self.sr_ratio)
        r = layer_norm(p, r.flatten(2).transpose(1, 2), self.norm)
        k, v = linear(p, r, self.kv).view(b, -1, 2, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4)
        o = p.round(F.scaled_dot_product_attention(q, k, v))
        return linear(p, o.transpose(1, 2).reshape(b, n, c), self.proj)


class MLP(nn.Module):
    def __init__(self, p, dim):
        super().__init__()
        self.p = p
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return linear(self.p, self.p.round(F.gelu(linear(self.p, x, self.fc1))), self.fc2)


class Block(nn.Module):
    def __init__(self, p, dim, heads, sr):
        super().__init__()
        self.p = p
        self.norm1, self.norm2 = nn.LayerNorm(dim), nn.LayerNorm(dim)
        self.attn = Attention(p, dim, heads, sr)
        self.mlp = MLP(p, dim)

    def forward(self, x, h, w):
        x = self.p.round(x + self.attn(layer_norm(self.p, x, self.norm1), h, w))
        return self.p.round(x + self.mlp(layer_norm(self.p, x, self.norm2)))


class ToySegmenter(nn.Module):
    def __init__(self, p, n_class, dim=16, heads=2, sr=2):
        super().__init__()
        self.p = p
        self.patch = nn.Conv2d(3, dim, 7, stride=4, padding=3)
        self.level_embed = nn.Parameter(torch.zeros(dim))
        self.block = Block(p, dim, heads, sr)
        self.norm = nn.LayerNorm(dim)
        self.head = nn.Conv2d(dim, n_class, 1)

    def forward(self, x, train=False):
        p = self.p
        y = conv(p, x, self.patch.weight, self.patch.bias, stride=4, padding=3)
        b, c, h, w = y.shape
        t = p.round(y.flatten(2).transpose(1, 2) + self.level_embed.to(p.dtype))
        t = layer_norm(p, self.block(t, h, w), self.norm)
        y = conv(p, t.transpose(1, 2).reshape(b, c, h, w), self.head.weight, self.head.bias)
        return F.interpolate(y.float(), scale_factor=4, mode="bilinear").to(p.dtype)


def build(spec, p: Precision):
    return ToySegmenter(p, 2)
'''

TERM = '''import torch


def term(logits, labels, w):
    """The mean absolute gap between the softmax and the one-hot labels."""
    n = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.clamp(0, n - 1), n).to(logits.dtype)
    gap = (torch.softmax(logits, dim=-1) - onehot).abs().sum(dim=-1)
    return (w * gap).sum() / (w.sum().clamp(min=1.0) * n)
'''

WORK = '''"""The toy attention kernel's least time: one launch a call over the four
flips, q and the output at 1/4 of the tile, k and v at 1/8, bfloat16."""

from xv2bench.work.kernels import bound_s


def launch_bounds(cell, batch, tile):
    n, m, d = (tile // 4) ** 2, (tile // 8) ** 2, 16
    images = 4 * batch
    return [bound_s(images * 2 * (2 * n + 2 * m) * d, images * 4.0 * n * m * d)]
'''

METRIC = '''from xv2bench.readers import named_roofline
from xv2bench.work import toy_attn


def read(r):
    if r.kind != "eval":
        return None
    return named_roofline(r, ("toy_attn_kernel",), toy_attn.launch_bounds(r.cell, r.batch, r.tile))
'''

# run in the copy, with the copy first on the path: the harness as it finds the new files
CHECK = '''
import json, sys
import torch
from xv2bench import cells, check, readers, trace, traffic, weights
from xv2bench.reference import steps
from xv2bench.reference.model import Precision
from xv2bench.work import flops, toy_attn

cpu, seed = torch.device("cpu"), 2 ** 31 + 3
ev, tr = cells.load("toy-attn.toy-eval"), cells.load("toy-attn.toy-train")
spec, ref, init = ev.config["program"], ev.reference, ev.config["init"]
out = {"reference": ref.name, "module": ref.build.__code__.co_filename,
       "terms": sorted(ref.terms), "metrics": [m["name"] for m in ev.per_layer]}
with torch.device("meta"):
    leaves = weights.leaves_of(ref.build(spec, Precision()))
state = weights.draw(leaves, seed, cpu, **init, **ref.weight_rules)
plain = weights.draw(leaves, seed, cpu, init["kernel_scale"], kinds=ref.kinds)
out["scaled"] = sorted(k for k in state if not torch.equal(state[k], plain[k]))
out["scaled_by_rule"] = all(torch.allclose(state[k], init["residual_scale"] * plain[k])
                            for k in out["scaled"])
out["embed_std"] = float(state["level_embed"].std())
try:
    weights.draw(leaves, seed, cpu, **init)
    out["kind_needed"] = False
except ValueError:
    out["kind_needed"] = True
out["flops"] = {k: flops.per_tile(ref.build, spec, k, 2, 32) for k in ("train", "eval")}

prec = Precision(torch.float64)
pool = traffic.make_pool(tr.traffic, seed, 2, 3, "pre")
batches = [pool.batch(i) for i in range(tr.traffic["check_steps"])]
fresh = lambda: {k: v.clone() for k, v in state.items()}
want = steps.train_readings(tr.reference, spec, fresh, batches, seed, cpu, prec)
got = steps.train_readings(tr.reference, spec, fresh, batches, seed, cpu, prec)
bad = steps.train_readings(tr.reference, spec, fresh, batches, seed, cpu, prec, "altered")
out["losses"] = want["losses"]
out["train"] = check.judge(check.train_numbers(got, want), tr.limits)["correct"]
out["train_altered"] = check.judge(check.train_numbers(bad, want), tr.limits)["correct"]

model = steps.eval_model(ev.reference, spec, state, prec, cpu)
images, masks = pool.batch(0)
logits = steps.eval_logits(model, images, cpu)
loss, counts = steps.judge_eval(ev.reference, spec, logits, masks, pool.valid)
zero = torch.zeros(counts.shape)
altered = torch.cat([-10 * logits[:1], logits[1:]])
for key, lg in (("eval", logits), ("eval_altered", altered)):
    numbers = check.eval_batch_numbers(lg, loss, zero, counts.float(), logits, loss, counts)
    out[key] = check.judge(numbers, ev.limits)["correct"]

events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i, "dur": d, "tid": 1,
           "args": {}} for i, (n, d) in enumerate([("toy_attn_kernel<bf16>", 3.0),
                                                   ("xmma_gemm", 20.0),
                                                   ("toy_attn_kernel<bf16>", 3.0)])]
sl = trace.summarize(events, steps=2, window_s=1.0)
r = readers.Reading("eval", 1.0, 10, 1.0, [0.1], sl, None, 1.0, cell=ev, batch=2, tile=32)
out["metric"] = cells.reader("toy_attn_roofline.eval")(r)
out["metric_want"] = 100 * 2 * sum(toy_attn.launch_bounds(ev, 2, 32)) / 6e-6
print(json.dumps(out))
'''


def _hashes(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _new_files(root):
    here = os.path.join(root, "xv2bench")
    mix = {"tile": 32, "pool_batches": 2, "why": "a test", "source": "a test",
           "buildings": {"mean_per_tile": 3.0, "side_px": [4, 10]},
           "pixels": {"block": 8, "brightness": [60, 180], "contrast": [15, 60], "tint": 15,
                      "noise": 20}}
    files = {
        "reference/toy_attn.py": REFERENCE,
        "reference/terms/toy_l1.py": TERM,
        "work/toy_attn.py": WORK,
        "metrics/toy_attn_roofline.eval.py": METRIC,
        "configs/toy-attn.json": json.dumps({
            "name": "toy-attn", "reference": "toy_attn",
            "source": "https://arxiv.org/abs/2105.15203",
            "program": {"type": "pre", "loss_str": "focal+toy_l1", "precision": 64,
                        "optimizer": "adamw", "lr": 3e-4, "weight_decay": 0.0,
                        "batch_size": 2, "val_batch_size": 2, "train_crop": 32,
                        "autoaugment": False},
            "init": {"kernel_scale": 1.0, "residual_scale": 0.5}}),
        "traffic/toy-train.json": json.dumps(dict(mix, kind="train", check_steps=2,
                                                  slice_calls=2)),
        "traffic/toy-eval.json": json.dumps(dict(mix, kind="eval", sample_among=2,
                                                 check_batches=1, slice_calls=2)),
        "limits/toy-attn.toy-train.json": json.dumps({"limits": {
            n: {"limit": 1e-9} for n in ("loss1_gap", "grad_gap", "update_worst", "stats_gap")}}),
        "limits/toy-attn.toy-eval.json": json.dumps({"limits": {
            n: {"limit": 1e-9} for n in ("logits_gap", "loss_gap", "f1_gap")}}),
    }
    for rel, text in files.items():
        path = os.path.join(here, rel)
        assert not os.path.exists(path), rel
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-attn", "source": "https://arxiv.org/abs/2105.15203",
                             "file": "xv2bench/configs/toy-attn.json", "reduced": [],
                             "why": "a test"})
    for traffic in ("toy-train", "toy-eval"):
        bench["workloads"].append({"name": f"toy-attn.{traffic}", "config": "toy-attn",
                                   "traffic": traffic, "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "toy_attn_roofline.eval", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "kernels",
                               "moves": "eval_tiles_per_s", "workloads": ["toy-attn.toy-eval"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench


def test_a_new_architecture_is_new_files_only(tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(os.path.join(ROOT, "xv2bench"), os.path.join(root, "xv2bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _hashes(os.path.join(root, "xv2bench"))
    old = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench = _new_files(root)

    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {root!r})\n" +
                           CHECK], cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["reference"] == "toy_attn"
    assert out["module"] == os.path.join(root, "xv2bench", "reference", "toy_attn.py")
    assert out["terms"] == ["focal", "toy_l1"]
    assert out["metrics"] == ["toy_attn_roofline.eval"]
    # the reference's residual rule scales its output projections and nothing else
    assert out["scaled"] == ["block.attn.proj.bias", "block.attn.proj.weight",
                             "block.mlp.fc2.bias", "block.mlp.fc2.weight"]
    assert out["scaled_by_rule"] is True
    assert out["kind_needed"] is True and 0.01 < out["embed_std"] < 0.04
    fwd = out["flops"]["eval"] / 4
    assert fwd > 0 and 2.0 < out["flops"]["train"] / fwd < 4.0
    assert len(out["losses"]) == 2 and all(v > 0 for v in out["losses"])
    assert out["train"] is True and out["train_altered"] is False
    assert out["eval"] is True and out["eval_altered"] is False
    assert out["metric"] == pytest.approx(out["metric_want"]) and out["metric"] > 0

    # nothing that was there changed: every file hashes as before, and the
    # entries of BENCHMARK.json that were there are as they were
    after = _hashes(os.path.join(root, "xv2bench"))
    assert {k: v for k, v in after.items() if k in before} == before
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]


# Read from the harness as it was before a configuration could name its
# reference: each tiny cell's leaves (a digest of their names and shapes), its
# drawn state at seed 2^31 + 5 (a digest of the float32 bytes; ResNeSt-50
# models only), its model FLOPs a tile and its K1-K6 launch plan (launches,
# sum of least times).
PARENT = {
    ("loc-rs50-attn-ds.train-aa", None): dict(
        leaves="ff70ee1d6f8453d2b78ce6b993dba00fee2b6efae1990a69d7bd6dccbb4a97a9", n=524,
        state="2b3875f9016ce4cbd9410b2e19c44f55bd8a47e89afa35db87b2d15b3be714c3",
        flops=7404146688.0,
        plan={"K2 conv_bn_fused": (6, "5.312366180100509e-06"),
              "K3 head_conv_fused": (1, "3.3426149253731343e-07"),
              "K4 conv_bn_wgrad": (6, "6.747358948674223e-06"),
              "K5 conv_bn_dgrad": (6, "5.488297456136909e-06"),
              "K1 relayout": (8, "1.809576119402985e-07")}),
    ("loc-rs50-attn-ds.eval-tta", None): dict(
        leaves="ff70ee1d6f8453d2b78ce6b993dba00fee2b6efae1990a69d7bd6dccbb4a97a9", n=524,
        state="2b3875f9016ce4cbd9410b2e19c44f55bd8a47e89afa35db87b2d15b3be714c3",
        flops=9243836416.0,
        plan={"K2 conv_bn_fused": (6, "9.771159166835187e-06"),
              "K3 head_conv_fused": (1, "6.668322388059701e-07"),
              "K1 relayout": (1, "3.912597014925373e-08")}),
    ("dmg-fused-rs200.eval-tta", None): dict(
        leaves="e464c6aa47cec6d9e3d57fa0b06746f4da12a18c5526a00b65c1a7dc6e17fea8", n=3318,
        state=None, flops=64691142656.0,
        plan={"K2 conv_bn_fused": (14, "2.931347750050556e-05"),
              "K3 head_conv_fused": (1, "1.2737385074626867e-06"),
              "K1 relayout": (1, "5.8688955223880594e-08")}),
    ("dmg-fused-rs200.eval-tta", "resnest50"): dict(
        leaves="e2076483a4796f3c872bad3ec5aa19d9a69121b48eb375eafa187e481c019338", n=1018,
        state="da72cf404adba40329b2704e2f5bab0bae49ab8c35fac83d666416599e8b5d29",
        flops=44690604032.0,
        plan={"K2 conv_bn_fused": (14, "2.931347750050556e-05"),
              "K3 head_conv_fused": (1, "1.2737385074626867e-06"),
              "K1 relayout": (1, "5.8688955223880594e-08")}),
}


@pytest.mark.parametrize("workload,encoder", list(PARENT))
def test_the_tiny_cells_read_as_before(workload, encoder):
    cell = tiny.cell(workload, **({"encoder": encoder} if encoder else {}))
    want = PARENT[(workload, encoder)]
    ctx = harness.prepare(cell, 2 ** 31 + 5, torch.device("cpu"), with_program=False)
    assert len(ctx.leaves) == want["n"]
    assert hashlib.sha256(json.dumps(ctx.leaves).encode()).hexdigest() == want["leaves"]
    if want["state"] is not None:
        digest = hashlib.sha256()
        for k, v in ctx.state().items():
            digest.update(k.encode())
            digest.update(v.contiguous().numpy().tobytes())
        assert digest.hexdigest() == want["state"]
    assert flops.per_tile(cell.reference.build, ctx.spec, ctx.kind, ctx.batch, ctx.tile) == \
        want["flops"]
    plan = kernels.launch_plan(ctx.spec, ctx.kind, ctx.batch, ctx.tile)
    assert {k: (len(v), repr(sum(v))) for k, v in plan.items()} == want["plan"]
    assert cell.reference.residual == weights.RESIDUAL and cell.reference.kinds == {}
