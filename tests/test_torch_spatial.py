"""``--spatial_shards`` (the image height split over a space axis of ranks,
``xview2_tpu_torch/parallel/mesh.py``) against the unsharded computation.

(a) K2 in band mode (its plain version, ``reference_conv_bn`` through
    ``conv_bn_fused(..., pad_top, pad_bottom)``) at every pair of pads
    against the full-height conv sliced, in float64 (1e-12 of the scale),
    at 128 -> 128 and at the fused variant's packed cross-fusion (C = 256
    -> 128, the group-major kernel of two branches, with a fold),
    and against JAX's ``conv_bn_fused`` in Pallas interpret mode on the full
    map, sliced (float32, the JAX kernel test's rtol 1e-5 / atol 1e-4); the
    K4/K5 band path (the cotangent zero-padded to the input's rows) the same
    way, with cotangents on ``out``, ``s1`` and ``s2``;
(b) ONE job of two real processes in a gloo group on the CPU, 1 x 2 (one
    data row of two bands; ``tests/torch_spatial_jobs.py``, torch only),
    while the test process computes the same cases on the whole height and
    JAX's train step on the same crops: every halo primitive in float64
    forward and backward (the convs at 7x7/s2/p3, 3x3/s2, dilation 2,
    grouped, 1x1/s2 and a halo deeper than the band; the max pool; both
    ResNeSt pools; the split attention in train and eval mode; the band
    conv of the fused chain; four losses, OHEM's ranking among them) at
    1e-12 of the scale; the ResNet-50 ``UNetLoc`` fused-tail TTA eval step
    in float64 (logits, loss, F1 counts); its float64 train step with its
    augmentation against one process on the whole crops (crops EQUAL, loss
    1e-9 relative, parameters after the SGD update and statistics 1e-9 of
    scale, bit-equal ranks) and against JAX's unsharded step (loss 1e-9,
    gradients 1e-6 of scale, statistics 1e-9);
(c) a second job of four processes, 2 x 2: the Siamese ResNet-50
    ``--autoaugment`` train step of ``tests/test_spatial.py`` (in float64,
    fused tail) against one process on the global batch;
(d) the crop rule and the eval tiles' rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spatial_jobs as jobs
import xview2_tpu.ops.packed_fused_conv as jpfc
from torch_jax_variables import jax_train_grads, one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.layers import group_major_rows, s2d_conv_kernel
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops import packed_fused_conv as port
from xview2_tpu_torch.parallel import mesh, steps
from xview2_tpu_torch.weights import to_flax

PADS = [(1, 1), (1, 0), (0, 1), (0, 0)]


def _close(got, want, tol, what, floor=1e-300):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ------------------------------------------------------------ (a) K2 band

H = 16


def _band(pt, pb):
    """The band's output rows and its input rows (with the halo rows that a
    zero pad flag says the input carries)."""
    r0, r1 = (0 if pt else 4), (H if pb else 12)
    return (r0, r1), (r0 - 1 + pt, r1 + 1 - pb)


def _k2_case(dtype, kind="c128"):
    """``c128``: a 128 -> 128 conv; ``cross_fusion``: the fused variant's
    packed cross-fusion, C = 256 -> 128 through the group-major packed kernel
    of ``PackedConvLayer(groups=2)`` (a fine (3, 3, 64, 32) kernel), the
    fold over the concat of both branches' channels."""
    rng = np.random.default_rng(11)
    c, co = (128, 128) if kind == "c128" else (256, 128)
    x = rng.normal(size=(1, H, 8, c))
    if kind == "c128":
        k = rng.normal(0, 0.1, (3, 3, c, co))
    else:
        fine = torch.from_numpy(rng.normal(0, 0.1, (3, 3, 64, 32)))
        k = group_major_rows(s2d_conv_kernel(fine), 2).numpy()
    fold = (rng.normal(0, 0.5, c), rng.uniform(0.5, 1.5, c), rng.normal(0, 0.5, c))
    g = rng.normal(size=(1, H, 8, co))
    g1, g2 = rng.normal(size=co), rng.normal(0, 0.1, co)
    return [np.asarray(a, dtype) for a in (x, k, *fold, g, g1, g2)]


def _port_vjp(x, k, fold, cots, pads=(1, 1)):
    """Outputs and input/kernel/fold gradients of the port's conv_bn_fused."""
    tx, tk = torch.from_numpy(x).requires_grad_(), torch.from_numpy(k).requires_grad_()
    tf = tuple(torch.from_numpy(f).requires_grad_() for f in fold)
    outs = port.conv_bn_fused(tx, tk, tf, True, *pads)
    grads = torch.autograd.grad(outs, (tx, tk) + tf, tuple(torch.from_numpy(c) for c in cots))
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _effective(out, g, g1, g2, rows):
    """The cotangent of the whole map's ``out`` that a band's cotangents
    (``g`` on its output rows, ``g1``/``g2`` on its sums) amount to."""
    eff = np.zeros_like(out)
    r0, r1 = rows
    eff[:, r0:r1] = g[:, r0:r1] + g1 + 2.0 * out[:, r0:r1] * g2
    return eff


@pytest.fixture(scope="module")
def full_f64():
    """The whole map's case and ``out`` of each kind, made on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            x, k, *rest = _k2_case(np.float64, kind)
            fold, (g, g1, g2) = rest[:3], rest[3:]
            (out, s1, s2), _ = _port_vjp(x, k, fold, (np.zeros_like(g), 0 * g1, 0 * g2))
            cache[kind] = (x, k, fold, g, g1, g2), out
        return cache[kind]

    return get


# every pad pair at 128 -> 128, and the cross-fusion's C = 256 -> 128
BAND_CASES = [("c128", p) for p in PADS] + [("cross_fusion", p) for p in PADS]
BAND_IDS = [f"{kind}-pad{a}{b}" if kind != "c128" else f"pad{a}{b}"
            for kind, (a, b) in BAND_CASES]


@pytest.fixture(scope="module")
def jax_full():
    """JAX's conv_bn_fused on the whole map (interpret mode, float32): its
    outputs, and a function of the cotangent of ``out`` giving its vjp."""
    x, k, *rest = _k2_case(np.float32)
    fold = tuple(jnp.asarray(f) for f in rest[:3])
    jpfc.INTERPRET = True
    try:
        outs, vjp = jax.vjp(lambda a, b, c: jpfc.conv_bn_fused(a, b, c, True),
                            jnp.asarray(x), jnp.asarray(k), fold)
        cache = {}

        def grads(pads, eff):
            if pads not in cache:
                zero = jnp.zeros((k.shape[-1],), jnp.float32)
                cache[pads] = jax.tree.map(np.asarray, vjp((jnp.asarray(eff), zero, zero)))
            return cache[pads]

        yield (x, k, rest), [np.asarray(o) for o in outs], grads
    finally:
        jpfc.INTERPRET = False


@pytest.mark.parametrize("kind,pads", BAND_CASES, ids=BAND_IDS)
def test_band_k2_equals_the_full_height_conv_sliced(full_f64, kind, pads):
    (x, k, fold, g, g1, g2), out = full_f64(kind)
    rows, (i0, i1) = _band(*pads)
    (bout, bs1, bs2), _ = _port_vjp(x[:, i0:i1], k, fold, (g[:, rows[0]:rows[1]], g1, g2), pads)
    want = out[:, rows[0]:rows[1]]
    _close(bout, want, 1e-12, "out")
    _close(bs1, want.sum(axis=(0, 1, 2)), 1e-12, "s1")
    _close(bs2, (want * want).sum(axis=(0, 1, 2)), 1e-12, "s2")


@pytest.mark.parametrize("kind,pads", BAND_CASES, ids=BAND_IDS)
def test_band_k4_k5_equal_the_full_height_vjp(full_f64, kind, pads):
    """The band's backward (K4/K5 on the zero-padded cotangent) against the
    whole map's backward under the band's effective cotangent: dx on the
    band's input rows (zero elsewhere), dW and the fold cotangents."""
    (x, k, fold, g, g1, g2), out = full_f64(kind)
    rows, (i0, i1) = _band(*pads)
    _, got = _port_vjp(x[:, i0:i1], k, fold, (g[:, rows[0]:rows[1]], g1, g2), pads)
    eff = _effective(out, g, g1, g2, rows)
    _, want = _port_vjp(x, k, fold, (eff, 0 * g1, 0 * g2))
    assert not np.abs(want[0][:, :i0]).any() and not np.abs(want[0][:, i1:]).any()
    _close(got[0], want[0][:, i0:i1], 1e-12, "dx")
    for name, a, b in zip(("dk", "dmean", "dmul", "dbias"), got[1:], want[1:]):
        _close(a, b, 1e-12, name)


@pytest.mark.parametrize("pads", PADS, ids=[f"pad{a}{b}" for a, b in PADS])
def test_band_k2_k4_k5_equal_jax_on_the_full_map_sliced(jax_full, pads):
    (x, k, rest), (jout, _, _), jax_grads = jax_full
    fold, (g, g1, g2) = rest[:3], rest[3:]
    rows, (i0, i1) = _band(*pads)
    (bout, bs1, bs2), got = _port_vjp(x[:, i0:i1], k, fold, (g[:, rows[0]:rows[1]], g1, g2),
                                      pads)
    want = jout[:, rows[0]:rows[1]]
    np.testing.assert_allclose(bout, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(bs1, want.sum(axis=(0, 1, 2)), rtol=1e-5, atol=1e-4 * H)
    np.testing.assert_allclose(bs2, (want * want).sum(axis=(0, 1, 2)), rtol=1e-5,
                               atol=1e-4 * H)
    jdx, jdk, jfold = jax_grads(pads, _effective(jout, g, g1, g2, rows))
    _close(got[0], jdx[:, i0:i1], 1e-4, "dx")
    _close(got[1], jdk, 1e-4, "dk")
    for name, a, b in zip(("dmean", "dmul", "dbias"), got[2:], jfold):
        _close(a, b, 1e-4, name)


# ------------------------------------------------------ (b) 1 x 2 on gloo

@pytest.fixture(scope="module")
def unet(tmp_path_factory):
    """(the test process's whole-height results, the two ranks' results)."""
    d = tmp_path_factory.mktemp("spatial")
    model, variables = seeded_model(jobs.TRAIN_KW)
    torch.save(model.state_dict(), d / "state.pt")
    procs = jobs.start("unet", 2, 2, d, str(d / "state.pt"))
    try:
        state = model.state_dict()
        before = mesh.collective.calls
        ref = {"primitives": jobs.primitive_cases(), "eval": jobs.eval_step(state),
               "more_eval": jobs.more_eval_steps(), "train": jobs.train_step(state)}
        ref["calls"] = mesh.collective.calls - before
        x, y = ref["train"]["crops"]
        with jax.enable_x64():
            ref["jax"] = jax_train_grads(jobs.TRAIN_KW, variables, x.double().numpy(),
                                         y.numpy(), [jobs.TRAIN_KW["loss_str"]])[0]
    finally:
        ranks = jobs.join(procs, d)
    (d / "state.pt").unlink()
    return ref, ranks


# The ResNeSt pools and the split attention compute in float32 whatever the
# map's dtype (their JAX functions' window sums, the pooled attention), so
# a band's backward, which adds a halo row's float32 cotangent to its owner's
# in float64, and a band's pool, summed over the space group before the
# division, round once more: they hold at float32's resolution, 1e-6 of the
# scale (the packed BatchNorm's tolerance in the data-parallel tests).  In
# train mode ``bn1`` normalizes the three images' pooled values by their
# spread, which scales that rounding up about tenfold in the parameter
# gradients behind it: 1e-5.
F32_INSIDE = {"avd_pool_3x3_s2": 1e-6, "avd_pool_3x3_s1": 1e-6, "avg_down_pool_2x2": 1e-6,
              "split_attention_train": 1e-5, "split_attention_eval": 1e-6}


@pytest.mark.parametrize("case", list(jobs.PRIMITIVES))
def test_halo_primitive_on_two_bands_equals_the_whole_height(unet, case):
    ref, ranks = unet
    want, got = ref["primitives"][case], [r["primitives"][case] for r in ranks]
    tol = F32_INSIDE.get(case, 1e-12)
    for i, w in enumerate(want["outs"]):
        if w.dim() == 4:  # a map: the bands in order
            _close(torch.cat([g["outs"][i] for g in got], dim=1), w, tol, f"out {i}")
        else:  # a per-channel sum: the bands' parts add up
            _close(sum(g["outs"][i] for g in got), w, tol, f"sum {i}")
    for i, w in enumerate(want["dx"]):
        _close(torch.cat([g["dx"][i] for g in got], dim=1), w, tol, f"dx {i}")
    # a leaf whose true gradient is zero (a bias that train-mode BatchNorm
    # cancels, its float64 noise about 1e-13) is held at a scale of at least
    # 1e-3 of the case's largest gradient
    floor = 1e-3 * max([float(w.abs().max()) for w in want["dparams"]], default=0.0)
    for i, w in enumerate(want["dparams"]):
        _close(sum(g["dparams"][i] for g in got), w, tol, f"dparam {i}", floor)
    for g in got:
        for i, w in enumerate(want["buffers"]):
            _close(g["buffers"][i], w, tol, f"buffer {i}")


@pytest.mark.parametrize("case", list(jobs.LOSSES))
def test_loss_on_two_bands_equals_the_whole_height(unet, case):
    ref, ranks = unet
    want, got = ref["primitives"][f"loss_{case}"], [r["primitives"][f"loss_{case}"]
                                                     for r in ranks]
    for g in got:
        _close(g["loss"], want["loss"], 1e-12, "loss")
    _close(torch.cat([g["grad"] for g in got], dim=1), want["grad"], 1e-12, "gradient")


# The eval step casts the logits to float32 (as JAX's does) and its loss sums
# them in float32: a float64 model's logits hold to one float32 rounding and
# the loss, summed over two bands and then the ranks, to a few: 1e-6.
EVAL_TOL = 1e-6


def test_tta_eval_step_on_two_bands_equals_the_whole_tiles(unet):
    ref, ranks = unet
    want = ref["eval"]
    _close(torch.cat([r["eval"]["logits"] for r in ranks], dim=1), want["logits"], EVAL_TOL,
           "logits")
    for r in ranks:
        _close(r["eval"]["loss"], want["loss"], EVAL_TOL, "loss")
        for a, b in zip(r["eval"]["f1"], want["f1"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(jobs.EVAL_CASES))
def test_more_eval_steps_on_two_bands_equal_the_whole_tile(unet, case):
    """The stock tail, ResNeSt-50 and --dilation 4 (halos of 4 rows at /8)."""
    ref, ranks = unet
    want = ref["more_eval"][case]
    _close(torch.cat([r["more_eval"][case]["logits"] for r in ranks], dim=1), want["logits"],
           EVAL_TOL, "logits")
    for r in ranks:
        _close(r["more_eval"][case]["loss"], want["loss"], EVAL_TOL, "loss")
        for a, b in zip(r["more_eval"][case]["f1"], want["f1"]):
            assert torch.equal(a, b)


def _leaves(flat, tensors):
    sizes = [t.numel() for t in tensors.values()]
    return {n: v.reshape(t.shape) for (n, t), v in
            zip(tensors.items(), torch.split(flat, sizes))}


def _shapes(kw):
    with torch.device("meta"):
        model = build_model(Config(**kw))
    return dict(model.named_parameters()), dict(model.named_buffers())


def _hold_step(got, want, shapes):
    params, buffers = shapes
    assert got["loss"].item() == pytest.approx(want["loss"].item(), rel=1e-9)
    for name, w in _leaves(want["buffers"], buffers).items():
        _close(_leaves(got["buffers"], buffers)[name], w, 1e-9, name)
    if "params" in got:
        p = _leaves(got["params"], params)
        for name, w in _leaves(want["params"], params).items():
            _close(p[name], w, 1e-9, name)


def test_train_step_on_two_bands_equals_one_process(unet):
    ref, ranks = unet
    shapes = _shapes(jobs.TRAIN_KW)
    for r in ranks:
        for i in range(2):
            assert torch.equal(r["train"]["crops"][i], ref["train"]["crops"][i])
        _hold_step(r["train"], ref["train"], shapes)
    assert ranks[0]["train"]["digest"] == ranks[1]["train"]["digest"]
    assert ref["calls"] == 0
    assert all(r["train"]["space_collectives"] > 0 for r in ranks)


def _flat_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_on_two_bands_equals_jax_unsharded(unet):
    ref, ranks = unet
    params, buffers = _shapes(jobs.TRAIN_KW)
    jloss, jgrads, jstats = ref["jax"]
    got = ranks[0]["train"]
    assert got["loss"].item() == pytest.approx(jloss, rel=1e-9)
    grads, _ = to_flax(_leaves(got["grads"], params))
    flat = _flat_tree(grads)
    assert set(flat) == set(jgrads)
    for key, want in jgrads.items():
        _close(flat[key], want, 1e-6, f"gradient {key}")
    _, stats = to_flax(_leaves(ranks[1]["train"]["buffers"], buffers))
    flat = _flat_tree(stats)
    assert set(flat) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(flat[key], want, rtol=1e-9, atol=1e-12, err_msg=key)


# ------------------------------------------------------ (c) 2 x 2 on gloo

def test_siamese_autoaugment_step_on_a_2x2_grid_equals_one_process(tmp_path):
    model, _ = seeded_model(jobs.SIAMESE_KW)
    state = model.state_dict()
    torch.save(state, tmp_path / "state.pt")
    procs = jobs.start("siamese", 4, 2, tmp_path, str(tmp_path / "state.pt"))
    try:
        want = jobs.train_step(state, jobs.SIAMESE_KW, b=2, channels=6)
    finally:
        ranks = jobs.join(procs, tmp_path)
    shapes = _shapes(jobs.SIAMESE_KW)
    for r in ranks:
        _hold_step(r, want, shapes)
    assert len({r["digest"] for r in ranks}) == 1
    for d in range(2):  # each data row's ranks trained on the row's crops
        for i in range(2):
            for s in range(2):
                assert torch.equal(ranks[2 * d + s]["crops"][i], want["crops"][i][d:d + 1])


@pytest.mark.slow  # a whole ResNeSt step: a minute of CPU in three processes
def test_resnest50_train_step_on_two_bands_equals_one_process(tmp_path):
    """The ResNeSt-50 UNetLoc fused-tail float64 train step at 1 x 2 (the
    deep stem, the split attention's pooled statistics over the space group,
    the avd and avg-down pools): the loss within 1e-6, the parameters after
    the update and the statistics within 1e-4 of their scale, bit-equal
    ranks.  The pools and the split attention compute in float32 (a band's
    pool is summed over the space group before the division), and the
    train-mode BatchNorms behind them scale those roundings up: float32
    noise, not float64's (ROADMAP Queue 3: a ResNeSt step has no float64
    parity with JAX either)."""
    procs = jobs.start("resnest", 2, 2, tmp_path)
    try:
        want = jobs.train_step(jobs.seeded_state(jobs.RESNEST_KW), jobs.RESNEST_KW)
    finally:
        ranks = jobs.join(procs, tmp_path, timeout=900.0)
    params, buffers = _shapes(jobs.RESNEST_KW)
    for r in ranks:
        assert r["loss"].item() == pytest.approx(want["loss"].item(), rel=1e-6)
        for name, w in _leaves(want["buffers"], buffers).items():
            _close(_leaves(r["buffers"], buffers)[name], w, 1e-4, name)
        p = _leaves(r["params"], params)
        for name, w in _leaves(want["params"], params).items():
            _close(p[name], w, 1e-4, name, floor=1.0)
    assert ranks[0]["digest"] == ranks[1]["digest"]


# ------------------------------------------------------------ (d) the rules

@pytest.mark.parametrize("crop,shards", [(96, 2), (64, 4), (160, 2)])
def test_crop_not_divisible_by_32_times_the_shards_raises(crop, shards):
    with pytest.raises(ValueError, match="divisible by 32"):
        Config(gpus=4, spatial_shards=shards, train_crop=crop)
    Config(gpus=4, spatial_shards=shards, train_crop=crop * 32 * shards)


def test_eval_tile_not_divisible_raises():
    with pytest.raises(ValueError, match="divisible by 32"):
        steps.check_band_height(96, 2, "the eval tile")
    steps.check_band_height(128, 2, "the eval tile")
    steps.check_band_height(96, 1, "the eval tile")
