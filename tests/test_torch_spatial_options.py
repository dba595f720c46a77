"""``--spatial_shards`` with every other option against the unsharded step:
ONE job of two real processes in a gloo group on the CPU, 1 x 2 (one data
row of two bands; ``tests/torch_spatial_jobs.py``, torch only), float64.

(a) The resizes and pools of the decoder options on a band against the whole
    height, forward and backward: bilinear resizes whose align-corners
    positions fall between two bands (2x up, 4 -> 24, 16 -> 4), a resize of
    a map every rank holds whole (1 -> n and 3 -> 8, PPM's way back), the
    adaptive pools to 1, 3 and 6 bins (n -> 1, windows across the band
    edge, bins more than the rows) resized back, and an ASPP branch at
    dilation 18 on a band of 4 rows (``halo_rows``' gather path, fill 0).
    1e-12 of the scale.
(b) The train step on the bands against the same step alone: the
    ``UNetLoc`` decoder options, the damage variants and ``--remat``.  The
    ranks first share out the cases' unsharded references, each computed
    alone (no group, ``torch_spatial_jobs.alone``), then run every case on
    their bands, and only the distances come back: the loss 1e-9
    relative, the worst gradient leaf and the running statistics 1e-9 of
    their scale (a leaf's scale at least 1e-3 of the case's largest
    gradient: a bias that a train-mode BatchNorm cancels holds float64
    noise), the crops equal, the ranks' parameters and buffers bit-equal.
    The fused variants (300 M parameters, 2.4 GB in float64) and
    ``--interpolate`` (a fixed 512^2 train head) take the train step's
    forward, loss, backward and gradient average on a float64 batch.  The
    TTA eval step of one tile of the crop's size, where the case has one: the bands'
    logits gathered, loss and F1 counts, at the eval step's float32
    resolution (1e-6, as ``tests/test_torch_spatial.py``).
(c) ``--ppm --attention --deep_supervision`` (its two bands' gradients
    after the average) against JAX's unsharded step on the same crops and
    weights: loss 1e-9, gradients 1e-6 of scale, statistics 1e-9.

Tier-1 runs the first case of each group (``ppm_attention_ds``, the JAX
case, at 128^2; ``fused_coral``; ``parallelEnc_ppm``; ``remat_tail``); the
rest is ``slow``: a second job of the same kind.
"""

import jax
import numpy as np
import pytest
import torch

import torch_spatial_jobs as jobs
from test_torch_decoder_options_train import jax_ds_grads
from torch_jax_variables import one_torch_thread  # noqa: F401 (one CPU thread a worker)
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.weights import to_flax

# the first case of each group: the UNetLoc options (``--ppm`` with the
# gates and deep supervision, the JAX case), the fused variant, the other
# variants, --remat
TIER1 = ["fused_coral", "ppm_attention_ds", "parallelEnc_ppm", "remat_tail"]
# why slow: each costs 5-25 s of CPU in the ranks, most of it gloo's
# latency on the CPU (200-400 collectives a step; fusedEnc 5 GB); the tier-1
# budget of this file (about 95 s alone) is spent by the cases above
SLOW = ["ppm", "aspp_dilation2", "dec_interp", "interpolate", "siameseEnc", "parallel",
        "diff", "cat_mse", "remat_dots", "remat_full", "fusedEnc_mse"]
EVAL_TOL = 1e-6  # the eval step's float32 logits and loss (tests/test_torch_spatial.py)
# (loss, gradient leaf, statistics): --remat tail turns the fused tail off,
# and the stock packed tail's BatchNorm sums in float32 whatever the map's
# dtype (JAX ``_PackedBN``): a band's sums, added over the ranks, round
# otherwise than the whole map's, and the float32 noise of dec_l5's
# statistics reaches the loss at about 1e-9 and the gradients at about 1e-6
# (read 1.5e-9, 5.6e-7 and 2.7e-9 on the CPU)
TOLS = {"remat_tail": (1e-8, 1e-5, 1e-7)}


def _run_job(d, names, resample):
    """Start the ranks on ``names``; meanwhile the whole-height resample
    cases and, when the JAX case is among the names, its crops and JAX's
    step on them here; then the ranks' results by case."""
    procs = jobs.start("options", 2, 2, d, str(d), names, resample)
    try:
        ref = {"resample": jobs.resample_cases() if resample else None}
        if jobs.JAX_CASE in names:
            kw = jobs.option_kw(jobs.JAX_CASE)
            state = jobs.seeded_state(kw)
            ref["whole"] = jobs._case_steps(jobs.JAX_CASE, state)
            x, y = ref["whole"]["train"]["crops"]
            params, stats = to_flax(state)
            with jax.enable_x64():
                ref["jax"] = jax_ds_grads(kw, {"params": params, "batch_stats": stats},
                                          x.double().numpy(), y.numpy())[:3]
    finally:
        ranks = jobs.join(procs, d, timeout=900.0)
    cases = {}
    for name in names:
        cases[name] = [torch.load(d / f"{name}_rank{r}.pt") for r in range(2)]
        for r in range(2):
            (d / f"{name}_rank{r}.pt").unlink()
    if jobs.JAX_CASE in names:  # its distances from the whole step computed here
        band = cases[jobs.JAX_CASE][0]
        band.update(jobs._distances(jobs.JAX_CASE, band, ref["whole"]))
    return ref, ranks, cases


@pytest.fixture(scope="module")
def tier1(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("options"), TIER1, True)


@pytest.fixture(scope="module")
def slow_job(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("options_slow"), SLOW, False)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("case", list(jobs.RESAMPLE))
def test_resize_and_pool_on_two_bands_equal_the_whole_height(tier1, case):
    ref, ranks, _ = tier1
    want, got = ref["resample"][case], [r["resample"][case] for r in ranks]
    _close(torch.cat([g["out"] for g in got], dim=1), want["out"], 1e-12, "out")
    for i, w in enumerate(want["dx"]):  # a band's input: the bands in order
        _close(torch.cat([g["dx"][i] for g in got], dim=1), w, 1e-12, f"dx {i}")
    for i, w in enumerate(want["dwhole"]):  # a whole input: each rank's copy's share
        _close(sum(g["dwhole"][i] for g in got), w, 1e-12, f"dwhole {i}")
    for i, w in enumerate(want["dparams"]):
        _close(sum(g["dparams"][i] for g in got), w, 1e-12, f"dparam {i}")
    for g in got:  # the pooled maps and statistics every rank holds whole
        for i, w in enumerate(want["held"]):
            _close(g["held"][i], w, 1e-12, f"held {i}")


def _job(request, case):
    return request.getfixturevalue("tier1" if case in TIER1 else "slow_job")


def _params(names):
    return [n if n in TIER1 else pytest.param(n, marks=pytest.mark.slow) for n in names]


@pytest.mark.parametrize("case", _params(TIER1 + SLOW))
def test_train_step_with_the_option_on_two_bands_equals_one_process(request, case):
    _, _, cases = _job(request, case)
    got = cases[case]
    ref = next(g for g in got if "ref_loss" in g)
    loss_tol, grad_tol, stat_tol = TOLS.get(case, (1e-9, 1e-9, 1e-9))
    for g in got:
        assert g["loss"].item() == pytest.approx(ref["ref_loss"].item(), rel=loss_tol)
        assert g["space_collectives"] > 0
    err, leaf = ref["grad_err"]
    assert err <= grad_tol, f"gradient {leaf}: {err:.3g} of its scale"
    assert ref["buffer_err"] <= stat_tol, ref["buffer_err"]
    assert ref.get("crops_equal", True)
    assert got[0]["digest"] == got[1]["digest"]  # bit-equal ranks


EVAL_CASES = [n for n in TIER1 + SLOW if "remat" not in n and n not in ("fused_coral",
                                                                         "fusedEnc_mse")]


@pytest.mark.parametrize("case", _params(EVAL_CASES))
def test_tta_eval_step_with_the_option_on_two_bands_equals_one_process(request, case):
    _, _, cases = _job(request, case)
    got = cases[case]
    want = next(g for g in got if "eval_ref" in g)["eval_ref"]
    for g in got:
        _close(g["eval"]["logits"], want["logits"], EVAL_TOL, "logits")
        _close(g["eval"]["loss"], want["loss"], EVAL_TOL, "loss")
        for a, b in zip(g["eval"]["f1"], want["f1"]):
            assert torch.equal(a, b)


@pytest.mark.slow  # remat_full runs in the slow job
def test_remat_recomputation_repeats_the_forward_collectives(tier1, slow_job):
    """``--remat tail`` sends what the plain step sends (its local
    checkpoints recompute an affine and an activation, no statistics);
    ``--remat full`` recomputes the whole forward, its halos, space sums and
    BatchNorm sums, in the same order on both ranks (no deadlock, equal
    results above): more collectives a step."""
    tail, full = tier1[2]["remat_tail"], slow_job[2]["remat_full"]
    space = [[g["space_collectives"] for g in c] for c in (tail, full)]
    calls = [[g["collectives"] for g in c] for c in (tail, full)]
    print(f"collectives a step per rank: --remat tail {calls[0]} (space {space[0]}), full "
          f"{calls[1]} (space {space[1]})")
    assert space[0][0] == space[0][1] and space[1][0] == space[1][1]
    assert space[1][0] > space[0][0] and calls[1][0] > calls[0][0]


def _flat_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _leaves(flat, tensors):
    sizes = [t.numel() for t in tensors.values()]
    return {n: v.reshape(t.shape) for (n, t), v in zip(tensors.items(),
                                                        torch.split(flat, sizes))}


def test_ppm_attention_ds_step_on_two_bands_equals_jax_unsharded(tier1):
    """The two bands' averaged gradients and running statistics of ``UNetLoc
    --ppm --attention --deep_supervision`` against JAX's step on the whole
    crops, from the same numpy weights."""
    ref, _, cases = tier1
    jloss, jgrads, jstats = ref["jax"]
    got = cases[jobs.JAX_CASE][0]
    with torch.device("meta"):
        model = build_model(Config(**jobs.option_kw(jobs.JAX_CASE)))
    params, buffers = dict(model.named_parameters()), dict(model.named_buffers())
    assert got["loss"].item() == pytest.approx(jloss, rel=1e-9)
    grads = _flat_tree(to_flax(_leaves(got["train"]["grads"], params))[0])
    assert set(grads) == set(jgrads)
    assert any("ppm" in k for k in grads) and any("output_block_ds3" in k for k in grads)
    for key, want in jgrads.items():
        _close(grads[key], want, 1e-6, f"gradient {key}")
    stats = _flat_tree(to_flax(_leaves(got["train"]["buffers"], buffers))[1])
    assert set(stats) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(stats[key], want, rtol=1e-9, atol=1e-12, err_msg=key)
