"""Data parallelism over ``--gpus N`` (``xview2_tpu_torch/parallel/mesh.py``)
against the single-device step on the global batch, in float64
(``Config(precision=64)``, ``jax.enable_x64`` on the JAX side).

ONE job of two real processes in a gloo group on the CPU
(``tests/torch_data_parallel_jobs.py``, torch only) computes every case of
this module on its rows; the test process computes the same cases on the
whole batch without a group (which must send no collective) and JAX's
train step on the same crops, while the ranks run.  Each parametrised test
reads one case:

(a) ``BatchNorm.normalize_train``, ``normalize_train_packed`` and
    ``fold_from_sums`` (of a plain and of a packed chain): output and input
    gradient rows, the affine gradients summed over the ranks, the running
    statistics on every rank, within 1e-12 of the scale;
(b) every loss term and deep supervision: the loss on every rank and each
    rank's logits gradient (divided by the N-fold seed) within 1e-12;
(c) the ResNet-50 ``UNetLoc`` fused-tail train step (the kernels' plain
    versions), 2 ranks x 2 raw tiles cropped to 32^2 against 1 process x 4
    from the same generator, augmentation included: the crops EQUAL to the
    global batch's rows, the loss within 1e-9 relative, every parameter
    after the SGD update and every running statistic within 1e-9 of its
    leaf's scale, parameters and buffers bit-equal across the ranks (rank
    1 starts from perturbed weights that ``broadcast_module`` replaces);
(d) the same step's loss, averaged gradients and statistics against JAX's
    train step on the 4 crops, at the train-step parity's tolerances (loss
    1e-9, leaves 1e-6 of scale, statistics 1e-9);
(e) ``--remat full`` at 2 ranks: the recomputed folds, the loss, the
    parameters and the statistics EQUAL to the step without remat;
(f) the inverse-CDF pixel draw of the augmentation.
"""

import jax
import numpy as np
import pytest
import torch

import torch_data_parallel_jobs as jobs
from torch_jax_variables import jax_train_grads, one_torch_thread, seeded_model  # noqa: F401
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.ops.augment import sample_nonzero_pixel
from xview2_tpu_torch.parallel import mesh
from xview2_tpu_torch.weights import to_flax

WORLD = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the test process's single-process results, the ranks' results)."""
    d = tmp_path_factory.mktemp("data_parallel")
    model, variables = seeded_model(jobs.TRAIN_KW)
    state = model.state_dict()
    torch.save(state, d / "state.pt")
    procs = jobs.start("all_cases", WORLD, d, str(d / "state.pt"))
    try:
        before = mesh.collective.calls
        ref = {"bn": jobs.bn_cases(0, 1), "loss": jobs.loss_cases(0, 1),
               "train": jobs.train_step(0, 1, state)}
        ref["calls"] = mesh.collective.calls - before
        x, y = ref["train"]["crops"]
        with jax.enable_x64():
            ref["jax"] = jax_train_grads(jobs.TRAIN_KW, variables, x.double().numpy(),
                                         y.numpy(), [jobs.TRAIN_KW["loss_str"]])[0]
    finally:
        ranks = jobs.join(procs, d)
    (d / "state.pt").unlink()
    return ref, ranks


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


# ``normalize_train_packed`` sums in float32 whatever the input's dtype (JAX
# ``_PackedBN``), so its case holds at float32's resolution: 1e-6 of the
# scale, about 8 ulps.
BN_TOL = {"normalize_train": 1e-12, "normalize_train_packed": 1e-6, "fold_from_sums_1": 1e-12,
          "fold_from_sums_4": 1e-12}


@pytest.mark.parametrize("case", list(BN_TOL))
def test_batchnorm_on_the_rank_halves_equals_the_whole_batch(results, case):
    ref, ranks = results
    want, got, tol = ref["bn"][case], [r["bn"][case] for r in ranks], BN_TOL[case]
    for key in ("y", "dx"):
        _close(torch.cat([g[key] for g in got]), want[key], tol, key)
    for key in ("dweight", "dbias"):
        _close(sum(g[key] for g in got), want[key], tol, key)
    for g in got:
        for key in ("running_mean", "running_var"):
            _close(g[key], want[key], tol, key)


@pytest.mark.parametrize("case", list(jobs.LOSS_CASES) + ["deep_supervision"])
def test_loss_at_two_ranks_equals_the_whole_batch(results, case):
    ref, ranks = results
    want, got = ref["loss"][case], [r["loss"][case] for r in ranks]
    for g in got:
        _close(g["loss"], want["loss"], 1e-12, "loss")
    _close(torch.cat([g["grad"] for g in got]), want["grad"], 1e-12, "gradient")


def _leaves(flat, tensors):
    """Split a flat vector by the shapes of ``tensors`` (name -> tensor)."""
    sizes = [t.numel() for t in tensors.values()]
    return {n: v.reshape(t.shape) for (n, t), v in
            zip(tensors.items(), torch.split(flat, sizes))}


@pytest.fixture(scope="module")
def shapes():
    with torch.device("meta"):
        model = build_model(Config(**jobs.TRAIN_KW))
    return dict(model.named_parameters()), dict(model.named_buffers())


def test_train_step_crops_are_the_global_batch_rows(results):
    ref, ranks = results
    for i in range(2):
        assert torch.equal(torch.cat([r["train"]["crops"][i] for r in ranks]),
                           ref["train"]["crops"][i])


def test_train_step_at_two_ranks_equals_one_process_on_the_global_batch(results, shapes):
    ref, ranks = results
    params, buffers = shapes
    assert ref["train"]["folds"], "the fused chain did not run"
    for r in ranks:
        assert r["train"]["loss"].item() == pytest.approx(ref["train"]["loss"].item(), rel=1e-9)
        for name, want in _leaves(ref["train"]["buffers"], buffers).items():
            _close(_leaves(r["train"]["buffers"], buffers)[name], want, 1e-9, name)
    got = _leaves(ranks[0]["train"]["params"], params)
    for name, want in _leaves(ref["train"]["params"], params).items():
        _close(got[name], want, 1e-9, name)


def test_ranks_hold_bit_equal_parameters_and_buffers(results):
    _, ranks = results
    assert ranks[0]["train"]["digest"] == ranks[1]["train"]["digest"]


def _flat_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_at_two_ranks_equals_jax_on_the_global_batch(results, shapes):
    ref, ranks = results
    params, buffers = shapes
    jloss, jgrads, jstats = ref["jax"]
    assert ranks[0]["train"]["loss"].item() == pytest.approx(jloss, rel=1e-9)
    grads, _ = to_flax(_leaves(ranks[0]["train"]["grads"], params))
    got = _flat_tree(grads)
    assert set(got) == set(jgrads)
    for key, want in jgrads.items():
        _close(got[key], want, 1e-6, f"gradient {key}")
    _, stats = to_flax(_leaves(ranks[1]["train"]["buffers"], buffers))
    got = _flat_tree(stats)
    assert set(got) == set(jstats)
    for key, want in jstats.items():
        np.testing.assert_allclose(got[key], want, rtol=1e-9, atol=1e-12, err_msg=key)


def test_remat_full_at_two_ranks_recomputes_equal_folds(results):
    _, ranks = results
    for r in ranks:
        remat, n = r["train"]["remat"], r["train"]["n_folds"]
        assert n > 0 and remat["n_folds"] == 2 * n
        assert remat["first_folds"] and remat["recomputed_folds"]
        assert remat["loss"] and remat["params"] and remat["buffers"]


def test_collectives_only_under_a_group(results):
    """The ranks send the same collectives, the single process none."""
    ref, ranks = results
    assert ref["calls"] == 0 and mesh.active() is None
    assert ranks[0]["train"]["collectives"] == ranks[1]["train"]["collectives"] > 0


@pytest.mark.parametrize("kind", ["sparse", "dense", "single", "empty"])
def test_pixel_draw_is_the_inverse_cdf(kind):
    """The index drawn from u is the floor(u * count)-th non-zero pixel in
    row-major order; a tile with an empty mask draws floor(u * H * W)."""
    rng = np.random.default_rng(["sparse", "dense", "single", "empty"].index(kind))
    b, h, w = 64, 12, 20
    p = {"sparse": 0.03, "dense": 0.6, "single": 0.0, "empty": 0.0}[kind]
    masks = (rng.random((b, h, w)) < p).astype(np.uint8) * rng.integers(1, 5, (b, h, w),
                                                                         dtype=np.uint8)
    if kind == "single":
        masks[np.arange(b), rng.integers(0, h, b), rng.integers(0, w, b)] = 1
    u = rng.random(b).astype(np.float32)
    u[:2] = [0.0, np.nextafter(np.float32(1.0), np.float32(0.0))]
    ys, xs = sample_nonzero_pixel(torch.from_numpy(masks), torch.from_numpy(u))
    for i in range(b):
        nz = np.flatnonzero(masks[i].reshape(-1))
        if not nz.size:
            nz = np.arange(h * w)
        k = int(np.floor(np.float64(u[i]) * nz.size))
        assert (int(ys[i]), int(xs[i])) == divmod(int(nz[k]), w), i
