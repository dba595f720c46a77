"""Shared by the port's parity tests of the ResNeSt encoders and the damage
models: flax variables for a JAX model with BN statistics and affines drawn
from a numpy seed (or a port model and its variables at once), random
inputs of either task, and a port model loaded from the variables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xview2_tpu.config import Config as JaxConfig
from xview2_tpu.models.layers import fused_tail_scope as jax_fused_tail_scope
from xview2_tpu.models.unet import build_model as jax_build_model
from xview2_tpu.models.unet import emits_packed_loss_view, fused_head_defer_ok
from xview2_tpu.ops.layout import relayout_standard as jax_relayout
from xview2_tpu.ops.losses import make_loss_fn as jax_make_loss_fn
from xview2_tpu.ops.losses import packed_loss_view_labels as jax_packed_labels
from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.weights import from_flax, to_flax

_CORAL_BIAS = np.array([1.0, 0.0, -1.0])  # the CORAL head's initial ordinal bias


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while a module that imports this
    runs: the same results, and under pytest-xdist torch's spinning OpenMP
    workers no longer crowd out the other workers (beside busy processes
    the damage CLI test ran several times faster on one thread than on
    torch's default threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_variables(cfg_kw, seed=0, dtype=np.float32, kernel_scale=2.2):
    """Flax variables for ``build_model(JaxConfig(**cfg_kw))``: the port
    model's initial state (torch's initializers, from ``seed``) through
    ``weights.to_flax`` (the trees are equal by name and shape,
    ``test_torch_resnest.py::test_parameter_trees_match_jax``; tracing the
    flax init would cost more than the test), with BN statistics and
    affines drawn from a numpy seed and conv kernels scaled by
    ``kernel_scale`` so activations stay O(1) through the network."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(Config(**dict(cfg_kw, precision=32)))
    params, stats = to_flax(model.state_dict())
    rng = np.random.default_rng(seed + 1)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['kernel']"):
            return (np.asarray(leaf, dtype) * kernel_scale).astype(dtype)
        draws = {"['scale']": lambda: rng.uniform(0.5, 1.5, leaf.shape),
                 "['bias']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['coral_bias']": lambda: _CORAL_BIAS + rng.normal(0, 0.1, leaf.shape),
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn().astype(dtype)
        return np.asarray(leaf, dtype)

    return jax.tree_util.tree_map_with_path(draw, {"params": params, "batch_stats": stats})


def seeded_model(cfg_kw, seed=0, kernel_scale=2.2):
    """The port model of ``cfg_kw`` (torch's initializers from ``seed``) with
    its conv kernels scaled by ``kernel_scale`` and its BN statistics and
    affines and the CORAL bias drawn from a numpy seed, as ``jax_variables``
    draws them, and the same values as flax variables: ``(model,
    variables)``.  One model is built, so this suits the variants whose
    cross-fusion convs hold hundreds of millions of parameters."""
    cfg = Config(**cfg_kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg)
    rng = np.random.default_rng(seed + 1)
    draws = {"weight": lambda n: rng.uniform(0.5, 1.5, n), "bias": lambda n: rng.normal(0, 0.1, n),
             "coral_bias": lambda n: _CORAL_BIAS + rng.normal(0, 0.1, n),
             "running_mean": lambda n: rng.normal(0, 0.1, n),
             "running_var": lambda n: rng.uniform(0.5, 2.0, n)}
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if t.dim() == 4:
                t.mul_(kernel_scale)
            else:
                t.copy_(torch.from_numpy(draws[name.rsplit(".", 1)[1]](t.shape)))
    if cfg.precision == 64:
        model = model.double()
    params, stats = to_flax(model.state_dict())
    return model, {"params": params, "batch_stats": stats}


def center_head(cfg_kw, variables, size=64, seed=0):
    """Shift the head bias by each class's median logit of the port model on
    a random probe, so that every class wins at some pixels."""
    model = port_model(cfg_kw, variables)
    rng = np.random.default_rng(seed)
    probe = torch.from_numpy(rng.normal(size=(2, size, size, Config(**cfg_kw).in_channels)))
    probe = probe.to(next(model.parameters()).dtype)
    with torch.inference_mode():
        logits = model(probe)
    median = logits.reshape(-1, logits.shape[-1]).median(dim=0).values.double().numpy()
    head = variables["params"]["output_block"]["output_block"]["conv"]
    head["bias"] = (head["bias"] - median).astype(head["bias"].dtype)
    return variables


def port_model(cfg_kw, variables):
    """The port's model of ``cfg_kw`` with the flax ``variables`` loaded."""
    cfg = Config(**cfg_kw)
    model = build_model(cfg)
    if cfg.precision == 64:
        model = model.double()
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model


def eval_batch(seed, channels, b=2, size=64):
    """uint8 images, labels and a validity vector whose last sample is
    padding; labels 0/1 for 3 channels, damage classes 0..4 and a patch of
    255 (un-classified) for 6."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, size, size, channels), np.uint8)
    if channels == 3:
        masks = (rng.random((b, size, size)) > 0.8).astype(np.uint8)
    else:
        masks = rng.integers(0, 5, (b, size, size)).astype(np.uint8)
        masks[0, :3, :5] = 255
    valid = np.ones((b,), np.float32)
    valid[-1] = 0.0
    return images, masks, valid


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def jax_train_grads(cfg_kw, variables, x, y, loss_strs):
    """JAX's train-mode forward, loss and gradient of one batch ``(x, y)``
    (the numerics core of ``make_train_step`` without the update), for each
    loss of ``loss_strs`` (all on the model of ``cfg_kw``): a list of
    ``(loss, flat gradients, flat new batch_stats)``.  One trace serves every
    loss: the traced loss is their sum weighted by a one-hot vector given at
    run time, which selects one loss and its gradient exactly."""
    cfg = JaxConfig(**dict(cfg_kw, loss_str=loss_strs[0]))
    model = jax_build_model(cfg)
    assert emits_packed_loss_view(cfg)
    loss_fns = [jax_make_loss_fn(s, cfg.type) for s in loss_strs]

    def forward_loss(p, bs, x, y_main, w):
        with jax_fused_tail_scope(bool(cfg.fused_tail), None,
                                  defer_head=fused_head_defer_ok(cfg)):
            outs, mutated = model.apply({"params": p, "batch_stats": bs}, x, True,
                                        mutable=["batch_stats"])
        logits = jax_relayout(outs)
        return sum(w[i] * fn(logits, y_main) for i, fn in enumerate(loss_fns)), \
            mutated["batch_stats"]

    @jax.jit
    def step(p, bs, x, y, w):
        y_main = jax_relayout(jax_packed_labels(y))
        (loss, new_bs), grads = jax.value_and_grad(forward_loss, has_aux=True)(p, bs, x,
                                                                               y_main, w)
        return loss, grads, new_bs

    p, bs = (jax.tree.map(jnp.asarray, variables[k]) for k in ("params", "batch_stats"))
    out = []
    for i in range(len(loss_strs)):
        loss, grads, new_bs = step(p, bs, jnp.asarray(x), jnp.asarray(y),
                                   jnp.eye(len(loss_strs), dtype=x.dtype)[i])
        out.append((float(loss), _flat(grads), _flat(new_bs)))
    return out
