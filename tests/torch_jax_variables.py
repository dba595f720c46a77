"""Shared by the port's parity tests of the ResNeSt encoders and the Siamese
damage model: flax variables for a JAX model with BN statistics and affines
drawn from a numpy seed, random inputs of either task, and a port model
loaded from the variables."""

import jax
import numpy as np
import torch

from xview2_tpu_torch.config import Config
from xview2_tpu_torch.models.unet import build_model
from xview2_tpu_torch.weights import from_flax, to_flax


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
                 "['mean']": lambda: rng.normal(0, 0.1, leaf.shape),
                 "['var']": lambda: rng.uniform(0.5, 2.0, leaf.shape)}
        for suffix, fn in draws.items():
            if key.endswith(suffix):
                return fn().astype(dtype)
        return np.asarray(leaf, dtype)

    return jax.tree_util.tree_map_with_path(draw, {"params": params, "batch_stats": stats})


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
