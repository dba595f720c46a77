"""Typed configuration for the PyTorch/CUDA port.

A copy of ``xview2_tpu/config.py``: the same fields, defaults, CLI and
validation, so checkpoints and launch scripts carry over unchanged.  The
only difference is :attr:`Config.compute_dtype`, which maps to torch dtypes,
and :func:`apply_precision`, which turns TF32 off for ``--precision 32``
(cuDNN convolutions run in TF32 by default on the card).

Everything downstream reads a frozen :class:`Config`; nothing reads argparse
namespaces directly.
"""

from __future__ import annotations

import dataclasses
import json
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from typing import Optional, Tuple

EXEC_MODES = ("train", "eval")
TASK_TYPES = ("pre", "post")
OPTIMIZERS = ("sgd", "adam", "adamw", "radam", "adabelief", "adabound", "adamp", "novograd")
DMG_MODELS = ("siamese", "siameseEnc", "fused", "fusedEnc", "parallel", "parallelEnc", "diff", "cat")
ENCODERS = ("resnest50", "resnest101", "resnest200", "resnest269", "resnet50", "resnet101", "resnet152")
LOSS_TERMS = ("dice", "focal", "ce", "ohem", "mse", "coral")
DILATIONS = (1, 2, 4)
PRECISIONS = (16, 32)


@dataclasses.dataclass(frozen=True)
class Config:
    """Frozen run configuration.

    Field names/defaults/choices track the reference CLI one-to-one so that
    checkpoints and launch scripts translate directly.  ``gpus`` is kept for
    CLI compatibility and means "number of devices on the data mesh axis".
    """

    # --- infra flags (reference main.py:29-53) ---
    exec_mode: str = "train"
    data: str = "/data"
    results: str = "/results"
    gpus: int = 1
    num_workers: int = 8
    batch_size: int = 16
    val_batch_size: int = 13
    precision: int = 16  # 16 -> bf16 compute, 32 -> fp32 (TF32 off, see apply_precision)
    epochs: int = 250
    patience: int = 100
    ckpt: Optional[str] = None
    logname: str = "logs"
    ckpt_pre: Optional[str] = None
    type: str = "pre"
    seed: int = 1

    # --- model flags (reference model/plt.py:181-234) ---
    optimizer: str = "adamw"
    dmg_model: str = "siamese"
    encoder: str = "resnest200"
    loss_str: str = "focal+dice"
    use_scheduler: bool = False
    warmup: int = 1
    init_lr: float = 1e-4
    final_lr: float = 1e-4
    lr: float = 3e-4
    weight_decay: float = 0.0
    momentum: float = 0.9
    dilation: int = 1
    tta: bool = False
    ppm: bool = False
    aspp: bool = False
    no_skip: bool = False
    deep_supervision: bool = False
    attention: bool = False
    autoaugment: bool = False
    interpolate: bool = False
    dec_interp: bool = False

    # --- extensions of the JAX package (not present in the reference) ---
    profile: bool = False  # torch.profiler trace of the first 6 train steps under --results/profile
    index_csv: Optional[str] = None  # train index.csv; None -> auto-generated under --results on first train
    exclude: Optional[str] = None  # JSON list of excluded train indices; None -> bundled reference list on xBD-shaped trees
    train_crop: int = 512  # train crop size (reference pytorch_loader.py:57)
    spatial_shards: int = 1  # shard image height over a 2nd mesh axis (GSPMD halo exchange)
    pretrained_enc: Optional[str] = None  # .npz from tools/convert_weights.py (reference bakes pretrained=True, unet.py:45)
    raw_cache: Optional[str] = None  # dir for decoded raw-tile cache (skips PNG inflate after epoch 1)
    bgr: bool = False  # feed BGR pixels like the reference's cv2.imread (parity runs); default RGB
    fold_eval_bn: bool = True  # eval-mode BN as a single folded affine (mathematically identical; see layers.fold_eval_bn_scope)
    eval_tta: str = "auto"  # eval-mode TTA override: auto = checkpoint's --tta (reference Model.load_from_checkpoint behavior), on/off = force
    fused_tail: bool = False  # decoder tail via the fused conv+BN CUDA kernels (ops/packed_fused_conv.py)
    einsum_1x1: bool = False  # lower 1x1 convs to einsum dots (fusable HLO; see layers.Conv1x1)
    eval_fused_tail: str = "auto"  # eval-mode fused-tail override: auto = checkpoint's --fused_tail, on/off = force (identical variable trees)
    eval_einsum_1x1: str = "auto"  # eval-mode einsum-1x1 override: auto = checkpoint's --einsum_1x1, on/off = force
    remat: str = "none"  # train-step rematerialization: none/tail/dots/full (for geometries that exceed HBM; numerics-identical)

    def __post_init__(self):
        if self.exec_mode not in EXEC_MODES:
            raise ValueError(f"exec_mode must be one of {EXEC_MODES}, got {self.exec_mode!r}")
        for knob in ("eval_tta", "eval_fused_tail", "eval_einsum_1x1"):
            if getattr(self, knob) not in ("auto", "on", "off"):
                raise ValueError(f"{knob} must be auto/on/off, got {getattr(self, knob)!r}")
        if self.remat not in ("none", "tail", "dots", "full"):
            raise ValueError(f"remat must be none/tail/dots/full, got {self.remat!r}")
        if self.type not in TASK_TYPES:
            raise ValueError(f"type must be one of {TASK_TYPES}, got {self.type!r}")
        if self.optimizer.lower() not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {self.optimizer!r}")
        if self.dmg_model not in DMG_MODELS:
            raise ValueError(f"dmg_model must be one of {DMG_MODELS}, got {self.dmg_model!r}")
        if self.encoder not in ENCODERS:
            raise ValueError(f"encoder must be one of {ENCODERS}, got {self.encoder!r}")
        if self.dilation not in DILATIONS:
            raise ValueError(f"dilation must be one of {DILATIONS}, got {self.dilation}")
        # 64 is a test-only numerics instrument (parity below the fp32 noise
        # floor) — valid on Config but not on the CLI,
        # whose choices stay the reference's {16, 32} (main.py:34).
        if self.precision not in PRECISIONS + (64,):
            raise ValueError(f"precision must be one of {PRECISIONS}, got {self.precision}")
        for term in self.loss_terms:
            if term not in LOSS_TERMS:
                raise ValueError(f"unknown loss term {term!r}; valid: {LOSS_TERMS}")
        if self.spatial_shards < 1 or self.gpus % self.spatial_shards:
            raise ValueError(
                f"spatial_shards ({self.spatial_shards}) must divide gpus ({self.gpus})")
        # Derived rule from reference main.py:57-59.
        if self.interpolate and (self.deep_supervision or self.dec_interp):
            object.__setattr__(self, "deep_supervision", False)
            object.__setattr__(self, "dec_interp", False)

    # --- derived properties ---
    @property
    def loss_terms(self) -> Tuple[str, ...]:
        return tuple(self.loss_str.split("+"))

    @property
    def n_class(self) -> int:
        """Output channels of the network head.

        Reference ``model/unet.py:21-26`` (damage) and ``UNetLoc`` default
        ``n_class=2`` (``model/unet.py:200``).
        """
        if self.type == "pre":
            return 2
        if self.loss_str == "mse":
            return 1
        if self.loss_str == "coral":
            return 3
        return 4

    @property
    def n_metric_class(self) -> int:
        """Classes seen by the F1 metric (reference utils/f1.py:21)."""
        return 2 if self.type == "pre" else 5

    @property
    def in_channels(self) -> int:
        """Network input channels: 3 for localization, 6 for pre/post pair."""
        return 3 if self.type == "pre" else 6

    @property
    def compute_dtype(self):
        import torch

        if self.precision == 16:
            return torch.bfloat16
        return torch.float64 if self.precision == 64 else torch.float32

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "Config":
        return cls(**json.loads(payload))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def apply_precision(cfg: Config) -> None:
    """Keep ``--precision 32`` full float32 on the card: cuDNN convolutions
    default to TF32 (about three decimal digits), which would silently turn
    an fp32 run into a reduced-precision one."""
    if cfg.precision != 16:
        import torch

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def build_parser() -> ArgumentParser:
    """Argparse surface identical to the reference CLI."""
    parser = ArgumentParser(formatter_class=ArgumentDefaultsHelpFormatter)
    arg = parser.add_argument
    # infra (reference main.py:29-53)
    arg("--exec_mode", type=str, choices=list(EXEC_MODES), default="train", help="Execution mode of main script")
    arg("--data", type=str, default="/data", help="Path to the data directory")
    arg("--results", type=str, default="/results", help="Path to the results directory")
    arg("--gpus", type=int, default=1, help="Number of devices on the data-parallel mesh axis")
    arg("--num_workers", type=int, default=8, help="Number of host threads for data loading")
    arg("--batch_size", type=int, default=16, help="Training batch size (global)")
    arg("--val_batch_size", type=int, default=13, help="Evaluation batch size (global)")
    arg("--precision", type=int, default=16, choices=list(PRECISIONS), help="16 = bf16 compute, 32 = fp32")
    arg("--epochs", type=int, default=250, help="Max number of epochs")
    arg("--patience", type=int, default=100, help="Early stopping patience")
    arg("--ckpt", type=str, default=None, help="Path to pretrained checkpoint")
    arg("--logname", type=str, default="logs", help="Name of logging file")
    arg("--ckpt_pre", type=str, default=None,
        help="Path to pretrained checkpoint of localization model used to initialize network for damage assessment")
    arg("--type", type=str, choices=list(TASK_TYPES),
        help="Type of task to run; pre - localization, post - damage assessment")
    arg("--seed", type=int, default=1)
    # model (reference model/plt.py:181-234)
    arg("--optimizer", type=str, default="adamw", choices=list(OPTIMIZERS))
    arg("--dmg_model", type=str, default="siamese", choices=list(DMG_MODELS),
        help="U-Net variant for damage assessment task")
    arg("--encoder", type=str, default="resnest200", choices=list(ENCODERS), help="U-Net encoder")
    arg("--loss_str", type=str, default="focal+dice",
        help="Combination of: dice, focal, ce, ohem, mse, coral, e.g focal+dice creates the loss function as sum of focal and dice")
    arg("--use_scheduler", action="store_true", help="Enable Noam learning rate scheduler")
    arg("--warmup", type=int, default=1, help="Warmup epochs for Noam learning rate scheduler")
    arg("--init_lr", type=float, default=1e-4, help="Initial learning rate for Noam scheduler")
    arg("--final_lr", type=float, default=1e-4, help="Final learning rate for Noam scheduler")
    arg("--lr", type=float, default=3e-4, help="Learning rate, or a target learning rate for Noam scheduler")
    arg("--weight_decay", type=float, default=0, help="Weight decay (L2 penalty)")
    arg("--momentum", type=float, default=0.9, help="Momentum for SGD optimizer")
    arg("--dilation", type=int, choices=list(DILATIONS), default=1,
        help="Dilation rate for the encoder, e.g dilation=2 uses dilation instead of stride in the last encoder block")
    arg("--tta", action="store_true", help="Enable test time augmentation")
    arg("--ppm", action="store_true", help="Use pyramid pooling module")
    arg("--aspp", action="store_true", help="Use atrous spatial pyramid pooling")
    arg("--no_skip", action="store_true", help="Disable skip connections in UNet")
    arg("--deep_supervision", action="store_true", help="Enable deep supervision")
    arg("--attention", action="store_true", help="Enable attention module at the decoder")
    arg("--autoaugment", action="store_true", help="Use imageNet autoaugment pipeline")
    arg("--interpolate", action="store_true", help="Interpolate feature map from encoder without a decoder")
    arg("--dec_interp", action="store_true", help="Use interpolation instead of transposed convolution in a decoder")
    # extensions of the JAX package
    arg("--profile", action="store_true", help="Capture a profiler trace of the first training steps")
    arg("--index_csv", type=str, default=None,
        help="Path to train index.csv; if absent it is generated once under --results (data/index.py)")
    arg("--exclude", type=str, default=None,
        help="JSON list of train indices to exclude from index generation; "
             "default: the reference exclude list on xBD-shaped trees (utils/exclude.txt)")
    arg("--train_crop", type=int, default=512, help="Training crop size")
    arg("--spatial_shards", type=int, default=1,
        help="Shard image height over a second mesh axis (conv halo exchange via GSPMD)")
    arg("--pretrained_enc", type=str, default=None,
        help="Converted ImageNet encoder weights (.npz from tools/convert_weights.py)")
    arg("--raw_cache", type=str, default=None,
        help="Directory for a decoded raw-tile cache (epochs after the first skip PNG decode)")
    arg("--bgr", action="store_true",
        help="Feed BGR channel order as the reference does (cv2.imread); default is RGB")
    arg("--fold_eval_bn", type=int, default=1, choices=[0, 1],
        help="Fold eval-mode BatchNorm into a single fused affine (mathematically identical)")
    arg("--eval_tta", type=str, default="auto", choices=["auto", "on", "off"],
        help="Eval-mode TTA: auto follows the checkpoint's --tta; on/off force it")
    arg("--fused_tail", type=int, default=0, choices=[0, 1],
        help="Run the decoder tail through the fused conv+BN kernels")
    arg("--einsum_1x1", type=int, default=0, choices=[0, 1],
        help="Lower 1x1 convs to einsum dots so BN/act epilogues can fuse")
    arg("--eval_fused_tail", type=str, default="auto", choices=["auto", "on", "off"],
        help="Eval-mode fused-tail chain: auto follows the checkpoint's --fused_tail; "
             "on/off force it (compute-path knob; the variable tree is identical)")
    arg("--eval_einsum_1x1", type=str, default="auto", choices=["auto", "on", "off"],
        help="Eval-mode einsum-1x1 lowering: auto follows the checkpoint's "
             "--einsum_1x1; on/off force it (compute-path knob)")
    arg("--remat", type=str, default="none", choices=["none", "tail", "dots", "full"],
        help="Rematerialize the forward in the train-step backward (numerics-"
             "identical; trades recompute FLOPs for HBM). Use when a config's "
             "geometry exceeds HBM — measured slower when activations fit "
             "(BASELINE.md remat rows)")
    return parser


def parse_args(argv=None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**vars(ns))
