"""CLI entry point: ``python -m xview2_tpu_torch.main --exec_mode {train,eval} ...``

The flag surface is the JAX package's (``config.py``).  Both modes run on
the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import sys

from xview2_tpu_torch.config import parse_args


def main(argv=None, device="cuda") -> int:
    cfg = parse_args(argv)
    from xview2_tpu_torch.train import trainer  # heavy imports after arg parsing

    if cfg.exec_mode == "train":
        best = trainer.fit(cfg, device=device)
        print(f"best checkpoint: {best}")
        return 0
    metrics = trainer.test(cfg, device=device)
    print(f"test metrics: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
