"""CLI entry point: ``python -m xview2_tpu_torch.main --exec_mode eval ...``

The flag surface is the JAX package's (``config.py``).  This slice of the
port runs eval mode on the card; train mode is the next slice.
"""

from __future__ import annotations

import sys

from xview2_tpu_torch.config import parse_args


def main(argv=None, device="cuda") -> int:
    cfg = parse_args(argv)
    if cfg.exec_mode == "train":
        raise NotImplementedError("--exec_mode train is not ported to xview2_tpu_torch yet "
                                  "(ROADMAP Queue 1, train step)")
    from xview2_tpu_torch.train import trainer  # heavy imports after arg parsing

    metrics = trainer.test(cfg, device=device)
    print(f"test metrics: {metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
