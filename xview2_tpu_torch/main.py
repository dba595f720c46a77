"""CLI entry point: ``python -m xview2_tpu_torch.main --exec_mode {train,eval} ...``

The flag surface is the JAX package's (``config.py``).  Both modes run on
the card unless the caller passes ``device="cpu"``.

``--gpus N`` runs one process per GPU (``parallel/mesh.py``), the
counterpart of JAX's ``data`` mesh and of its multi-host
``_maybe_init_distributed``:

- under ``torchrun`` (``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` in the
  environment) this process joins the group by ``env://``, on NCCL with
  ``cuda:LOCAL_RANK`` (gloo on the CPU); ``WORLD_SIZE`` must equal
  ``--gpus``, and the hosts may be several;
- without a launcher and with ``N > 1`` it spawns N local ranks itself
  (start method ``spawn``) over a TCP store it holds on ``127.0.0.1``, so
  ``python -m xview2_tpu_torch.main --gpus 8 ...`` works as the JAX CLI's
  line does;
- with ``--gpus 1`` and no launcher no group is made and no collective
  runs.
"""

from __future__ import annotations

import os
import sys

from xview2_tpu_torch.config import parse_args

LAUNCHER_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK")


def _run(cfg, device) -> int:
    from xview2_tpu_torch.parallel import mesh
    from xview2_tpu_torch.train import trainer

    if cfg.exec_mode == "train":
        best = trainer.fit(cfg, device=device)
        if mesh.is_main():
            print(f"best checkpoint: {best}")
        return 0
    metrics = trainer.test(cfg, device=device)
    if mesh.is_main():
        print(f"test metrics: {metrics}")
    return 0


def _rank_device(device, local_rank: int):
    import torch

    return torch.device(f"cuda:{local_rank}") if torch.device(device).type == "cuda" else \
        torch.device("cpu")


def _backend(dev) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def _spawned_rank(local_rank: int, argv, device, world: int, port: int, threads: int) -> None:
    """One rank of a job ``main`` spawned: join the group over the parent's
    store, run, leave.  On the CPU each rank takes its share of the
    parent's ``threads``."""
    import torch
    import torch.distributed as dist

    from xview2_tpu_torch.parallel import mesh

    dev = _rank_device(device, local_rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, threads // world))
    store = dist.TCPStore("127.0.0.1", port, world_size=world + 1, is_master=False,
                          timeout=mesh.TIMEOUT)
    mesh.init_data_parallel(world, local_rank, backend=_backend(dev), device=dev, store=store)
    try:
        _run(parse_args(argv), dev)
    finally:
        mesh.shutdown()


def _spawn(argv, device, world: int) -> int:
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from xview2_tpu_torch.parallel import mesh

    store = dist.TCPStore("127.0.0.1", 0, world_size=world + 1, is_master=True,
                          timeout=mesh.TIMEOUT, wait_for_workers=False)
    mp.start_processes(_spawned_rank, nprocs=world, join=True, start_method="spawn",
                       args=(argv, device, world, store.port, torch.get_num_threads()))
    return 0


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_args(argv)
    import torch

    from xview2_tpu_torch.parallel import mesh
    from xview2_tpu_torch.parallel.steps import resolve_device
    from xview2_tpu_torch.train import trainer  # heavy imports after arg parsing

    resolve_device(device)
    trainer._check_supported(cfg)  # before any rank starts
    if all(k in os.environ for k in LAUNCHER_ENV):
        world = int(os.environ["WORLD_SIZE"])
        if world != cfg.gpus:
            raise ValueError(f"WORLD_SIZE={world} under the launcher but --gpus {cfg.gpus}")
        dev = _rank_device(device, int(os.environ["LOCAL_RANK"]))
        mesh.init_data_parallel(world, int(os.environ["RANK"]), backend=_backend(dev),
                                device=dev, init_method="env://")
        try:
            return _run(cfg, dev)
        finally:
            mesh.shutdown()
    if torch.device(device).type == "cuda" and cfg.gpus > torch.cuda.device_count():
        raise ValueError(f"--gpus {cfg.gpus} but this host has {torch.cuda.device_count()} "
                         "CUDA devices (several hosts run under torchrun)")
    if cfg.gpus > 1:
        return _spawn(argv, device, cfg.gpus)
    return _run(cfg, device)


if __name__ == "__main__":
    sys.exit(main())
