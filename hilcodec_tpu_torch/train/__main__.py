"""Training CLI, the port's `train.py`:

    python -m hilcodec_tpu_torch.train -n NAME -c CONFIG [-p a.b=v ...]
        [-f] [-b BASE_DIR] [--device D]

Trains on the CUDA card unless `--device` names another device; without a
card and without `--device` it refuses to start. The run directory is
BASE_DIR/NAME (default logs/NAME); it resumes from the newest
`{epoch:05d}.ckpt.npz` there.

Data-parallel training over N cards of one host, one process a card:

    python -m torch.distributed.run --nproc_per_node N \
        -m hilcodec_tpu_torch.train -n NAME -c CONFIG ...

Each process joins the group torchrun describes (`parallel/dist.
init_from_env`: NCCL on `cuda:LOCAL_RANK`, gloo with `--device cpu`);
`train.batch_size` is per process. Rank 0 writes the config copy, the
summaries and the checkpoints.
"""

import os
import sys

import torch.distributed as dist

from ..parallel import dist as D
from ..utils.hparams import get_hparams
from .loop import TrainLoop


def main(argv=None) -> int:
    torchrun = D.launched_by_torchrun()
    hps, ns = get_hparams(argv, write_snapshot=not torchrun
                          or os.environ["RANK"] == "0")
    device = D.init_from_env(ns.device) if torchrun else ns.device
    try:
        loop = TrainLoop(hps, run_dir=hps.model_dir, device=device)
        loop.init_or_resume()
        loop.run()
    finally:
        if torchrun and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
