"""Training CLI, the port's `train.py`:

    python -m hilcodec_tpu_torch.train -n NAME -c CONFIG [-p a.b=v ...]
        [-f] [-b BASE_DIR] [--device D]

Trains on the CUDA card unless `--device` names another device; without a
card and without `--device` it refuses to start. The run directory is
BASE_DIR/NAME (default logs/NAME); it resumes from the newest
`{epoch:05d}.ckpt.npz` there.
"""

import sys

from ..utils.hparams import get_hparams
from .loop import TrainLoop


def main(argv=None) -> int:
    hps, ns = get_hparams(argv)
    loop = TrainLoop(hps, run_dir=hps.model_dir, device=ns.device)
    loop.init_or_resume()
    loop.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
