"""Checkpoint GC: delete all but the newest checkpoint of every run
directory under BASE_DIR (the port's `clean_checkpoint.py`).

Usage: ``python -m hilcodec_tpu_torch.clean_checkpoint [base_dir]
[--dry-run]``; prints each path removed (or that would be) and the bytes
freed.
"""

import argparse

from .utils.checkpoint import clean_checkpoints


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m hilcodec_tpu_torch.clean_checkpoint")
    p.add_argument("base_dir", nargs="?", default="logs")
    p.add_argument("--dry-run", action="store_true")
    ns = p.parse_args(argv)
    removed = clean_checkpoints(ns.base_dir, dry_run=ns.dry_run)
    total = 0
    for path, size in removed:
        print(("would remove " if ns.dry_run else "removed ") + path)
        total += size
    print(f"freed {total / 1e6:.1f} MB" + (" (dry run)" if ns.dry_run else ""))


if __name__ == "__main__":
    main()
