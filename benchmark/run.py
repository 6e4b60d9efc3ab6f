"""Entry point: `python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (see `harness.py`)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402


def main() -> None:
    from benchmark import harness
    sys.exit(harness.main(None, T_START))


if __name__ == "__main__":
    main()
