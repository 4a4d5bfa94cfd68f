"""Write one cell's input file for a seed, in a process of its own.

    python3 perfbench/write_input.py --repo <checkout> --workload <cell> \
        --seed <n> --device <cuda:0|cpu> --out <path>

``run.py``'s driver starts it when the file is not there yet, so the
process that is timed never does this work.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name in ("--repo", "--workload", "--seed", "--device", "--out"):
        ap.add_argument(name, required=True)
    args = ap.parse_args(argv)
    for p in (str(PERFBENCH.parent), str(PERFBENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchlib import spec

    cell = spec.load_cell(args.workload, repo=Path(args.repo))
    cell.driver().write_dng(cell, int(args.seed), torch.device(args.device), Path(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
