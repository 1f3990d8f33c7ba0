"""The driver the A / B comparison tools share: each OTHER checkout (A)
against this one (B), one process a run, in the order A, B, B, A,
`--rounds N` times over (default 1), then the card's name and power
limit.  A tool gives its per-run function, which takes a checkout's
root, prints its JSON line and returns an exit code:

    python3 tools/<tool>.py [--rounds N] OTHER [OTHER ...]
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(tool, one_run, argv=None):
    """Run `tool`'s comparison; `tool --one ROOT` is one run."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) > 1 and argv[0] == "--one":
        return one_run(argv[1])
    rounds = 1
    if argv[:1] == ["--rounds"] and len(argv) > 1:
        rounds, argv = int(argv[1]), argv[2:]
    import torch
    if not argv or not torch.cuda.is_available():
        print(f"{Path(tool).stem}: needs a CUDA device and one or more "
              f"other checkouts", file=sys.stderr)
        return 2
    rc = 0
    for other in argv:
        for _ in range(rounds):
            for root in (other, ROOT, ROOT, other):
                rc |= subprocess.call([sys.executable, tool, "--one",
                                       str(Path(root).resolve())])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return rc
