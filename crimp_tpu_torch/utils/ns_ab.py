"""North-star A/B of two checkouts of the repository on one card, in turns.

    python -m crimp_tpu_torch.utils.ns_ab --parent DIR [--passes 5] [--scan] [--out FILE]

Run from the root of this checkout on a machine with a CUDA card and the
CUDA toolkit. It builds the kernels of this tree and of DIR (another
checkout, e.g. a ``git archive`` of the parent commit) in parallel, then
runs ``utils/surrogate.north_star`` (chip_smoke.py's phase 4: the 84 x
10 000-event surrogate, seed 7) in one process per turn: parent, this
tree, this tree, parent. Each turn makes one warm-up pass and ``--passes``
timed passes, and prints each pass's stage walls (ms, card synchronized).
``--scan`` times chip_smoke.py phase 6's monolithic north-star scan instead
(``search.z2_power_2d_grid``, 2500 nu x 40 nudot, split 2^18), inside an obs
run as the smoke runs it. The last line is the JSON record of all turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r"""
import json, sys
sys.path.insert(0, ".")
from crimp_tpu_torch.utils import surrogate
PAR, TPL = "tests/data/1e2259.par", "tests/data/1e2259_template.txt"
times, intervals = surrogate.build_surrogate(PAR, "tests/data/timIntToAs_1e2259.txt", TPL,
                                             events_per_toa=10000, seed=7)
surrogate.north_star(PAR, TPL, times, intervals, device="cuda")
passes = [surrogate.north_star(PAR, TPL, times, intervals, device="cuda")["stages"] for _ in range({n})]
print(json.dumps([{{k: v * 1e3 for k, v in p.items()}} for p in passes]))
"""

_SCAN = r"""
import json, os, sys, tempfile, time
sys.path.insert(0, ".")
import numpy as np, torch
os.environ.update({{"CRIMP_TORCH_OBS": "1", "CRIMP_TORCH_OBS_DIR": tempfile.mkdtemp(), "CRIMP_TORCH_OBS_COST": "0"}})
from crimp_tpu_torch import obs
from crimp_tpu_torch.ops import search
from crimp_tpu_torch.utils import surrogate
times, _ = surrogate.build_surrogate("tests/data/1e2259.par", "tests/data/timIntToAs_1e2259.txt",
                                     "tests/data/1e2259_template.txt", events_per_toa=10000, seed=7)
sec = (times - times.mean()) * 86400.0
cen = sec - (sec[0] + sec[-1]) / 2
f0, df = search.uniform_grid(np.linspace(0.1430, 0.1436, 2500))
fd = -(10.0 ** np.linspace(-14.5, -13.5, 40))

def scan():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search.z2_power_2d_grid(cen, f0, df, 2500, fd, 2, device="cuda", per_split=1 << 18)
    torch.cuda.synchronize()
    return time.perf_counter() - t0

scan()
with obs.run("ns_ab_scan"):
    passes = [{{"total": scan() * 1e3}} for _ in range({n})]
print(json.dumps(passes))
"""

_BUILD = "import sys; sys.path.insert(0, '.'); from crimp_tpu_torch.ops import z2_grid; z2_grid.build()"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="root of the other checkout")
    parser.add_argument("--passes", type=int, default=5)
    parser.add_argument("--scan", action="store_true", help="time phase 6's monolithic scan instead")
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    args = parser.parse_args(argv)
    trees = {"parent": os.path.abspath(args.parent), "change": os.getcwd()}
    builds = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=root) for root in trees.values()]
    if any([p.wait() != 0 for p in builds]):  # wait for every build before judging
        print("ns_ab: a kernel build failed", file=sys.stderr)
        return 1
    record = {"passes": args.passes, "what": "scan" if args.scan else "north_star", "turns": []}
    turn = _SCAN if args.scan else _TURN
    for name in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", turn.format(n=args.passes)], cwd=trees[name],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"ns_ab: the {name} turn failed:\n{proc.stderr[-4000:]}", file=sys.stderr)
            return 1
        passes = json.loads(proc.stdout.strip().splitlines()[-1])
        record["turns"].append({"tree": name, "passes": passes})
        totals = ", ".join(f"{p['total']:.2f}" for p in passes)
        fits = "" if args.scan else "; fit ms " + ", ".join(f"{p['fit']:.2f}" for p in passes)
        print(f"{name}: total ms {totals}{fits}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
