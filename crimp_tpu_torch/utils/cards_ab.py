"""The north-star 2-D scan spread over the cards of one host, against one card.

    python -m crimp_tpu_torch.utils.cards_ab [--turns 3] [--out FILE]

Run from the root of a checkout on a machine with two or more CUDA cards
(up to four are used) and the CUDA toolkit. On chip_smoke.py's north-star
surrogate (phase 4: 84 x 10 000 events, seed 7) and its 2500 nu x 40 nudot
grid (nharm 2, polynomial sin/cos) it times, in turns, the monolithic scan
on cuda:0 (``search.z2_power_2d_grid``) and the sharded scan
(``parallel.mesh.z2_2d_sharded``) on an N x 1 and, with four cards, a 2 x 2
(events x trials) mesh, each once over distinct cards and once over N
shards of cuda:0. A call runs from its host inputs to its result on the
host, every card synchronized before and after; the times are host wall
times, since a call spans cards. Each layout over distinct cards must give
the bits of the same layout on one card, every layout must launch K2 once
a shard, and every sharded result must lie within K2's twin tolerance of
the monolithic one (rtol 2e-3 / atol 0.05, same argmax). Prints the card's
name and power limit, one line per layout and, as the last line, the JSON
record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

PAR, TPL = "tests/data/1e2259.par", "tests/data/1e2259_template.txt"
INTERVALS = "tests/data/timIntToAs_1e2259.txt"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=3)
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    args = parser.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("cards_ab needs two or more CUDA cards", file=sys.stderr)
        return 2
    from crimp_tpu_torch.ops import search, z2_grid
    from crimp_tpu_torch.parallel import mesh as pmesh
    from crimp_tpu_torch.utils import surrogate

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()
    n_cards = min(4, torch.cuda.device_count())
    cards = [f"cuda:{i}" for i in range(n_cards)]
    times, _ = surrogate.build_surrogate(PAR, INTERVALS, TPL, events_per_toa=10000, seed=7)
    sec = (times - times.mean()) * 86400.0
    cen = sec - (sec[0] + sec[-1]) / 2
    freqs = np.linspace(0.1430, 0.1436, 2500)
    fd = -(10.0 ** np.linspace(-14.5, -13.5, 40))
    f0, df = search.uniform_grid(freqs)

    shapes = {f"{n_cards}x1": n_cards} | ({"2x2": 2} if n_cards == 4 else {})
    calls = {"monolithic": lambda: search.z2_power_2d_grid(cen, f0, df, freqs.size, fd, 2, poly=True,
                                                           device="cuda:0").cpu().numpy()}
    for name, ev in shapes.items():
        for where, devices in (("cards", cards), ("one card", ["cuda:0"] * n_cards)):
            mesh = pmesh.build_mesh(devices, event_parallel=ev)
            calls[f"{name} {where}"] = lambda mesh=mesh: pmesh.z2_2d_sharded(cen, freqs, fd, 2, mesh, poly=True)

    def sync():
        for c in cards:
            torch.cuda.synchronize(c)

    def timed(fn):
        sync()
        z2_grid.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out, z2_grid.LAUNCHES["z2_tile_sums"]

    results = {name: timed(fn)[1:] for name, fn in calls.items()}  # warm-up, and the results held
    walls = {name: [] for name in calls}
    order = list(calls)
    for turn in range(args.turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            walls[name].append(timed(calls[name])[0])
    mono = results["monolithic"][0]
    record = {"card": card, "cards": n_cards, "events": int(cen.size), "turns": args.turns, "layouts": {}}
    ok = True
    for name, (out, launches) in results.items():
        row = {"ms": walls[name], "mean_ms": float(np.mean(walls[name])), "k2_launches": launches}
        if name != "monolithic":
            row["max_abs_dz2_vs_monolithic"] = float(np.max(np.abs(out - mono)))
            row["within_twin_tolerance"] = bool(np.allclose(out, mono, rtol=2e-3, atol=0.05)
                                                and np.argmax(out) == np.argmax(mono))
            row["launches_ok"] = launches == n_cards
            ok &= row["within_twin_tolerance"] and row["launches_ok"]
            if name.endswith(" cards"):
                row["bitwise_one_card"] = bool(np.array_equal(out, results[name.replace("cards", "one card")][0]))
                ok &= row["bitwise_one_card"]
        record["layouts"][name] = row
    for line in card:
        print(line)
    base = record["layouts"]["monolithic"]["mean_ms"]
    for name, row in record["layouts"].items():
        checks = {k: v for k, v in row.items() if k not in ("ms", "mean_ms")}
        print(f"{name}: {row['mean_ms']:.3f} ms (host wall, mean of {args.turns} in turns), "
              f"{row['mean_ms'] / base:.3f}x the monolithic; {checks}", flush=True)
    record["ok"] = bool(ok)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
