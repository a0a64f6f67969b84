"""The readings a cell's limits are set from: the program and the control.

    python3 portbench/study.py --workload ns_1e2259.campaign --seeds 12 --first-seed 1000 \
        --out chiprun_out/study.json

For each seed, at the cell's own size, in one process: one event set drawn
from the seed, one unit of the program (after one warm-up unit on the
first seed), the plain reference in float64, and the control: the same
reference one precision step below what the configuration states (the
ToA fit in float32, each Z^2 and H-test cos and sin rounded to bfloat16
and summed in float32). Prints, and writes to ``--out``, every number the
cell's driver compares, for the program and for the control, seed by
seed. The benchmark's own runs never run the control.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import harness  # noqa: E402

CONTROL = {"fit_dtype": torch.float32, "z2_dtype": torch.bfloat16}


def study(workload: str, seeds: list[int], device="cuda", config=None, mix=None) -> list[dict]:
    _, config_file, mix_file = harness.cell_files(workload)
    config = config_file if config is None else config
    mix = dict(mix_file if mix is None else mix, event_sets=1)
    module = harness.load_module(harness.HERE / "drivers" / f"{mix['driver']}.py")
    rows = []
    for n, seed in enumerate(seeds):
        driver = module.make(config, mix, seed, device)
        driver.draw()
        if n == 0:
            driver.unit(0)
        rec = driver.unit(0)
        t0 = time.perf_counter()
        ref = driver.reference(0, rec.get("z2_idx"))
        ref_s = time.perf_counter() - t0
        ctrl = driver.reference(0, rec.get("z2_idx"), **CONTROL)
        rows.append({"seed": seed, "program": driver.gaps(rec, ref), "control": driver.gaps(ctrl, ref),
                     "unit_s": rec["seconds"], "reference_s": ref_s})
        print(json.dumps(rows[-1]), file=sys.stderr)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=1000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    rows = study(args.workload, [args.first_seed + i for i in range(args.seeds)])
    names = sorted(rows[0]["program"])
    summary = {name: {"program_max": max(r["program"][name] for r in rows),
                      "control_min": min(r["control"][name] for r in rows)} for name in names}
    out = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "rows": rows, "summary": summary}
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
