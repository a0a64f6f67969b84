"""What the drivers over seeded event sets share: inputs, set-up, the check."""

from __future__ import annotations

import gc
import pathlib

import numpy as np
import torch

from portbench import scan
from portbench.gen import events
from portbench.reference import timing


def scale(counts: dict, n: float) -> dict:
    return {"flops": counts["flops"] * n, "bytes": counts["bytes"] * n, "dtype": counts["dtype"]}


def total(parts: list) -> dict:
    return {"flops": sum(p["flops"] for p in parts), "bytes": sum(p["bytes"] for p in parts),
            "dtype": parts[0]["dtype"]}


def z2_gaps(got: dict, want: dict) -> dict:
    """Z^2 at the trials ``got`` carries against ``want``'s at the same
    trials: the widest gap (``z2_abs_gap``) and the relative gap at the
    last trial, the unit's highest row (``z2_peak_gap``). A gap relative to
    each trial's power does not separate K2's float32 sums from bfloat16
    trig (its worst trials are the strong ones, the control's the weak)."""
    lookup = dict(zip(np.asarray(want["z2_idx"]).tolist(), np.asarray(want["z2"]).tolist()))
    ref = np.array([lookup[i] for i in np.asarray(got["z2_idx"]).tolist()])
    diff = np.abs(np.asarray(got["z2"]) - ref)
    return {"z2_abs_gap": float(np.max(diff)), "z2_peak_gap": float(diff[-1] / ref[-1])}


class EventDriver:
    """Event sets drawn from the seed over a configuration's ToA intervals,
    taken in turn unit after unit; the check compares every unit's answers
    with the plain reference of its set."""

    unit_name = "unit"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        base = pathlib.Path(config["_dir"])
        self.paths = {key: str(base / config[key]) for key in ("par", "template", "intervals")}
        self.par = timing.read_par(self.paths["par"])
        self.template = timing.read_template(self.paths["template"])
        self.intervals = timing.read_table(self.paths["intervals"])
        self.scan = config["scan"]
        n_sets = int(mix["event_sets"])
        self.samples = [scan.check_indices(self.scan, self.seed, k, n_sets, int(mix["z2_sample"]),
                                           int(mix["z2_stride"]), int(mix["z2_edge_rows"]))
                        for k in range(n_sets)] if "z2_sample" in mix else []
        self.row_events = events.interval_counts(self.intervals[config["events_column"]], config.get("events_total"))
        self.n_events = int(self.row_events.sum())
        self.sets: list = []

    def prepare(self, times: np.ndarray):
        """The program's input made from one set's sorted event MJDs."""
        return times

    def draw(self) -> None:
        plan = events.interval_plan(self.par, self.intervals["ToA_tstart"], self.intervals["ToA_tend"])
        cdf = events.profile_cdf(self.template)
        for k in range(int(self.mix["event_sets"])):
            t = events.draw_times(plan, cdf, self.row_events, self.seed, k, self.device)
            self.sets.append(self.prepare(t.cpu().numpy()))
            del t

    def setup(self) -> None:
        """Draw the sets, then warm up: one unit, the shapes every unit uses."""
        self.draw()
        self.unit(0)

    def release(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference(self, k: int, z2_idx: np.ndarray, fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
        raise NotImplementedError

    def gaps(self, got: dict, want: dict) -> dict:
        raise NotImplementedError

    def check(self, records: list) -> tuple[dict, dict]:
        """(the widest gap of each number over all records, the reference's
        outputs by set). The reference runs once a set, at the union of the
        Z^2 trials its records kept (none where they keep no Z^2)."""
        refs = {}
        for k in sorted({r["set"] for r in records}):
            kept = [r["z2_idx"] for r in records if r["set"] == k and "z2_idx" in r]
            refs[k] = self.reference(k, np.unique(np.concatenate(kept)) if kept else None)
        numbers: dict = {}
        for r in records:
            for name, value in self.gaps(r, refs[r["set"]]).items():
                numbers[name] = max(numbers.get(name, value), value)
        return numbers, refs
