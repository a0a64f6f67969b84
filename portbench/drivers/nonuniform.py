"""Blind-search traffic on trial periods stepped evenly: whole 1-D Z^2
scans, scan after scan.

A scan is CRIMP's periodsearch ``ztest`` over every event of a set, through
the program's ``PeriodSearch`` on the card: event times in seconds from
their mean, the frequencies 1/period of the mix's ``grid`` (``n_period``
periods from ``period_lo`` to ``period_hi`` s, stepped evenly, so the
frequencies are not) in ascending order, its harmonics. Such a grid is not
uniform in frequency, so the program runs it on K3, never on K2. The mix's
``event_sets`` sets are drawn from the seed in set-up and taken in turn.
Kept from each scan for the check: the Z^2 at the trials
``scan.check_indices`` picks for its set on a one-row grid, plus the scan's
highest trial.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crimp_tpu_torch.ops import search
from portbench import scan
from portbench.counts import k3
from portbench.drivers import common
from portbench.gen import events
from portbench.reference import z2


def frequencies(grid: dict) -> np.ndarray:
    """1/period of the evenly stepped periods, in ascending order."""
    periods = np.linspace(grid["period_lo"], grid["period_hi"], int(grid["n_period"]))
    return 1.0 / periods[::-1]


class Driver(common.EventDriver):
    unit_name = "scan"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.grid = mix["grid"]
        if float(self.grid["fdot"]) != 0.0:
            raise ValueError("a ztest scan has no nudot: the mix's grid needs fdot 0")
        one_row = {"n_freq": int(self.grid["n_period"]), "n_fdot": 1, "nharm": int(self.grid["nharm"])}
        super().__init__(dict(config, scan=one_row), mix, seed, device)
        self.freqs = frequencies(self.grid)

    def prepare(self, times: np.ndarray) -> np.ndarray:
        return events.seconds_since_mean(times)

    def unit(self, i: int) -> dict:
        k = i % len(self.sets)
        t0 = time.perf_counter()
        z2_all = search.PeriodSearch(self.sets[k], self.freqs, self.scan["nharm"], device=self.device).ztest()
        seconds = time.perf_counter() - t0
        idx = np.append(self.samples[k], int(np.argmax(z2_all)))
        return {"set": k, "seconds": seconds, "z2_idx": idx, "z2": z2_all[idx]}

    def end_to_end(self, window_s: float, records: list) -> dict:
        pairs = len(records) * float(self.n_events) * scan.n_trials(self.scan)
        return {"search_pairs_per_s": pairs / window_s / 1e9}

    def reference(self, k: int, z2_idx: np.ndarray, fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
        sec = torch.as_tensor(self.sets[k], device=self.device)
        f = torch.as_tensor(self.freqs[np.asarray(z2_idx)], device=self.device)
        out = z2.z2_trials(sec, f, torch.zeros_like(f), self.scan["nharm"], z2_dtype)
        return {"z2_idx": np.asarray(z2_idx), "z2": out.cpu().numpy()}

    def gaps(self, got: dict, want: dict) -> dict:
        return common.z2_gaps(got, want)

    def counts(self, records: list, refs: dict) -> dict:
        one = k3.scan_counts(self.n_events, scan.n_trials(self.scan), 1, self.scan["nharm"])
        return {"k3": common.scale(one, len(records))}


def make(config, mix, seed, device):
    return Driver(config, mix, seed, device)
