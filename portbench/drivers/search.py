"""Blind-search traffic: whole 2-D (nu, nudot) Z^2 scans, scan after scan.

A scan is CRIMP's periodsearch ``twod_ztest`` over every event of a set,
through the program's ``PeriodSearch`` on the card: event times in seconds
from their mean, the configuration's trial grid, its harmonics. The mix's
``event_sets`` sets are drawn from the seed in set-up and taken in turn.
Kept from each scan for the check: the Z^2 rows at the trials ``scan.check_indices``
picks for its set, plus the scan's highest row.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crimp_tpu_torch.ops import search
from portbench import scan
from portbench.counts import k2
from portbench.drivers import common
from portbench.gen import events
from portbench.reference import campaign as ref


class Driver(common.EventDriver):
    unit_name = "scan"

    def prepare(self, times: np.ndarray) -> np.ndarray:
        return events.seconds_since_mean(times)

    def unit(self, i: int) -> dict:
        k = i % len(self.sets)
        freqs, log_fdots = scan.axes(self.scan)
        t0 = time.perf_counter()
        rows, _ = search.PeriodSearch(self.sets[k], freqs, self.scan["nharm"], device=self.device).twod_ztest(log_fdots)
        seconds = time.perf_counter() - t0
        z2 = rows[:, 2]
        idx = np.append(self.samples[k], int(np.argmax(z2)))
        return {"set": k, "seconds": seconds, "z2_idx": idx, "z2": z2[idx]}

    def end_to_end(self, window_s: float, records: list) -> dict:
        pairs = len(records) * float(self.n_events) * scan.n_trials(self.scan)
        return {"search_pairs_per_s": pairs / window_s / 1e9}

    def reference(self, k: int, z2_idx: np.ndarray, fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
        sec = torch.as_tensor(self.sets[k], device=self.device)
        z2 = ref.z2_seconds(sec, scan.trials(self.scan, z2_idx), self.scan["nharm"], self.device, z2_dtype)
        return {"z2_idx": np.asarray(z2_idx), "z2": z2}

    def gaps(self, got: dict, want: dict) -> dict:
        return common.z2_gaps(got, want)

    def counts(self, records: list, refs: dict) -> dict:
        one = k2.scan_counts(self.n_events, self.scan["n_freq"], self.scan["n_fdot"], self.scan["nharm"])
        return {"k2": common.scale(one, len(records))}


def make(config, mix, seed, device):
    return Driver(config, mix, seed, device)
