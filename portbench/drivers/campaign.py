"""Campaign traffic: whole north-star passes back to back.

A pass is what a timing user runs over a campaign's merged events: the
2-D (nu, nudot) Z^2 scan over every event, then per ToA interval the
anchored fold, the batched ToA fit, the H-test and the ``.tim`` ToAs,
through the program's ``north_star`` entry on the card. The mix's
``event_sets`` distinct sets are drawn from the seed in set-up and taken
in turn, pass after pass, so no pass can be served from an earlier one.

Kept from each pass for the check: the fit columns, H-powers, ``.tim``
ToAs, and the Z^2 rows at the trials sampled from the seed plus the pass's
highest row. Per pass the program's own stage clocks (``stages``) feed the
per-layer stage metrics.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crimp_tpu_torch.utils import surrogate
from portbench import scan
from portbench.counts import k2, k5
from portbench.drivers import common
from portbench.reference import campaign as ref

# what north_star runs, which the configuration has to state as it is
FIXED = {"scan": {"freq_lo": 0.1430, "freq_hi": 0.1436, "log_fdot_lo": -14.5, "log_fdot_hi": -13.5, "nharm": 2},
         "nbr_bins": 15, "htest_nharm": 5}
N_BRUTE, REFINE_ITERS = 128, 25  # the fit's brute grid and golden-section rounds (ToAFitConfig's defaults)


class Driver(common.EventDriver):
    unit_name = "pass"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        super().__init__(config, mix, seed, device)
        for key, want in FIXED.items():
            got = config[key]
            if (got if not isinstance(want, dict) else {k: got[k] for k in want}) != want:
                raise ValueError(f"north_star runs {key}={want}; the configuration states {got}")

    def unit(self, i: int) -> dict:
        k = i % len(self.sets)
        t0 = time.perf_counter()
        out = surrogate.north_star(self.paths["par"], self.paths["template"], self.sets[k], self.intervals,
                                   n_freq=self.scan["n_freq"], n_fdot=self.scan["n_fdot"],
                                   ph_shift_res=self.config["ph_shift_res"], device=self.device)
        seconds = time.perf_counter() - t0
        z2 = out["rows"][:, 2]
        top = int(np.argmax(z2))
        idx = np.append(self.samples[k], top)
        return {"set": k, "seconds": seconds, "stages": dict(out["stages"]),
                "z2_idx": idx, "z2": z2[idx],
                "phShift": out["fit"]["phShift"], "phShift_LL": out["fit"]["phShift_LL"],
                "phShift_UL": out["fit"]["phShift_UL"], "Hpower": out["fit"]["Hpower"],
                "toa": np.asarray(out["tim"]["TOA"], dtype=np.float64)}

    def end_to_end(self, window_s: float, records: list) -> dict:
        return {"campaign_s": window_s / len(records)}

    def reference(self, k: int, z2_idx: np.ndarray, fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
        out = ref.campaign(self.par, self.template, self.sets[k], self.intervals, scan.trials(self.scan, z2_idx),
                           self.scan["nharm"], self.config["htest_nharm"], self.config["ph_shift_res"], self.device,
                           fit_dtype=fit_dtype, z2_dtype=z2_dtype)
        out["z2_idx"] = np.asarray(z2_idx)
        return out

    def gaps(self, got: dict, want: dict) -> dict:
        step = 2 * np.pi / self.config["ph_shift_res"]
        bounds = np.concatenate([got["phShift_LL"] - want["phShift_LL"], got["phShift_UL"] - want["phShift_UL"]])
        return {**common.z2_gaps(got, want),
                "phshift_gap_rad": float(np.max(np.abs(got["phShift"] - want["phShift"]))),
                "bound_gap_steps": float(np.max(np.abs(bounds)) / step),
                "h_gap": float(np.max(np.abs(got["Hpower"] - want["Hpower"])
                                      / (want["Hpower"] + 2 * self.config["htest_nharm"]))),
                "tim_gap_us": float(np.max(np.abs(got["toa"] - want["toa"])) * 86400e6)}

    def counts(self, records: list, refs: dict) -> dict:
        per_pass_k2 = k2.scan_counts(self.n_events, self.scan["n_freq"], self.scan["n_fdot"], self.scan["nharm"])
        k5_parts = [k5.fit_counts(self.row_events, len(self.template["amp"]), N_BRUTE, REFINE_ITERS,
                                  refs[r["set"]]["loop_shifts"], refs[r["set"]]["loop_events"]) for r in records]
        return {"k2": common.scale(per_pass_k2, len(records)), "k5": common.total(k5_parts)}


def make(config, mix, seed, device):
    return Driver(config, mix, seed, device)

