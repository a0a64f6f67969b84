"""Readvaryparam traffic: the ``-rv`` ToA measurement, pass after pass.

A pass is what ``measuretoas -rv`` runs between reading its event file and
writing its tables, through the program's own functions in the order
``pipelines/measure_toas.py`` calls them: each ToA interval's events sliced
from a set's sorted event times, the anchored fold on the card, the padded
batch, and the readvaryparam fit (every parameter the template flags refit
beside the phase shift; K6 on the card) in one batch, as ``measure_toas``
fits rows within 4x of each other in size. The mix's ``event_sets`` sets are
drawn from the seed in set-up and taken in turn.

Kept from each pass for the check: every ToA's phShift, maximum
log-likelihood and refit template. With every template phase free,
phShift is not fixed by the data (``reference/general.py``), so the check
holds each ToA's maximum to the likelihood the reference works out for the
reported template and shift on its own fold of the same events
(``ll_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from crimp_tpu_torch.io import template as template_io
from crimp_tpu_torch.models import profiles
from crimp_tpu_torch.models import timing as program_timing
from crimp_tpu_torch.ops import anchored, toafit
from portbench.counts import k6
from portbench.drivers import common
from portbench.reference import campaign as ref
from portbench.reference import general, timing

N_BRUTE, REFINE_ITERS, NM_ITERS, DENSE_WINDOW = 128, 25, 150, 32  # ToAFitConfig's defaults


class Driver(common.EventDriver):
    unit_name = "pass"

    def __init__(self, config: dict, mix: dict, seed: int, device):
        super().__init__(config, mix, seed, device)
        self.model = program_timing.resolve(self.paths["par"])
        tpl_dict = template_io.read_template(self.paths["template"])
        self.kind, self.tpl = profiles.from_template(tpl_dict)
        free_idx, lo, hi, self.n_free = toafit.free_param_spec(self.kind, tpl_dict)
        self.cfg = toafit.ToAFitConfig(kind=self.kind, ph_shift_res=config["ph_shift_res"], nbins=config["nbr_bins"],
                                       free_idx=free_idx, free_lo=lo, free_hi=hi, n_free=self.n_free,
                                       fix_norm=not free_idx)
        self.exposure = self.intervals["ToA_exposure"].astype(float)

    def unit(self, i: int) -> dict:
        k = i % len(self.sets)
        starts, ends = self.intervals["ToA_tstart"], self.intervals["ToA_tend"]
        t0 = time.perf_counter()
        segs = toafit.slice_sorted_intervals(self.sets[k], starts, ends, assume_sorted=True)
        phases, _ = anchored.fold_segments(self.model, segs, device=self.device)
        x, mask = toafit.pad_segments(phases)
        t1 = time.perf_counter()
        fit = toafit.fit_toas_batch_auto(self.kind, self.tpl, x, mask, self.exposure, self.cfg, device=self.device)
        t2 = time.perf_counter()
        return {"set": k, "seconds": t2 - t0, "stages": {"fold": t1 - t0, "fit": t2 - t1},
                "phShift": np.asarray(fit["phShift"], dtype=np.float64),
                "logLmax": np.asarray(fit["logLmax"], dtype=np.float64),
                "theta": np.asarray(fit["theta_best"], dtype=np.float64)}

    def end_to_end(self, window_s: float, records: list) -> dict:
        return {"toas_per_s": len(records) * len(self.intervals["ToA_tstart"]) / window_s}

    def reference(self, k: int, z2_idx, fit_dtype=torch.float64, z2_dtype=torch.float64) -> dict:
        """The reference's own fold of set ``k``, and the fixed-template fit
        in ``fit_dtype`` reported as a refit (the control, in float32)."""
        segs = ref.segments(self.sets[k], self.intervals["ToA_tstart"], self.intervals["ToA_tend"])
        x = np.zeros((len(segs), max(s.size for s in segs)))
        mask = np.zeros(x.shape, dtype=bool)
        for r, s in enumerate(segs):
            x[r, : s.size] = timing.folded(self.par, s)
            mask[r, : s.size] = True
        out = {"x": torch.as_tensor(x, device=self.device), "mask": torch.as_tensor(mask, device=self.device),
               "T": torch.as_tensor(self.exposure, dtype=torch.float64, device=self.device)}
        out.update(general.control_fit(self.template, out["x"], out["mask"], out["T"], self.config["ph_shift_res"],
                                       dtype=fit_dtype))
        return out

    def gaps(self, got: dict, want: dict) -> dict:
        """``ll_gap``: the widest |logLmax - LL| over the ToAs, LL the
        reference's likelihood of the reported template and shift."""
        dev = want["x"].device
        ll = general.loglik(want["x"], want["mask"], want["T"], torch.as_tensor(got["phShift"], device=dev),
                            torch.as_tensor(got["theta"], device=dev)).cpu().numpy()
        gap = np.abs(np.asarray(got["logLmax"]) - ll)
        return {"ll_gap": float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")}

    def counts(self, records: list, refs: dict) -> dict:
        one = k6.fit_counts(self.row_events, len(self.template["amp"]), self.n_free, NM_ITERS, N_BRUTE,
                            REFINE_ITERS, DENSE_WINDOW)
        return {"k6": common.scale(one, len(records))}


def make(config, mix, seed, device):
    return Driver(config, mix, seed, device)
