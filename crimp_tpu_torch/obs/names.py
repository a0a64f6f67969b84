"""Names of the main path's layer and step spans.

A layer span brackets one layer's work in a call (``crimp.fit``: the whole
batched ToA fit); its step spans bracket each stretch of host work in it,
and each hand-kernel launch keeps its kernel-site name (``toa_sweep_brute``,
``grid_sums_2d``, ...), its cost row's key. A layer span is an
``obs.span``: a stage span of an obs run and a range of the
``torch.profiler`` timeline while the profiler records. A step span is
the range alone (``obs.profiler_range``): in an obs run a stage span
synchronizes the card and writes two events, which would add host time to
the very calls the run times. The benchmark's per-layer metrics read how
long the card idled inside each range (``portbench/metrics/*_idle_ms.*``,
``idle_unattributed_pct.*``). ``docs/observability.md`` lists them.
"""

from __future__ import annotations

# entry points: one north-star pass (utils/surrogate.py::north_star)
PASS = "crimp.pass"
PASS_PREP = "crimp.pass.prep"  # model and template resolved, event seconds, trial axes

# search and K2 (ops/search.py: PeriodSearch.twod_ztest, the uniform-grid sums)
SCAN = "crimp.scan"
SCAN_PLAN = "crimp.scan.plan"  # centred times, route, row coefficients, launch plan
SCAN_TO_CARD = "crimp.scan.to_card"  # the events' copy to the card
SCAN_ROWS = "crimp.scan.rows"  # powers to the host, the (freq, fdot, Z^2) rows

# fold (ops/toafit.py's slicing and padding, ops/anchored.py::fold_segments)
FOLD = "crimp.fold"
FOLD_SLICE = "crimp.fold.slice"  # slice_sorted_intervals
FOLD_ANCHORS = "crimp.fold.anchors"  # anchor epochs, event offsets, prepare_anchors (longdouble)
FOLD_TO_CARD = "crimp.fold.to_card"  # the anchors and offsets to the card
FOLD_TO_HOST = "crimp.fold.to_host"  # the phases to the host, split by segment
FOLD_PAD = "crimp.fold.pad"  # pad_segments

# ToA fit and K5 / K6 (ops/toafit.py::fit_toas_batch and its callers)
FIT = "crimp.fit"
FIT_PLAN = "crimp.fit.plan"  # the runtime knobs and the sharding decision
FIT_TO_CARD = "crimp.fit.to_card"  # phases, masks, exposures and template to the card
FIT_EVENTS = "crimp.fit.events"  # K5's sweep_events, once a fit
FIT_ERROR_SCAN = "crimp.fit.error_scan"  # the error scan: its launches and host bookkeeping
FIT_CHI2 = "crimp.fit.chi2"  # the binned-profile goodness of fit
FIT_TO_HOST = "crimp.fit.to_host"  # the fit's columns to the host

# H-test and tim (north_star, ops/search.py::h_power_segments, pipelines/tim_tools.py)
HTEST = "crimp.htest"
HTEST_ROWS = "crimp.htest.rows"  # each ToA's frequency and its events' centred seconds
HTEST_SUMS = "crimp.htest.sums"  # h_power_segments
TIM = "crimp.tim"
TIM_ROTATION = "crimp.tim.rotation"  # integer_rotation_host
TIM_TABLE = "crimp.tim.table"  # the .tim columns
TIM_WRITE = "crimp.tim.write"  # the .tim file
