"""The control: the plain reference in the program's place, one precision
step below what the configuration states (the ToA fit in float32, each
Z^2 and H-test cos and sin rounded to bfloat16), must be judged not
correct by each cell's limits. At the cells' own size it runs on the card
through ``portbench/study.py``; here at a size a test run holds."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.study import CONTROL


@pytest.mark.parametrize("cell,kw", [("ns_1e2259.campaign", dict(n_intervals=6, events=10000, sets=1)),
                                     # trials off the pulse (its highest row noise): at a test's
                                     # 1.7e5 events bfloat16's gaps grow past the limits only there
                                     ("blind_1e7.z2", dict(n_intervals=84, events=2000, sets=1,
                                                           scan=dict(freq_lo=0.1403, freq_hi=0.1463))),
                                     ("ns_1e2259.rv", dict(n_intervals=2, events=10000, sets=1))])
def test_control_is_not_correct(cell, kw, small):
    config, mix = small(cell, **kw)
    mix = dict(mix, z2_sample=256) if "z2_sample" in mix else mix
    driver = harness.load_module(harness.HERE / "drivers" / f"{mix['driver']}.py").make(config, mix, 31337, "cpu")
    driver.draw()
    idx = None
    if "scan" in config and driver.samples:
        every = np.arange(config["scan"]["n_freq"] * config["scan"]["n_fdot"])
        idx = np.append(driver.samples[0], np.argmax(driver.reference(0, every)["z2"]))
    want = driver.reference(0, idx)
    got = driver.reference(0, idx, **CONTROL)
    gaps = driver.gaps(got, want)
    failed = [name for name, limit in mix["limits"].items() if not gaps[name] <= limit]
    assert failed, gaps
    # the reference judged against itself reads nought to rounding
    own = driver.gaps(want, want)
    assert all(own[name] <= 1e-3 * limit for name, limit in mix["limits"].items())
    assert CONTROL == {"fit_dtype": torch.float32, "z2_dtype": torch.bfloat16}
