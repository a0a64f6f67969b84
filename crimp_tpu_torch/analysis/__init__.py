"""graftlint for crimp_tpu_torch: the capture-discipline / knob-registry /
parity static analyzer. Port of ``crimp_tpu/analysis``.

Usage::

    python -m crimp_tpu_torch.analysis [--format json|text|sarif] [paths...]
    python -m crimp_tpu_torch.analysis --changed-only      # git-diff scoped report
    python -m crimp_tpu_torch.analysis --waivers           # waiver inventory table

Rules (crimp_tpu_torch/docs/analysis.md has the full contract + waiver syntax):

- GL001 capture purity (env/time/random/file-I/O unreachable from code
  that runs under CUDA-graph capture)
- GL002 host-sync hazards (``.item()``/``.cpu()``/``torch.nonzero``/
  synchronize, tensor coercions and branching in captured code)
- GL003 knob-registry consistency (crimp_tpu_torch/knobs.py <-> reads <->
  docs <-> resumable numeric_mode fingerprint)
- GL004 dtype discipline (longdouble confined to host-side anchor modules)
- GL005 order-sensitive reductions in sharded/parity-pinned modules
- GL006 failure-domain discipline (bare except / swallowed errors outside
  sanctioned telemetry guards)
- GL007 sharding-registry discipline (hand-written spec tuples outside
  parallel/registry.py)
- GL008 concurrency discipline (thread-reachable module-global mutations
  must hold a declared lock; lock-declaring modules guard every mutation)
- GL009 resilience contract web (LADDERS/FAULT_POINTS <-> degradation and
  fire sites <-> firing tests <-> docs/robustness.md)
- GL010 telemetry-surface drift (obs counter/gauge literals <->
  docs/observability.md <-> consumers; ledger METRICS <-> chip_smoke.py)

The linter imports neither torch nor JAX. The tier-1 gate
(tests/test_torch_analysis_gate.py) runs the full rule set over
crimp_tpu_torch/ and chip_smoke.py and requires zero unwaived findings.
"""

from crimp_tpu_torch.analysis import facts, sarif
from crimp_tpu_torch.analysis.cli import main
from crimp_tpu_torch.analysis.core import RULES, Config, Finding, Report
from crimp_tpu_torch.analysis.engine import run

__all__ = ["main", "run", "Config", "Finding", "Report", "RULES",
           "facts", "sarif"]
