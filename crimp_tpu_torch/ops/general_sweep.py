"""The readvaryparam ToA fit's profile: every flagged template parameter
refit per (segment, phase) by a fixed-iteration bounded Nelder-Mead.

Port of ``_general_profile_vecs`` (``crimp_tpu/ops/toafit.py:428-459``),
``nelder_mead`` (``crimp_tpu/ops/optimize.py:54-119``) and
``extended_loglik`` (``crimp_tpu/models/profiles.py:173-204``), which the
JAX package fuses under ``fit_toas_batch``'s jit. ``general_profile`` is
the entry point ``ops/toafit.py`` routes ``cfg.free_idx`` to:

- on a CUDA tensor one launch of K6 (``csrc/toafit_general.cu``
  ``toafit_general_nm``): a 512-thread block takes G consecutive phases of
  one row (``group_for``) and runs their whole Nelder-Mead side by side,
  the simplices in shared memory; each pass over the row's events
  evaluates every problem's next value: its reflect, the one more
  candidate its decision tree reads, or up to 4 starting or shrink
  vertices. At G 2 and 4 a Fourier row's first harmonic pairs are staged
  in shared memory once a block (``nm_stage`` plans how many events). It
  reports per problem the shrink steps and the candidate values its
  decisions read (what ``costmodel.k6_counts`` charges).
  ``LAUNCHES["general_sweep"]`` counts these launches. Operands K6 cannot
  take raise ``KernelError``; nothing falls back;
- on a CPU tensor the plain twin ``general_profile_reference``: the
  branch-free ``optimize.nelder_mead`` over ``general_nll``.

``general_golden`` is the fit's golden-section refine with the refit
vector at its optimum (JAX's ``golden_section`` at
``crimp_tpu/ops/toafit.py:640-660``): on a CUDA tensor one launch of K6's
``toafit_general_golden``, one 512-thread block a row whose rounds run
their two golden points side by side (G 2) through the Nelder-Mead body
``toafit_general_nm`` runs, ``LAUNCHES["general_golden"]``; on a CPU
tensor ``general_golden_reference``, ``optimize.golden_section`` over
one-phase twins and the twin at the optimum. Both give the bits of that
chain. The launch stages a Fourier row's first harmonic pairs in shared
memory once; ``stage_events`` plans how many events (host code, the C
entry refuses a stage that does not fit); the stage moves no bit. Inside
an obs run each K6 launch of a Fourier template adds its events and those
its walks read from the stage to the counters ``k6_fourier_events`` and
``k6_staged_events``: their ratio is the staged share.

``plan_row_groups`` is the host plan of the readvaryparam fit's row groups
(``ops/toafit.py`` runs each group's chain of K6 launches on a stream of
its own): the rows longest first, cut into the number of groups a
list-scheduling model of K6's blocks on the card's SMs finds fastest.

``general_nll`` is the twin of K6's evaluation, in torch ops over (S, P,
m, N) temporaries: the template with the free entries set to
``lo + span * (1 / (1 + exp(-u)))``, the curve with each term in the
order K6 takes it (Fourier from the events' harmonic pairs,
``harmonic_pairs``, and the vertices' (a, b), by angle addition), and the
event sums in K6's fixed order (``block_sum``), so a problem's value does
not depend on the problems beside it. ``general_eval`` gives K6's values
at given points (its ``toafit_general_eval`` entry,
``LAUNCHES["general_eval"]``) or the twin's. ``mirror_profile`` runs the
twin's ``optimize.nelder_mead`` over either, with the decision of every
step, to find the step where two runs part; ``pass_plan`` counts from
such a trace the passes over the events a K6 block makes. Whether a tensor
takes K6 is ``toafit._on_card``'s one test (imported at call time:
``ops/toafit.py`` imports this module).
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import math
import threading

import numpy as np
import torch

from crimp_tpu_torch import obs, resilience
from crimp_tpu_torch.models.profiles import CAUCHY, FOURIER, VONMISES
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.ops.optimize import bounded_transform, golden_section, nelder_mead
from crimp_tpu_torch.utils import profiling

_F64 = torch.float64

THREADS = 512  # csrc/toafit_general.cu THREADS: the event sums' fixed order
WARP = 32
MAX_COMP = 16  # csrc/toafit_general.cu MAX_COMP (and so at most 3 MAX_COMP + 2 free parameters)
INIT_SCALE = 0.25  # the initial simplex's step (JAX's _general_profile_vecs)
POS_GROUP = 4  # csrc/toafit_general.cu POS_GROUP: starting or shrink vertices of a problem a pass
GROUPS = (1, 2, 4)  # the phases a K6 block may take side by side (csrc MAX_GROUP)
GROUP = 4  # at the brute and dense grids: utils/k6_ab.py's fastest of 2, 4, 8 and 16
TWO_PI = 2 * math.pi
_KIND_CODE = {FOURIER: 0, VONMISES: 1, CAUCHY: 2}
STEP_NAMES = ("expand", "reflect", "outside", "inside", "shrink")  # K6's trace codes
INV_TWO_PI = 1.0 / (2 * math.pi)

LAUNCHES = {"general_sweep": 0, "general_eval": 0, "general_golden": 0}

# toafit_general_nm: x, mask, exposure, phis, base, free_idx, box lo, span, u0; n_rows, n_phis, n_events,
# n_comp, kind, n_free, nm_iters, group, n_stage; ll, vec, shrinks, reads, trace, stream
NM_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 5
               + [ctypes.c_longlong] + [ctypes.c_void_p] * 6)
# toafit_general_golden: x, mask, exposure, lo, hi, base, free_idx, box lo, span, u0; n_rows, n_events,
# n_comp, kind, n_free, nm_iters, refine_iters, n_stage; phi_best, ll_max, vec, shrinks, reads, stream
GOLDEN_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 6)
STAGE_ARG = 17  # n_stage's place in both entries' arguments
STAGE_STEP = 4 * THREADS  # csrc/toafit_general.cu STAGE_STEP: a stage short of the row ends on a whole step
STAGE_EVENT_BYTES = 16 + 1  # a staged event: its (C_1, S_1) and its mask byte

# plan_row_groups' model: a K6 block's time is BLOCK_US[launch] * (its row's
# masked events + ROW_OVERHEAD), one block an SM (__launch_bounds__(512, 1));
# the costs make the one-group schedule of the 1E 2259+586 campaign's 84 rows
# (5 136 to 14 897 events) take the brute sweep's, golden refine's and dense
# window's measured 230, 235 and 127 ms on an H100's 132 SMs
ROW_OVERHEAD = 1240  # events: a pass's work outside the event loop (~11 900 of ~106 800 cycles)
BLOCK_US = {"brute": 0.96701, "golden": 14.5628, "dense": 1.03381}
MAX_ROW_GROUPS = 4
ROW_GROUP_GAIN = 0.02  # a further group must shorten the model's time by this share

_LIB = None
_LIB_LOCK = threading.Lock()
# guards LAUNCHES and _BOXES (fits run beside the heartbeat and a serving engine's prep thread)
_STATE_LOCK = threading.Lock()
_BOXES: dict = {}
BOX_CAP = 64  # (box, device) pairs _box keeps


def reset_launches() -> None:
    with _STATE_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def _count_launch(key: str) -> None:
    with _STATE_LOCK:
        LAUNCHES[key] += 1


# ---------------------------------------------------------------------------
# Host packing: what K6 and its twin take
# ---------------------------------------------------------------------------


def flatten_template(tpl) -> torch.Tensor:
    """[norm, amp_1..K, loc_1..K, wid_1..K, ampShift], (D,) f64."""
    return torch.cat([tpl.norm[..., None], tpl.amp, tpl.loc, tpl.wid, tpl.amp_shift[..., None]], dim=-1)


def _box(cfg, device) -> dict:
    """The free indices and their box on ``device``, kept for the first
    BOX_CAP (box, device) pairs: a launch then copies nothing from the host,
    so the host issues a chain of launches without waiting on the card. Each
    tensor is a host copy, complete when it returns (no kernel a stream could
    run late), and a kept box is never freed, so every stream may read it; a
    box past the cap is made for its call alone, on the stream that uses it."""
    device = torch.device(device)
    key = (tuple(cfg.free_idx), tuple(cfg.free_lo), tuple(cfg.free_hi), device)
    with _STATE_LOCK:
        box = _BOXES.get(key)
    if box is None:
        tf = bounded_transform(cfg.free_lo, cfg.free_hi)
        box = {"idx": torch.as_tensor(cfg.free_idx, dtype=torch.long, device=device),
               "free_idx": torch.as_tensor(cfg.free_idx, dtype=torch.int32, device=device),
               "span": (tf.hi - tf.lo).to(device), "tf": bounded_transform(tf.lo.to(device), tf.hi.to(device))}
        with _STATE_LOCK:
            if key in _BOXES or len(_BOXES) < BOX_CAP:
                box = _BOXES.setdefault(key, box)
    return box


def pack(tpl, cfg, n_rows: int, warm_vec=None, device=None) -> dict:
    """K6's problem operands on ``device``: ``base`` the template's
    flattened vector (D,), ``free_idx`` (F,) int32, ``lo`` and ``span`` =
    hi - lo (F,) f64, and ``u0`` (S, F), the start to_unbounded(start[
    free_idx]) of every row, ``start`` the template or ``warm_vec`` (S, D)."""
    device = tpl.norm.device if device is None else device
    base = flatten_template(tpl).to(device=device, dtype=_F64)
    box = _box(cfg, device)
    start = base.expand(n_rows, -1) if warm_vec is None else warm_vec.to(device=device, dtype=_F64)
    return {"base": base.contiguous(), "free_idx": box["free_idx"], "idx": box["idx"], "lo": box["tf"].lo,
            "span": box["span"], "u0": box["tf"].to_unbounded(start[:, box["idx"]]).contiguous()}


def to_bounded(pk: dict, u: torch.Tensor) -> torch.Tensor:
    """lo + span * sigmoid(u), sigmoid written 1 / (1 + exp(-u)) as K6 and
    torch's CUDA sigmoid compute it."""
    return pk["lo"] + pk["span"] * (1.0 / (1.0 + torch.exp(-u)))


def vectors(pk: dict, u: torch.Tensor) -> torch.Tensor:
    """Flattened template vectors (..., D) at unbounded points u (..., F)."""
    vec = pk["base"].expand(*u.shape[:-1], pk["base"].shape[0]).clone()
    vec[..., pk["idx"]] = to_bounded(pk, u)
    return vec


# ---------------------------------------------------------------------------
# The twin's evaluation
# ---------------------------------------------------------------------------


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in K6's fixed order: thread t of 512 adds
    elements t, t + 512, ... in turn from +0.0, the 32 lanes of a warp meet
    in a halving tree (lane l takes l + 16, then l + 8, ...), then the 16
    warp sums the same way. Padding adds +0.0. -> v.shape[:-1]."""
    n = v.shape[-1]
    pad = (-n) % THREADS
    if pad or n == 0:
        v = torch.nn.functional.pad(v, (0, pad if n else THREADS))
    chunks = v.reshape(*v.shape[:-1], -1, THREADS)
    acc = torch.zeros(chunks.shape[:-2] + (THREADS,), dtype=v.dtype, device=v.device)
    for c in range(chunks.shape[-2]):
        acc = acc + chunks[..., c, :]
    acc = acc.reshape(*acc.shape[:-1], THREADS // WARP, WARP)
    half = WARP
    while half > 1:
        half //= 2
        acc = acc[..., :half] + acc[..., half:2 * half]
    acc = acc[..., 0]
    half = THREADS // WARP
    while half > 1:
        half //= 2
        acc = acc[..., :half] + acc[..., half:2 * half]
    return acc[..., 0]


def harmonic_pairs(x: torch.Tensor, n_comp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S), each (..., n_comp, N): (cos, sin)(j 2 pi x) of the events x
    (..., N) for j = 1..n_comp as K6 forms them, one cos and one sin of
    2 pi x, then C_j+1 = C_j C_1 - S_j S_1, S_j+1 = S_j C_1 + C_j S_1, each
    operation rounded on its own."""
    ang = TWO_PI * x
    c1, s1 = torch.cos(ang), torch.sin(ang)
    cs, ss = [c1], [s1]
    for _ in range(1, n_comp):
        c, s = cs[-1], ss[-1]
        cs.append(c * c1 - s * s1)
        ss.append(s * c1 + c * s1)
    return torch.stack(cs, dim=-2), torch.stack(ss, dim=-2)


def general_nll(kind: str, pk: dict, x, mask, exposure, phis, u) -> torch.Tensor:
    """-extended_loglik at unbounded points u (S, P, m, F) of the rows x,
    mask (S, N), exposure (S,) at phases phis (S, P) -> (S, P, m): the twin
    of K6's evaluation (module docstring), each operation the one K6 takes.
    A Fourier term is a_j C_j + b_j S_j with the events' ``harmonic_pairs``
    and a_j = (amp ampShift) cos(loc - j phi), b_j = -((amp ampShift)
    sin(loc - j phi)): (amp ampShift) cos((j 2 pi x + loc) - j phi)."""
    vec = vectors(pk, u)
    K = (vec.shape[-1] - 2) // 3
    norm, amp_sh = vec[..., 0], vec[..., 1:1 + K] * vec[..., -1:]
    # every component at once over (S, P, m, K, N); the K terms then summed in order
    if kind == FOURIER:
        j = torch.arange(1, K + 1, dtype=x.dtype, device=x.device)
        theta = vec[..., 1 + K:1 + 2 * K] - j * phis[:, :, None, None]
        a, b = amp_sh * torch.cos(theta), -(amp_sh * torch.sin(theta))
        c, s = harmonic_pairs(x, K)
        terms = a[..., None] * c[:, None, None] + b[..., None] * s[:, None, None]
    else:
        xs, ph = x[:, None, None, None, :], phis[:, :, None, None, None]
        wid = vec[..., 1 + 2 * K:1 + 3 * K]
        cd = torch.cos(xs - vec[..., 1 + K:1 + 2 * K, None] - ph)
        if kind == VONMISES:
            kappa = 1.0 / (wid * wid)
            coef = amp_sh / ((2 * math.pi) * torch.special.i0(kappa))
            terms = coef[..., None] * torch.exp(kappa[..., None] * cd)
        else:
            terms = ((amp_sh * INV_TWO_PI) * torch.sinh(wid))[..., None] / (torch.cosh(wid)[..., None] - cd)
    total = terms[..., 0, :]
    for k in range(1, K):
        total = total + terms[..., k, :]
    T = exposure[:, None, None]
    if kind == FOURIER:
        nf, expected = norm, norm * T
    else:
        q = amp_sh[..., 0]
        for k in range(1, K):
            q = q + amp_sh[..., k]
        nf = (2 * math.pi) * norm + q
        expected = (nf * T) * INV_TWO_PI
    normalized = (norm[..., None] + total) / nf[..., None]
    m = mask[:, None, None, :]
    log_sum = block_sum(torch.where(m, torch.log(torch.clamp(normalized, min=1e-300)), 0.0))
    min_val = torch.amin(torch.where(m, normalized, math.inf), dim=-1)
    n_events = torch.sum(mask, dim=-1).to(x.dtype)[:, None, None]
    value = -expected + n_events * torch.log(expected) + log_sum
    return -torch.where(min_val <= 0, -math.inf, value)


def general_profile_reference(kind, tpl, x, mask, exposure, phis, cfg, warm_vec=None, trace: list | None = None,
                              evaluate=None):
    """Plain twin of K6: (LL (S, P), refit vectors (S, P, D)), the
    branch-free ``optimize.nelder_mead`` (``cfg.nm_iters`` steps, initial
    step 0.25, its per-step records into ``trace``) over ``general_nll``
    from every row's start, or over ``evaluate(u)`` (S, P, m, F) -> (S, P,
    m) where given."""
    S, P = phis.shape
    pk = pack(tpl, cfg, S, warm_vec, x.device)
    u0 = pk["u0"][:, None, :].expand(S, P, -1)
    fn = evaluate or (lambda u: general_nll(kind, pk, x, mask, exposure, phis, u))
    u_best, f_best = nelder_mead(fn, u0, init_scale=INIT_SCALE, iters=cfg.nm_iters, trace=trace)
    return -f_best, vectors(pk, u_best)


# ---------------------------------------------------------------------------
# K6: build, bind, launch
# ---------------------------------------------------------------------------


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from crimp_tpu_torch.ops import z2_grid

            lib = ctypes.CDLL(str(z2_grid.build()["toafit_general"]))
            vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.toafit_general_nm.argtypes = NM_ARGTYPES
            lib.toafit_general_nm.restype = ci
            lib.toafit_general_max_group.argtypes = [ci]
            lib.toafit_general_max_group.restype = ci
            lib.toafit_general_nm_room.argtypes = []
            lib.toafit_general_nm_room.restype = cl
            lib.toafit_general_nm_blocks.argtypes = [ci, cl]
            lib.toafit_general_nm_blocks.restype = ci
            lib.toafit_general_eval.argtypes = [vp] * 9 + [ci, ci, cl, ci, ci, ci, ci] + [vp] * 2
            lib.toafit_general_eval.restype = ci
            lib.toafit_general_golden.argtypes = GOLDEN_ARGTYPES
            lib.toafit_general_golden.restype = ci
            lib.toafit_general_golden_room.argtypes = []
            lib.toafit_general_golden_room.restype = cl
            _LIB = lib
    return _LIB


def group_for(n_phis: int, n_free: int, lib=None, preferred: int = GROUP) -> int:
    """G, the phases of a row a K6 block takes side by side: ``preferred``
    halved until it is at most ``n_phis`` and its G simplices of
    ``n_free`` parameters fit the card's shared memory (``lib``'s
    ``toafit_general_max_group``; K6's library when None). 1 at one phase."""
    cap = (lib or _lib()).toafit_general_max_group(n_free)
    g = preferred
    while g > 1 and (g > n_phis or g > cap):
        g //= 2
    return g


def simplex_bytes(group: int, n_free: int) -> int:
    """The dynamic shared memory of ``group`` problems' simplices, values,
    candidates and orders at ``n_free`` parameters (csrc dyn_bytes)."""
    doubles = (n_free + 1) * n_free + (n_free + 1) + 4 * n_free
    return group * doubles * 8 + group * (n_free + 1) * 4


def nm_bytes(group: int, n_free: int, stage: int) -> int:
    """A Nelder-Mead launch's dynamic shared memory at n_stage ``stage``
    (csrc nm_bytes): ``group`` simplices, and at G 2 and 4 the stage after
    them, 16-byte aligned."""
    base = simplex_bytes(group, n_free)
    return base if group == 1 else -(-base // 16) * 16 + stage * STAGE_EVENT_BYTES


def stage_events(group: int, n_free: int, n_events: int, room: int) -> int:
    """n_stage, the events of a row whose first harmonic pair a staging K6
    launch (the golden refine: ``group`` 2; the Nelder-Mead at G 2 and 4)
    stages in shared memory: the most whose ``STAGE_EVENT_BYTES`` each fit
    ``room`` (``toafit_general_golden_room`` or ``toafit_general_nm_room``:
    the card's shared memory a block less the kernel's static state) beside
    the ``group`` simplices (16-byte aligned), a multiple of ``STAGE_STEP``,
    or every one of ``n_events`` where they all fit. Raises ``KernelError``
    where not even the simplices fit."""
    base = -(-simplex_bytes(group, n_free) // 16) * 16
    if base > room:
        raise resilience.KernelError(f"K6: {group} simplices of {n_free} free parameters ({base} B) do not fit the "
                                     f"card's shared memory ({room} B)")
    fit = (room - base) // STAGE_EVENT_BYTES
    return n_events if fit >= n_events else fit // STAGE_STEP * STAGE_STEP


def nm_stage(kind, group: int, n_free: int, n_events: int, lib=None) -> int:
    """The planned n_stage of a K6 Nelder-Mead launch at ``group`` phases a
    block: ``stage_events`` in ``toafit_general_nm_room`` (``lib``'s; K6's
    library when None) for a Fourier template at G 2 and 4, 0 otherwise
    (``nm_kernel<1>`` and the other families stage nothing)."""
    if kind != FOURIER or group == 1:
        return 0
    return stage_events(group, n_free, n_events, (lib or _lib()).toafit_general_nm_room())


def _count_stage(kind, mask: torch.Tensor, stage: int) -> None:
    """A Fourier launch's events and those its walks read from the stage
    (the masked events below ``stage``) into the obs counters of the
    active run; nothing outside a run (the sums wait on the card)."""
    if kind != FOURIER or obs.active() is None:
        return
    obs.counter_add("k6_fourier_events", int(mask.sum()))
    obs.counter_add("k6_staged_events", int(mask[:, :stage].sum()))


def pass_plan(trace: list, n_free: int, group: int) -> torch.Tensor:
    """The passes over its row's events that each K6 block makes, (S,
    ceil(P / group)), from ``optimize.nelder_mead``'s per-step ``trace`` of
    (S, P) problems: a problem takes ceil((F + 1) / 4) passes for its
    starting vertices, then each step one pass a candidate value its
    decisions read and, when it shrinks, ceil(F / 4) more; it never waits
    for the problems beside it, so its block makes as many passes as the
    longest of its ``group`` problems (a ragged last group has fewer)."""
    per = -(-(n_free + 1) // POS_GROUP) + sum(t["reads"] + (t["step"] == 4).long() * -(-n_free // POS_GROUP)
                                             for t in trace)
    S, P = per.shape
    pad = torch.zeros((S, -P % group), dtype=per.dtype, device=per.device)
    return torch.cat([per, pad], dim=1).reshape(S, -1, group).amax(dim=-1)


def _operands(entry: str, kind, tpl, x, mask, exposure, phis, cfg, warm_vec) -> dict | None:
    """Check what K6's entry point takes and pack it; raises ``KernelError``
    on anything else; an empty batch returns None."""
    if kind not in _KIND_CODE:
        raise resilience.KernelError(f"{entry}: K6 takes no template family {kind!r}")
    if tpl.norm.dim() != 0:
        raise resilience.KernelError(f"{entry}: K6 takes one shared template, not one a row")
    K, F = tpl.n_comp, len(cfg.free_idx)
    if not 1 <= K <= MAX_COMP:
        raise resilience.KernelError(f"{entry}: K6 takes 1 to {MAX_COMP} template components, got {K}")
    D = 3 * K + 2
    if not 1 <= F <= D or len(set(cfg.free_idx)) != F or not all(0 <= i < D for i in cfg.free_idx) \
            or len(cfg.free_lo) != F or len(cfg.free_hi) != F:
        raise resilience.KernelError(f"{entry}: K6 takes 1 to {D} distinct free indices below {D} with "
                                     f"a box each, got {cfg.free_idx}")
    for name, (t, dtype, ndim) in {"x": (x, _F64, 2), "mask": (mask, torch.bool, 2),
                                   "exposure": (exposure, _F64, 1), "phis": (phis, _F64, 2)}.items():
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous() or t.device != x.device:
            raise resilience.KernelError(
                f"{entry}: K6 takes {name} as a contiguous {ndim}-D {dtype} tensor on x's device "
                f"(got {t.dtype}, shape {tuple(t.shape)}, contiguous {t.is_contiguous()}, {t.device})")
    S, N = x.shape
    if mask.shape != (S, N) or exposure.shape != (S,) or phis.shape[0] != S:
        raise resilience.KernelError(f"{entry}: shapes x {tuple(x.shape)}, mask {tuple(mask.shape)}, exposure "
                                     f"{tuple(exposure.shape)}, phis {tuple(phis.shape)} do not line up")
    if warm_vec is not None and tuple(warm_vec.shape) != (S, D):
        raise resilience.KernelError(f"{entry}: warm_vec {tuple(warm_vec.shape)} is not ({S}, {D})")
    if S == 0 or phis.shape[1] == 0:
        return None
    if N == 0:
        raise resilience.KernelError(f"{entry}: K6 takes at least one event slot a row")
    if S * phis.shape[1] > 2**31 - 1:
        raise resilience.KernelError(f"{entry}: {S} x {phis.shape[1]} problems exceed K6's grid")
    return pack(tpl, cfg, S, warm_vec, x.device)


def _args(pk, x, mask, exposure, phis):
    """The pointers both entry points take first."""
    return (x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), phis.data_ptr(), pk["base"].data_ptr(),
            pk["free_idx"].data_ptr(), pk["lo"].data_ptr(), pk["span"].data_ptr())


def _launch_nm(kind, tpl, x, mask, exposure, phis, cfg, warm_vec=None, trace: bool = False,
               group: int | None = None, lib=None, stage: int | None = None):
    """Check the operands and launch K6's Nelder-Mead once (``lib`` a K6
    library, K6's own when None), ``group`` phases a block (None:
    ``group_for``): (LL (S, P), vectors (S, P, D), shrinks (S, P) int32,
    reads (S, P) int32 the candidate values the decisions read, and the
    (S, P, nm_iters) int8 decisions with ``trace``, else None). ``stage`` is
    the launch's n_stage: None plans it (``nm_stage``), an int pins it (it
    moves no bit; the entry refuses one it cannot take)."""
    S, P = phis.shape
    D = 3 * tpl.n_comp + 2
    ll = torch.empty((S, P), dtype=_F64, device=x.device)
    vec = torch.empty((S, P, D), dtype=_F64, device=x.device)
    shrinks = torch.zeros((S, P), dtype=torch.int32, device=x.device)
    reads = torch.zeros((S, P), dtype=torch.int32, device=x.device)
    steps = torch.empty((S, P, cfg.nm_iters), dtype=torch.int8, device=x.device) if trace else None
    if cfg.nm_iters < 0:
        raise resilience.KernelError(f"general_sweep: K6 takes nm_iters >= 0, got {cfg.nm_iters}")
    pk = _operands("general_sweep", kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
    if pk is None:
        return ll, vec, shrinks, reads, steps
    from crimp_tpu_torch.ops import z2_grid

    lib = lib or _lib()
    with profiling.launch_window(x.device):
        if group is None:
            group = group_for(P, len(cfg.free_idx), lib)
        if group not in GROUPS:
            raise resilience.KernelError(f"general_sweep: K6 takes a group of {GROUPS} phases a block, got {group}")
        if stage is None:
            stage = nm_stage(kind, group, len(cfg.free_idx), x.shape[1], lib)
        rc = lib.toafit_general_nm(*_args(pk, x, mask, exposure, phis), pk["u0"].data_ptr(), S, P,
                                   x.shape[1], tpl.n_comp, _KIND_CODE[kind], len(cfg.free_idx), cfg.nm_iters,
                                   group, stage, ll.data_ptr(), vec.data_ptr(), shrinks.data_ptr(), reads.data_ptr(),
                                   None if steps is None else steps.data_ptr(), z2_grid.stream_of(x))
    z2_grid.check_launch(rc, "toafit_general_nm")
    _count_launch("general_sweep")
    _count_stage(kind, mask, stage)
    return ll, vec, shrinks, reads, steps


def _launch_eval(kind, tpl, x, mask, exposure, phis, cfg, u):
    """Check the operands and launch K6's evaluation once: f (S, P, M) at
    u (S, P, M, F)."""
    S, P = phis.shape
    if u.dtype != _F64 or not u.is_contiguous() or u.device != x.device or u.dim() != 4 \
            or tuple(u.shape[:2]) != (S, P) or u.shape[3] != len(cfg.free_idx):
        raise resilience.KernelError(f"general_eval: K6 takes u as a contiguous (S, P, M, F) f64 tensor on x's "
                                     f"device, got {u.dtype} {tuple(u.shape)}")
    f = torch.empty(tuple(u.shape[:3]), dtype=_F64, device=x.device)
    pk = _operands("general_eval", kind, tpl, x, mask, exposure, phis, cfg, None)
    if pk is None or u.shape[2] == 0:
        return f
    from crimp_tpu_torch.ops import z2_grid

    lib = _lib()
    with profiling.launch_window(x.device):
        rc = lib.toafit_general_eval(*_args(pk, x, mask, exposure, phis), u.data_ptr(), S, P,
                                     x.shape[1], tpl.n_comp, _KIND_CODE[kind], len(cfg.free_idx), u.shape[2],
                                     f.data_ptr(), z2_grid.stream_of(x))
    z2_grid.check_launch(rc, "toafit_general_eval")
    _count_launch("general_eval")
    return f


def _launch_golden(kind, tpl, x, mask, exposure, lo, hi, cfg, lib=None, stage: int | None = None):
    """Check the operands and launch K6's golden-section refine once (``lib``
    a K6 library, K6's own when None): (phi_best (S,), ll_max (S,), refit
    vectors (S, D), shrinks (S,) int32 and reads (S,) int32, each summed
    over a row's 2 + 2 ``cfg.refine_iters`` problems). ``stage`` is the
    launch's n_stage, the Fourier events whose first harmonic pair it
    stages in shared memory: None plans it (``stage_events`` at G 2; 0 for
    the families that take no pair), an int pins it (it moves no bit)."""
    S = x.shape[0]
    D = 3 * tpl.n_comp + 2
    for name, t in (("lo", lo), ("hi", hi)):
        if t.dtype != _F64 or t.dim() != 1 or t.shape[0] != S or not t.is_contiguous() or t.device != x.device:
            raise resilience.KernelError(f"general_golden: K6 takes {name} as a contiguous ({S},) f64 tensor on x's "
                                         f"device, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if cfg.nm_iters < 0 or cfg.refine_iters < 0:
        raise resilience.KernelError(f"general_golden: K6 takes nm_iters and refine_iters >= 0, got "
                                     f"{cfg.nm_iters} and {cfg.refine_iters}")
    phi, ll = (torch.empty(S, dtype=_F64, device=x.device) for _ in range(2))
    vec = torch.empty((S, D), dtype=_F64, device=x.device)
    shrinks, reads = (torch.zeros(S, dtype=torch.int32, device=x.device) for _ in range(2))
    pk = _operands("general_golden", kind, tpl, x, mask, exposure, lo[:, None], cfg, None)
    if pk is None:
        return phi, ll, vec, shrinks, reads
    from crimp_tpu_torch.ops import z2_grid

    lib = lib or _lib()
    with profiling.launch_window(x.device):
        if stage is None:
            stage = stage_events(2, len(cfg.free_idx), x.shape[1], lib.toafit_general_golden_room())
            stage = stage if kind == FOURIER else 0
        rc = lib.toafit_general_golden(
            x.data_ptr(), mask.data_ptr(), exposure.data_ptr(), lo.data_ptr(), hi.data_ptr(), pk["base"].data_ptr(),
            pk["free_idx"].data_ptr(), pk["lo"].data_ptr(), pk["span"].data_ptr(), pk["u0"].data_ptr(), S,
            x.shape[1], tpl.n_comp, _KIND_CODE[kind], len(cfg.free_idx), cfg.nm_iters, cfg.refine_iters, stage,
            phi.data_ptr(), ll.data_ptr(), vec.data_ptr(), shrinks.data_ptr(), reads.data_ptr(), z2_grid.stream_of(x))
    z2_grid.check_launch(rc, "toafit_general_golden")
    _count_launch("general_golden")
    _count_stage(kind, mask, stage)
    return phi, ll, vec, shrinks, reads


# ---------------------------------------------------------------------------
# Row groups: the readvaryparam fit's chains of launches side by side
# ---------------------------------------------------------------------------


def schedule_ms(groups, n_sm: int, n_brute: int = 128, n_dense: int = 64) -> float:
    """The model's time of a readvaryparam fit's three K6 launches (the brute
    grid of ``n_brute`` phases, the golden refine, the dense window of
    ``n_dense``) when each row group of ``groups`` (each a sequence of its
    rows' masked events, in launch order) runs them in turn on a stream of
    its own, group 0 the first in priority: list scheduling on ``n_sm`` SMs
    of one block each, a freed SM taking the next block, in row order, of
    the first group whose launch is ready (its group's last launch has
    ended). A block's time is ``BLOCK_US[launch] * (events +
    ROW_OVERHEAD)``; a row takes ceil(P / ``GROUP``) blocks at P phases."""
    chains = []
    for rows in groups:
        launches = [[BLOCK_US[name] * (n + ROW_OVERHEAD) for n in rows for _ in range(blocks)]
                    for name, blocks in (("brute", -(-n_brute // GROUP)), ("golden", 1),
                                         ("dense", -(-n_dense // GROUP)))]
        chains.append([blocks for blocks in launches if blocks])
    sms = [0.0] * n_sm
    launch, nxt, ready, ends = ([0] * len(chains) for _ in range(4))
    live = [g for g, chain in enumerate(chains) if chain]
    end = 0.0
    while live:
        t = heapq.heappop(sms)
        g = next((g for g in live if ready[g] <= t), None)
        if g is None:  # no launch is ready: the SM waits for the first that will be
            heapq.heappush(sms, min(ready[g] for g in live))
            continue
        blocks = chains[g][launch[g]]
        done = t + blocks[nxt[g]]
        heapq.heappush(sms, done)
        ends[g] = max(ends[g], done)
        nxt[g] += 1
        if nxt[g] == len(blocks):
            ready[g], nxt[g] = ends[g], 0
            launch[g] += 1
            if launch[g] == len(chains[g]):
                live.remove(g)
                end = max(end, ends[g])
    return end / 1e3


@functools.lru_cache(maxsize=64)
def _group_count(counts: tuple, n_sm: int, n_brute: int, n_dense: int, max_groups: int) -> int:
    order = np.argsort(-np.asarray(counts), kind="stable")
    best, best_ms = 1, schedule_ms([counts], n_sm, n_brute, n_dense)
    for g in range(2, min(max_groups, len(counts)) + 1):
        ms = schedule_ms([[counts[r] for r in part] for part in np.array_split(order, g)], n_sm, n_brute, n_dense)
        if ms < best_ms * (1 - ROW_GROUP_GAIN):
            best, best_ms = g, ms
    return best


def plan_row_groups(row_events, n_sm: int, n_brute: int = 128, n_dense: int = 64,
                    max_groups: int = MAX_ROW_GROUPS) -> list[np.ndarray]:
    """The row groups of a readvaryparam fit, from each row's masked events
    and the card's SMs alone: a list of row-index arrays, one a group. One
    group is every row in the batch's order. Otherwise the rows sorted by
    events, most first (ties in row order), cut into G near-equal
    consecutive runs, G from 2 to ``max_groups`` the fastest by
    ``schedule_ms``, each further group taken only where it shortens the
    model's time by ``ROW_GROUP_GAIN``. Fewer than two rows: one group."""
    counts = tuple(int(n) for n in np.asarray(row_events).reshape(-1))
    g = 1 if len(counts) < 2 or max_groups < 2 else _group_count(counts, int(n_sm), int(n_brute), int(n_dense),
                                                                  int(max_groups))
    if g == 1:
        return [np.arange(len(counts))]
    return np.array_split(np.argsort(-np.asarray(counts), kind="stable"), g)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def general_profile(kind, tpl, x, mask, exposure, phis, cfg, warm_vec=None, site: str = "toa_general_sweep"):
    """(LL (S, P), refit flattened vectors (S, P, D)): every (row, phase)
    problem's bounded Nelder-Mead over the ``cfg.free_idx`` parameters,
    started at the template or at ``warm_vec`` (S, D). One K6 launch on a
    CUDA tensor (span and cost row ``site``), the twin on a CPU tensor."""
    from crimp_tpu_torch.ops import toafit

    if not toafit._on_card(x):
        return general_profile_reference(kind, tpl, x, mask, exposure, phis, cfg, warm_vec)
    args = (x.contiguous(), mask.contiguous(), exposure.contiguous(), phis.contiguous())
    with costmodel.kernel_span(site):
        ll, vec, shrinks, reads, _ = _launch_nm(kind, tpl, *args, cfg, warm_vec)
    costmodel.capture(site, None, kind, *args, cfg, out=[ll, vec],
                      counts=lambda: costmodel.k6_counts(
                          x.shape[0], phis.shape[1], float(mask.sum()) / max(x.shape[0], 1), tpl.n_comp, kind,
                          len(cfg.free_idx), float(reads.sum()), float(shrinks.sum())))
    return ll, vec


def general_golden_reference(kind, tpl, x, mask, exposure, lo, hi, cfg, sweep=None):
    """Plain version of K6's golden-section refine: ``optimize.golden_section``
    over one-phase profiles of every row on [lo, hi] (``cfg.refine_iters``
    iterations), then the profile at the optimum for its refit vector.
    Returns (phi_best (S,), ll_max (S,), vectors (S, D)). ``sweep`` is the
    profile it chains, the twin ``general_profile_reference`` by default
    (``general_profile`` makes it the chain of one-phase K6 launches that a
    card fit ran before the refine was one launch)."""
    sweep = general_profile_reference if sweep is None else sweep

    def at(phi):
        return sweep(kind, tpl, x, mask, exposure, phi[:, None].contiguous(), cfg)

    phi_best, ll_max = golden_section(lambda phi: at(phi)[0][:, 0], lo, hi, iters=cfg.refine_iters)
    return phi_best, ll_max, at(phi_best)[1][:, 0]


def general_golden(kind, tpl, x, mask, exposure, lo, hi, cfg):
    """The readvaryparam fit's golden-section refine of every row's profile
    on [lo, hi] (each (S,)) and the refit flattened vector at the optimum:
    (phi_best (S,), ll_max (S,), vectors (S, D)). On a CUDA tensor one K6
    launch (``toafit_general_golden``, span and cost row
    ``toa_general_refine``), bitwise the chain of one-phase K6 launches under
    ``golden_section`` and the launch at the optimum; operands K6 cannot
    take raise ``KernelError`` (nothing falls back). On a CPU tensor
    ``general_golden_reference``."""
    from crimp_tpu_torch.ops import toafit

    if not toafit._on_card(x):
        return general_golden_reference(kind, tpl, x, mask, exposure, lo, hi, cfg)
    args = (x.contiguous(), mask.contiguous(), exposure.contiguous())
    site = toafit.general_site("toa_sweep_refine")
    with costmodel.kernel_span(site):
        phi, ll, vec, shrinks, reads = _launch_golden(kind, tpl, *args, lo.contiguous(), hi.contiguous(), cfg)
    costmodel.capture(site, None, kind, *args, lo, hi, cfg, out=[phi, ll, vec],
                      counts=lambda: costmodel.k6_golden_counts(
                          x.shape[0], float(mask.sum()) / max(x.shape[0], 1), tpl.n_comp, kind, len(cfg.free_idx),
                          cfg.refine_iters, float(reads.sum()), float(shrinks.sum())))
    return phi, ll, vec


def general_eval(kind, tpl, x, mask, exposure, phis, cfg, u):
    """f = -extended_loglik at unbounded points u (S, P, M, F), phase phis
    (S, P): K6's evaluation on a CUDA tensor (the bits its Nelder-Mead
    compares), ``general_nll`` on a CPU tensor."""
    from crimp_tpu_torch.ops import toafit

    if not toafit._on_card(x):
        return general_nll(kind, pack(tpl, cfg, x.shape[0], None, x.device), x, mask, exposure, phis, u)
    return _launch_eval(kind, tpl, x, mask, exposure, phis, cfg, u)


def mirror_profile(kind, tpl, x, mask, exposure, phis, cfg, warm_vec=None, kernel: bool = False):
    """The twin's Nelder-Mead over ``general_nll`` or, with ``kernel``, over
    K6's own evaluation (``toafit_general_eval`` on the card): (LL (S, P),
    vectors (S, P, D), trace), ``trace`` ``optimize.nelder_mead``'s
    per-step records (decision codes as K6's, ``STEP_NAMES``). Over K6's
    evaluation it is K6's Nelder-Mead step by step, so where K6 and the
    twin part, the two traces show the step and the values compared there."""
    trace: list = []
    evaluate = None
    if kernel:
        def evaluate(u):
            return _launch_eval(kind, tpl, x, mask, exposure, phis, cfg, u.contiguous())

    ll, vec = general_profile_reference(kind, tpl, x, mask, exposure, phis, cfg, warm_vec, trace, evaluate)
    return ll, vec, trace
