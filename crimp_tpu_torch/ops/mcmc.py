"""Affine-invariant ensemble MCMC in torch (Goodman & Weare stretch moves).

Port of ``crimp_tpu/ops/mcmc.py`` (the emcee replacement of CRIMP's
fit_toas.py:140-202). The ensemble halves update alternately, the
standard parallel-stretch scheme, keeping detailed balance while staying
batched: walkers and proposals are (..., W, ndim) tensors and the
log-probability scores a whole half-ensemble in one call, returning
(..., W'). Leading axes are independent problems (``ensemble_sample_batch``).

The sampler has two layers:

- ``ensemble_sample_draws`` takes every random number as a tensor: per
  step, a partner index, a stretch uniform and an accept uniform for each
  walker (``Draws``; columns ``[:W//2]`` belong to the first half, the rest
  to the second). The loop over steps holds no host sync: the chain is
  preallocated on the device and nothing is read back until it ends. On
  the card, blocks of steps are captured once in a CUDA graph and
  replayed, since a step is ~130 kernels of a few microseconds each and
  eager launches would leave the card idle.
- ``ensemble_sample`` / ``ensemble_sample_batch`` make those draws from a
  ``torch.Generator`` on the run's device, seeded from ``seed``.

The JAX package draws from its own key sequence inside ``lax.scan``; feeding
those draws to ``ensemble_sample_draws`` reproduces its chain.

``delta_logprob`` is the delta-basis likelihood shared by the fit's
``mcmc_delta`` path and the batched local-ephemeris windows: a proposal's
model is one ``basis @ theta`` product, masked for padded rows.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from crimp_tpu_torch.utils import profiling
from crimp_tpu_torch.utils.device import resolve_device

# Steps per captured CUDA graph on the card: ~130 small kernels per step,
# so one graph holds ~13 000 launches and replays them without host cost.
GRAPH_STEPS = 100


class Draws(NamedTuple):
    """Random numbers of a run, each (steps, ..., W)."""

    partner: torch.Tensor  # int64: first half in [0, W - W//2), second in [0, W//2)
    stretch_u: torch.Tensor  # f64 uniforms on [0, 1) -> stretch factor z
    accept_u: torch.Tensor  # f64 uniforms on [0, 1) -> Metropolis test


def delta_logprob(theta: torch.Tensor, data: dict) -> torch.Tensor:
    """Linear-regime Gaussian log-probability ``mu = basis @ theta``, batched.

    ``data`` holds ``basis`` (..., N, ndim), ``y``, ``err``, ``mask`` (..., N)
    and ``lo``/``hi`` (..., ndim), where ``...`` are the leading problem axes
    (windows, sources) or none. ``theta`` is (..., W, ndim) and the result
    (..., W). The model is mean-subtracted over the valid (mask == 1) rows
    and compared with the (already centered) data; rows with mask == 0 are
    inert padding and add exactly +0.0. Box priors gate the result to -inf
    outside (lo, hi). No host syncs: it runs inside the sampler's CUDA graphs.
    """
    basis, y, err, mask = data["basis"], data["y"], data["err"], data["mask"]
    lo, hi = data["lo"].unsqueeze(-2), data["hi"].unsqueeze(-2)
    in_box = torch.all((theta > lo) & (theta < hi), dim=-1)
    mu = torch.matmul(theta, basis.transpose(-1, -2))  # (..., W, N)
    mask = mask.unsqueeze(-2)
    mu = mu - torch.sum(mu * mask, dim=-1, keepdim=True) / torch.sum(mask, dim=-1, keepdim=True)
    resid = (y.unsqueeze(-2) - mu) / err.unsqueeze(-2)
    nll = 0.5 * torch.sum(mask * (resid**2 + torch.log(2 * math.pi * err.unsqueeze(-2) ** 2)), dim=-1)
    return torch.where(in_box, -nll, -math.inf)


def ensemble_draws(steps: int, n_walkers: int, seed: int = 0, batch_shape=(), device=None) -> Draws:
    """The draws of a run from a ``torch.Generator`` on ``device`` seeded
    from ``seed`` (deterministic for a seed on a given device type)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    half = n_walkers // 2
    shape = (steps, *batch_shape)
    partner = torch.cat([
        torch.randint(0, n_walkers - half, (*shape, half), generator=gen, device=dev),
        torch.randint(0, half, (*shape, n_walkers - half), generator=gen, device=dev),
    ], dim=-1)
    u = lambda: torch.rand((*shape, n_walkers), generator=gen, dtype=torch.float64, device=dev)
    return Draws(partner, u(), u())


def _half_update(lp_fn, movers, movers_lp, others, partner, z, logz_term, log_accept):
    partners = torch.gather(others, -2, partner[..., None].expand(*partner.shape, movers.shape[-1]))
    proposal = partners + z[..., None] * (movers - partners)
    prop_lp = lp_fn(proposal)
    log_ratio = logz_term + prop_lp - movers_lp
    accept = log_accept < log_ratio
    return torch.where(accept[..., None], proposal, movers), torch.where(accept, prop_lp, movers_lp)


def _run_steps(lp_fn, walkers, lp, per_step, chain, lps):
    """Steps over the leading axis of ``per_step`` (partner, z, log z term,
    log accept), writing each state into ``chain``/``lps``; returns the last."""
    half = walkers.shape[-2] // 2
    a, b = slice(None, half), slice(half, None)
    for s in range(per_step[0].shape[0]):
        draw = [t[s] for t in per_step]
        first, lp1 = _half_update(lp_fn, walkers[..., a, :], lp[..., a], walkers[..., b, :],
                                  *(d[..., a] for d in draw))
        second, lp2 = _half_update(lp_fn, walkers[..., b, :], lp[..., b], first,
                                   *(d[..., b] for d in draw))
        walkers = torch.cat([first, second], dim=-2)
        lp = torch.cat([lp1, lp2], dim=-1)
        chain[s] = walkers
        lps[s] = lp
    return walkers, lp


def _run_graphed(lp_fn, walkers, lp, per_step, chain, lps, block: int):
    """``_run_steps`` with every whole block of ``block`` steps replayed
    from one captured CUDA graph: the same kernels in the same order as
    the eager loop, without its per-launch host cost."""
    n_blocks = per_step[0].shape[0] // block
    static_in = [t[:block].clone() for t in per_step]
    state_w, state_lp = walkers.clone(), lp.clone()
    chain_blk, lps_blk = torch.empty_like(chain[:block]), torch.empty_like(lps[:block])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up before capture, as torch.cuda.graph asks
        _run_steps(lp_fn, state_w, state_lp, static_in, chain_blk, lps_blk)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        out_w, out_lp = _run_steps(lp_fn, state_w, state_lp, static_in, chain_blk, lps_blk)
    profiling.count_graph_capture(time.perf_counter() - t0)
    for i in range(n_blocks):
        rows = slice(i * block, (i + 1) * block)
        for dst, src in zip(static_in, per_step):
            dst.copy_(src[rows])
        graph.replay()
        chain[rows].copy_(chain_blk)
        lps[rows].copy_(lps_blk)
        state_w.copy_(out_w)
        state_lp.copy_(out_lp)
    rest = slice(n_blocks * block, None)
    return _run_steps(lp_fn, state_w.clone(), state_lp.clone(), [t[rest] for t in per_step],
                      chain[rest], lps[rest])


def ensemble_sample_draws(log_prob_fn, p0: torch.Tensor, draws: Draws, stretch_a: float = 2.0,
                          data=None, graph_steps: int = 0):
    """Run the stretch-move ensemble on given draws; returns (chain, log_probs).

    ``p0`` is (..., W, ndim); chain: (steps, ..., W, ndim); log_probs:
    (steps, ..., W), both on ``p0``'s device. ``log_prob_fn(theta)`` (or
    ``log_prob_fn(theta, data)`` when ``data`` is given) maps (..., W', ndim)
    to (..., W'). ``graph_steps`` > 0 runs blocks of that many steps as one
    replayed CUDA graph (CUDA tensors only; the log-probability must then
    be capturable: no host syncs, no host tensors); the chain is the eager
    chain, bit for bit.
    """
    lp_fn = log_prob_fn if data is None else (lambda theta: log_prob_fn(theta, data))
    lp = lp_fn(p0)
    # the per-step scalars of the stretch move, for every step at once
    z = ((stretch_a - 1.0) * draws.stretch_u + 1.0) ** 2 / stretch_a
    per_step = [draws.partner, z, (p0.shape[-1] - 1) * torch.log(z), torch.log(draws.accept_u)]

    steps = draws.partner.shape[0]
    chain = torch.empty((steps, *p0.shape), dtype=p0.dtype, device=p0.device)
    lps = torch.empty((steps, *lp.shape), dtype=lp.dtype, device=lp.device)
    if graph_steps > 0 and steps >= graph_steps:
        if p0.device.type != "cuda":
            raise ValueError("graph_steps needs CUDA tensors")
        _run_graphed(lp_fn, p0, lp, per_step, chain, lps, graph_steps)
    else:
        _run_steps(lp_fn, p0, lp, per_step, chain, lps)
    return chain, lps


def ensemble_sample(log_prob_fn, p0, steps: int, seed: int = 0, stretch_a: float = 2.0,
                    data=None, device=None):
    """Run the stretch-move ensemble from ``p0`` (walkers, ndim) on ``device``
    (default cuda) with draws seeded from ``seed``; returns (chain
    (steps, walkers, ndim), log_probs (steps, walkers)) as device tensors.
    On the card the steps run as replayed CUDA graphs of ``GRAPH_STEPS``."""
    dev = resolve_device(device)
    p0 = torch.as_tensor(np.asarray(p0, dtype=np.float64), device=dev)
    draws = ensemble_draws(steps, p0.shape[-2], seed, p0.shape[:-2], device=dev)
    graph_steps = GRAPH_STEPS if dev.type == "cuda" else 0
    return ensemble_sample_draws(log_prob_fn, p0, draws, stretch_a, data, graph_steps)


def ensemble_sample_batch(log_prob_fn, p0, data, steps: int, seed: int = 0,
                          stretch_a: float = 2.0, device=None):
    """Independent ensembles over a leading problem axis B in one run.

    ``p0`` is (B, walkers, ndim); ``log_prob_fn(theta, data)`` scores
    (B, W', ndim) against per-problem ``data`` (its tensors carry the
    leading B axis) and returns (B, W'). Returns (chain (B, steps, walkers,
    ndim), log_probs (B, steps, walkers)).
    """
    chain, lps = ensemble_sample(log_prob_fn, p0, steps, seed, stretch_a, data, device)
    return chain.movedim(0, 1), lps.movedim(0, 1)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def summarize_chain(chain, log_probs, keys: list[str], burn: int = 0):
    """Posterior summaries matching CRIMP's reporting (fit_toas.py:192-202):
    median, 16/84-percentile deviations, MAP (host numpy)."""
    chain, log_probs = _np(chain), _np(log_probs)
    n_steps = chain.shape[0]
    if burn >= n_steps:
        raise ValueError(
            f"burn ({burn}) must be smaller than the number of recorded "
            f"steps ({n_steps}); nothing would be left to summarize"
        )
    flat = chain[burn:].reshape(-1, chain.shape[-1])
    flat_lp = log_probs[burn:].reshape(-1)
    i_map = int(np.argmax(flat_lp))
    summaries = {}
    for i, name in enumerate(keys):
        q16, q50, q84 = np.percentile(flat[:, i], [16, 50, 84])
        summaries[name] = {
            "median": float(q50),
            "minus": float(q50 - q16),
            "plus": float(q84 - q50),
            "map": float(flat[i_map, i]),
        }
    return flat, flat_lp, summaries


def effective_sample_size(chain, c: float = 5.0):
    """Autocorrelation-time effective sample size (host numpy).

    ``chain`` is (steps,), (steps, walkers) or (steps, walkers, ndim). Per
    dimension, the normalized autocorrelation function is averaged across
    walkers (each walker demeaned by the ensemble mean), the integrated
    autocorrelation time is ``tau = 1 + 2 * sum_{t>=1} rho(t)`` with Sokal's
    automatic windowing (smallest M with M >= c * tau(M)), and ESS = total
    samples / tau. Returns a scalar for 1-D/2-D input, an (ndim,) vector for
    3-D input.
    """
    x = np.asarray(_np(chain), dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim == 2:
        return float(_ess_one(x, c))
    if x.ndim != 3:
        raise ValueError(f"chain must be 1-D, 2-D or 3-D, got shape {x.shape}")
    return np.array([_ess_one(x[:, :, d], c) for d in range(x.shape[2])])


def _ess_one(x: np.ndarray, c: float) -> float:
    """ESS for one (steps, walkers) scalar chain."""
    n_steps, n_walkers = x.shape
    total = n_steps * n_walkers
    if n_steps < 2:
        return float(total)
    y = x - x.mean(axis=0, keepdims=True)
    # FFT autocovariance per walker, averaged across the ensemble
    n_fft = 1
    while n_fft < 2 * n_steps:
        n_fft *= 2
    f = np.fft.rfft(y, n=n_fft, axis=0)
    acov = np.fft.irfft(f * np.conjugate(f), n=n_fft, axis=0)[:n_steps].real
    acov = acov.mean(axis=1) / n_steps
    if acov[0] <= 0.0:
        return float(total)  # constant chain: every sample identical
    rho = acov / acov[0]
    # Sokal window: cumulative tau, stop at the smallest M >= c * tau(M)
    taus = 2.0 * np.cumsum(rho) - 1.0
    window = np.arange(len(taus))
    hit = np.nonzero(window >= c * taus)[0]
    m = int(hit[0]) if hit.size else len(taus) - 1
    tau = max(float(taus[m]), 1.0)
    return float(total / tau)
