"""Checkpointed, resumable periodicity scans.

Port of ``crimp_tpu/ops/resumable.py``. The trial axis of a scan is
embarrassingly parallel, so a long scan is a sequence of independent trial
chunks: each chunk's result is persisted as it completes, and a restart
recomputes only the missing ones.

Layout of a checkpoint store (a directory):

    manifest.json   problem fingerprint (event hash, grid, nharm, fdots,
                    chunking, the port's kernel version, the pinned numeric
                    mode); resume refuses a store whose fingerprint does not
                    match, so stale chunks never mix into another problem
    chunk_00042.npy power rows of trial chunk 42, shape (n_rows, k)

Chunks and the manifest are written atomically (tmp + rename).

Chunked is bitwise the whole scan. The launch plan (K2's or K3's event
split length) depends on the trial count, and it sets the rounding, so the
scan resolves one plan, for the whole grid, through
``autotune.resolve_blocks``, pins it in the store and passes it to every
chunk. Each chunk of a uniform grid is computed as the whole grid's trial
tiles that cover it (``tile0``: K2's tile frequencies are the whole grid's,
f0 + tile * 256 * df), then sliced; K3's trials do not depend on the trials
beside them. So a resumed scan equals the uninterrupted one bit for bit,
and both equal ``PeriodSearch`` under the same plan.

Every numeric mode is pinned in the store: trig mode, fast path, launch
plan, grid_mxu, delta_fold, mcmc_delta and the event-shard count. A store
whose modes differ only by a resolved preference (an env knob, a re-tuned
plan) adopts the store's modes, visibly; an explicit conflicting choice
refuses. Chunk computation
retries through ``resilience.retry_call`` at point ``scan_chunk`` (a
``KernelError`` never retries), and every finished chunk beats the
heartbeat. On a job with several devices a scan of at least
``search.MIN_SHARD_PAIRS`` (trial, event) pairs runs every chunk through
``parallel.mesh``'s twins (``auto_mesh``, decided once for the whole grid)
with the same pinned plan and tile offset, so sharded chunks are bitwise
the whole sharded scan, and bitwise the one-device scan where each event
shard holds whole splits. A store resumed with another event-shard count
refuses: a chunk's sums can round with that count.
"""

from __future__ import annotations

import hashlib
import json
import logging
import pathlib

import numpy as np
import torch

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.ops import fasttrig
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.device import resolve_device

CHUNK_TRIALS = 50_000
# The kernel-semantics version of a store: the port's own, so a store that
# crimp_tpu wrote (version 3) is refused rather than mixed in.
KERNEL_VERSION = "crimp_tpu_torch-1"


def _fingerprint(times: np.ndarray, freqs: np.ndarray, fdots: np.ndarray, nharm: int, chunk_trials: int,
                 fddots=None, semicoherent: int = 0) -> dict:
    t = np.ascontiguousarray(np.asarray(times, dtype=np.float64))
    fp = {
        "version": KERNEL_VERSION,
        "n_events": int(t.shape[0]),
        "events_sha256": hashlib.sha256(t.tobytes()).hexdigest(),
        "n_freq": int(len(freqs)),
        "f_first": float(freqs[0]),
        "f_last": float(freqs[-1]),
        # the whole grid, not just its ends: a non-uniform grid sharing them
        # with a uniform one is a different problem
        "freqs_sha256": hashlib.sha256(
            np.ascontiguousarray(np.asarray(freqs, dtype=np.float64)).tobytes()).hexdigest(),
        "fdots": [float(f) for f in np.atleast_1d(fdots)],
        "nharm": int(nharm),
        "chunk_trials": int(chunk_trials),
    }
    if fddots is not None:
        fp["fddots"] = [float(f) for f in np.atleast_1d(fddots)]
    if semicoherent:
        fp["semicoherent"] = int(semicoherent)
    return fp


class ResumableScan:
    """Z^2_n (or H) over a (fdot x frequency) grid, checkpointed per trial chunk.

    ``fdots=None`` gives the 1-D scan (squeezed on return); ``fddots``
    extends it to the (fddot x fdot x freq) cube, and ``semicoherent=S``
    computes each cube chunk as the S-segment incoherent stack (uniform grid
    required). ``statistic="h"`` is the 1-D H-test. ``store=None`` disables
    checkpointing. ``device`` (default cuda) runs the kernels. Usage::

        scan = ResumableScan(times_sec, freqs, nharm=2, store="ckpt_dir")
        power = scan.run()      # computes missing chunks, returns (n_freq,)
    """

    def __init__(self, times, freqs, nharm: int = 2, fdots=None, fddots=None, store: str | None = None,
                 chunk_trials: int = CHUNK_TRIALS, poly: bool | None = None, statistic: str = "z2",
                 semicoherent: int = 0, device=None):
        if statistic not in ("z2", "h"):
            raise ValueError(f"statistic must be 'z2' or 'h', got {statistic!r}")
        if statistic == "h" and (fdots is not None or fddots is not None):
            raise ValueError("the H-test scan is 1-D (fdots/fddots unsupported)")
        if semicoherent and fddots is None:
            raise ValueError("semicoherent stacking is the cube scan's mode (pass fddots)")
        from crimp_tpu_torch.ops import autotune, search

        self.times = np.asarray(times, dtype=np.float64)
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.nharm = int(nharm)
        self.statistic = statistic
        self._squeeze = fdots is None and fddots is None
        self.fdots = np.zeros(1) if fdots is None else np.atleast_1d(np.asarray(fdots, dtype=np.float64))
        self.fddots = None if fddots is None else np.atleast_1d(np.asarray(fddots, dtype=np.float64))
        self.semicoherent = int(semicoherent)
        self.chunk_trials = int(chunk_trials)
        self.device = resolve_device(device)
        self._grid = search.uniform_grid(self.freqs)
        if self.semicoherent and self._grid is None:
            raise ValueError("semi-coherent scans need a uniform frequency grid")

        # Every numeric-mode knob resolves now and is pinned in the store:
        # chunks of different modes never mix into one power array.
        self._poly_explicit = poly is not None
        self.poly = fasttrig.poly_trig_enabled(poly, self.device)
        self._fastpath = self._grid is not None and search.grid_fastpath_enabled(self.nharm)
        n_rows = len(self.fdots) * (1 if self.fddots is None else len(self.fddots))
        self._mxu_explicit = knobs.env_nonneg_int(autotune.GRID_MXU_ENV, valid=(0, 1)) is not None
        if self._fastpath:
            cube = self.fddots is not None
            self._mxu, self._mxu_reseed, self._mxu_bf16 = search.resolve_grid_mxu(
                None, None, None, len(self.times), len(self.freqs) * (n_rows if cube else 1), self.poly, cube,
                device=self.device)
        else:
            self._mxu, self._mxu_reseed, self._mxu_bf16 = False, autotune.GRID_MXU_RESEED_DEFAULT, False
        self._kernel = self._plan_kernel()
        # one launch plan, resolved at the whole grid's size, for every chunk
        n_plan_events = len(self.times)
        if self.semicoherent:
            from crimp_tpu_torch.ops import semicoherent as semi

            n_plan_events = semi.split_segments(self.times, self.semicoherent)[0].shape[1]
        self._blocks = autotune.resolve_blocks(self._kernel, n_plan_events, len(self.freqs) * n_rows, self.poly,
                                               n_rows=n_rows, nharm=self.nharm, device=self.device)
        self._blocks_explicit = autotune.env_blocks_override(self._kernel) is not None
        self._deltafold_explicit = knobs.env_nonneg_int(autotune.DELTA_FOLD_ENV, valid=(0, 1)) is not None
        r = autotune.resolve_delta_fold(len(self.times), device=self.device)
        self._delta_fold = bool(r["delta_fold"])
        self._delta_fold_budget = float(r["budget"])
        # one sharding decision, at the whole grid's size, for every chunk
        self._shard_mesh = self._resolve_mesh(n_rows)
        self._numeric_mode = {
            "poly_trig": bool(self.poly),
            "grid_fastpath": bool(self._fastpath),
            "grid_blocks": list(self._blocks),
            "grid_mxu": [int(self._mxu), self._mxu_reseed, int(self._mxu_bf16)],
            "delta_fold": [int(self._delta_fold), self._delta_fold_budget],
            # the delta-basis MCMC never runs inside a scan, but it shares the
            # session's numeric-mode fingerprint
            "mcmc_delta": [int(autotune.resolve_mcmc_delta(len(self.times), device=self.device)["mcmc_delta"])],
            "event_shards": self._event_shards(),
        }
        self._times_dev = None
        self.store = pathlib.Path(store) if store is not None else None
        self.n_chunks = -(-len(self.freqs) // self.chunk_trials)
        if self.store is not None:
            self._open_store()

    def _plan_kernel(self) -> str:
        if not self._fastpath:
            return "general"
        if self._mxu:
            return "grid_mxu"
        if self.semicoherent:
            return "semicoherent"
        return "grid3d" if self.fddots is not None else "grid"

    # -- store management ---------------------------------------------------

    def _open_store(self) -> None:
        from crimp_tpu_torch.ops import autotune

        fp = _fingerprint(self.times, self.freqs, self.fdots, self.nharm, self.chunk_trials,
                          fddots=self.fddots, semicoherent=self.semicoherent)
        fp["statistic"] = self.statistic
        fp["numeric_mode"] = self._numeric_mode
        manifest = self.store / "manifest.json"
        if not manifest.exists():
            self.store.mkdir(parents=True, exist_ok=True)
            tmp = manifest.with_suffix(".json.tmp")
            tmp.write_text(json.dumps(fp, indent=2))
            tmp.rename(manifest)
            return
        existing = json.loads(manifest.read_text())
        if existing == fp:
            return
        # Same problem and kernel version, but a preference resolved another
        # way (an env knob, a re-tuned plan): adopt the store's pinned modes
        # so its chunks stay usable. Anything else, or an explicit choice
        # that conflicts with the store, refuses.
        mode = existing.get("numeric_mode", {})
        store_blocks = mode.get("grid_blocks")
        blocks_ok = (isinstance(store_blocks, list) and len(store_blocks) == 2
                     and all(isinstance(b, int) and b > 0 for b in store_blocks))
        store_mxu = mode.get("grid_mxu", [0, autotune.GRID_MXU_RESEED_DEFAULT, 0])
        mxu_ok = (isinstance(store_mxu, list) and len(store_mxu) == 3 and store_mxu[0] in (0, 1)
                  and store_mxu[2] in (0, 1) and isinstance(store_mxu[1], int) and store_mxu[1] > 0)
        store_df = mode.get("delta_fold", [0, autotune.DELTA_FOLD_BUDGET_DEFAULT])
        df_ok = (isinstance(store_df, list) and len(store_df) == 2 and store_df[0] in (0, 1)
                 and isinstance(store_df[1], (int, float)) and 0.0 < store_df[1] < float("inf"))
        adoptable = (
            {k: v for k, v in existing.items() if k != "numeric_mode"}
            == {k: v for k, v in fp.items() if k != "numeric_mode"}
            and "poly_trig" in mode and "grid_fastpath" in mode and blocks_ok
            and not (self._poly_explicit and bool(mode.get("poly_trig")) != self.poly)
            and not (self._blocks_explicit and store_blocks != list(self._blocks))
            and mxu_ok and not (self._mxu_explicit and bool(store_mxu[0]) != self._mxu)
            and df_ok and not (self._deltafold_explicit and bool(store_df[0]) != self._delta_fold)
        )
        if mode.get("event_shards", 1) != self._event_shards():
            raise ValueError(f"checkpoint store {self.store} was written with {mode.get('event_shards', 1)} event "
                             f"shard(s) per chunk and this job makes {self._event_shards()}; a chunk's sums can "
                             "round with its shard count, so resume with the store's devices (parallel.mesh; "
                             "CRIMP_TORCH_SHARD) or use a fresh store directory")
        if not adoptable:
            raise ValueError(f"checkpoint store {self.store} belongs to a different problem (manifest "
                             "fingerprint mismatch); refusing to mix chunks — use a fresh store directory")
        logging.getLogger(__name__).warning(
            "resuming %s with the store's pinned numeric mode %s (freshly resolved preferences were %s)",
            self.store, mode, self._numeric_mode)
        self.poly = bool(mode["poly_trig"])
        self._fastpath = bool(mode["grid_fastpath"])
        self._blocks = (int(store_blocks[0]), int(store_blocks[1]))
        self._mxu, self._mxu_reseed, self._mxu_bf16 = bool(store_mxu[0]), int(store_mxu[1]), bool(store_mxu[2])
        self._kernel = self._plan_kernel()
        self._delta_fold = bool(store_df[0])
        self._delta_fold_budget = float(store_df[1])
        self._numeric_mode = mode

    def _chunk_path(self, i: int) -> pathlib.Path:
        return self.store / f"chunk_{i:05d}.npy"

    def done_chunks(self) -> list[int]:
        if self.store is None:
            return []
        return sorted(int(p.stem.split("_")[1]) for p in self.store.glob("chunk_*.npy"))

    # -- compute ------------------------------------------------------------

    def _times_device(self) -> torch.Tensor:
        """The events on the device, copied once per instance."""
        if self._times_dev is None:
            self._times_dev = torch.as_tensor(self.times).to(self.device)
        return self._times_dev

    def _stream(self) -> bool:
        """Whether fast-path chunks stream the events to the card
        (CRIMP_TORCH_STREAM_MIN_EVENTS governs; bitwise either way, the
        streamed chunk length being the pinned split length)."""
        from crimp_tpu_torch.ops import search

        if not self._fastpath or self.fddots is not None:
            return False
        threshold = search.stream_min_events()
        return threshold is not None and len(self.times) >= threshold

    def _n_rows(self) -> int:
        if self.statistic == "h":
            return 1
        return len(self.fdots) * (1 if self.fddots is None else len(self.fddots))

    def _load_chunk(self, i: int) -> np.ndarray | None:
        """A checkpointed chunk's rows, validated, or None after quarantining
        a torn one (recomputed, never concatenated)."""
        path = self._chunk_path(i)
        lo = i * self.chunk_trials
        width = min(self.chunk_trials, len(self.freqs) - lo)
        try:
            faultinject.fire("scan_chunk")
            arr = np.load(path, allow_pickle=False)
        except (OSError, ValueError, EOFError, resilience.CacheCorruptError):
            resilience.quarantine_file(path, label="scan_chunk")
            return None
        if arr.ndim != 2 or arr.shape != (self._n_rows(), width) or not np.issubdtype(arr.dtype, np.floating):
            resilience.quarantine_file(path, label="scan_chunk")
            return None
        return arr

    def _uniform_kw(self) -> dict:
        kw = {"poly": self.poly, "mxu": self._mxu, "reseed": self._mxu_reseed, "mxu_bf16": self._mxu_bf16}
        if self._mxu:
            kw["mxu_blocks"] = tuple(self._blocks)
        else:
            kw["per_split"] = int(self._blocks[0])
        return kw

    def _resolve_mesh(self, n_rows: int):
        """The auto-sharding mesh of every chunk, mirroring
        ``PeriodSearch._mesh`` at the whole grid's size (None below
        ``search.MIN_SHARD_PAIRS`` pairs, on one device, and for
        semi-coherent scans, which drive their own dispatch)."""
        from crimp_tpu_torch.ops.search import MIN_SHARD_PAIRS
        from crimp_tpu_torch.parallel import mesh as pmesh

        if self.semicoherent or len(self.times) * len(self.freqs) * n_rows < MIN_SHARD_PAIRS:
            return None
        return pmesh.auto_mesh(device=self.device)

    def _event_shards(self) -> int:
        from crimp_tpu_torch.parallel import mesh as pmesh

        return 1 if self._shard_mesh is None else int(self._shard_mesh.shape.get(pmesh.EVENT_AXIS, 1))

    def _sum_rows(self):
        """(fdots, fddots) of a chunk's trig sums: the scan's rows, or the
        single zero-fdot row of a 1-D scan and of the H-test."""
        if self.statistic == "h" or self._squeeze:
            return (0.0,), None
        return self.fdots, self.fddots

    def _rows(self, c: torch.Tensor, s: torch.Tensor, cut: slice) -> torch.Tensor:
        """The chunk's (n_rows, k) Z^2 or (1, k) H rows from its f64 trig
        sums (each (n_fddot, n_fdot, nharm, n) with the chunk's trials at
        ``cut``), formed as the one-device wrappers form them, whichever
        path (one device, the mesh's twins, streamed) gave the sums."""
        from crimp_tpu_torch.ops import search

        n = len(self.times)
        if self.statistic == "h":
            rows = search.h_from_sums(c[0, 0], s[0, 0], n, dim=0)[None, :]
        elif self.fddots is not None:
            rows = torch.sum(search.z2_from_sums(c, s, n), dim=2)
        elif self._squeeze:
            rows = torch.sum(search.z2_from_sums(c[0, 0], s[0, 0], n), dim=0)[None, :]
        else:
            rows = torch.sum(search.z2_from_sums(c[0], s[0], n), dim=1)
        return rows[..., cut].reshape(-1, cut.stop - cut.start)

    def _compute_chunk_device(self, i: int) -> torch.Tensor:
        """(n_rows, k) Z^2 (or (1, k) H) rows of trial chunk i, on the
        device. A uniform chunk is the whole grid's trial tiles that cover
        it (``tile0``), sliced; a non-uniform chunk is its own trials. The
        sums come from the mesh's twins when the scan shards
        (``_shard_mesh``), else from the one-device path, under the same
        pinned plan."""
        from crimp_tpu_torch.ops import search
        from crimp_tpu_torch.parallel import mesh as pmesh

        faultinject.fire("scan_chunk")
        lo = i * self.chunk_trials
        chunk = self.freqs[lo:lo + self.chunk_trials]
        k = len(chunk)
        per_split = int(self._blocks[0])
        dev, mesh = self.device, self._shard_mesh
        fdots, fddots = self._sum_rows()
        if not self._fastpath:
            fdd = (0.0,) if fddots is None else fddots
            if mesh is not None:
                c, s = pmesh.general_sums_sharded(self.times, chunk, fdots, fdd, self.nharm, mesh, None, self.poly,
                                                  per_split)
            else:
                c, s = search.general_harmonic_sums(self._times_device(), chunk, fdots, fdd, self.nharm,
                                                    poly=self.poly, device=dev, per_split=per_split)
            return self._rows(c, s, slice(0, k))
        f0, df = self._grid
        tile = int(self._blocks[1])
        tile0 = lo // tile
        off = lo - tile0 * tile
        n_cover = off + k
        cut = slice(off, off + k)
        if self.semicoherent:
            from crimp_tpu_torch.ops import semicoherent as semi

            rows = semi.semicoherent_z2_grid(self.times, f0, df, n_cover, self.fdots, self.fddots,
                                             nharm=self.nharm, n_segments=self.semicoherent, poly=self.poly,
                                             mxu=self._mxu, reseed=self._mxu_reseed, mxu_bf16=self._mxu_bf16,
                                             device=dev, per_split=None if self._mxu else per_split,
                                             tile0=tile0)
            return rows[..., cut].reshape(-1, k)
        if mesh is not None:
            c, s = pmesh.grid_sums_sharded(self.times, f0, df, n_cover, fdots, fddots, self.nharm, mesh,
                                           self.poly, self._mxu, self._mxu_reseed, self._mxu_bf16,
                                           None if self._mxu else per_split, tile0,
                                           mxu_blocks=tuple(self._blocks) if self._mxu else None)
        elif fddots is None and self._stream():
            c, s = search.harmonic_sums_grid_streamed(self.times, f0, df, n_cover, self.nharm, fdots=fdots,
                                                      poly=self.poly, mxu=self._mxu, reseed=self._mxu_reseed,
                                                      mxu_bf16=self._mxu_bf16, event_chunk=per_split,
                                                      tile0=tile0, device=dev)
        else:
            # the resilience ladder where the one-device wrapper has one:
            # every statistic but the 2-D Z^2 (as in the JAX package)
            ladder = self.statistic == "h" or self._squeeze or fddots is not None
            c, s = search.harmonic_sums_3d_grid(self._times_device(), f0, df, n_cover, fdots, fddots, self.nharm,
                                                device=dev, tile0=tile0, ladder=ladder, **self._uniform_kw())
        return self._rows(c, s, cut)

    def _finish_chunk(self, i: int, rows_dev, parts, progress) -> None:
        """Bring one computed chunk to the host and checkpoint it atomically."""
        from crimp_tpu_torch.ops import z2_grid

        rows = np.ascontiguousarray(z2_grid.to_host(rows_dev, "scan_chunk"))
        if self.store is not None:
            tmp = self._chunk_path(i).with_suffix(".npy.tmp")
            with open(tmp, "wb") as fh:  # np.save(path) would append .npy
                np.save(fh, rows)
            tmp.rename(self._chunk_path(i))
        parts[i] = rows
        obs.counter_add("chunks_computed", 1)
        if progress is not None:
            progress(i, self.n_chunks)

    def run(self, progress=None) -> np.ndarray:
        """Compute all missing chunks (checkpointing each) and return the
        (n_fdot, n_freq) power, (n_fddot, n_fdot, n_freq) for the cube, or
        (n_freq,) for the 1-D scan. ``progress(i, n_chunks)`` follows each
        checkpointed chunk.

        Pipelined: chunk i+1's kernels are launched before chunk i is
        brought to the host and written, so the card computes while the host
        serializes. When a chunk's computation fails, the chunk before it is
        still written before the failure propagates, so a resume finds every
        chunk that finished."""
        with obs.run("resumable_scan", statistic=self.statistic, n_chunks=self.n_chunks):
            obs.record_numeric_mode(self._numeric_mode)
            done = set(self.done_chunks())
            obs.counter_add("chunks_resumed", len(done))
            obs.counter_add("chunks_computed", 0)
            progress = obs.heartbeat.scan_progress(base=len(done), total=self.n_chunks,
                                                   label=f"{self.statistic}_chunks", echo=progress)
            parts: list[np.ndarray | None] = [None] * self.n_chunks
            pending: tuple[int, object] | None = None
            with obs.span("chunk_loop", kind="stage"):
                for i in range(self.n_chunks):
                    if i in done:
                        arr = self._load_chunk(i)
                        if arr is not None:
                            parts[i] = arr
                            continue
                        # a torn chunk was quarantined: recompute it
                    try:
                        rows_dev = resilience.retry_call(lambda i=i: self._compute_chunk_device(i),
                                                         point="scan_chunk")
                    except BaseException:
                        if pending is not None:
                            self._finish_chunk(pending[0], pending[1], parts, progress)
                        raise
                    if pending is not None:
                        self._finish_chunk(pending[0], pending[1], parts, progress)
                    pending = (i, rows_dev)
                if pending is not None:
                    self._finish_chunk(pending[0], pending[1], parts, progress)
            power = np.concatenate(parts, axis=1)
            if self.fddots is not None:
                power = power.reshape(len(self.fddots), len(self.fdots), -1)
            return power[0] if self._squeeze else power
