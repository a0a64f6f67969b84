"""The port's sharding registry (crimp_tpu_torch.parallel.registry) and the
sharded cost rows.

- the rule table is crimp_tpu's: the same seven kernels, axis names,
  params and reduce axes, each PartitionSpec read as a plain tuple;
- an unregistered kernel or param raises ``KeyError``;
- ``collective_bytes`` is JAX's ring estimate, 2(k - 1)/k * B per shard,
  by hand (tests/test_parallel.py's hand math) and equal to crimp_tpu's
  on the same mesh; ``dcn_axes`` and the ici/dcn split classify stub
  multi-process meshes as crimp_tpu's;
- a sharded dispatch inside an obs run lands a cost row with ``devices``
  the shard count, ``cards`` the distinct devices, ``sharded`` true and the
  registry's collective bytes; ``obs roofline`` renders the rows, scales a
  card's share by the shards it ran, and gives the aggregate roof over
  the cards.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from crimp_tpu.parallel import mesh as jax_pmesh  # noqa: E402
from crimp_tpu.parallel import registry as jax_registry  # noqa: E402
from crimp_tpu_torch.obs import costmodel  # noqa: E402
from crimp_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from crimp_tpu_torch.parallel import registry  # noqa: E402

torch.set_num_threads(2)

KERNELS = ("sharded_sums_general", "sharded_sums_grid", "sharded_sums_grid3d", "semicoherent_stack",
           "delta_refold_sharded", "stacked_fold", "segment_batch")


def _mesh(ev_par=4):
    return pmesh.build_mesh(["cpu"] * 8, event_parallel=ev_par)


def _stub_mesh(trials_span_processes: bool):
    def dev(proc):
        return SimpleNamespace(process_index=proc)

    if trials_span_processes:
        devices = np.array([[dev(0), dev(1)], [dev(0), dev(1)]])
    else:
        devices = np.array([[dev(0), dev(0)], [dev(1), dev(1)]])
    return SimpleNamespace(shape={"events": 2, "trials": 2}, axis_names=("events", "trials"), devices=devices)


def _outs():
    return [SimpleNamespace(shape=(2, 1, 8), dtype=np.float64), SimpleNamespace(shape=(2, 1, 8), dtype=np.float64)]


class TestRuleTable:
    def test_same_rules_as_jax(self):
        assert (registry.EVENT_AXIS, registry.TRIAL_AXIS, registry.SEGMENT_AXIS, registry.SOURCE_AXIS) == (
            jax_registry.EVENT_AXIS, jax_registry.TRIAL_AXIS, jax_registry.SEGMENT_AXIS, jax_registry.SOURCE_AXIS)
        assert len(registry.RULES) == len(jax_registry.RULES) == 7
        for mine, ref in zip(registry.RULES, jax_registry.RULES):
            assert mine.kernel == ref.kernel
            assert mine.reduce_axes == ref.reduce_axes
            assert [p for p, _ in mine.params] == [p for p, _ in ref.params]
            assert [tuple(s) for _, s in mine.params] == [tuple(s) for _, s in ref.params]
            assert [tuple(s) for s in mine.outs] == [tuple(s) for s in ref.outs]

    @pytest.mark.parametrize("kernel", KERNELS)
    def test_lookup_binds_the_same_row_as_jax(self, kernel):
        if kernel in ("semicoherent_stack", "segment_batch"):
            meshes = (pmesh.segment_mesh(["cpu"] * 8), jax_pmesh.segment_mesh(jax.devices()[:8]))
        elif kernel == "stacked_fold":
            meshes = (pmesh.source_mesh(["cpu"] * 8), jax_pmesh.source_mesh(jax.devices()[:8]))
        else:
            meshes = (_mesh(), jax_pmesh.build_mesh(jax.devices()[:8], event_parallel=4))
        mine = registry.specs_for(kernel, meshes[0])
        ref = jax_registry.specs_for(kernel, meshes[1])
        assert mine.rule.kernel == ref.rule.kernel
        assert mine.device_count() == ref.device_count() == 8
        assert mine.reduce_size() == ref.reduce_size()

    def test_general_specs(self):
        plan = registry.specs_for("sharded_sums_general", _mesh())
        assert plan.in_specs("times", "weights", "freqs", "fdots") == (
            ("events",), ("events",), ("trials",), (None,))
        assert plan.out_specs == ((None, None, "trials"), (None, None, "trials"))
        assert plan.device_count() == 8
        assert plan.reduce_size() == 4
        assert plan.named("freqs") == registry.Placement(plan.mesh, ("trials",))
        assert registry.leading_axis_sharding(plan.mesh, "segments") == registry.Placement(plan.mesh,
                                                                                          ("segments",))

    def test_unregistered_kernel_and_param_raise(self):
        with pytest.raises(KeyError, match="no rule matches"):
            registry.specs_for("mystery_kernel", _mesh())
        plan = registry.specs_for("sharded_sums_grid", _mesh())
        with pytest.raises(KeyError, match="freqs"):
            plan.spec("freqs")
        with pytest.raises(KeyError, match=r"'events': 4"):
            plan.spec("no_such_param")
        refold = registry.specs_for("delta_refold_sharded", _mesh())
        assert refold.spec("n_events", leaf=3.0) == registry.REPLICATED
        with pytest.raises(KeyError, match="n_events"):
            refold.spec("n_events")
        assert refold.out_specs == ("events",)


class TestCollectiveBytes:
    def test_hand_math_equals_jax(self):
        """8 shards at event_parallel=4: the reduce runs over k=4 event
        shards; each (2, 3, 300) f64 output is 14400 B globally, split
        2-way over trials -> 7200 B a shard; two outputs -> B = 14400; ring
        factor 2(k-1)/k = 1.5 -> 21600 B a shard, crimp_tpu's figure."""
        outs = [torch.empty((2, 3, 300), dtype=torch.float64)] * 2
        plan = registry.specs_for("sharded_sums_grid", _mesh(4))
        assert plan.collective_bytes(outs) == pytest.approx(21600.0)
        jax_plan = jax_registry.specs_for("sharded_sums_grid",
                                          jax_pmesh.build_mesh(jax.devices()[:8], event_parallel=4))
        jax_outs = [jax.ShapeDtypeStruct((2, 3, 300), np.float64)] * 2
        assert jax_plan.collective_bytes(jax_outs) == pytest.approx(plan.collective_bytes(outs))

    def test_data_parallel_kernels_move_nothing(self):
        plan = registry.specs_for("stacked_fold", pmesh.source_mesh(["cpu"] * 8))
        assert plan.reduce_size() == 1
        assert plan.collective_bytes([np.zeros((8, 64))]) == 0.0

    def test_event_reduce_stays_within_a_process_on_the_host_major_mesh(self):
        plan = registry.specs_for("sharded_sums_grid", _stub_mesh(trials_span_processes=True))
        assert plan.dcn_axes() == ("trials",)
        # per out: 128 B over 2 trial shards -> 64; B = 128; 2(2-1)/2 * 128 = 128
        assert plan.collective_bytes_split(_outs()) == {"ici": 128.0, "dcn": 0.0}
        jax_plan = jax_registry.specs_for("sharded_sums_grid", _stub_mesh(trials_span_processes=True))
        assert jax_plan.dcn_axes() == plan.dcn_axes()
        assert jax_plan.collective_bytes_split(_outs()) == plan.collective_bytes_split(_outs())

    def test_a_reduce_spanning_processes_lands_on_dcn(self):
        plan = registry.specs_for("sharded_sums_grid", _stub_mesh(trials_span_processes=False))
        assert plan.dcn_axes() == ("events",)
        assert plan.collective_bytes_split(_outs()) == {"ici": 0.0, "dcn": 128.0}

    def test_single_process_mesh_has_no_dcn_axes(self):
        plan = registry.specs_for("sharded_sums_grid", _mesh(4))
        assert plan.dcn_axes() == ()
        split = plan.collective_bytes_split(_outs())
        assert split["dcn"] == 0.0 and split["ici"] > 0.0


class TestShardedCostRows:
    @pytest.fixture()
    def obs_on(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
        monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path / "obs"))
        monkeypatch.setenv("CRIMP_TORCH_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
        monkeypatch.delenv("CRIMP_TORCH_OBS_HOST", raising=False)
        monkeypatch.delenv("CRIMP_TORCH_OBS_COST", raising=False)
        monkeypatch.delenv("CRIMP_TORCH_SHARD", raising=False)
        costmodel.reset_mem_cache()
        return tmp_path / "obs"

    def test_sharded_rows_in_the_manifest_and_the_roofline(self, obs_on, capsys):
        from crimp_tpu_torch import obs
        from crimp_tpu_torch.obs import cli, roofline
        from crimp_tpu_torch.ops import anchored, deltafold, multisource

        rng = np.random.RandomState(3)
        t = np.sort(rng.uniform(-40000.0, 40000.0, 3000))
        freqs = np.linspace(0.14315, 0.14325, 193)
        tm = {"PEPOCH": 58000.0, "F0": 0.1432, "F1": -1e-14}
        segs = [np.sort(58000.0 + 2.0 * i + rng.uniform(0.0, 1.5, 300)) for i in range(2)]
        ph, t_ref = anchored.fold_segments(tm, segs, delta_fold=0, device="cpu")
        anchor_idx = np.repeat(np.arange(2), [s.size for s in segs])
        delta = anchored.anchor_deltas(np.concatenate(segs), t_ref, anchor_idx)
        dp = np.zeros(deltafold.n_params(0))
        dp[0] = 3e-10
        tms = [{"PEPOCH": 58000.0, "F0": 0.14 + 0.003 * i, "F1": -1e-13} for i in range(8)]
        seg_lists = [[np.sort(rng.uniform(58000.0, 58002.0, 80))] for _ in range(8)]
        with pmesh.virtual_devices(["cpu"] * 8):
            mesh = pmesh.build_mesh(event_parallel=8)
            with obs.run("accept") as rec:
                pmesh.z2_sharded(t, freqs, nharm=2, mesh=mesh, trig_dtype=torch.float64)
                pmesh.z2_2d_sharded(t, np.linspace(0.1, 0.1001, 600), [0.0, -1e-13], nharm=2,
                                    mesh=pmesh.build_mesh(event_parallel=4))
                pmesh.delta_refold_sharded(tm, t_ref, np.concatenate(ph), delta, anchor_idx, dp)
                multisource.fold_sources(tms, seg_lists, device="cpu")
        doc = json.loads((obs_on / f"{rec.run_id}.manifest.json").read_text())
        rows = doc["costmodel"]
        for k in ("sharded_sums_general", "sharded_sums_grid", "delta_refold_sharded", "stacked_fold"):
            assert rows[k]["devices"] == 8, k
            assert rows[k]["sharded"] is True, k
        # two (1, 2, 193) f64 outputs, unsharded over trials (extent 1):
        # B = 2 * 1*2*193*8 bytes; ring factor 2(8-1)/8 = 1.75 (JAX's test)
        assert rows["sharded_sums_general"]["reduce_axes"] == ["events"]
        assert rows["sharded_sums_general"]["collective_bytes"] == pytest.approx(1.75 * 2 * (1 * 2 * 193 * 8))
        assert all(rows[k]["cards"] == 1 for k in ("sharded_sums_general", "delta_refold_sharded"))
        assert rows["sharded_sums_grid"]["collective_bytes"] > 0
        assert rows["delta_refold_sharded"]["collective_bytes"] == 0
        assert rows["stacked_fold"]["collective_bytes"] == 0
        assert doc["counters"]["mesh_sharded_calls"] >= 3
        assert cli.main(["roofline", str(obs_on / f"{rec.run_id}.manifest.json")]) == 0
        out = capsys.readouterr().out
        for k in ("sharded_sums_general", "delta_refold_sharded", "stacked_fold"):
            assert k in out, k
        # a CPU run records no platform; on the CPU table's peaks the rows
        # keep their shard count, and eight shards on one device make no
        # aggregate roof
        analysis = roofline.analyze({**doc, "platform": {"backend": "cpu"}})
        assert {r["name"]: r["devices"] for r in analysis["rows"]}["sharded_sums_general"] == 8
        assert analysis["aggregate"] is None

    def test_a_card_running_several_shards_does_their_work(self):
        """Per-shard counts times the shards a card ran, over the span: the
        share of a card that ran 4 shards is 4 rows' work; on 2 cards of 4
        shards each card ran 2, and the aggregate roof counts the cards."""
        from crimp_tpu_torch.obs import roofline

        def doc(devices, cards):
            row = {"flops": 1e9, "bytes_accessed": 1e6, "devices": devices, "cards": cards}
            return {"run_id": "r", "name": "run", "platform": {"backend": "cpu", "devices": []},
                    "spans": [{"name": "run", "kind": "run", "t0_s": 0.0, "dur_s": 1.0, "parent": None,
                               "thread": 0, "attrs": {}},
                              {"name": "k", "kind": "kernel", "t0_s": 0.1, "dur_s": 0.5, "parent": 0,
                               "thread": 0, "attrs": {}}],
                    "costmodel": {"k": row}}

        one = roofline.analyze(doc(4, 1))
        two = roofline.analyze(doc(4, 2))
        plain = roofline.analyze(doc(1, 1))
        assert one["rows"][0]["flops_per_s"] == pytest.approx(4 * plain["rows"][0]["flops_per_s"])
        assert two["rows"][0]["flops_per_s"] == pytest.approx(2 * plain["rows"][0]["flops_per_s"])
        assert one["rows"][0]["cards"] == 1 and one["aggregate"] is None
        assert two["aggregate"]["devices"] == 2
        assert "2-device aggregate roof" in roofline.render(two)

    def test_the_segment_sharded_fit_records_its_row(self, obs_on):
        """The fit auto-sharded on a 4-device job lands its ``toa_fit_batch``
        row with the shard count (the segment rule: no collective), as the
        one-batch fit on one device lands its own."""
        from crimp_tpu_torch import obs
        from crimp_tpu_torch.models.profiles import ProfileParams
        from crimp_tpu_torch.ops import toafit

        def f(v):
            return torch.tensor(v, dtype=torch.float64)

        tpl = ProfileParams(norm=f(10.0), amp=f([3.0]), loc=f([0.3]), wid=torch.zeros(1, dtype=torch.float64),
                            ph_shift=f(0.0), amp_shift=f(1.0))
        ph = np.random.RandomState(5).uniform(0.0, 1.0, (5, 64))
        args = ("fourier", tpl, ph, np.ones_like(ph, dtype=bool), np.full(5, 12.8),
                toafit.ToAFitConfig(ph_shift_res=50, n_brute=8, refine_iters=3))
        rows = {}
        for label, slots in (("one", 1), ("sharded", 4)):
            with pmesh.virtual_devices(["cpu"] * slots), obs.run(label) as rec:
                toafit.fit_toas_batch_auto(*args, device="cpu")
            rows[label] = json.loads((obs_on / f"{rec.run_id}.manifest.json").read_text())["costmodel"]
        assert rows["one"]["toa_fit_batch"]["devices"] == 1 and rows["one"]["toa_fit_batch"]["sharded"] is False
        row = rows["sharded"]["toa_fit_batch"]
        assert row["devices"] == 4 and row["sharded"] is True and row["collective_bytes"] == 0
