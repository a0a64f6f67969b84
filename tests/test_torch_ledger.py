"""The performance ledger (crimp_tpu_torch.obs.ledger) against
crimp_tpu.obs.ledger.

- the same bench records, driver records, bench logs and obs manifests give
  the same entries (but the port's ``device_kind`` field), classes,
  baselines and check reports, when every record is of one platform;
- the deliberate difference: a baseline belongs to one platform and card,
  so a TPU-platform record never seeds or gates a card's baseline (class
  ``other_platform`` in the check);
- ``python -m crimp_tpu_torch.obs ledger add|show|check`` and the
  CRIMP_TORCH_OBS_LEDGER knob.
"""

import json

import pytest

from crimp_tpu.obs import ledger as jax_ledger
from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import cli, ledger

KIND = "NVIDIA H100 80GB HBM3"


def record(round_n, platform="tpu", **metrics):
    rec = {"metric": "toa_extraction_throughput", "value": metrics.pop("toas_per_sec", 10.0), "platform": platform}
    rec.update(metrics)
    return rec


def strip(entries):
    return [{k: v for k, v in e.items() if k != "device_kind"} for e in entries]


@pytest.fixture()
def artifacts(tmp_path):
    """One platform's worth of records: driver records with a sibling bench
    log, a bare bench record, a failed and a carried round, a CPU-fallback
    round and a degraded manifest."""
    paths = []
    for n, rec, rc in ((1, None, 1), (2, record(2, toas_per_sec=12.0, north_star_wall_s=9.0), 0),
                       (3, record(3, toas_per_sec=11.0, north_star_wall_s=9.5, carried=True), 0),
                       (4, record(4, platform="cpu", platform_fallback=True), 0),
                       (5, record(5, toas_per_sec=11.5, north_star_wall_s=12.0), 0)):
        path = tmp_path / f"BENCH_r{n:02d}.json"
        path.write_text(json.dumps({"n": n, "cmd": "bench", "rc": rc, "parsed": rec}))
        paths.append(str(path))
    log_dir = tmp_path / "onchip_results_r2"
    log_dir.mkdir()
    (log_dir / "bench.log").write_text("noise\n" + json.dumps(record(2, toas_per_sec=12.5)) + "\n")
    bare = tmp_path / "bench_record_r6.json"
    bare.write_text(json.dumps(record(6, toas_per_sec=13.0)))
    paths.append(str(bare))
    return paths


@pytest.fixture()
def manifests(tmp_path, monkeypatch):
    """Port manifests: one clean run, one degraded, both stamped with a TPU
    backend so both ledgers read one platform."""
    monkeypatch.setenv("CRIMP_TORCH_OBS", "1")
    monkeypatch.setenv("CRIMP_TORCH_OBS_DIR", str(tmp_path / "obs"))
    out = []
    for degraded in (False, True):
        with obs.run("ledgered"):
            if degraded:
                obs.mark_degraded("grid:exact")
        doc = json.load(open(obs.last_manifest_path()))
        doc["platform"]["backend"] = "tpu"
        path = tmp_path / f"run_r{7 + degraded}.manifest.json"
        path.write_text(json.dumps(doc))
        out.append(str(path))
    return out


class TestParity:
    def test_same_entries_classes_baselines_and_checks(self, artifacts, manifests):
        port, ref = [], []
        for path in artifacts + manifests:
            port += ledger.entries_from_path(path)
            ref += jax_ledger.entries_from_path(path)
        assert strip(port) == ref
        assert [e["class"] for e in port] == [e["class"] for e in ref]
        assert ledger.baseline(port) == jax_ledger.baseline(ref)
        for tol in (5.0, 0.5):
            assert ledger.check(port, tolerance_pct=tol) == jax_ledger.check(ref, tolerance_pct=tol)
        report = ledger.check(port)
        assert report["candidate"]["round"] == 7 and report["ok"]  # the clean manifest, run_r7
        assert {e["class"] for e in report["excluded"]} == {"failed", "carried", "cpu_fallback", "degraded"}
        assert ledger.render_check(report) == jax_ledger.render_check(jax_ledger.check(ref))

    def test_regression_is_flagged_alike(self, tmp_path):
        entries = [ledger.entry_from_record(record(1, toas_per_sec=10.0), source="a", round_n=1),
                   ledger.entry_from_record(record(2, toas_per_sec=8.0), source="b", round_n=2)]
        ref = [jax_ledger.entry_from_record(record(1, toas_per_sec=10.0), source="a", round_n=1),
               jax_ledger.entry_from_record(record(2, toas_per_sec=8.0), source="b", round_n=2)]
        got = ledger.check(entries)
        assert got == jax_ledger.check(ref) and not got["ok"]
        assert got["regressions"][0]["metric"] == "toas_per_sec"


class TestPerPlatformBaseline:
    def test_a_tpu_record_stays_out_of_a_card_baseline(self):
        tpu = ledger.entry_from_record(record(1, toas_per_sec=100.0), source="BENCH_r01.json", round_n=1)
        card = ledger.entry_from_record(record(2, platform="cuda", device_kind=KIND, toas_per_sec=20.0),
                                        source="card.json", round_n=2)
        assert card["device_kind"] == KIND and tpu["device_kind"] is None
        report = ledger.check([tpu, card])
        assert report["ok"] and report["regressions"] == []
        assert {"source": "BENCH_r01.json", "round": 1, "class": "other_platform"} in report["excluded"]
        assert ledger.baseline([tpu, card], "cuda", KIND) == {
            "toas_per_sec": {"value": 20.0, "round": 2, "source": "card.json"}}
        # the JAX ledger, one vocabulary for every accelerator, gates them together
        ref = [jax_ledger.entry_from_record(record(1, toas_per_sec=100.0), source="BENCH_r01.json", round_n=1),
               jax_ledger.entry_from_record(record(2, platform="cuda", toas_per_sec=20.0), source="card.json",
                                            round_n=2)]
        assert not jax_ledger.check(ref)["ok"]

    def test_another_card_kind_is_another_baseline(self):
        a = ledger.entry_from_record(record(1, platform="cuda", device_kind="NVIDIA A100", toas_per_sec=50.0),
                                     source="a", round_n=1)
        b = ledger.entry_from_record(record(2, platform="cuda", device_kind=KIND, toas_per_sec=20.0), source="b",
                                     round_n=2)
        assert ledger.check([a, b])["ok"]

    def test_card_manifests_carry_their_kind(self, manifests, tmp_path):
        doc = json.load(open(manifests[0]))
        doc["platform"] = {"backend": "cuda", "devices": [{"id": 0, "platform": "gpu", "kind": KIND}]}
        path = tmp_path / "card.manifest.json"
        path.write_text(json.dumps(doc))
        (entry,) = ledger.entries_from_path(str(path))
        assert (entry["class"], entry["platform"], entry["device_kind"]) == ("onchip", "cuda", KIND)


class TestCli:
    def test_add_show_check(self, artifacts, tmp_path, capsys, monkeypatch):
        path = str(tmp_path / "ledger.jsonl")
        assert cli.main(["ledger", "add", *artifacts, "--ledger", path]) == 0
        assert "appended" in capsys.readouterr().out
        assert len(ledger.read(path)) == len(artifacts) + 1  # r2's sibling bench log
        assert cli.main(["ledger", "show", "--ledger", path]) == 0
        assert "baseline toas_per_sec" in capsys.readouterr().out
        assert cli.main(["ledger", "check", "--ledger", path, "--format", "json"]) == 0
        assert json.loads(capsys.readouterr().out)["ok"]
        monkeypatch.setenv("CRIMP_TORCH_OBS_LEDGER", path)
        assert ledger.env_ledger_path() == path
        assert cli.main(["ledger", "check", "--fail-on-regression"]) == 0
        monkeypatch.setenv("CRIMP_TORCH_OBS_LEDGER", "off")
        assert ledger.env_ledger_path() is None
        assert cli.main(["ledger", "add", artifacts[0]]) == 2
        assert cli.main(["ledger", "add", "--ledger", path]) == 2
        capsys.readouterr()

    def test_append_bench_record_follows_the_knob(self, tmp_path, monkeypatch):
        monkeypatch.delenv("CRIMP_TORCH_OBS_LEDGER", raising=False)
        assert ledger.append_bench_record(record(1), source="x") is None
        path = str(tmp_path / "l.jsonl")
        monkeypatch.setenv("CRIMP_TORCH_OBS_LEDGER", path)
        assert ledger.append_bench_record(record(1), source="x", round_n=1) == path
        assert ledger.read(path)[0]["class"] == "onchip"
