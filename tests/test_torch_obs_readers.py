"""The port's flight-recorder readers (crimp_tpu_torch.obs.{manifest,
report, salvage, merge, cli}) against crimp_tpu.obs's, on the same
manifests and event streams, written by either package.

Outputs are equal field for field: ``validate_manifest`` on valid and
corrupted documents, ``span_paths``, ``span_rollup``, ``summarize``,
``diff`` / ``render_diff``, ``chrome_trace``, ``prometheus``,
``read_events``, ``salvage`` (a clean stream and a torn tail) and
``merge_streams`` over per-host streams. The only field allowed to differ
is one that names the package: the schema-version problem's advice
(``upgrade crimp_tpu_torch`` against ``upgrade crimp_tpu``). Every CLI
subcommand the port registers exits with crimp_tpu's code on the same
input.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from crimp_tpu import obs as jax_obs
from crimp_tpu.obs import cli as jax_cli
from crimp_tpu.obs import manifest as jax_manifest
from crimp_tpu.obs import merge as jax_merge
from crimp_tpu.obs import report as jax_report
from crimp_tpu.obs import salvage as jax_salvage
from crimp_tpu_torch import obs
from crimp_tpu_torch.obs import cli, manifest, merge, report, salvage

torch.set_num_threads(2)

NAMES_THE_PACKAGE = ("upgrade crimp_tpu_torch to diff it", "upgrade crimp_tpu to diff it")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for prefix in ("CRIMP_TORCH", "CRIMP_TPU"):
        for suffix in ("OBS", "OBS_DIR", "OBS_EVENTS", "OBS_HEARTBEAT_S", "OBS_HOST", "FAULTS"):
            monkeypatch.delenv(f"{prefix}_{suffix}", raising=False)


def _record(pkg, out_dir, monkeypatch, name="reader_run", host=None, scale=1.0, knob=None):
    """One small run of ``pkg``'s recorder: nested spans, counters, gauges,
    heartbeats, a degradation. Returns (manifest path, events path)."""
    prefix = "CRIMP_TORCH" if pkg is obs else "CRIMP_TPU"
    monkeypatch.setenv(f"{prefix}_OBS", "1")
    monkeypatch.setenv(f"{prefix}_OBS_DIR", str(out_dir))
    monkeypatch.setenv(f"{prefix}_OBS_HEARTBEAT_S", "0.001")
    if host is not None:
        monkeypatch.setenv(f"{prefix}_OBS_HOST", str(host))
    if knob is not None:
        monkeypatch.setenv(f"{prefix}_FAULTS", knob)
    with pkg.run(name, purpose="readers"):
        for i in range(3):
            with pkg.span("stage_a", kind="stage", step=i):
                with pkg.span("kernel_x", kind="kernel"):
                    time.sleep(0.002 * scale)
                pkg.counter_add("events_folded", 100 * (i + 1))
            pkg.beat(i + 1, 3, label="chunks")
        with pkg.span("stage_b", kind="stage"):
            time.sleep(0.003 * scale)
        pkg.record_span("serve_request", 0.0125, kind="request", client="c0", status="ok")
        pkg.gauge_set("bucket_occupancy_pct", 81.25)
        pkg.counter_add("serve_ok", 2)
        pkg.mark_degraded("multisource:split_bucket:resource_exhausted")
    for var in ("OBS_HOST", "FAULTS"):
        monkeypatch.delenv(f"{prefix}_{var}", raising=False)
    path = pkg.last_manifest_path()
    return path, path.replace(".manifest.json", ".events.jsonl")


@pytest.fixture
def runs(monkeypatch, tmp_path):
    """Two runs from each package (B slower than A, a knob set in B)."""
    out = {}
    for key, pkg in (("port", obs), ("jax", jax_obs)):
        a = _record(pkg, tmp_path / key, monkeypatch, name="run_a")
        b = _record(pkg, tmp_path / key, monkeypatch, name="run_b", scale=6.0,
                    knob="oom:fold_cache:99")
        out[key] = (a, b)
    return out


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _same_problems(doc):
    got, want = manifest.validate_manifest(doc), jax_manifest.validate_manifest(doc)
    norm = [p.replace(*NAMES_THE_PACKAGE) for p in got]
    assert norm == want
    return got


def _corruptions(doc):
    bad_span = json.loads(json.dumps(doc))
    bad_span["spans"][2]["parent"] = 7
    bad_span["spans"][1]["dur_s"] = "x"
    del bad_span["spans"][3]["attrs"]
    root_parent = json.loads(json.dumps(doc))
    root_parent["spans"][0]["parent"] = 0
    return {
        "not_a_dict": [doc],
        "missing_run_id": {k: v for k, v in doc.items() if k != "run_id"},
        "wrong_types": {**doc, "wall_s": "slow", "counters": {"a": "1"}, "gauges": [], "error": 3},
        "newer_schema": {**doc, "schema_version": 99, "schema": "other.obs"},
        "empty_spans": {**doc, "spans": []},
        "bad_spans": bad_span,
        "root_parent": root_parent,
        "bad_extensions": {**doc, "salvaged": "yes", "heartbeat": 1, "degraded": "no", "degradations": {},
                           "host": "0", "merged": 1, "hosts": [1, {}], "costmodel": {"k": 1}},
        "hosts_not_list": {**doc, "hosts": {}, "costmodel": []},
    }


class TestManifest:
    def test_valid_manifests_from_either_package(self, runs):
        for key in ("port", "jax"):
            for path, _ in runs[key]:
                doc = _load(path)
                assert _same_problems(doc) == []
                assert manifest.load_manifest(path) == jax_manifest.load_manifest(path)
                assert manifest.span_paths(doc) == jax_manifest.span_paths(doc)

    @pytest.mark.parametrize("case", ["not_a_dict", "missing_run_id", "wrong_types", "newer_schema", "empty_spans",
                                      "bad_spans", "root_parent", "bad_extensions", "hosts_not_list"])
    def test_corrupted_documents_give_jax_s_problems(self, runs, case):
        doc = _corruptions(_load(runs["port"][0][0]))[case]
        assert _same_problems(doc)

    def test_unparseable_and_invalid_files_raise_alike(self, tmp_path, runs):
        torn = tmp_path / "torn.manifest.json"
        torn.write_text(open(runs["port"][0][0]).read()[:200])
        invalid = tmp_path / "invalid.manifest.json"
        invalid.write_text(json.dumps({"schema": "crimp_tpu.obs"}))
        for path in (torn, invalid):
            with pytest.raises(ValueError) as got:
                manifest.load_manifest(str(path))
            with pytest.raises(ValueError) as want:
                jax_manifest.load_manifest(str(path))
            assert str(got.value) == str(want.value)


class TestReport:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_every_export_equals_jax_s(self, runs, writer):
        (a_path, _), (b_path, _) = runs[writer]
        a, b = _load(a_path), _load(b_path)
        for doc in (a, b):
            assert report.span_rollup(doc) == jax_report.span_rollup(doc)
            assert report.summarize(doc) == jax_report.summarize(doc)
            assert report.chrome_trace(doc) == jax_report.chrome_trace(doc)
            assert report.prometheus(doc) == jax_report.prometheus(doc)
        d = report.diff(a, b)
        assert d == jax_report.diff(a, b)
        assert d["knob_drift"] and d["stages"][0]["delta_s"] > 0
        assert report.render_diff(d) == jax_report.render_diff(d)
        assert report.diff(a, b, min_delta_s=10.0) == jax_report.diff(a, b, min_delta_s=10.0)

    def test_summary_shows_the_counters(self, runs):
        text = report.summarize(_load(runs["port"][0][0]))
        assert "serve_ok" in text and "events_folded" in text and "stage_a/kernel_x" in text


def _tear(src, dst, drop_tail_events=3):
    """A killed run's stream: the last events lost and the final line cut
    mid-record."""
    lines = open(src).read().splitlines()
    kept = lines[:-drop_tail_events]
    with open(dst, "w") as fh:
        fh.write("\n".join(kept) + "\n" + lines[-drop_tail_events][:17])
    return str(dst)


class TestSalvageAndMerge:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_salvage_clean_and_torn_streams_equal_jax_s(self, runs, tmp_path, writer):
        _, events = runs[writer][1]
        torn = _tear(events, tmp_path / f"{writer}_torn.events.jsonl")
        for path in (events, torn):
            assert salvage.read_events(path) == jax_salvage.read_events(path)
            doc = salvage.salvage(path)
            assert doc == jax_salvage.salvage(path)
            assert _same_problems(doc) == []
        assert salvage.salvage(torn)["salvaged"] and not salvage.salvage(events)["salvaged"]
        out = salvage.salvage_file(torn)
        assert out.endswith(".salvaged.manifest.json") and _load(out) == jax_salvage.salvage(torn)
        assert salvage.resolve_events(str(tmp_path / writer)) == jax_salvage.resolve_events(str(tmp_path / writer))

    def test_salvage_refuses_what_is_not_a_stream(self, tmp_path):
        empty = tmp_path / "empty.events.jsonl"
        empty.write_text("\n")
        headless = tmp_path / "headless.events.jsonl"
        headless.write_text(json.dumps({"ev": "ctr", "k": "a", "v": 1}) + "\n")
        for path in (empty, headless):
            with pytest.raises(ValueError) as got:
                salvage.salvage(str(path))
            with pytest.raises(ValueError) as want:
                jax_salvage.salvage(str(path))
            assert str(got.value) == str(want.value)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_merge_per_host_streams_equals_jax_s(self, monkeypatch, tmp_path, writer):
        pkg = obs if writer == "port" else jax_obs
        out_dir = tmp_path / f"mh_{writer}"
        streams = [_record(pkg, out_dir, monkeypatch, name="mh", host=h)[1] for h in (0, 1)]
        torn = _tear(streams[1], streams[1])  # host 1 was killed mid-run
        assert ".host1." in torn
        doc = merge.merge_streams(streams, force=True)
        assert doc == jax_merge.merge_streams(streams, force=True)
        assert doc["merged"] and doc["host_count"] == 2 and doc["salvaged"] and _same_problems(doc) == []
        assert report.prometheus(doc) == jax_report.prometheus(doc)
        assert report.chrome_trace(doc) == jax_report.chrome_trace(doc)
        assert merge.resolve_streams([str(out_dir)]) == jax_merge.resolve_streams([str(out_dir)])
        out = merge.merge_file(streams, force=True)
        assert _load(out) == jax_merge.merge_streams(streams, force=True)

    def test_merge_refuses_two_runs_alike(self, runs):
        streams = [runs["port"][0][1], runs["port"][1][1]]
        with pytest.raises(ValueError) as got:
            merge.merge_streams(streams)
        with pytest.raises(ValueError) as want:
            jax_merge.merge_streams(streams)
        assert str(got.value) == str(want.value)


def _exit_codes(argv, capsys):
    codes = []
    for main in (cli.main, jax_cli.main):
        try:
            codes.append(main(argv))
        except SystemExit as exc:  # argparse usage errors
            codes.append(exc.code)
        capsys.readouterr()
    return codes


class TestCli:
    def test_every_subcommand_exits_as_jax(self, runs, tmp_path, capsys, monkeypatch):
        (a, a_events), (b, b_events) = runs["port"]
        torn = _tear(b_events, tmp_path / "torn.events.jsonl")
        bad = tmp_path / "bad.manifest.json"
        bad.write_text(json.dumps({**_load(a), "spans": []}))
        fresh = tmp_path / "fresh.heartbeat.json"
        fresh.write_text(json.dumps({"t_unix": time.time(), "done": 1}))
        stale = tmp_path / "stale.heartbeat.json"
        stale.write_text(json.dumps({"t_unix": time.time() - 3600.0}))
        cases = {
            "summary": (["summary", a], 0), "summary_json": (["summary", a, "--format", "json"], 0),
            "summary_missing": (["summary", str(tmp_path / "nope.json")], 2),
            "summary_invalid": (["summary", str(bad)], 2),
            "diff": (["diff", a, b], 0), "diff_json": (["diff", a, b, "--format", "json"], 0),
            "diff_drift": (["diff", a, b, "--fail-on-drift"], 1),
            "trace": (["trace", a, "-o", str(tmp_path / "t.json")], 0), "prom": (["prom", a], 0),
            "validate": (["validate", a], 0), "validate_bad": (["validate", str(bad)], 1),
            "merge_two_runs": (["merge", a_events, b_events], 2),
            "merge_forced": (["merge", a_events, b_events, "--force", "-o", str(tmp_path / "m.json")], 0),
            "salvage": (["salvage", torn, "-o", str(tmp_path / "s.json")], 0),
            "salvage_missing": (["salvage", str(tmp_path / "none.events.jsonl")], 2),
            "tail_ended": (["tail", b_events, "--once"], 0), "tail_torn": (["tail", torn, "--once"], 1),
            "heartbeat_fresh": (["heartbeat-check", str(fresh), "--max-age-s", "60"], 0),
            "heartbeat_stale": (["heartbeat-check", str(stale), "--max-age-s", "60"], 1),
            "heartbeat_missing": (["heartbeat-check", str(tmp_path / "x.heartbeat.json"), "--max-age-s", "60"], 1),
            "heartbeat_bad_age": (["heartbeat-check", str(fresh), "--max-age-s", "0"], 2),
            "no_subcommand": ([], 2),
        }
        for name, (argv, expected) in cases.items():
            assert _exit_codes(argv, capsys) == [expected, expected], name

    def test_the_port_registers_no_ledger_or_roofline(self, capsys):
        # both subcommands exist since the ledger and the roofline were
        # ported: a bad ledger action is a usage error, a missing manifest
        # an I/O error, exit code 2 either way
        with pytest.raises(SystemExit) as exc:
            cli.main(["ledger", "x"])
        assert exc.value.code == 2
        assert cli.main(["roofline", "x"]) == 2
        capsys.readouterr()

    def test_module_entry_point_summarizes_a_port_run(self, runs):
        import subprocess
        import sys

        path = runs["port"][0][0]
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        proc = subprocess.run([sys.executable, "-m", "crimp_tpu_torch.obs", "summary", path], cwd=repo,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert "serve_ok" in proc.stdout and proc.stdout.strip() == report.summarize(_load(path))
        assert np.isfinite(_load(path)["wall_s"])
