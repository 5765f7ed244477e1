"""The benchmark's files: BENCHMARK.json's shape, every file it names, and
a cell, configuration, traffic mix and metric added by files alone."""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench.harness import HERE, ROOT, load_cell, load_json, load_reader

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            extra = set(e) - KEYS[section]
            assert set(e) >= KEYS[section] and extra <= {"workloads"}, (section, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    configs = {c["name"] for c in BENCH["configs"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    used = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        used.add(w["config"])
        cell = load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    assert used == configs


def test_every_named_file_loads():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert path.parts[len(ROOT.parts)] == "portbench"
        cfg = load_json(path)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) == set(cfg["reduced"]), c["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(load_reader(m["name"]))
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert (HERE / "ops" / f"{cell.traffic['op']}.py").exists()
        assert "limits" in cell.workload and "trace_calls" in cell.workload
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, f"PERF.md's list of layers lacks {layer!r}"


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the checkout gains a configuration, a traffic mix, a cell
    and an end-to-end metric as new files and entries only, and the harness
    runs the cell and reads the metric with no code edited."""
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "portbench"
    cfg = load_json(pb / "configs" / "cid22-512.json")
    cfg.update(name="tiny-64", images=2, height=64, width=64, qualities=[40, 80, 20])
    (pb / "configs" / "tiny-64.json").write_text(json.dumps(cfg))
    traffic = load_json(pb / "traffic" / "session.json")
    traffic["warmup_calls"] = 1
    (pb / "traffic" / "session-one-warmup.json").write_text(json.dumps(traffic))
    work = load_json(pb / "workloads" / "cid22-512.session.json")
    (pb / "workloads" / "tiny-64.session.json").write_text(json.dumps(work))
    (pb / "metrics" / "calls_per_s.py").write_text(textwrap.dedent('''
        def read(run):
            return len(run.ok_calls) / run.window_s
    '''))
    bench["configs"].append({"name": "tiny-64", "source": "https://example.org/tiny",
                             "file": "portbench/configs/tiny-64.json", "reduced": ["images"],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny-64.session", "config": "tiny-64",
                               "traffic": "session-one-warmup", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny-64.session"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent('''
        import json, time
        from portbench.harness import load_cell, run_cell
        out = run_cell(load_cell("tiny-64.session"), 7, 0.2, False, time.perf_counter(),
                       device="cpu")
        print(json.dumps({"correct": out["correct"], "metrics": sorted(out["metrics"])}))
    ''')
    env = {**os.environ, "PYTHONPATH": str(ROOT)}  # the program from here, the benchmark copied
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["metrics"] == ["calls_per_s", "setup_s"]


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cid22-512.session", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    from portbench.run import build_result
    from portbench_tiny import tiny_run

    out = tiny_run("cid22-512.session", trace=trace)
    device = {"platform": "gpu", "kind": "test", "count": 1, "memory_peak_bytes": 1}
    line = build_result(out, device)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += (["breakdown"] if trace else []) + ["host", "checks"]
    assert list(line) == want
    json.dumps(line, allow_nan=False)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
