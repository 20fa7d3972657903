"""BENCHMARK.json against the benchmark's contract, and the pieces it names
present under h100bench/."""
import re

import pytest

from h100bench.core import bench

M = bench.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in M["workloads"]])


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "h100bench/run.py"]
    assert M["paths"] == ["h100bench"]


def test_names_and_units():
    named = M["configs"] + M["workloads"] + M["end_to_end"] + M["per_layer"]
    for x in named:
        assert NAME.match(x["name"]), x["name"]
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in M[section]]
        assert len(names) == len(set(names))


def test_bounds():
    assert "setup_s" in E2E
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    for w in M["workloads"]:
        e2e = [m["name"] for m in bench.metrics_for(M, "end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics_for(M, "per_layer", w["name"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_each_layer_metric_moves_a_metric_its_cells_report(metric):
    moved = E2E[metric["moves"]]
    for cell in _cells(metric):
        assert cell in _cells(moved), (metric["name"], cell)
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert (bench.BENCH / "metrics" / f"{metric['name']}.py").exists()


def test_layers_match_one_name_each():
    for m in M["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
    assert {m["layer"] for m in M["per_layer"]} <= {
        "scheduler", "model step", "kernels", "device", "encode",
        "host launches"}


def test_shares_name_their_peak():
    for m in M["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_pieces_exist():
    for c in M["configs"]:
        cfg = bench.data("configs", c["name"])
        assert c["file"] == f"h100bench/configs/{c['name']}.json"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert (bench.BENCH / "models" / f"{cfg['kind']}.py").exists()
        assert (bench.BENCH / "reference" / f"{cfg['kind']}.py").exists()
    for w in M["workloads"]:
        assert (bench.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert any(c["name"] == w["config"] for c in M["configs"])
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) \
        == len(M["workloads"])


def test_reduced_names_no_width():
    width = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                       r"_rank$|expansion|experts_per_tok)")
    for c in M["configs"]:
        assert not any(width.search(k) for k in c["reduced"]), c["reduced"]


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51
    total = (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
