"""BENCHMARK.json against the rules its format keeps, and the files it
names."""

import json
import os
import re

import pytest

from benchmark import harness

# the manifest alone, and with the candidate cells it would take
MANIFESTS = [harness.manifest(), harness.manifest(candidates=True)]
MAN = MANIFESTS[0]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                    r"_rank$|head|expansion|per_tok)")


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    assert all(TEXT.match(w) for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= man["run_seconds"] <= 51
    assert isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_names_units_and_entry_keys(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(("cell", w["name"]))
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    assert len(names) == len(set(names))


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_every_configuration_keeps_a_cell_and_its_file_lies_under_paths(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        files.add(c["file"])
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    assert len(files) == len(man["configs"])


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_pairs_are_unique_and_four_chip_cells_are_few(man):
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_each_cell_reports_set_up_another_end_to_end_and_a_layer(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in harness.reported(man, w["name"],
                                                   "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.reported(man, w["name"], "per_layer")


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_a_layer_metric_moves_what_each_of_its_cells_reports(man):
    for m in man["per_layer"]:
        for cell in m.get("workloads", []):
            e2e = {x["name"] for x in harness.reported(man, cell,
                                                       "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_metrics_of_one_layer_share_its_name_and_each_has_a_reader(man):
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("man", MANIFESTS, ids=["alone", "candidates"])
def test_every_cell_finds_its_family_driver_and_limits(man):
    for w in man["workloads"]:
        _cell, cfg, traffic = harness.cell_of(man, w["name"])
        assert os.path.exists(os.path.join(harness.BENCH, "families",
                                           cfg["family"] + ".py"))
        assert os.path.exists(os.path.join(harness.BENCH, "drivers",
                                           traffic["driver"] + ".py"))
        assert traffic["limits"]


def test_a_check_fits_the_time_allowed():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", "", "x" * 65, "µs"])
def test_bad_names_are_refused(name):
    assert not NAME.match(name)
