"""The port's roofline and perf report (``launch/roofline.py``,
``launch/perf_report.py``) and the dry-run's decoder cells.

``_useful_traffic_model`` equals the reference's (pure Python) for every
cell, the decoder cells included (exact); ``roofline_terms`` of a
hand-built report gives the H100's terms (relative 1e-12: float division
in another order); a useful share above 1.0 is refused; the decoder
cells' dry-run counts the lane shard's K1 and K2 by the cost formulas
(exact).
"""

import json

import pytest

from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro_torch.core.trellis import CCSDS_27
from repro_torch.launch import cost, dryrun, perf_report, roofline, specs

REPORTS = [{"arch": c.arch, "shape": c.shape.name, "kind": c.kind}
           for c in specs.iter_cells(include_skips=True)]
REPORTS += [{"arch": "viterbi-ccsds", "shape": v, "kind": "decode_stream",
             "bits_per_step": 512 * n} for v, n in dryrun.VITERBI_CELLS.items()]


@pytest.mark.parametrize("report", REPORTS, ids=lambda r: f"{r['arch']}-{r['shape']}")
def test_useful_traffic_model_is_the_references(report):
    assert roofline._useful_traffic_model(report) == j_roofline._useful_traffic_model(report)


def test_cells_cover_the_references():
    assert len(REPORTS) == len(list(j_specs.iter_cells(include_skips=True))) + 2


def _report(**count):
    c = {"flops_per_device_by_dtype": {"bf16": 989e12, "f32": 67e12, "int": 132 * 64 * 1.98e9},
         "bytes_per_device": 3.35e12 * 2.5, "collective_bytes_per_device": {"all-gather": 450e9},
         "flops_global": 1e16, "bytes_global": 1e15, "collective_bytes_global": {"x": 1e13}}
    c["flops_per_device"] = sum(c["flops_per_device_by_dtype"].values())
    c.update(count)
    return {"arch": "starcoder2-3b", "shape": "train_4k", "mesh": "16x16", "kind": "train",
            "status": "ok", "n_chips": 256, "count": c, "model_flops_global": 5e15,
            "memory": {"argument_size_in_bytes": 3e9}}


def test_roofline_terms_use_the_h100_peaks():
    t = roofline.roofline_terms(_report())
    assert t["t_compute_s"] == pytest.approx(3.0, rel=1e-12)  # one second per dtype's peak
    assert t["t_memory_s"] == pytest.approx(2.5, rel=1e-12)
    assert t["t_collective_s"] == pytest.approx(1.0, rel=1e-12)
    assert t["dominant"] == "compute" and t["step_lower_bound_s"] == t["t_compute_s"]
    assert t["useful_flops_ratio"] == t["roofline_fraction"] == 0.5
    assert t["args_gb"] == 3.0 and t["temp_gb"] is None
    assert (roofline.LINK_BW, roofline.HBM_BW) == (450e9, 3.35e12)
    assert roofline.PEAKS == {"bf16": 989e12, "f32": 67e12, "int": 132 * 64 * 1.98e9}


def test_a_share_above_one_is_an_error(tmp_path):
    bad = _report(flops_global=1e15)  # model FLOPs 5e15 above the counted 1e15
    with pytest.raises(ValueError, match="above 1.0"):
        roofline.roofline_terms(bad)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    (tmp_path / "skip.json").write_text(json.dumps(
        {"arch": "a", "shape": "long_500k", "mesh": "16x16", "status": "skip", "reason": "r"}))
    rows = roofline.load_all(tmp_path)
    assert sorted(r["dominant"] for r in rows) == ["error", "skip"]
    assert "**error**" in roofline.to_markdown(rows)


@pytest.mark.parametrize("multi_pod,shards", [(False, 16), (True, 32)])
def test_viterbi_cell_counts_a_lane_shards_kernels(multi_pod, shards):
    r = dryrun.run_viterbi_cell("stream_16m_int8", multi_pod)
    width = 32768 // shards
    k = r["count"]["kernels_per_device"]
    assert k["acs_forward (K1)"]["bytes"] == cost.k1_cost(CCSDS_27, 596, width, 1)[0]
    assert k["acs_forward (K1)"]["ops"] == cost.k1_cost(CCSDS_27, 596, width, 1)[1]
    assert k["traceback (K2)"]["bytes"] == cost.k2_cost(596, width, 42, 512)[0]
    assert r["count"]["positions_with_work"] == shards
    assert r["count"]["collective_bytes_per_device"] == {}
    t = roofline.roofline_terms(r)
    assert t["dominant"] == "memory" and 0 < t["roofline_fraction"] <= 1.0


def test_perf_report_prints_a_dash_for_missing_reports(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(perf_report, "ROOT", tmp_path)
    (tmp_path / "torch_dryrun").mkdir()
    r = dryrun.run_viterbi_cell("stream_16m_int8", False)
    (tmp_path / "torch_dryrun" / "viterbi-ccsds__stream_16m_int8__pod16x16.json").write_text(
        json.dumps(r))
    perf_report.main([])
    out = capsys.readouterr().out
    assert out.count("| — | — | — | — | — |") == 8
    assert "| two-kernel int8 (K1 + K2, backend cuda) | " in out and out.count("**") == 2
