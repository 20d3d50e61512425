"""Each configuration file: the program's parameter tree it builds, and the
reference's values, which must be that tree's."""

from __future__ import annotations

import json
import math
import os

import pytest

from port_bench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))


def params_of(cfg: dict):
    from sycl_points_tpu_torch.pipeline.params import load_params

    return load_params(cfg["params"], cls=harness._import(cfg["params_class"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_reference_values_are_the_programs(entry):
    cfg = harness.load_json(os.path.join(harness.REPO, entry["file"]))
    p = params_of(cfg)
    ref = cfg["reference"]
    s = ref["scan"]
    assert (s["box_min"], s["box_max"]) == (p.scan.preprocess.box_filter.min, p.scan.preprocess.box_filter.max)
    assert p.scan.downsampling.voxel.enable and s["voxel"] == p.scan.downsampling.voxel.size
    assert not p.scan.downsampling.polar.enable
    assert s["random_num"] == p.scan.downsampling.random.num and s["scan_capacity"] == p.scan_capacity
    ce = p.covariance_estimation
    assert s["neighbor_num"] == ce.neighbor_num and ce.m_estimation.enable
    assert ce.m_estimation.type.name == "GEMAN_MCCLURE"
    assert (s["mad_scale"], s["min_robust_scale"], s["robust_iterations"]) == (
        ce.m_estimation.mad_scale, ce.m_estimation.min_robust_scale, ce.m_estimation.max_iterations)
    assert math.isclose(s["gate_max_angle"], p.scan.preprocess.angle_incidence_filter.max_angle)
    assert s["gate_min_angle"] == p.scan.preprocess.angle_incidence_filter.min_angle
    m = ref["map"]
    sp = p.submap
    assert sp.map_type == "VOXEL_HASH_MAP" and m["voxel"] == sp.voxel_size
    assert (m["prune_cycle"], m["max_staleness"], m["max_distance"]) == (
        sp.remove_old_data_cycle, sp.max_staleness, sp.max_distance_range)
    assert m["extract_capacity"] == sp.extract_capacity and m["sample_num"] == sp.point_random_sampling_num
    assert m["min_num_points"] == p.registration.min_num_points and m["neighbor_num"] == ce.neighbor_num
    f = p.registration.factor
    assert f.reg_type.name == "GICP" and f.robust.type.name == "NONE" and f.degenerate_reg is None
    assert not f.rotation_constraint.enable and f.coarse_to_fine_iters == 0
    if "registration" in ref:
        r = ref["registration"]
        assert (r["max_corr_dist"], r["max_iterations"]) == (f.max_correspondence_distance, f.max_iterations)
        assert r["criteria"] == f.criteria.translation == f.criteria.rotation
        assert f.optimization_method == "gauss_newton" and f.gn.lambda_ == 1.0
    if "lio" in ref:
        r, lp = ref["lio"], p.lio
        assert r["max_corr_dist"] == f.max_correspondence_distance
        assert (r["total_iterations"], r["gn_lambda"]) == (lp.total_iterations, lp.gn.lambda_)
        assert r["criteria"] == lp.criteria.translation == lp.criteria.rotation
        assert lp.optimization_method == "gauss_newton" and not lp.robust.auto_scale
        assert r["invalid_regularization_factor"] == lp.invalid_regularization_factor
        dw = lp.directional_icp_weighting
        assert r["directional"] == {k: getattr(dw, k) for k in r["directional"]}
        assert not p.imu.initial_alignment.enable and not p.imu.deskew.enable


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_file_names_what_it_runs(entry):
    cfg = harness.load_json(os.path.join(harness.REPO, entry["file"]))
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["params"])
    assert set(cfg["check"]["limits"]) and set(cfg["check"]["stages"]) <= {"pre", "reg", "lio", "map"}
    json.dumps(cfg)  # plain data


def test_every_cell_resolves_to_files_of_its_own():
    for w in BENCH["workloads"]:
        spec = harness.resolve(BENCH, w["name"])
        assert spec.traffic["streams"] > 0
        for m in spec.per_layer:
            assert os.path.exists(harness.find((HERE,), "metrics", m["name"], ".py"))
