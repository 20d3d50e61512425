"""A cell added as files only, run through the harness on the CPU at a tiny
size: sound, with the timed path broken underneath, and the control.

The harness's look for a card is skipped (``run_cell`` is given the CPU);
the rest of a run is the benchmark's own: traffic, set-up, window, capture,
check. Each broken run must come out not correct, and so must the control
(the reference in bfloat16 in the program's place).
"""

from __future__ import annotations

import copy
import json
import os
import time

import pytest
import torch

from port_bench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECONDS = 4.0


def dummy_cell(tmp_path, config: str, imu_hz: int = 0):
    """A configuration, a traffic mix and a cell of their own, as files."""
    (tmp_path / "configs").mkdir(exist_ok=True)
    (tmp_path / "traffic").mkdir(exist_ok=True)
    tp = harness.load_json(os.path.join(HERE, "traffic", "loop256.json"))
    tp.update(streams=2, rays_azimuth=128, rays_rings=16, warmup_frames=1, imu_hz=imu_hz)
    (tmp_path / "traffic" / "dummy.json").write_text(json.dumps(tp))
    cfg = harness.load_json(os.path.join(HERE, "configs", f"{config}.json"))
    cfg = copy.deepcopy(cfg)
    # every frame captured; at this tiny size every frame a keyframe, so the
    # submap step is read too
    cfg["check"]["plan"] = {"every": 1, "streams": 2, "frames": 50}
    cfg["params"]["submap"]["keyframe"] = {"time_threshold_seconds": 0.05, "inlier_ratio_threshold": 0.0}
    (tmp_path / "configs" / "dummy.json").write_text(json.dumps(cfg))
    bench = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    bench["configs"].append({"name": "dummy", "source": "a test", "file": "configs/dummy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy", "traffic": "dummy", "chips": 1,
                               "why": "a test"})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + ["dummy.cell"]
    return harness.resolve(bench, "dummy.cell", roots=(str(tmp_path), HERE), base=str(tmp_path))


def run(spec, devices=1, **kw):
    return harness.run_cell(spec, 2**31 + 11, SECONDS, False, [torch.device("cpu")] * devices, time.perf_counter(),
                            **kw)


def test_sound_lo_cell_is_correct_and_its_control_is_not(tmp_path):
    out = run(dummy_cell(tmp_path, "fleet_lo_vhm"), control=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) >= {"stream_frames_per_s", "setup_s"}
    assert out["metrics"]["stream_frames_per_s"]["value"] > 0
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert not out["control"]["correct"], out["control"]
    # the control fails a number (not only a stage never read)
    assert any(v > lim for v, lim in out["control"]["numbers"].values())


def test_sound_lio_cell_is_correct(tmp_path):
    out = run(dummy_cell(tmp_path, "fleet_lio_vhm", imu_hz=200), control=True)
    assert out["correct"], out["checks"]
    assert any(k.startswith("lio_") for k in out["checks"])
    assert not out["control"]["correct"]


def _pose_altered(monkeypatch):
    from sycl_points_tpu_torch.registration import pipeline

    orig = pipeline.align_streams

    def align_streams(*a, **kw):
        out = orig(*a, **kw)
        T = out.T.clone()
        T[:, 0, 3] += 0.05  # 5 cm, where the pose is produced
        return out._replace(T=T)

    monkeypatch.setattr(pipeline, "align_streams", align_streams)


def _state_unchanged(monkeypatch):
    from sycl_points_tpu_torch.parallel import fleet

    orig = fleet.make_submap_step_streams

    def make(*a, **kw):
        step = orig(*a, **kw)

        def unchanged(map_state, target_prev, *rest):
            _, _, sampled, stats2 = step(map_state, target_prev, *rest)
            return map_state, target_prev, sampled, stats2

        return unchanged

    monkeypatch.setattr(fleet, "make_submap_step_streams", make)


def _half_batch(monkeypatch):
    from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor

    orig = PCProcessor.preprocess_streams

    def preprocess_streams(self, clouds, generators, *a, **kw):
        out = orig(self, clouds, generators, *a, **kw)
        h = out.points.shape[0] // 2
        # the second half of the streams left out: the first half's scans in their place
        return type(out)(**{f: None if v is None else torch.cat([v[:h], v[:h]])
                            for f, v in vars(out).items()})

    monkeypatch.setattr(PCProcessor, "preprocess_streams", preprocess_streams)


def _registrations_fail(monkeypatch):
    from sycl_points_tpu_torch.parallel import fleet

    orig = fleet.FleetOdometry._stream_result_types

    def result_types(self, stats):
        out = orig(self, stats)
        # the last stream's registrations come out as failures, where they are produced
        return out[:-1] + [fleet.ResultType.small_number_of_points]

    monkeypatch.setattr(fleet.FleetOdometry, "_stream_result_types", result_types)


@pytest.mark.parametrize("fault", [_pose_altered, _state_unchanged, _half_batch, _registrations_fail],
                         ids=["pose_altered", "state_unchanged", "half_batch_left_out", "registrations_fail"])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    out = run(dummy_cell(tmp_path, "fleet_lo_vhm"))
    assert not out["correct"], out["checks"]


def _exchange_left_out(monkeypatch):
    from sycl_points_tpu_torch.parallel import fleet

    orig = fleet._receive

    def receive(tree, rows, device, streams):
        # every shard gets the first shard's rows: nothing crosses between devices
        return orig(tree, slice(0, rows.stop - rows.start), device, streams)

    monkeypatch.setattr(fleet, "_receive", receive)


def test_fleet_split_over_two_devices(tmp_path):
    out = run(dummy_cell(tmp_path, "fleet_lo_vhm"), devices=2)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 2


def test_fleet_split_without_the_exchange_is_not_correct(tmp_path, monkeypatch):
    _exchange_left_out(monkeypatch)
    out = run(dummy_cell(tmp_path, "fleet_lo_vhm"), devices=2)
    assert not out["correct"], out["checks"]


def test_witness_reads_each_exclusion(tmp_path, monkeypatch):
    from port_bench import check, witness

    found = {}
    judge = check.run

    def run_and_witness(captures, poses, cfg, **kw):
        found.update(witness.witness(captures, poses, cfg))
        return judge(captures, poses, cfg, **kw)

    monkeypatch.setattr(check, "run", run_and_witness)
    out = run(dummy_cell(tmp_path, "fleet_lo_vhm"))
    assert out["correct"], out["checks"]
    assert set(found) == {"scan_cov", "scan_normal", "scan_tie", "map_voxels", "map_tie", "reg"}
    # a sound run's well-conditioned covariances and fixed point read as the check does
    assert found["scan_cov"]["program_well"] <= out["checks"]["scan_cov_rel_gap"][1]
    assert found["reg"]["program_to_f64_procedure_m"] <= out["checks"]["reg_trans_gap_m"][1]
