"""The port's roofline: ``repro_torch.roofline.calibrate`` (the reference's
calibration tests, ``tests/test_roofline_calibrate.py``, against the port's
modules, and the H100 facts where it departs) and
``repro_torch.roofline.stencil`` (``plan_terms`` and ``estimate_plan_time``
equal to the reference's, one constants object passed to both, wherever the
port executes a plan as the reference's model assumes: mxu plans, pallas at
1-D and within the deepest register instance; elsewhere the port's launch
and pass counts)."""
import dataclasses
import json
import math
import os
from types import SimpleNamespace

import pytest
import torch

from repro.core import autotune as jtune
from repro.core import stencils as jstencils
from repro.roofline import calibrate as jcal
from repro.roofline import stencil as jrs
from repro_torch.core import autotune, stencils
from repro_torch.core.api import StencilPlan, StencilProblem, sweep_schedule
from repro_torch.kernels import stencil_kernels as sk
from repro_torch.roofline import calibrate
from repro_torch.roofline import stencil as rs


@pytest.fixture()
def cache_path(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "_caches", {})
    return str(tmp_path / "plans.json")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_static_constants_are_the_h100_data_sheet(tmp_path):
    c = calibrate.load_constants(device="cpu", path=str(tmp_path / "none.json"))
    assert c is calibrate.STATIC and c.source == "static" and c.n_samples == 0
    assert (c.peak_flops, c.hbm_bw, c.ici_bw) == (33.5e12, 3.35e12, 450e9)
    # the stencil kernels' FP32 rate is half the FMA-counted 67 TFLOP/s
    # (-fmad=false); the mxu GEMM runs at it in f32, on the tensor cores in bf16
    assert c.peak_flops == 67e12 / 2
    assert (c.peak_flops_mxu, c.peak_flops_mxu_bf16) == (67e12, 989e12)
    # the reference's are TPU-v5e numbers, with no mxu peak until fitted
    assert (jcal.STATIC.hbm_bw, jcal.STATIC.peak_flops_mxu) == (819e9, 0.0)


def test_fit_is_max_observed_throughput(tmp_path):
    path = str(tmp_path / "consts.json")
    got = calibrate.record_samples(
        [{"flops": 1e9, "bytes": 4e9, "coll_bytes": 0.0, "seconds": 1e-3},
         {"flops": 8e9, "bytes": 2e9, "coll_bytes": 0.0, "seconds": 1e-3}],
        device="cpu", path=path)
    assert got.peak_flops == pytest.approx(8e12)
    assert got.hbm_bw == pytest.approx(4e12)
    assert got.ici_bw == calibrate.ICI_BW
    assert got.n_samples == 2 and got.source == "measured"
    assert calibrate.load_constants(device="cpu", path=path) == got
    # the same samples fit the reference's calibrator to the same peaks
    ref = jcal.record_samples(
        [{"flops": 1e9, "bytes": 4e9, "coll_bytes": 0.0, "seconds": 1e-3},
         {"flops": 8e9, "bytes": 2e9, "coll_bytes": 0.0, "seconds": 1e-3}],
        device="cpu", path=str(tmp_path / "ref.json"))
    assert (ref.peak_flops, ref.hbm_bw, ref.n_samples) == \
        (got.peak_flops, got.hbm_bw, got.n_samples)


def test_ratchet_is_monotone(tmp_path):
    path = str(tmp_path / "consts.json")
    calibrate.record_samples([{"flops": 8e9, "bytes": 2e9, "seconds": 1e-3}],
                             device="cpu", path=path)
    after = calibrate.record_samples([{"flops": 1e3, "bytes": 1e3, "seconds": 1.0}],
                                     device="cpu", path=path)
    assert after.peak_flops == pytest.approx(8e12)
    assert after.n_samples == 2
    better = calibrate.record_samples([{"flops": 1e10, "bytes": 1e9, "seconds": 1e-3}],
                                      device="cpu", path=path)
    assert better.peak_flops == pytest.approx(1e13)


def test_ici_fitted_only_from_collective_samples(tmp_path):
    got = calibrate.record_samples(
        [{"flops": 1e9, "bytes": 1e9, "coll_bytes": 5e8, "seconds": 1e-3}],
        device="cpu", path=str(tmp_path / "consts.json"))
    assert got.ici_bw == pytest.approx(5e11)


def test_mxu_peaks_fit_per_element_type(tmp_path):
    """f32 GEMM samples ratchet ``peak_flops_mxu``, bf16 ones
    ``peak_flops_mxu_bf16``; an unfitted one reads 0.0, the fallback."""
    path = str(tmp_path / "consts.json")
    got = calibrate.record_samples(
        [{"flops": 1e9, "bytes": 1e9, "seconds": 1e-3},
         {"flops": 0.0, "mxu_flops": 3e10, "bytes": 1e9, "seconds": 1e-3}],
        device="cpu", path=path)
    assert got.peak_flops_mxu == pytest.approx(3e13) and got.peak_flops_mxu_bf16 == 0.0
    got = calibrate.record_samples(
        [{"flops": 0.0, "mxu_bf16_flops": 4e11, "bytes": 1e9, "seconds": 1e-3}],
        device="cpu", path=path)
    assert got.peak_flops_mxu == pytest.approx(3e13)
    assert got.peak_flops_mxu_bf16 == pytest.approx(4e14)


def test_constants_file_beside_plan_cache(tmp_path, monkeypatch):
    cache_path = str(tmp_path / "sub" / "plans.json")
    monkeypatch.delenv(calibrate.CONSTANTS_ENV, raising=False)
    assert calibrate.constants_path(cache_path) == \
        str(tmp_path / "sub" / calibrate.CONSTANTS_BASENAME)
    monkeypatch.setenv(calibrate.CONSTANTS_ENV, "/tmp/elsewhere.json")
    assert calibrate.constants_path(cache_path) == "/tmp/elsewhere.json"


def test_default_files_live_apart_from_the_reference(monkeypatch):
    for env in (calibrate.CONSTANTS_ENV, jcal.CONSTANTS_ENV, autotune.CACHE_ENV,
                jtune.CACHE_ENV):
        monkeypatch.delenv(env, raising=False)
    assert calibrate.CONSTANTS_ENV != jcal.CONSTANTS_ENV
    assert autotune.CACHE_ENV != jtune.CACHE_ENV
    home = os.path.expanduser("~")
    assert calibrate.constants_path() == \
        os.path.join(home, ".cache", "repro_torch", "roofline_constants.json")
    assert autotune.default_cache_path() == \
        os.path.join(home, ".cache", "repro_torch", "plan_cache.json")
    assert calibrate.constants_path() != jcal.constants_path()
    assert autotune.default_cache_path() != jtune.default_cache_path()
    # setting the reference's variables moves nothing of the port's
    monkeypatch.setenv(jtune.CACHE_ENV, "/tmp/ref_plans.json")
    monkeypatch.setenv(jcal.CONSTANTS_ENV, "/tmp/ref_consts.json")
    assert autotune.default_cache_path().endswith("repro_torch/plan_cache.json")
    assert calibrate.constants_path().endswith("repro_torch/roofline_constants.json")


def test_file_format_and_corruption_tolerance(tmp_path):
    path = str(tmp_path / "consts.json")
    calibrate.record_samples([{"flops": 1e9, "bytes": 1e9, "seconds": 1e-3}],
                             device="cpu", path=path)
    raw = json.load(open(path))
    assert raw["version"] == calibrate.CONSTANTS_VERSION
    assert set(raw["devices"]["cpu"]) == {"peak_flops", "peak_flops_mxu",
                                          "peak_flops_mxu_bf16", "hbm_bw", "ici_bw",
                                          "n_samples"}
    with open(path, "w") as f:
        f.write("{not json")
    assert calibrate.load_constants(device="cpu", path=path).source == "static"
    got = calibrate.record_samples([{"flops": 2e9, "bytes": 1e9, "seconds": 1e-3}],
                                   device="cpu", path=path)
    assert got.source == "measured"


def test_per_device_kind_entries_are_independent(tmp_path):
    path = str(tmp_path / "consts.json")
    calibrate.record_samples([{"flops": 1e9, "bytes": 1e9, "seconds": 1e-3}],
                             device="cpu", path=path)
    calibrate.record_samples([{"flops": 9e9, "bytes": 9e9, "seconds": 1e-3}],
                             device="nvidia_h100_80gb_hbm3", path=path)
    assert calibrate.load_constants(device="cpu", path=path).peak_flops == pytest.approx(1e12)
    assert calibrate.load_constants(device="nvidia_h100_80gb_hbm3",
                                    path=path).peak_flops == pytest.approx(9e12)


def test_empty_samples_are_a_noop(tmp_path):
    path = str(tmp_path / "consts.json")
    assert calibrate.record_samples([], device="cpu", path=path).source == "static"
    assert not os.path.exists(path)


def test_half_fitted_constants_are_not_served(tmp_path):
    path = str(tmp_path / "consts.json")
    got = calibrate.record_samples([{"flops": 1e9, "bytes": 0.0, "seconds": 1e-3}],
                                   device="cpu", path=path)
    assert got.source == "static"
    got = calibrate.record_samples([{"flops": 0.0, "bytes": 4e9, "seconds": 1e-3}],
                                   device="cpu", path=path)
    assert got.source == "measured"
    assert got.peak_flops == pytest.approx(1e12)
    assert got.hbm_bw == pytest.approx(4e12)


def test_device_kind_is_torchs_card_name(monkeypatch):
    assert calibrate.device_kind("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert calibrate.device_kind("cuda") == "nvidia_h100_80gb_hbm3"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert autotune.device_signature("cuda") == "nvidia_h100_80gb_hbm3x1"
    assert autotune.device_signature("cpu") == "cpux1"


def test_bandwidth_floor_is_twice_the_l2(monkeypatch):
    """The reference's 32 MiB is below an H100's 50 MB L2: on a card the
    floor is twice the L2 it reports."""
    assert calibrate.min_bandwidth_working_set("cpu") == jcal.MIN_BANDWIDTH_WORKING_SET
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev=None: SimpleNamespace(L2_cache_size=50 << 20))
    assert calibrate.min_bandwidth_working_set("cuda") == 100 << 20
    assert calibrate.min_bandwidth_working_set("cuda") > jcal.MIN_BANDWIDTH_WORKING_SET


# -- the autotune wiring ------------------------------------------------------

def test_tune_records_calibration_samples(cache_path):
    prob = StencilProblem("1d3p", (1 << 22,), device="cpu")    # 32 MiB working set
    autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1e-3,
                  calibrate_samples=True)
    consts = calibrate.load_constants(device=autotune.device_kind(prob.device),
                                      cache_path=cache_path)
    assert consts.source == "measured" and consts.n_samples >= 1
    assert consts.peak_flops > 0 and consts.hbm_bw > 0 and consts.peak_flops_mxu > 0
    assert os.path.exists(calibrate.constants_path(cache_path))


def test_stub_timers_never_poison_calibration(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1e-12)
    assert not os.path.exists(calibrate.constants_path(cache_path))
    assert calibrate.load_constants(device="cpu", cache_path=cache_path).source == "static"


def test_cache_resident_problems_do_not_ratchet_hbm_bw(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1e-9,
                  calibrate_samples=True)
    entry = calibrate._load_devices(calibrate.constants_path(cache_path))["cpu"]
    assert entry["n_samples"] >= 1
    assert entry["peak_flops"] > 0 and entry["hbm_bw"] == 0.0
    consts = calibrate.load_constants(device="cpu", cache_path=cache_path)
    assert consts.source == "static" and consts.hbm_bw == calibrate.HBM_BW


def test_tune_ranking_survives_fitted_constants(cache_path):
    prob = StencilProblem("1d3p", (128,), device="cpu")
    r1 = autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1e-3,
                       calibrate_samples=True)
    r2 = autotune.tune(prob, cache_path=cache_path, timer=lambda fn, p: 1e-3,
                       calibrate_samples=True, force=True)
    assert r1.plan is not None and r2.plan is not None and r2.n_measured >= 1


# ---------------------------------------------------------------------------
# plan_terms / estimate_plan_time against the reference
# ---------------------------------------------------------------------------

def _ref(plan):
    return jtune.plan_from_dict(autotune.plan_to_dict(plan))


CONSTS = calibrate.RooflineConstants(peak_flops=2.5e12, hbm_bw=1.7e12, ici_bw=1e11,
                                     peak_flops_mxu=9e12, n_samples=3, source="measured")
SAME_SHAPES = {"1d3p": (4096,), "1d5p": (2048,), "heat1d": (4096,), "2d5p": (64, 256),
               "2d9p": (64, 256), "heat2d": (64, 256), "3d7p": (16, 8, 256),
               "3d27p": (16, 8, 256)}
STEPS = (None, 16, 7, 11)


def _same_execution_plans(name):
    """mxu plans, and pallas plans the port runs as the reference's model
    assumes: at 1-D at any depth, at 2-D / 3-D one launch a chunk."""
    spec = stencils.make(name)
    plans = [StencilPlan(backend="mxu", k=k, vl=vl, m=m, ttile=tt, remainder=rem)
             for k in (1, 2, 4) for vl, m in ((4, 4), (8, 8)) for tt in (1, 2)
             for rem in ("fused", "native")]
    t0 = 8 if spec.ndim > 1 else None
    for k in (1, 2, 4):
        for tt in (1, 2, 4):
            for vl, m in ((8, 4), (8, 8), (16, 2)):
                for rem in ("fused", "native"):
                    p = StencilPlan(backend="pallas", sweep="resident", k=k, ttile=tt, vl=vl,
                                    m=m, t0=t0, remainder=rem)
                    if all(len(rs.launch_depths(spec, vl, m, d)) == 1
                           for steps in STEPS
                           for d, _ in sweep_schedule(k, steps, rem, tt)[0]):
                        plans.append(p)
    return plans


@pytest.mark.parametrize("name", sorted(SAME_SHAPES))
def test_terms_equal_reference_where_execution_is_the_same(name):
    spec, jspec, shape = stencils.make(name), jstencils.make(name), SAME_SHAPES[name]
    plans = _same_execution_plans(name)
    assert any(p.backend == "pallas" and p.ttile > 1 for p in plans)
    for plan in plans:
        for steps in STEPS:
            for itemsize in (4, 2):
                got = rs.plan_terms(spec, shape, itemsize, plan, steps)
                want = jrs.plan_terms(jspec, shape, itemsize, _ref(plan), steps)
                assert got == pytest.approx(want, rel=1e-12), (plan, steps)
            for consts in (CONSTS, calibrate.STATIC):
                assert rs.estimate_plan_time(spec, shape, 4, plan, steps, consts) == \
                    pytest.approx(jrs.estimate_plan_time(jspec, shape, 4, _ref(plan), steps,
                                                         consts), rel=1e-12), (plan, steps)


@pytest.mark.parametrize("name,shape,m,depths", [
    ("2d5p", (64, 256), 8, {8: 2, 16: 4}),       # M = 8: depth-4 launches
    ("2d5p", (64, 256), 4, {8: 1, 16: 2}),       # M = 4: depth-8 launches
    ("2d5p", (64, 256), 2, {8: 1, 16: 1}),       # M = 2: the deep depth-16 instance
    ("3d7p", (16, 8, 256), 8, {8: 2, 16: 4}),    # depth-4 launches at every M
    ("3d7p", (16, 8, 256), 2, {8: 2, 16: 4}),
])
def test_deep_nd_plans_cost_a_pass_a_launch(name, shape, m, depths):
    """A chunk past the deepest register instance is consecutive launches,
    each a read and write of the grid with its own halo factor."""
    spec, jspec = stencils.make(name), jstencils.make(name)
    pts, n0 = math.prod(shape), shape[0]
    for depth, launches in depths.items():
        assert len(rs.launch_depths(spec, 8, m, depth)) == launches
        k, tt = 4, depth // 4
        plan = StencilPlan(backend="pallas", sweep="resident", k=k, ttile=tt, vl=8, m=m, t0=8)
        f, b, _ = rs.plan_terms(spec, shape, 4, plan, None)
        ds = rs.launch_depths(spec, 8, m, depth)
        ext = [1 + 2 * d * spec.r / n0 for d in ds]
        assert b == pytest.approx(sum(2 * pts * 4 * e for e in ext) / depth
                                  + 4 * pts * 4 / rs.RESIDENT_AMORT_STEPS)
        assert f == pytest.approx(sum(d * pts * (spec.flops_per_point + 4 / m) * e
                                      for d, e in zip(ds, ext)) / depth)
        jf, jb, _ = jrs.plan_terms(jspec, shape, 4, _ref(plan), None)
        if launches == 1:
            assert (f, b) == pytest.approx((jf, jb))
        else:
            assert b > jb


@pytest.mark.parametrize("name,shape,vl,m,depths", [
    ("1d3p", (4096,), 8, 1, {16: 1, 34: 2, 64: 2}),     # M = 1, r = 1: depth-32 launches
    ("1d5p", (4000,), 32, 5, {16: 1, 20: 2, 64: 4}),    # M = 1, r = 2: depth-16 launches
    ("1d5p", (4032,), 8, 6, {32: 1, 48: 2}),            # M = 2, r = 2: depth-32 launches
    ("1d3p", (4096,), 8, 8, {64: 1, 256: 1}),           # M = 8: one launch to 256
])
def test_deep_1d_plans_cost_a_pass_a_launch(name, shape, vl, m, depths):
    """A 1-D chunk deeper than 32·M // r is consecutive warp launches
    (``sweep1d_launches``), each a read and write of the grid with the halo
    factor of its own depth; one launch is the reference's accounting."""
    spec, jspec = stencils.make(name), jstencils.make(name)
    pts, n0 = math.prod(shape), shape[0]
    for depth, launches in depths.items():
        ds = rs.launch_depths(spec, vl, m, depth)
        assert len(ds) == launches and sum(ds) == depth
        assert ds == tuple(d for _, _, d in sk.sweep1d_launches(m, depth, spec.r))
        plan = StencilPlan(backend="pallas", sweep="resident", k=depth, ttile=1, vl=vl, m=m)
        f, b, _ = rs.plan_terms(spec, shape, 4, plan, depth)
        ext = [1 + 2 * d * spec.r / n0 for d in ds]
        assert b == pytest.approx(sum(2 * pts * 4 * e for e in ext) / depth
                                  + 4 * pts * 4 / depth)
        jf, jb, _ = jrs.plan_terms(jspec, shape, 4, _ref(plan), depth)
        if launches == 1:
            assert (f, b) == pytest.approx((jf, jb))
        else:
            assert b > jb


def test_launch_depths_follow_the_routes():
    assert rs.launch_depths(stencils.make("1d3p"), 8, 8, 64) == (64,)
    assert rs.launch_depths(stencils.make("1d3p"), 8, 1, 34) == (32, 2)
    assert rs.launch_depths(stencils.make("1d5p"), 32, 5, 20) == (16, 4)
    assert rs.launch_depths(stencils.make("1d5p"), 32, 3, 4) == (4,)
    assert rs.launch_depths(stencils.make("2d5p"), 8, 8, 16) == (4, 4, 4, 4)
    assert rs.launch_depths(stencils.make("2d5p"), 8, 12, 16) == (8, 8)
    assert rs.launch_depths(stencils.make("3d7p"), 8, 4, 6) == (4, 2)
    assert rs.launch_depths(stencils.make("3d27p"), 32, 8, 8) == \
        tuple(d for _, _, d in sk.sweep3d_launches(8, 8, 1))


@pytest.mark.parametrize("steps", [None, 16, 7])
@pytest.mark.parametrize("name,shape", [("1d3p", (4096,)), ("2d5p", (64, 256))])
def test_roundtrip_crop_is_a_view(name, shape, steps):
    """The roundtrip engine pays the wrap-pad copy and the layout round
    trip a sweep (6 grid transfers), the reference 8 (a crop copy too)."""
    spec, jspec = stencils.make(name), jstencils.make(name)
    plan = StencilPlan(backend="pallas", sweep="roundtrip", k=2, vl=8, m=8,
                       t0=8 if spec.ndim > 1 else None, remainder="native")
    _, b, _ = rs.plan_terms(spec, shape, 4, plan, steps)
    _, jb, _ = jrs.plan_terms(jspec, shape, 4, _ref(plan), steps)
    sweeps = rs._sweeps_per_step(2, steps, "native")
    assert jb - b == pytest.approx(2.0 * math.prod(shape) * 4 * sweeps)
    resident = dataclasses.replace(plan, sweep="resident")
    assert rs.estimate_plan_time(spec, shape, 4, resident, steps) < \
        rs.estimate_plan_time(spec, shape, 4, plan, steps)


@pytest.mark.parametrize("name,plan,transfers", [
    ("1d3p", StencilPlan(scheme="fused", k=1), 16),          # 2 rolls, 3 products, 2 sums
    ("1d3p", StencilPlan(scheme="reorg", k=1), 16),
    ("1d3p", StencilPlan(scheme="multiload", k=1), 14),      # a pad copy, slices
    ("1d3p", StencilPlan(scheme="transpose", k=1, vl=8, m=8), 14 + 4 / 16),
    ("1d3p", StencilPlan(scheme="dlt", k=1, vl=4), 14 + 4 / 16),
    ("1d3p", StencilPlan(scheme="transpose", k=4), 16),      # multistep_fused
    ("2d5p", StencilPlan(scheme="fused", k=1), 30),
    ("2d5p", StencilPlan(scheme="transpose", k=1, vl=8, m=8), 2 + 2 * 2 + 10 + 12 + 4 / 16),
    ("2d5p", StencilPlan(scheme="multiload", k=1), 4 + 10 + 12),
    ("3d27p", StencilPlan(scheme="fused", k=2), 2 * 26 + 54 + 78),
    ("2d5p", StencilPlan(scheme="fused", k=1, tiling="tessellate", tile=(8, 8), height=2),
     3 * (30 + 3)),
    ("2d5p", StencilPlan(scheme="transpose", k=1, tiling="tessellate", tile=(8, 8),
                         height=2), 3 * (4 + 28 + 3)),
])
def test_jnp_plans_are_priced_as_eager_passes(name, plan, transfers):
    spec = stencils.make(name)
    shape = (64, 64) if spec.ndim == 2 else (8, 8, 64) if spec.ndim == 3 else (4096,)
    pts = math.prod(shape)
    assert rs.jnp_transfers_per_step(spec, plan) == pytest.approx(transfers)
    f, b, c = rs.plan_terms(spec, shape, 4, plan, None)
    assert b == pytest.approx(transfers * pts * 4) and c == 0.0
    # the reference charges one fused read + write a k-block
    _, jb, _ = jrs.plan_terms(jstencils.make(name), shape, 4, _ref(plan), None)
    assert b > jb
    jf, _, _ = jrs.plan_terms(jstencils.make(name), shape, 4, _ref(plan), None)
    assert f == pytest.approx(jf * (spec.ndim + 1 if plan.tiling == "tessellate" else 1))


def test_tessellate_remainder_shares():
    spec = stencils.make("2d5p")
    plan = StencilPlan(scheme="fused", k=1, tiling="tessellate", tile=(8, 8), height=4,
                       remainder="fused")
    # 7 steps: one round of 4 (3 sub-steps of 33 transfers each a step), 3 single steps
    assert rs.jnp_transfers_per_step(spec, plan, 7) == pytest.approx((4 * 99 + 3 * 30) / 7)
    native = dataclasses.replace(plan, remainder="native")
    assert rs.jnp_transfers_per_step(spec, native, 7) == pytest.approx(99)


def test_mxu_bf16_is_charged_at_the_tensor_core_rate():
    spec, jspec, shape = stencils.make("2d5p"), jstencils.make("2d5p"), (64, 256)
    plan = StencilPlan(backend="mxu", k=2, vl=8, m=8)
    f, b, _ = rs.plan_terms(spec, shape, 2, plan, 16)
    assert rs.estimate_plan_time(spec, shape, 2, plan, 16) == \
        max(f / calibrate.PEAK_FLOPS_MXU_BF16, b / calibrate.HBM_BW)
    assert rs.estimate_plan_time(spec, shape, 4, plan, 16) == pytest.approx(
        max(rs.plan_terms(spec, shape, 4, plan, 16)[0] / calibrate.PEAK_FLOPS_MXU,
            rs.plan_terms(spec, shape, 4, plan, 16)[1] / calibrate.HBM_BW))
    # fitted constants without an mxu sample: the reference's fallback
    fitted = dataclasses.replace(CONSTS, peak_flops_mxu=0.0, peak_flops_mxu_bf16=0.0)
    assert rs.estimate_plan_time(spec, shape, 2, plan, 16, fitted) == pytest.approx(
        jrs.estimate_plan_time(jspec, shape, 2, _ref(plan), 16, fitted))


def test_distributed_plans_raise_naming_a9():
    spec = stencils.make("1d3p")
    with pytest.raises(NotImplementedError, match="A9"):
        rs.plan_terms(spec, (256,), 4, StencilPlan(backend="distributed", decomp=(2,)))
    with pytest.raises(NotImplementedError, match="A9"):
        rs.estimate_plan_time(spec, (256,), 4, StencilPlan(backend="mxu", decomp=(2,)))


def test_resident_per_run_cost_scales_inverse_with_steps():
    spec = stencils.make("1d3p")
    shape = (1 << 20,)
    plan = StencilPlan(backend="pallas", sweep="resident", k=2, vl=8, m=8)
    t16 = rs.estimate_plan_time(spec, shape, 4, plan, steps=16)
    t32 = rs.estimate_plan_time(spec, shape, 4, plan, steps=32)
    assert (t16 - t32) * calibrate.HBM_BW == pytest.approx(4.0 * shape[0] * 4 / 32, rel=1e-6)
    rt = dataclasses.replace(plan, sweep="roundtrip")
    assert rs.estimate_plan_time(spec, shape, 4, rt, 16) == \
        pytest.approx(rs.estimate_plan_time(spec, shape, 4, rt, 32))


def test_ttile_cuts_modeled_hbm_bytes_at_1d():
    spec = stencils.make("1d3p")
    shape = (1 << 20,)
    base = StencilPlan(backend="pallas", sweep="resident", k=2, vl=8, m=8)
    for steps in (16, 32, 64):
        _, b_base, _ = rs.plan_terms(spec, shape, 4, base, steps)
        _, b_tt, _ = rs.plan_terms(spec, shape, 4, dataclasses.replace(base, ttile=4), steps)
        assert b_base / b_tt >= 2.0


def _star(ndim, r):
    return (stencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                 stencils._star_taps(ndim, r)),
            jstencils.StencilSpec(f"star{ndim}d-r{r}", ndim, r, "star",
                                  jstencils._star_taps(ndim, r)))


def test_launch_depths_follow_the_routes_at_reach():
    """At r = 2..4 the 2-D and 3-D sweeps take the register kernels' chains
    (``sweep2d_launches`` / ``sweep3d_launches`` of reach r); r > 4 and
    more taps than the register kernels hold take the far-reach kernel's
    chain (``far_launches``: depth 8 a launch at 1-D, 1 at 2-D and 3-D)."""
    assert rs.launch_depths(_star(2, 2)[0], 8, 8, 4) == (2, 2)
    assert rs.launch_depths(_star(2, 2)[0], 8, 8, 16) == (2,) * 8
    assert rs.launch_depths(_star(2, 4)[0], 8, 5, 9) == (2, 2, 2, 2, 1)
    assert rs.launch_depths(_star(3, 2)[0], 8, 8, 2) == (2,)
    assert rs.launch_depths(_star(3, 2)[0], 8, 8, 8) == (2,) * 4
    assert rs.launch_depths(_star(3, 3)[0], 8, 8, 4) == (1,) * 4
    assert rs.launch_depths(_star(3, 4)[0], 16, 4, 3) == (1,) * 3
    assert rs.launch_depths(_star(2, 5)[0], 8, 8, 16) == (1,) * 16
    assert rs.launch_depths(_star(3, 5)[0], 8, 8, 4) == (1,) * 4
    assert rs.launch_depths(_star(1, 5)[0], 8, 8, 20) == (8, 8, 4)
    box = stencils.StencilSpec("box3d-r2", 3, 2, "box", stencils._box_taps(3, 2))
    assert rs.launch_depths(box, 8, 8, 2) == (1, 1)


@pytest.mark.parametrize("ndim,r,shape,vl,m,depths", [
    (2, 2, (256, 4096), 8, 8, {2: 1, 4: 2, 16: 8}),     # M = 8, r = 2: depth-2 launches
    (2, 3, (256, 4096), 8, 4, {2: 1, 3: 2, 8: 4}),      # M = 4, r = 3: depth-2 launches
    (3, 2, (64, 64, 512), 8, 8, {2: 1, 8: 4}),          # M = 8, r = 2: depth-2 launches
    (3, 4, (64, 64, 512), 8, 8, {1: 1, 4: 4}),          # M = 8, r = 4: depth-1 launches
])
def test_reach_chains_cost_a_pass_a_launch(ndim, r, shape, vl, m, depths):
    """A 2-D or 3-D chunk of reach r > 1 deeper than its instance's deepest
    is consecutive register launches, each a read and write of the grid
    with the halo factor of its own depth; one launch is the reference's
    accounting, term for term."""
    spec, jspec = _star(ndim, r)
    pts, n0 = math.prod(shape), shape[0]
    launcher = sk.sweep2d_launches if ndim == 2 else sk.sweep3d_launches
    for depth, launches in depths.items():
        ds = rs.launch_depths(spec, vl, m, depth)
        assert len(ds) == launches and sum(ds) == depth
        assert ds == tuple(d for _, _, d in launcher(m, depth, r))
        plan = StencilPlan(backend="pallas", sweep="resident", k=depth, ttile=1, vl=vl, m=m,
                           t0=16)
        f, b, _ = rs.plan_terms(spec, shape, 4, plan, depth)
        ext = [1 + 2 * d * r / n0 for d in ds]
        assert b == pytest.approx(sum(2 * pts * 4 * e for e in ext) / depth
                                  + 4 * pts * 4 / depth)
        jf, jb, _ = jrs.plan_terms(jspec, shape, 4, _ref(plan), depth)
        if launches == 1:
            assert (f, b) == pytest.approx((jf, jb))
        else:
            assert b > jb
