"""``repro_torch.core.locked_json``, the locked read-merge-write helper the
port's plan cache and calibration share: the reference's tests
(``tests/test_locked_json.py``) against the port's modules, and the two
helpers' behaviour held against the reference's copy on the same files."""
import json
import os
import threading

import pytest

from repro.core import locked_json as ref_json
from repro_torch.core import autotune, locked_json
from repro_torch.core.api import StencilPlan
from repro_torch.roofline import calibrate


# ---------------------------------------------------------------------------
# the helper itself
# ---------------------------------------------------------------------------

def test_read_json_missing_and_corrupt(tmp_path):
    assert locked_json.read_json(str(tmp_path / "nope.json")) is None
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    assert locked_json.read_json(str(p)) is None


def test_locked_update_creates_dirs_and_writes_atomically(tmp_path):
    path = str(tmp_path / "deep" / "er" / "f.json")
    out = locked_json.locked_update(path, lambda raw: {"raw": raw, "n": 1})
    assert out == {"raw": None, "n": 1}
    with open(path) as f:
        assert json.load(f) == {"raw": None, "n": 1}
    out2 = locked_json.locked_update(path, lambda raw: {"n": raw["n"] + 1})
    assert out2["n"] == 2
    # no stray tempfiles left behind
    assert sorted(os.listdir(os.path.dirname(path))) == ["f.json", "f.json.lock"]


def test_locked_update_merge_exception_preserves_file(tmp_path):
    path = str(tmp_path / "f.json")
    locked_json.locked_update(path, lambda raw: {"keep": True})
    with pytest.raises(RuntimeError):
        locked_json.locked_update(
            path, lambda raw: (_ for _ in ()).throw(RuntimeError("boom")))
    assert locked_json.read_json(path) == {"keep": True}


def test_locked_update_on_written_runs_inside_lock(tmp_path):
    path = str(tmp_path / "f.json")
    seen = []
    locked_json.locked_update(path, lambda raw: {"x": 1},
                              on_written=lambda: seen.append(locked_json.read_json(path)))
    assert seen == [{"x": 1}]           # file already replaced when called


def test_locked_update_concurrent_counter(tmp_path):
    """N threads × M increments: every increment survives."""
    path = str(tmp_path / "counter.json")

    def bump(raw):
        return {"n": (raw or {}).get("n", 0) + 1}

    def worker():
        for _ in range(20):
            locked_json.locked_update(path, bump)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert locked_json.read_json(path)["n"] == 8 * 20


@pytest.mark.parametrize("content", ['{"a": [1, 2.5, null]}', "{not json", "", "[1, 2]"])
def test_read_json_matches_reference(tmp_path, content):
    p = tmp_path / "f.json"
    p.write_text(content)
    assert locked_json.read_json(str(p)) == ref_json.read_json(str(p))


def test_files_interchange_with_reference(tmp_path):
    """The two copies write the same file, and each reads the other's."""
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    payload = {"version": 2, "entries": {"k": {"x": [1, 2]}}}
    assert locked_json.locked_update(a, lambda raw: payload) == \
        ref_json.locked_update(b, lambda raw: payload)
    assert open(a).read() == open(b).read()
    assert ref_json.read_json(a) == locked_json.read_json(b) == payload


# ---------------------------------------------------------------------------
# both call sites, concurrently
# ---------------------------------------------------------------------------

def _rec(scheme):
    return {"plan": autotune.plan_to_dict(StencilPlan(scheme=scheme)), "seconds_per_step": 1.0}


def test_concurrent_plan_cache_and_calibration_writers(tmp_path):
    """Every plan-cache key survives, and the calibration ratchet sees every
    sample batch (n_samples adds up exactly)."""
    cache_path = str(tmp_path / "plans.json")
    const_path = str(tmp_path / "roofline_constants.json")
    n_writers, n_rounds = 4, 6
    errors = []

    def plan_writer(i):
        try:
            for j in range(n_rounds):
                c = autotune.PlanCache(cache_path)
                c.put(f"w{i}r{j}", _rec("fused"))
                c.save()
        except Exception as e:          # pragma: no cover
            errors.append(e)

    def calib_writer(i):
        try:
            for j in range(n_rounds):
                calibrate.record_samples(
                    [{"flops": 1e9 * (i + 1), "bytes": 1e8 * (j + 1), "coll_bytes": 0.0,
                      "seconds": 1.0}], device=f"dev{i}", path=const_path)
        except Exception as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=plan_writer, args=(i,)) for i in range(n_writers)]
    threads += [threading.Thread(target=calib_writer, args=(i,)) for i in range(n_writers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors

    fresh = autotune.PlanCache(cache_path)
    assert len(fresh) == n_writers * n_rounds
    for i in range(n_writers):
        for j in range(n_rounds):
            assert fresh.get(f"w{i}r{j}") is not None

    devs = calibrate._load_devices(const_path)
    assert set(devs) == {f"dev{i}" for i in range(n_writers)}
    for i in range(n_writers):
        e = devs[f"dev{i}"]
        assert e["n_samples"] == n_rounds          # no batch lost
        assert e["peak_flops"] == pytest.approx(1e9 * (i + 1))
        assert e["hbm_bw"] == pytest.approx(1e8 * n_rounds)   # max ratchet


def test_shared_plan_cache_instance_put_save_race(tmp_path):
    """put() racing save() on one shared instance neither crashes nor
    loses an entry."""
    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    n_keys, errors = 120, []
    stop = threading.Event()

    def putter():
        try:
            for i in range(n_keys):
                cache.put(f"k{i}", _rec("fused"))
        except Exception as e:          # pragma: no cover
            errors.append(e)
        finally:
            stop.set()

    def saver():
        try:
            while not stop.is_set():
                cache.save()
        except Exception as e:          # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=putter)] + \
        [threading.Thread(target=saver) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    cache.save()                        # flush whatever stayed dirty
    fresh = autotune.PlanCache(cache.path)
    missing = [f"k{i}" for i in range(n_keys) if fresh.get(f"k{i}") is None]
    assert not missing, missing
