"""The device trace's reading and the per-layer readers, on made-up
traces (a real one needs the card)."""

import json

import pytest

from benchmark import spec, tracing


def ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "ph": "X"}


def test_busy_idle_and_breakdown(tmp_path):
    events = [
        ev("bench.window", "user_annotation", 1000, 1000),
        ev("bench.encode", "user_annotation", 1000, 100),
        ev("bench.collect", "user_annotation", 1440, 560),
        ev("antidiag", "kernel", 1100, 200),
        ev("antidiag", "kernel", 1250, 100),       # overlaps the first
        ev("Memcpy DtoH", "gpu_memcpy", 1500, 50),
        ev("antidiag", "kernel", 1900, 200),       # runs past the window
        ev("bench.encode", "gpu_user_annotation", 1000, 900),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    d = tracing.read_chrome_trace(str(path))
    assert d["window_s"] == pytest.approx(1e-3)
    # kernels 1100-1350 and 1900-2000, the copy 1500-1550
    assert d["kernel_busy_s"] == pytest.approx(350e-6)
    assert d["busy_s"] == pytest.approx(400e-6)
    assert d["kernel_s"] == pytest.approx(400e-6)
    assert d["device_ops"][0] == ["antidiag", pytest.approx(400e-6)]
    idle = dict(d["idle_gaps"])
    # gaps 1000-1100 (in encode), 1350-1500 (1440 on in collect),
    # 1550-1900 (in collect)
    assert idle["host.encode"] == pytest.approx(100e-6)
    assert idle["host.other"] == pytest.approx(90e-6)
    assert idle["host.collect"] == pytest.approx(60e-6 + 350e-6)


def trace(traceback, kernel_s=0.2, source="profiler"):
    return {"traceback": traceback,
            "spans": {"encode": [0.01, 0.03], "pack": [0.02, 0.02]},
            "pairs": [1024, 1024], "n_buckets": [16, 16], "least_s": 0.02,
            "device": {"kernel_s": kernel_s, "kernel_busy_s": 0.15,
                       "busy_s": 0.16, "window_s": 0.3, "source": source}}


def test_readers():
    r = {m: spec.reader(m) for m in (
        "encode_ms", "pack_ms", "pairs_per_bucket", "score_roofline",
        "tb_roofline", "device_idle_pct")}
    t = trace(False)
    assert r["encode_ms"](t) == pytest.approx(20.0)
    assert r["pack_ms"](t) == pytest.approx(20.0)
    assert r["pairs_per_bucket"](t) == 64.0
    assert r["score_roofline"](t) == pytest.approx(10.0)
    assert r["tb_roofline"](t) is None
    assert r["tb_roofline"](trace(True)) == pytest.approx(10.0)
    assert r["score_roofline"](trace(True)) is None
    assert r["device_idle_pct"](t) == pytest.approx(50.0)
    # nothing to read: no share of a roofline, never 0
    assert r["score_roofline"](trace(False, kernel_s=0.0)) is None
    assert r["device_idle_pct"](trace(False, source="none")) is None


def test_a_trace_without_kernel_time_fails_the_run(tmp_path, monkeypatch):
    from benchmark import harness

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": [
                    ev("bench.window", "user_annotation", 0, 1000),
                    ev("memcpy", "gpu_memcpy", 10, 5)]}, f)

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(SystemExit, match="no kernel time"):
        harness._trace_data(Prof(), True, None, None, [], None, [], False,
                            1e-3)
