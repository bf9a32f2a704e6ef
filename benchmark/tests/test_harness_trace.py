"""The busy and idle arithmetic of the traced run, on made-up events."""

import json

import devtrace
import pytest


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (40, 50), (45, 48)]
    assert devtrace.union_s(iv) == pytest.approx(30e-6)
    assert devtrace.gaps(iv, 0, 100) == [(20, 40), (50, 100)]
    assert devtrace.gaps(iv, 8, 45) == [(20, 40)]


def test_summarise_clips_to_the_window_and_names_gaps():
    device = [("k1", -5, 10, "kernel"), ("k2", 5, 20, "kernel"), ("Memcpy HtoD", 40, 50,
                                                                   "gpu_memcpy"),
              ("Device Synchronize", 50, 90, "cuda_runtime")]
    host = [("aten::to", 18, 45), ("aten::copy_", 21, 39), ("aten::mm", 60, 61)]
    s = devtrace.summarise(device, host, (0, 100))
    assert s["busy_s"] == pytest.approx(30e-6)  # the synchronise does no work
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernel_s"] == pytest.approx(25e-6)  # k1 clipped to the window, the copy left out
    assert s["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    # each gap is named by the host operation that overlaps it most
    assert s["idle_gaps"][0] == ["aten::mm", pytest.approx(50e-6)]
    assert s["idle_gaps"][1] == ["aten::to", pytest.approx(20e-6)]
    lone = devtrace.summarise([("k", 0, 10, "kernel")], [], (0, 30))
    assert lone["idle_gaps"] == [["host, outside any torch operation", pytest.approx(20e-6)]]
    assert devtrace.idle_percent(s) == pytest.approx(70.0)
    assert devtrace.idle_percent(None) is None


def test_read_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW, "ts": 10, "dur": 90},
        {"ph": "X", "cat": "gpu_user_annotation", "name": devtrace.WINDOW, "ts": 10,
         "dur": 90},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 25, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 19, "dur": 1},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 20},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, host, window = devtrace.read_chrome_trace(path)
    assert window == (10.0, 100.0)
    assert device == [("k", 20.0, 25.0, "kernel"), ("Memcpy HtoD", 30.0, 35.0, "gpu_memcpy")]
    assert host == [("aten::to", 25.0, 45.0)]
