"""The trace readers on a small canned Chrome trace: spans, launches by
correlation id, device operations, the busy union and the breakdown."""

import pytest

from benchmark.harness import trace


def ev(name, cat, tid, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


CANNED = {"traceEvents": [
    # main thread: backbone span holding two launches, then fcos
    ev("bench/backbone", "user_annotation", 1, 0, 100),
    ev("cudaLaunchKernel", "cuda_runtime", 1, 10, 5, correlation=1),
    ev("bench/fcos", "user_annotation", 1, 50, 20),  # nested in backbone
    ev("cudaLaunchKernel", "cuda_runtime", 1, 55, 5, correlation=2),
    ev("cudaLaunchKernel", "cuda_runtime", 1, 80, 5, correlation=3),
    ev("cudaMemcpyAsync", "cuda_runtime", 1, 150, 5, correlation=4),
    # the autograd thread
    ev("autograd::engine::evaluate_function: ConvolutionBackward0",
       "cpu_op", 2, 200, 50),
    ev("cudaLaunchKernel", "cuda_runtime", 2, 210, 5, correlation=5),
    # device: kernel 1 and 2 overlap, a gap, then 3, the copy and 5
    ev("void stem_f32_kernel<true>(float)", "kernel", 7, 1000, 100, correlation=1),
    ev("sgemm_a", "kernel", 7, 1050, 100, correlation=2),
    ev("sgemm_b", "kernel", 7, 1300, 50, correlation=3),
    ev("Memcpy HtoD", "gpu_memcpy", 7, 1400, 10, correlation=4),
    ev("dgrad", "kernel", 7, 1500, 200, correlation=5),
    ev("ProfilerStep", "cpu_op", 1, 0, 3000),  # no span name: ignored
]}


def test_attribution_and_busy_time():
    s = trace.reduce_trace(CANNED)
    where = {name: span for name, span, _, _ in s["ops"]}
    assert where["void stem_f32_kernel<true>(float)"] == "backbone"
    assert where["sgemm_a"] == "fcos"  # the innermost open span
    assert where["sgemm_b"] == "backbone"
    assert where["Memcpy HtoD"] is None  # launched outside every span
    assert where["dgrad"] == "backward"
    # union: [1000, 1150) + [1300, 1350) + [1400, 1410) + [1500, 1700)
    assert s["busy_s"] == pytest.approx(410e-6)
    assert trace.span_seconds(s, "backbone") == pytest.approx(150e-6)
    assert trace.kernel_seconds(s, "stem_f32_kernel") == (
        pytest.approx(100e-6), 1)


def test_breakdown_lists_ops_and_gaps():
    b = trace.breakdown(trace.reduce_trace(CANNED))
    assert b["device_ops"][0][0] == "dgrad"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    gaps = [g for _, g in b["idle_gaps"]]
    assert gaps == sorted(gaps, reverse=True)
    assert gaps[0] == pytest.approx(150e-6)  # 1150 -> 1300
    assert b["idle_gaps"][0][0].startswith("before backbone")


def test_union_of_intervals():
    assert trace.union_seconds([]) == 0.0
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
