"""The reading of a canned profiler trace into busy time, idle share, ranges
and kernels, and the per-layer readers over it."""

import json
from types import SimpleNamespace

import pytest

from benchmark.harness import manifest as mf
from benchmark.harness.counts import PEAK_FLOPS, bound_s
from benchmark.harness.trace import Trace

MAIN, AUTOGRAD = 1, 2
SELECT = "void (anonymous namespace)::select_kernel<16, false>(float4 const*, int)"


def _x(cat, name, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args}


def canned():
    """A 100 us window: two forwards on the main thread (a conv layer range
    around launches 1-2), a backward on the autograd thread (launch 3), a
    select kernel; device busy 10-30, 40-50, 60-80 and a copy 85-90."""
    return [
        _x("user_annotation", "bench.window", 0, 100),
        _x("cpu_op", "aten::mm", 2, 2),
        _x("user_annotation", "bench.contconv_collect", 5, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        _x("cpu_op", "aten::copy_", 30, 15),
        _x("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 50, 10, tid=AUTOGRAD),
        _x("cuda_runtime", "cudaLaunchKernel", 52, 1, tid=AUTOGRAD, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=4),
        _x("cuda_runtime", "cudaMemcpyAsync", 84, 1, correlation=5),
        _x("kernel", "void pair_product_kernel<true>()", 10, 10, correlation=1),
        _x("kernel", "void bins_kernel()", 20, 10, correlation=2),
        _x("kernel", "void gemm_kernel()", 40, 10, correlation=3),
        _x("kernel", SELECT, 60, 20, correlation=4),
        _x("gpu_memcpy", "Memcpy DtoD", 85, 5, correlation=5),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 1},
    ]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": canned()}))
    return Trace.from_file(str(path))


def test_window_busy_and_idle(trace):
    assert trace.window_s == pytest.approx(100e-6)
    assert trace.busy() == [(10, 30), (40, 50), (60, 80), (85, 90)]
    assert trace.busy_s() == pytest.approx(55e-6)


def test_device_work_under_host_ranges(trace):
    calls, s = trace.device_s_under(lambda n: n == "bench.contconv_collect")
    assert (calls, s) == (1, pytest.approx(20e-6))
    calls, s = trace.device_s_under(lambda n: n.startswith("autograd::engine::evaluate_function"))
    assert (calls, s) == (1, pytest.approx(10e-6))


def test_kernels_by_name_and_the_breakdown(trace):
    assert trace.kernels(lambda n: "select_kernel" in n) == (1, pytest.approx(20e-6))
    ops = trace.device_ops()
    assert ops[0] == ["void (anonymous namespace)::select_kernel<16, false>(float4 const*, int)", pytest.approx(20e-6)]
    gaps = dict((n, s) for n, s in trace.idle_gaps())
    # idle 0-10 (middle under the collect range), 30-40 (under copy_), and
    # 50-60, 80-85, 90-100 with no range open on the main thread
    assert gaps["bench.contconv_collect"] == pytest.approx(10e-6)
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["(no host range)"] == pytest.approx(25e-6)
    assert sum(gaps.values()) == pytest.approx(45e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        Trace([_x("kernel", "k", 0, 1, correlation=1)])


def _ctx(trace, kind, **counts):
    work = {"kind": kind, "steps": 2}
    return SimpleNamespace(trace=trace, work=work, counts=counts, config={}, traffic={})


def test_readers(trace):
    idle = mf.reader("idle_share.rollout").read(_ctx(trace, "rollout"))
    assert idle == pytest.approx(45.0)
    assert mf.reader("idle_share.train").read(_ctx(trace, "rollout")) is None
    assert mf.reader("backward_ms.train").read(_ctx(trace, "train")) == pytest.approx(5e-3)
    mfu = mf.reader("mfu.rollout").read(_ctx(trace, "rollout", forward_flops=1e6))
    assert mfu == pytest.approx(100 * 2e6 / (100e-6 * PEAK_FLOPS))
    assert mf.reader("mfu.train").read(_ctx(trace, "train", step_flops=3e6)) == pytest.approx(
        100 * 6e6 / (100e-6 * PEAK_FLOPS))
    b7 = (9e6, 1e3)
    sel = mf.reader("morton_select_roofline").read(_ctx(trace, "rollout", b7=b7))
    assert sel == pytest.approx(100 * bound_s(*b7)[0] / 20e-6)
    layers = [(4e6, 1e3), (2e6, 1e3)]
    cc = mf.reader("contconv_collect_roofline").read(_ctx(trace, "rollout", contconv_layers=layers))
    assert cc == pytest.approx(100 * 0.5 * (6e6 / PEAK_FLOPS) / 20e-6)
    assert mf.reader("contconv_collect_roofline").read(_ctx(trace, "rollout")) is None
    assert mf.reader("morton_select_roofline").read(_ctx(None, "rollout", b7=b7)) is None


@pytest.mark.parametrize("name", ["mfu.rollout", "idle_share.rollout", "morton_select_roofline"])
def test_a_refresh1_reader_reads_as_its_base(trace, name):
    ctx = _ctx(trace, "rollout", forward_flops=1e6, b7=(9e6, 1e3))
    value = mf.reader(name + ".refresh1").read(ctx)
    assert value is not None and value == mf.reader(name).read(ctx)


@pytest.mark.parametrize("name,hit", [
    ("void (anonymous namespace)::select_kernel<32, false>(float4 const*, int, int)", True),
    ("void select_kernel<16, true>(float4 const*)", True),
    ("void at::native::index_select_kernel<float, long>(float*, long const*)", False),
    ("void at::native::masked_select_kernel<float>()", False),
    ("void at::native::(anonymous namespace)::select_kernel_impl(float*)", False),
])
def test_the_select_reader_takes_the_ports_kernel_only(name, hit):
    kernel = mf.reader("morton_select_roofline").KERNEL
    assert (kernel.search(name) is not None) is hit
