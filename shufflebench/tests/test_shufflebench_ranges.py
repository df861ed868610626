"""The reduction of a trace by the program's stage ranges
(``shufflebench/ranges.py``) on synthetic Chrome traces whose launches
and device operations share ``correlation`` ids."""

import copy
import json

import pytest

from shufflebench import ranges
from shufflebench import trace as tracing

MAIN, OTHER, THIRD = (1, 1), (1, 2), (1, 3)


def _ev(cat, name, ts, dur, thread=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                pid=thread[0], tid=thread[1], args=args)


def _range(stage, ts, dur, thread=MAIN):
    return _ev("user_annotation", ranges.PREFIX + stage, ts, dur, thread)


def _launch(ts, corr, thread=MAIN):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, thread,
               correlation=corr)


def _trace():
    """Two steps.  Step 1 launches from the sort, the splitters and
    their all_gather nested inside; step 2 launches outside any range
    while another thread is in one; a memcpy and a kernel run past the
    window's end or with no launch."""
    return {"traceEvents": [
        _ev("user_annotation", tracing.STEP, 0, 10),
        _ev("user_annotation", tracing.SYNC, 10, 90),
        _ev("user_annotation", tracing.STEP, 100, 10),
        _ev("user_annotation", tracing.SYNC, 110, 90),
        _range("terasort.local_sort", 1, 3),
        _range("terasort.splitters", 4, 5),
        _range("exchange.all_gather", 5, 3),
        _range("join.probe", 101, 2, OTHER),
        _range("terasort.merge", 165, 25, THIRD),
        _launch(2, 1),
        _launch(3, 5),
        _launch(4.5, 3),
        _launch(6, 2),
        _launch(102, 4),
        _ev("kernel", "sort_kernel", 5, 40, correlation=1),
        _ev("kernel", "nccl_kernel", 50, 10, correlation=2),
        _ev("gpu_memcpy", "Memcpy DtoD", 60, 10, correlation=3),
        _ev("kernel", "gather_kernel", 120, 50, correlation=4),
        _ev("kernel", "unlaunched", 175, 10),
        _ev("kernel", "tail_kernel", 195, 15, correlation=5),
        # the device-side copy of a range never counts as a launch
        _ev("gpu_user_annotation", ranges.PREFIX + "terasort.local_sort",
            5, 40),
        _ev("kernel", "after_window", 300, 10, correlation=1),
    ]}


def test_device_time_goes_to_the_innermost_range_of_its_launch():
    got = ranges.reduce(_trace())["ranges"]
    assert got == pytest.approx({
        # 40 us of the sort, and the tail kernel clipped to [195, 200)
        ranges.PREFIX + "terasort.local_sort": 45e-6,
        # launched inside the all_gather, which the splitters hold
        ranges.PREFIX + "exchange.all_gather": 10e-6,
        ranges.PREFIX + "terasort.splitters": 10e-6,
        # launched in no range of its own thread, and one with no launch
        ranges.OUTSIDE: 60e-6,
    })


def test_ranges_add_up_to_the_summary_kernels():
    t = _trace()
    got = ranges.reduce(t)["ranges"]
    assert sum(got.values()) == pytest.approx(
        sum(tracing.summarize(t)["kernels"].values()))


def test_idle_gaps_go_to_the_range_running_when_they_began():
    s = tracing.summarize(_trace())
    gaps = ranges.reduce(_trace())["range_gaps"]
    # [0, 5), [45, 50) and [70, 120) begin outside any range;
    # [170, 175) and [185, 195) inside the merge, on its own thread
    assert gaps == pytest.approx({
        ranges.OUTSIDE: 60e-6,
        ranges.PREFIX + "terasort.merge": 15e-6,
    })
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_reduce_leaves_the_trace_and_its_summary_as_they_were():
    t = _trace()
    before, summary = copy.deepcopy(t), tracing.summarize(t)
    ranges.reduce(t)
    assert t == before
    assert tracing.summarize(t) == summary
    assert set(summary) == {"steps", "window_s", "busy_s", "kernels",
                            "gaps"}


def test_a_trace_without_steps_is_reduced_over_its_events():
    t = {"traceEvents": [_range("join.pack", 0, 10), _launch(1, 7),
                         _ev("kernel", "k", 20, 5, correlation=7)]}
    got = ranges.reduce(t)
    assert got["ranges"] == pytest.approx(
        {ranges.PREFIX + "join.pack": 5e-6})
    # idle from the range's start to the kernel's
    assert got["range_gaps"] == pytest.approx(
        {ranges.PREFIX + "join.pack": 20e-6})
    assert ranges.reduce({"traceEvents": []}) == {"ranges": {},
                                                   "range_gaps": {}}


def test_mean_over_ranks():
    a = {"ranges": {"x": 2.0, "y": 1.0}, "range_gaps": {"x": 1.0}}
    b = {"ranges": {"x": 4.0}, "range_gaps": {}}
    assert ranges.mean([a, b]) == {"ranges": {"x": 3.0, "y": 0.5},
                                   "range_gaps": {"x": 0.5}}


def test_command_prints_ms_per_step(tmp_path, capsys):
    paths = []
    for r in range(2):
        p = tmp_path / f"rank{r}.json"
        p.write_text(json.dumps(_trace()))
        paths.append(str(p))
    assert ranges.main(paths) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps"] == 2
    per_step = out["ranges_ms_per_step"]
    assert list(per_step)[0] == ranges.OUTSIDE
    assert per_step[ranges.PREFIX + "terasort.local_sort"] == \
        pytest.approx(45e-3 / 2)
