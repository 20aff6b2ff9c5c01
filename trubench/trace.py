"""Device time from torch.profiler over a bounded slice of calls.

`profile_slice(call, calls, gru_launches)` profiles `calls` calls of
`call()`, ended by a synchronize, recording the device's activity alone,
and returns a `Slice`: every device operation (kernels, copies, sets) with
its start and end, and the slice's length on the host's clock. Recording
the host's operations too costs a serving call ~1-4 ms of host time, which
would read as device idle time, so the harness's spans (the names of what
the host was doing) come from a second, shorter profile with the host's
activity (`host=True`), which names the idle gaps of the breakdown. The
profiler has been seen to lose kernel records (`chip_smoke.py`
`device_ms`, :482-534 at commit d4c8964, whose check this copies): a
reading holds only if the GRU kernel records it holds equal the launches
the program counted over the slice (`cuda_gru.launch_counts()`); it is
taken again, three times in all, and then the traced run fails rather
than report a low time.

`KERNEL_KINDS` and `kind_of` are copied from `chip_smoke.py:335-343,
1773-1777` at commit d4c8964.
"""

from __future__ import annotations

import dataclasses
import re
import time

import torch

KERNEL_KINDS = (
    ("gru_kernels", r"gru_"),
    ("fft", r"fft|FFT"),
    ("convolution", r"conv|cudnn|implicit|wgrad|dgrad|fprop|Conv"),
    ("matmul", r"gemm|cutlass|sm90_xmma|ampere_sgemm|Kernel2|nvjet"),
    ("reduction", r"reduce|Reduce|norm|Norm"),
    ("copy", r"copy|Copy|cat|transpose|Transpose|im2col|col2im|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled|pointwise|foreach"),
)
UNFUSED_KINDS = ("elementwise", "reduction", "copy")
GRU = re.compile(r"gru_")
NCCL = re.compile(r"nccl", re.IGNORECASE)
PAD_S = 0.05  # idle time before and after the slice, in case records near its edges go missing
RETAKES = 3


def kind_of(name: str) -> str:
    for kind, pattern in KERNEL_KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


@dataclasses.dataclass
class Slice:
    ops: list  # (name, start_us, end_us) of every device operation in the slice
    spans: list  # (name, start_us, end_us) of the harness's spans (a profile with the host's activity)
    start: float  # us, the device timeline's start of the slice
    end: float
    seconds: float  # the slice's length, host clock
    named_gaps: list | None = None  # idle gaps by the host's span, from a profile with the host's activity

    def kernels(self, pattern: re.Pattern) -> list:
        return [op for op in self.ops if pattern.search(op[0])]

    def device_s(self, ops=None) -> float:
        return sum(e - s for _, s, e in (self.ops if ops is None else ops)) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        totals: dict[str, float] = {}
        for name, s, e in self.ops:
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return sorted(([n[:200], t] for n, t in totals.items()), key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time between device operations, summed by the innermost
        harness span open on the host where the gap began."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        totals: dict[str, float] = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            open_spans = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = min(open_spans, key=lambda sp: sp[2] - sp[1])[0] if open_spans else "outside the harness's spans"
            totals[name] = totals.get(name, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in totals.items()), key=lambda x: -x[1])[:top]


def _read(prof, label: str, seconds: float) -> Slice:
    from torch.autograd import DeviceType

    ops, spans, outer = [], [], None
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.name.startswith("bench."):  # a harness span, on the host or mirrored on the device's timeline
            if ev.device_type == DeviceType.CUDA:
                continue
            spans.append((ev.name, *rng))
            if ev.name == label:
                outer = rng
        elif ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, *rng))
    if outer is None:
        if spans or not ops:
            raise RuntimeError(f"torch.profiler recorded no {label!r} span")
        outer = (min(op[1] for op in ops), max(op[2] for op in ops))
    return Slice(ops, spans, outer[0], outer[1], seconds)


def profile_slice(call, calls: int, gru_launches, host: bool = False) -> Slice:
    """`calls` calls of call() under torch.profiler, checked as the module
    docstring says; with `host`, the host's activity and spans recorded too.
    `gru_launches()` is the program's count of GRU kernel launches so far."""
    from torch.profiler import ProfilerActivity, profile, record_function

    label = "bench.slice"
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    readings = []
    for _ in range(RETAKES):
        before = gru_launches()
        with profile(activities=activities) as prof:
            time.sleep(PAD_S)
            with record_function(label):
                start = time.perf_counter()
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - start
            time.sleep(PAD_S)
        expected = gru_launches() - before
        sl = _read(prof, label, seconds)
        got = len(sl.kernels(GRU))
        readings.append((got, expected))
        if got == expected and sl.ops:
            return sl
    raise RuntimeError(f"torch.profiler: GRU kernel records (held, launched) {readings}: never all of them")


def traced(call, calls: int, named_calls: int, gru_launches) -> Slice:
    """The slice of `calls` calls (device activity alone), its idle gaps
    named from `named_calls` more calls profiled with the host's spans."""
    sl = profile_slice(call, calls, gru_launches)
    sl.named_gaps = profile_slice(call, named_calls, gru_launches, host=True).idle_gaps()
    return sl
