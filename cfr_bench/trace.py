"""The traced run's device readings: torch.profiler over the whole window,
reduced to the card's busy time, the port's kernels' device time, the
device operations that took the most time and the idle gaps by what the
serving thread was doing.

Busy time is the union of the device operations' intervals inside the
window (kernels, copies, sets).  It holds only where the profiler kept
every launch of the port's kernels that the wrappers counted
(kernels.LAUNCHES); where it kept fewer, the run is malformed (Malformed),
never a guess.
"""

import bisect
import collections
import re
import time

MARK = "cfr_bench.window"
_KERNEL = re.compile(r"(\w+)_kernel<")


class Malformed(RuntimeError):
    pass


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_mark = None

    def mark(self):
        """Ties the profiler's clock to time.perf_counter at the window's start."""
        import torch
        with torch.profiler.record_function(MARK):
            self.t_mark = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def reduce(self, w0, w1, launched, serving):
        """(busy_s, kernel_s, device_ops, idle_gaps) over [w0, w1] (perf_counter
        seconds); `launched`: the wrappers' launch counts in the window;
        `serving`: the serving thread's (name, t0, t1) spans."""
        from torch.autograd import DeviceType
        events = self.prof.events()
        mark = [e for e in events if e.name == MARK]
        if not mark:
            raise Malformed("the profiler kept no %s marker" % MARK)
        off = self.t_mark - mark[0].time_range.start / 1e6
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        kept = collections.Counter()
        ivs, by_name = [], collections.Counter()
        kernel_s = 0.0
        for e in dev:
            a = e.time_range.start / 1e6 + off
            b = e.time_range.end / 1e6 + off
            m = _KERNEL.search(e.name)
            if m:
                kept[m.group(1)] += 1
            if b <= w0 or a >= w1:
                continue
            a, b = max(a, w0), min(b, w1)
            ivs.append((a, b))
            if m:
                kernel_s += b - a
                name = e.name[m.start():][:80]
            else:
                name = e.name[:80]
            by_name[name] += b - a
        want = collections.Counter()
        for name, n in launched.items():
            want[name.split(":")[0]] += n
        lost = ["%s kept %d of %d" % (k, kept[k], n) for k, n in sorted(want.items())
                if kept[k] < n]
        if lost:
            raise Malformed("the profiler kept fewer launches than the wrappers "
                            "counted: " + ", ".join(lost))
        ivs.sort()
        busy, gaps = 0.0, []
        cur_a = cur_b = w0
        for a, b in ivs:
            if a > cur_b:
                busy += cur_b - cur_a
                gaps.append((cur_b, a))
                cur_a = a
            cur_b = max(cur_b, b)
        busy += cur_b - cur_a
        if w1 > cur_b:
            gaps.append((cur_b, w1))
        return busy, kernel_s, by_name.most_common(10), _label_gaps(gaps, serving)


def _label_gaps(gaps, serving):
    """Idle seconds by the serving thread's innermost span at each gap's
    middle ("loop" where none was open)."""
    inner = [s for s in serving if s[0] in ("wait", "batch_queries")]
    outer = [s for s in serving if s[0] not in ("wait", "batch_queries")]
    inner.sort(key=lambda s: s[1])
    outer.sort(key=lambda s: s[1])
    starts_i = [s[1] for s in inner]
    starts_o = [s[1] for s in outer]
    out = collections.Counter()
    for a, b in gaps:
        mid = (a + b) / 2
        label = "loop"
        for spans, starts in ((inner, starts_i), (outer, starts_o)):
            k = bisect.bisect_right(starts, mid) - 1
            if k >= 0 and spans[k][2] >= mid:
                label = spans[k][0]
                break
        out["serving:" + label] += b - a
    return out.most_common(10)
