"""Spans of the serving path (`StageTimer`), and the device time of one
call of a function (`cuda_ms`).

A `StageTimer` records nested spans, each a begin and an end. A span's
duration comes from CUDA events on the current stream inside a call on a
CUDA device (`video`), and from the host clock elsewhere, so nothing
synchronizes until `totals()` reads them. While a span is open the timer
holds a `torch.profiler.record_function` range `inpaint.<span>`, so a
profiler trace puts each span on the clock of the device's kernels and
copies, inside the root range `inpaint.video` of its call.

Inside a call the timer also counts, where the build has CUDA:
`host_syncs`, each point at which the host waited for the device (PyTorch's
sync debug mode set to "warn" for the call, its warnings counted),
`device_alloc_calls`, the caching allocator's calls to the driver
(`num_device_alloc + num_device_free` of its statistics),
`conv_launches`, `raft_conv_launches` and `encoder_conv_launches`, the
launches of C, the float32 convolution kernel, by feat_prop's, RAFT's and
the encoder's entry point (kernels/conv.py `LAUNCHES["conv3x3"]`,
`["raft_conv"]` and `["encoder"]`). Each is read at every span boundary
and charged to the innermost open span. The program adds counts of its
own with `count` (ProPainter's `raft_iterations`, `attn_rows_flagged` and
`attn_rows_frame`), charged likewise. Spans and counts stay in memory
until `totals()` reads them.
"""

import contextlib
import statistics
import time
import warnings

import torch

RANGE_PREFIX = "inpaint."
SYNC_WARNING = "called a synchronizing CUDA operation"


def cuda_ms(fn, iters=10, warmup=2) -> float:
    """Median device time of fn() in ms over `iters` calls after `warmup`,
    each between two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _alloc_calls():
    # the nested form: memory_stats() flattens and sorts every statistic
    stats = torch.cuda.memory_stats_as_nested_dict()
    return stats["num_device_alloc"] + stats["num_device_free"]


class StageTimer:
    """Nested spans and the counters charged to them; see the module."""

    def __init__(self):
        self._cuda = False
        self._open = []          # [name, begin stamp, profiler range]
        self._closed = []        # (name, begin stamp, end stamp)
        self._syncs = 0
        self._readers = {}       # counter -> () -> running count
        self._last = {}          # counter -> count at the last boundary
        self._counts = {}        # counter -> {span: count}

    def _stamp(self):
        if not self._cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _boundary(self):
        """Charge what each counter counted since the last boundary to the
        innermost open span."""
        span = self._open[-1][0] if self._open else None
        for name, read in self._readers.items():
            now = read()
            n = now - self._last[name]
            self._last[name] = now
            by_span = self._counts.setdefault(name, {})
            by_span[None] = by_span.get(None, 0) + n
            if span is not None:
                by_span[span] = by_span.get(span, 0) + n

    def _begin(self, name, stamp):
        rng = torch.profiler.record_function(RANGE_PREFIX + name)
        rng.__enter__()
        self._open.append([name, stamp, rng])

    def _end(self, name, stamp):
        if not self._open or self._open[-1][0] != name:
            raise ValueError(f"span {name!r} is not the innermost open one "
                             f"({[s[0] for s in self._open]})")
        _, begin, rng = self._open.pop()
        rng.__exit__(None, None, None)
        self._closed.append((name, begin, stamp))

    def begin(self, name: str):
        """Open span `name`, nested in the innermost open one."""
        self._boundary()
        self._begin(name, self._stamp())

    def end(self, name: str):
        """Close span `name`, which must be the innermost open one."""
        self._boundary()
        self._end(name, self._stamp())

    def mark(self, name: str, then: str | None = None):
        """Close span `name` and, if given, open span `then` at the same
        instant: the boundary between two stages."""
        self._boundary()
        stamp = self._stamp()
        self._end(name, stamp)
        if then is not None:
            self._begin(then, stamp)

    def count(self, name: str, n: int):
        """Add n, a number the host already holds, to the counter `name`,
        charged to the innermost open span."""
        span = self._open[-1][0] if self._open else None
        by_span = self._counts.setdefault(name, {})
        by_span[None] = by_span.get(None, 0) + n
        if span is not None:
            by_span[span] = by_span.get(span, 0) + n

    @contextlib.contextmanager
    def video(self, device):
        """Record one call on `device`: the root range `inpaint.video` (in
        a trace only), and the counters where the build has CUDA. Spans
        left open by an exception are closed, and the sync debug mode and
        warning filters found are restored."""
        self._cuda = torch.device(device).type == "cuda"
        with contextlib.ExitStack() as stack:
            stack.enter_context(
                torch.profiler.record_function(RANGE_PREFIX + "video"))
            self._readers = self._counters(stack)
            self._last = {name: read() for name, read in
                          self._readers.items()}
            try:
                yield self
            finally:
                while self._open:
                    self.end(self._open[-1][0])
                self._boundary()
                self._readers = {}

    def _counters(self, stack):
        """The counters this build can read, their set-up entered on
        `stack`."""
        try:
            mode = torch.cuda.get_sync_debug_mode()
        except (AssertionError, RuntimeError):      # no CUDA in this build
            return {}
        stack.enter_context(warnings.catch_warnings())
        shown = warnings.showwarning

        def showwarning(message, category, *rest):
            if str(message).startswith(SYNC_WARNING):
                self._syncs += 1
            else:
                shown(message, category, *rest)

        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = showwarning
        torch.cuda.set_sync_debug_mode("warn")
        stack.callback(torch.cuda.set_sync_debug_mode, mode)
        from e2fgvi_tpu_torch.kernels import conv
        readers = {"host_syncs": lambda: self._syncs,
                   "conv_launches": lambda: conv.LAUNCHES["conv3x3"],
                   "raft_conv_launches": lambda: conv.LAUNCHES["raft_conv"],
                   "encoder_conv_launches": lambda: conv.LAUNCHES["encoder"]}
        if "num_device_alloc" in torch.cuda.memory_stats_as_nested_dict():
            readers["device_alloc_calls"] = _alloc_calls
        return readers

    def totals(self) -> dict:
        """Milliseconds per span name, summed over the spans closed since
        the last call; each counter's sum under its name and its split by
        span under `<counter>.<span>`. Resets."""
        if self._closed and not isinstance(self._closed[-1][2], float):
            self._closed[-1][2].synchronize()    # the last event recorded
        out = {}
        for name, begin, end in self._closed:
            ms = ((end - begin) * 1e3 if isinstance(begin, float)
                  else begin.elapsed_time(end))
            out[name] = out.get(name, 0.0) + ms
        for counter, by_span in self._counts.items():
            for span, n in by_span.items():
                out[counter if span is None else f"{counter}.{span}"] = n
        self._closed, self._counts = [], {}
        return out


class NoSpans:
    """StageTimer's stand-in for an untimed call: every method does
    nothing, so the call runs the statements it runs timed."""

    def begin(self, name):
        pass

    def end(self, name):
        pass

    def mark(self, name, then=None):
        pass

    def count(self, name, n):
        pass


NO_SPANS = NoSpans()
