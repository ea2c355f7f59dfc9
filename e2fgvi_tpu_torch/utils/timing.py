"""Per-stage device time of the serving path, from CUDA events.

`start()` records an event; each `mark(name)` records another and charges
the time since the previous event to `name`. Events ride the current
stream, so nothing synchronizes until `totals()` reads them.
"""

import torch


class StageTimer:
    def __init__(self):
        self._events = []           # (name or None, event)

    def _record(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._events.append((name, ev))

    def start(self):
        self._record(None)

    def mark(self, name: str):
        self._record(name)

    def totals(self) -> dict:
        """Milliseconds per stage name, summed over marks; resets."""
        torch.cuda.synchronize()
        out = {}
        for (_, prev), (name, ev) in zip(self._events, self._events[1:]):
            if name is not None:
                out[name] = out.get(name, 0.0) + prev.elapsed_time(ev)
        self._events = []
        return out
