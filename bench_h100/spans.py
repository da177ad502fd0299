"""CUDA events around calls of modules or functions, tagged with the harness's phase."""

from __future__ import annotations

import torch


class Timed:
    """Spans of the calls it wraps; the readers of module and function times share it."""

    def __init__(self, run):
        self.run = run
        self.spans = []          # (phase, forward index, start event, end event)

    def begin(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def end(self, start):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.spans.append((self.run.phase, self.run.forwards.get(self.run.phase, 0), start, ev))

    def modules(self, mods) -> list:
        """Hooks on each module's forward; returns the handles."""
        hooks = []
        for m in mods:
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: setattr(mod, "_bench_t0", self.begin())))
            hooks.append(m.register_forward_hook(lambda mod, args, out: self.end(mod._bench_t0)))
        return hooks

    def function(self, owner, name: str):
        """Wrap ``owner.name``; returns a handle whose ``remove()`` puts it back."""
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            t0 = self.begin()
            out = fn(*args, **kwargs)
            self.end(t0)
            return out
        setattr(owner, name, timed)
        return _Restore(owner, name, fn)

    def per_batch_ms(self, phase: str = "window"):
        """Mean over the phase's forwards of the summed span times (ms); None
        where nothing ran."""
        torch.cuda.synchronize()
        per = {}
        for ph, k, a, b in self.spans:
            if ph == phase:
                per[k] = per.get(k, 0.0) + a.elapsed_time(b)
        return sum(per.values()) / len(per) if per else None


class _Restore:
    def __init__(self, owner, name, fn):
        self.owner, self.name, self.fn = owner, name, fn

    def remove(self):
        setattr(self.owner, self.name, self.fn)
