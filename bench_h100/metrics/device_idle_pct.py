"""device_idle_pct: the share of the window's time in which the device had
nothing to run: one less the device's busy time a batch over the window's
time a batch. The busy time is the union of the device intervals (kernels,
copies, memsets) of the traced stretch (the mix's trace_batches batches after
the window, profiled with the device's activity alone), over its batches;
the window's time a batch is its host-clock seconds over its batches. The
profiler slows the host, not the device, so the stretch's own wall time
would count the profiler's cost as idle."""


def read(run):
    tr, batches = run.trace, len(run.feed.lat)
    if tr is None or not tr.cuda or tr.busy_s <= 0 or not batches:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.batches) / (run.window_s / batches))
