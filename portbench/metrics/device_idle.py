"""device_idle.<part>: 100 (1 - busy / window) over the profiled
sub-window, busy the union of the device's kernel, memcpy and memset
intervals (device trace).  The part names the cell's unit and changes
nothing here."""


def read(run, part, traffic):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
