"""The device's idle share of the profiled window: 1 minus the union of
the intervals in which a kernel, copy or set ran, over the window's wall,
in percent."""


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    t = prof["timeline"]
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
