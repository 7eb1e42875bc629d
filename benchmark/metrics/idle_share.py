"""Share of the traced run's profiled pass in which no operation ran on
the device: 1 - the union of the device's kernel and copy intervals over
the pass's wall time, in percent."""


def read(record):
    profile = record.profile
    if profile is None or profile["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - profile["busy_s"] / profile["window_s"])
