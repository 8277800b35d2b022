"""Share of the traced window in which nothing ran on the device [%]:
1 - (union of the device-activity intervals / the window)."""


def read(record):
    if not record.get("window_s") or not record.get("busy_s"):
        return None          # no device trace, or nothing ran on the device
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
