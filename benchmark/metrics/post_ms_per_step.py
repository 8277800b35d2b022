"""Milliseconds a step inside the benchmark's span ``post`` around the
port's layer, closed by a device synchronisation, over the traced steps."""


def read(record):
    spans = record.get("spans") or {}
    if not record.get("steps") or "post" not in spans:
        return None
    return spans["post"] * 1e3 / record["steps"]
