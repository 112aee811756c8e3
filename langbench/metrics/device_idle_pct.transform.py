"""``device_idle_pct.transform``: the share of the traced window in which no
operation ran on the device, in %."""


def read(rec: dict) -> float | None:
    dev = rec.get("device")
    if rec["entry"] != "transform" or not dev or dev["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
