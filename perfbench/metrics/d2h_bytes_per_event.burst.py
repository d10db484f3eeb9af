"""Bytes the pool fetched from the device rings (pool_stats d2h_bytes)
per event delivered in the window."""


def read(rec):
    w = rec["window"]
    return w["stats"]["d2h_bytes"] / w["events"] if w["events"] else None
