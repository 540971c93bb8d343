"""Seconds from the start of the process to the start of the first timed episode."""


def read(rec):
    return rec.get("setup_s")
