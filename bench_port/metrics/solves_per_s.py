"""2 iLQR solves a lane a step: 2 · B · (closed-loop steps completed in the window) over
the window's seconds, which hold whole episodes and end in a synchronize."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return 2.0 * rec["B"] * rec["steps"] / rec["window_s"]
