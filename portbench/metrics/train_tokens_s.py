"""Tokens of every WCT step of the window (batch x sequence, padding
included) over the window's time (host clock, to the device's end of the
last step)."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    return run.steps * run.mix["batch"] * run.mix["seq"] / run.window_s
