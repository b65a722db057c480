"""The device's idle share of the traced window, %: 100 less the frames'
device spans (each from its march's start event to its phase 2's end
event, on one stream so they do not overlap) over the window's wall."""

MOVES = "fps"


def read(t):
    if not t.busy_ms or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(t.busy_ms) / 1e3 / t.window_s)
