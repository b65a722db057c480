"""March iterations a frame: the rasterizer launches the march graphs ran
over the window (the program's device counter, read once after it) over
the window's frames."""

MOVES = "fps"


def read(t):
    if t.iterations is None or not t.frames:
        return None
    return t.iterations / t.frames
