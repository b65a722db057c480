"""Interactive frontend: the reference's live input loop + on-screen stats
(UnityManager.Update / OnGUI, UnityManager.cs:77-161,368-412), TPU-native.

`InteractiveSession` is the frontend-agnostic core: it owns the renderer, the
camera, and the reference's controllers (`MouseLook` smoothing + pitch clamp,
`FlyMovement` WASD with scroll speed scaling), consumes per-tick input events,
and produces frames in the reference's render modes (1 = screen, 2/3 = raw
raybuffer debug views, UnityManager.cs:126-134).  `run_terminal` drives it from
a live terminal: frames draw as ANSI truecolor half-blocks, so the whole
interactive loop — input, controllers, render, present — runs end-to-end in a
headless environment; latency (not just throughput) is what it exercises.

The counterpart of ``cpuvox_tpu/frontend/interactive.py`` over the port's
Renderer, which works on the card unless ``create`` is given another
device.  A step's frame is a numpy array on the host, so each step waits for
its frame, as a user at the screen does.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from cpuvox_tpu_torch.config import RenderConfig
from cpuvox_tpu_torch.render import camera as cm
from cpuvox_tpu_torch.render.controller import FlyMovement, MouseLook
from cpuvox_tpu_torch.render.frame import Renderer


@dataclasses.dataclass
class InteractiveSession:
    """Input -> controllers -> render, one tick at a time."""

    renderer: Renderer
    cam: cm.Camera
    look: MouseLook = dataclasses.field(default_factory=MouseLook)
    fly: FlyMovement = dataclasses.field(default_factory=FlyMovement)
    mode: int = 1  # 1 screen, 2 topdown raybuffer, 3 leftright raybuffer
    frame_times: list = dataclasses.field(default_factory=list)

    @classmethod
    def create(cls, lods, config: RenderConfig | None = None,
               cam: cm.Camera | None = None, renderer: Renderer | None = None,
               device="cuda"):
        r = renderer or Renderer.create(
            lods, config or RenderConfig(width=320, height=180),
            device=device)
        dims = r.device_world.dims
        if cam is None:
            # reference spawn: world mid at 0.6x height (UnityManager.cs:250-251)
            cam = cm.Camera(position=(dims[0] * 0.5, dims[1] * 0.6,
                                      dims[2] * 0.5),
                            pitch_deg=15.0, yaw_deg=0.0,
                            screen=(r.config.width, r.config.height))
        return cls(renderer=r, cam=cam)

    def step(self, dt: float, forward: float = 0.0, strafe: float = 0.0,
             mouse_dx: float = 0.0, mouse_dy: float = 0.0, scroll: float = 0.0,
             mode: int | None = None) -> np.ndarray:
        """Advance one tick and render; returns an (H, W) uint32 ARGB frame
        (row 0 = screen bottom) for the current render mode."""
        if mode is not None:
            self.mode = mode
        if scroll:
            self.fly.scroll(scroll)
        self.cam = self.look.update(self.cam, mouse_dx, mouse_dy)
        self.cam = self.fly.update(self.cam, dt, forward=forward, strafe=strafe)
        t0 = time.perf_counter()
        if self.mode == 1:
            frame = self.renderer.render(self.cam)
        else:
            _, (td, lr, *_rest) = self.renderer.render(
                self.cam, return_raybuffers=True)
            frame = td if self.mode == 2 else lr
        self.frame_times.append(time.perf_counter() - t0)
        return frame

    @property
    def fps(self) -> float:
        recent = self.frame_times[-20:]
        return len(recent) / sum(recent) if recent else 0.0


def _ansi_frame(frame: np.ndarray, cols: int, rows: int) -> str:
    """ARGB frame -> ANSI truecolor half-block string (2 pixels per cell)."""
    h, w = frame.shape
    ys = (np.arange(rows * 2) * h) // (rows * 2)
    xs = (np.arange(cols) * w) // cols
    img = frame[::-1][ys][:, xs]  # top-down, nearest
    r = (img >> 16) & 0xFF
    g = (img >> 8) & 0xFF
    b = img & 0xFF
    out = []
    for yy in range(rows):
        top = (r[2 * yy], g[2 * yy], b[2 * yy])
        bot = (r[2 * yy + 1], g[2 * yy + 1], b[2 * yy + 1])
        line = []
        for xx in range(cols):
            line.append(f"\x1b[38;2;{top[0][xx]};{top[1][xx]};{top[2][xx]}m"
                        f"\x1b[48;2;{bot[0][xx]};{bot[1][xx]};{bot[2][xx]}m▀")
        out.append("".join(line) + "\x1b[0m")
    return "\n".join(out)


def run_terminal(session: InteractiveSession, max_seconds: float = 0.0):
    """Live terminal loop: WASD move, arrows look, +/- speed, 1/2/3 modes,
    q quits.  Requires a TTY; everything else about the session is testable
    headlessly through step()."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    start = time.time()
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        last = time.time()
        while True:
            import select

            forward = strafe = dx = dy = 0.0
            mode = None
            quit_ = False
            while select.select([sys.stdin], [], [], 0)[0]:
                ch = sys.stdin.read(1)
                if ch == "q":
                    quit_ = True
                elif ch == "w":
                    forward += 1
                elif ch == "s":
                    forward -= 1
                elif ch == "d":
                    strafe += 1
                elif ch == "a":
                    strafe -= 1
                elif ch == "+":
                    session.fly.scroll(1)
                elif ch == "-":
                    session.fly.scroll(-1)
                elif ch in "123":
                    mode = int(ch)
                elif ch == "\x1b" and sys.stdin.read(1) == "[":
                    arrow = sys.stdin.read(1)
                    dx += {"C": 3.0, "D": -3.0}.get(arrow, 0.0)
                    dy += {"A": 1.5, "B": -1.5}.get(arrow, 0.0)
            if quit_:
                break
            now = time.time()
            dt = min(now - last, 0.1)
            last = now
            frame = session.step(dt, forward=forward, strafe=strafe,
                                 mouse_dx=dx, mouse_dy=dy, mode=mode)
            try:
                import shutil

                size = shutil.get_terminal_size()
                cols, rows = size.columns, max(size.lines - 2, 4)
            except Exception:
                cols, rows = 80, 24
            sys.stdout.write("\x1b[H" + _ansi_frame(frame, cols, rows))
            p = session.cam.position
            sys.stdout.write(
                f"\x1b[0m\n{session.fps:5.1f} fps | pos "
                f"({p[0]:.0f},{p[1]:.0f},{p[2]:.0f}) pitch "
                f"{session.cam.pitch_deg:+.0f} yaw {session.cam.yaw_deg:.0f} "
                f"| speed {session.fly.move_speed:.0f} | mode {session.mode} "
                f"| wasd+arrows, q quits\x1b[K")
            sys.stdout.flush()
            if max_seconds and time.time() - start > max_seconds:
                break
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
