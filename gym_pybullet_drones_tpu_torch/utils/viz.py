"""Trajectory visualization: 3-D flight animation from logged states.

The reference's visual output is the PyBullet OpenGL GUI plus MP4 capture
(BaseAviary.py:523-537, assets/ffmpeg_png2mp4.sh). Headless equivalents here:
drone-POV PNG frames from the ray-cast camera (`compat` record=True) and this
module's third-person 3-D animation of the whole fleet, rendered with
matplotlib and saved as an animated GIF (the pillow writer is always
available; no ffmpeg needed).
"""

import numpy as np


def animate_trajectory(states, path: str, fps: int = 24, stride: int = 2,
                       trail: int = 60, elev: float = 25.0, azim: float = -60.0):
    """Render a (drones, 16, T) Logger state array — or a Logger — to a GIF.

    Shows each drone as a marker with a fading trail; axes auto-fit the
    flight volume. Returns the output path.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    if hasattr(states, "states"):  # Logger instance
        states = states.states
    states = np.asarray(states)
    n, _, T = states.shape
    xyz = states[:, 0:3, :]  # (N, 3, T)

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)
    lo = xyz.min(axis=(0, 2)) - 0.2
    hi = xyz.max(axis=(0, 2)) + 0.2
    span = np.maximum(hi - lo, 0.5)
    mid = (hi + lo) / 2
    half = span.max() / 2
    ax.set_xlim(mid[0] - half, mid[0] + half)
    ax.set_ylim(mid[1] - half, mid[1] + half)
    ax.set_zlim(max(0.0, mid[2] - half), mid[2] + half)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_zlabel("z (m)")

    colors = plt.cm.tab10(np.arange(n) % 10)
    dots = [ax.plot([], [], [], "o", color=colors[j], markersize=6)[0]
            for j in range(n)]
    trails = [ax.plot([], [], [], "-", color=colors[j], alpha=0.5, lw=1)[0]
              for j in range(n)]

    frames = range(0, T, stride)

    def update(t):
        for j in range(n):
            dots[j].set_data([xyz[j, 0, t]], [xyz[j, 1, t]])
            dots[j].set_3d_properties([xyz[j, 2, t]])
            t0 = max(0, t - trail)
            trails[j].set_data(xyz[j, 0, t0:t + 1], xyz[j, 1, t0:t + 1])
            trails[j].set_3d_properties(xyz[j, 2, t0:t + 1])
        return dots + trails

    anim = animation.FuncAnimation(fig, update, frames=frames, blit=False)
    anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


class LiveViewer:
    """Interactive third-person 3-D fleet view — the stand-in for the
    reference's PyBullet OpenGL window (`gui=True`, BaseAviary.py:148-168).

    On an interactive matplotlib backend the window redraws in place
    (non-blocking, `plt.pause`); on headless backends (Agg) each update is
    captured as an RGB frame instead, retrievable via `frames` and muxable
    with utils.video.encode_video — so `gui=True` is useful even over SSH.
    """

    def __init__(self, num_drones: int, bounds: float = 2.0,
                 keep_frames: int = 300, rpm_sliders: bool = False,
                 max_rpm: float = 30000.0, hover_rpm: float = 15000.0):
        import matplotlib

        # Window path only on backends that can actually show one; any other
        # non-GUI backend (agg, pdf, svg, ps, cairo, inline, template, ...)
        # falls back to frame capture.
        backend = matplotlib.get_backend().lower()
        self._interactive = any(
            gui in backend
            for gui in ("qt", "gtk", "tk", "wx", "macosx", "nbagg", "webagg"))
        import matplotlib.pyplot as plt

        self._plt = plt
        self.frames = []
        self._keep = keep_frames
        self.fig = plt.figure(figsize=(6, 5))
        self.ax = self.fig.add_subplot(projection="3d")
        self.ax.set_xlim(-bounds, bounds)
        self.ax.set_ylim(-bounds, bounds)
        self.ax.set_zlim(0, bounds)
        self.ax.set_xlabel("x [m]")
        self.ax.set_ylabel("y [m]")
        self.ax.set_zlabel("z [m]")
        cmap = plt.get_cmap("tab10")
        self._dots = [self.ax.plot([], [], [], "o", color=cmap(j % 10),
                                   markersize=6)[0]
                      for j in range(num_drones)]
        self._trails = [self.ax.plot([], [], [], "-", color=cmap(j % 10),
                                     alpha=0.5, lw=1)[0]
                        for j in range(num_drones)]
        self._hist = [[] for _ in range(num_drones)]
        # ---- user-debug surface (reference BaseAviary.py:162-167) ---------
        # Four RPM sliders + a "Use GUI RPM" input switch. On interactive
        # backends these are real matplotlib widgets; headless, the same
        # state is driven programmatically via set_gui_rpm()/use_gui_rpm —
        # the consuming step logic (compat.gym.BaseAviaryEnv.step) is
        # identical either way, so user_debug_gui=True does something real
        # in both environments.
        import numpy as _np

        self.use_gui_rpm = False
        self._gui_rpm = _np.full(4, float(hover_rpm))
        self._sliders = []
        self._axis_lines = {}
        if rpm_sliders and self._interactive:
            from matplotlib.widgets import CheckButtons, Slider

            self.fig.subplots_adjust(bottom=0.32)
            for i in range(4):
                ax_s = self.fig.add_axes([0.15, 0.04 + 0.05 * i, 0.55, 0.03])
                s = Slider(ax_s, f"RPM {i}", 0.0, float(max_rpm),
                           valinit=float(hover_rpm))
                s.on_changed(
                    lambda v, i=i: self._gui_rpm.__setitem__(i, float(v)))
                self._sliders.append(s)
            ax_c = self.fig.add_axes([0.76, 0.06, 0.2, 0.12])
            self._check = CheckButtons(ax_c, ["Use GUI RPM"], [False])
            self._check.on_clicked(
                lambda _label: setattr(self, "use_gui_rpm",
                                       not self.use_gui_rpm))
        if self._interactive:
            plt.ion()
            self.fig.show()
        elif not hasattr(self.fig.canvas, "buffer_rgba"):
            # Vector backends (pdf/svg/ps) have no pixel buffer — swap in an
            # Agg canvas so frame capture works under any non-GUI backend.
            from matplotlib.backends.backend_agg import FigureCanvasAgg

            FigureCanvasAgg(self.fig)

    def update(self, pos, trail: int = 60):
        """pos: (N, 3) world positions."""
        import numpy as _np

        pos = _np.asarray(pos)
        for j, dot in enumerate(self._dots):
            self._hist[j].append(pos[j])
            self._hist[j] = self._hist[j][-trail:]
            h = _np.asarray(self._hist[j])
            dot.set_data([pos[j, 0]], [pos[j, 1]])
            dot.set_3d_properties([pos[j, 2]])
            self._trails[j].set_data(h[:, 0], h[:, 1])
            self._trails[j].set_3d_properties(h[:, 2])
        if self._interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(0.001)
        else:
            self.fig.canvas.draw()
            buf = _np.asarray(self.fig.canvas.buffer_rgba())[:, :, :3]
            self.frames.append(buf.copy())
            self.frames = self.frames[-self._keep:]

    @property
    def gui_rpm(self):
        """Current slider RPMs (4,) — the reference's readUserDebugParameter
        values (BaseAviary.py:320-333)."""
        import numpy as _np

        return _np.array(self._gui_rpm)

    def set_gui_rpm(self, rpm, use: bool = True):
        """Programmatic slider drive (headless backends / scripts)."""
        import numpy as _np

        self._gui_rpm = _np.asarray(rpm, dtype=float).reshape(4).copy()
        self.use_gui_rpm = bool(use)

    def show_axes(self, pos, quat, length: float = 0.08, drones=None):
        """Body-axes traces — the stand-in for the reference's
        addUserDebugLine local axes (BaseAviary._showDroneLocalAxes,
        :931-939... :964-980): red/green/blue segments along each drone's
        body x/y/z, updated in place. ``quat`` is (N, 4) xyzw."""
        import numpy as _np

        pos = _np.asarray(pos)
        quat = _np.asarray(quat)
        idx = range(pos.shape[0]) if drones is None else drones
        for j in idx:
            x, y, z, w = quat[j]
            R = _np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ])
            if j not in self._axis_lines:
                self._axis_lines[j] = [
                    self.ax.plot([], [], [], "-", color=c, lw=1.5)[0]
                    for c in ("r", "g", "b")]
            for k, line in enumerate(self._axis_lines[j]):
                tip = pos[j] + length * R[:, k]
                line.set_data([pos[j, 0], tip[0]], [pos[j, 1], tip[1]])
                line.set_3d_properties([pos[j, 2], tip[2]])

    def close(self):
        self._plt.close(self.fig)
