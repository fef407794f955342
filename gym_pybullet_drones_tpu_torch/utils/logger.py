"""Flight logger with the reference schema (the port's copy of the JAX
package's ``utils/logger.py``; numpy only).

API-compatible with the reference `utils/Logger.py` (log/save/save_as_csv/plot,
same 16-state x T and 12-control x T per-drone arrays, same npz keys, same CSV
series incl. the finite-difference rpy rates and RPM->PWM conversion,
Logger.py:49-201), plus a bulk path: `log_trajectory` ingests whole stacked
rollout outputs, (T, N, 20) state arrays, in one call instead of T*N scalar
calls. It takes numpy: callers convert tensors with ``.cpu().numpy()``.

The internal layout is (drones, channels, time) like the reference, grown
geometrically rather than one column at a time.
"""

import os
from datetime import datetime

import numpy as np

# DSLPID PWM<->RPM affine map (DSLPIDControl.py:43-46), used for the CSV/plot
# PWM series exactly as the reference does (Logger.py:185-201).
_PWM2RPM_SCALE, _PWM2RPM_CONST = 0.2685, 4070.3

# Channel order of the 16-state rows (Logger.py:52-67):
# [x y z vx vy vz r p y wx wy wz rpm0..rpm3]
_STATE_LABELS = ["x", "y", "z", "vx", "vy", "vz", "r", "p", "ya",
                 "wx", "wy", "wz", "rpm0-", "rpm1-", "rpm2-", "rpm3-"]


def _reorder_state(state20):
    """20-dim aviary state -> 16-dim log row (Logger.log, :117):
    [pos(0:3), vel(10:13), rpy(7:10), ang_v+rpm(13:20)]."""
    state20 = np.asarray(state20)
    return np.concatenate(
        [state20[..., 0:3], state20[..., 10:13], state20[..., 7:10], state20[..., 13:20]],
        axis=-1,
    )


class Logger:
    def __init__(self, logging_freq_hz: int, output_folder: str = "results",
                 num_drones: int = 1, duration_sec: int = 0, colab: bool = False):
        self.COLAB = colab
        self.OUTPUT_FOLDER = output_folder
        os.makedirs(output_folder, exist_ok=True)
        self.LOGGING_FREQ_HZ = logging_freq_hz
        self.NUM_DRONES = num_drones
        self.PREALLOCATED_ARRAYS = duration_sec != 0
        cap = duration_sec * logging_freq_hz
        # The reference preallocates duration*freq columns and exports them
        # all, zeros included (Logger.py:49-79); past that it grows one
        # column per log. So the exported length is max(logged, INITIAL
        # preallocation) — never the geometrically-grown capacity, which
        # would pad the CSVs/plots with zero samples.
        self._prealloc_cap = cap
        self.counters = np.zeros(num_drones, dtype=int)
        self._timestamps = np.zeros((num_drones, cap))
        self._states = np.zeros((num_drones, 16, cap))
        self._controls = np.zeros((num_drones, 12, cap))

    # -- ingestion -------------------------------------------------------------

    # Public views are trimmed to the logged length, so user code that reads
    # `logger.states` directly (as with the reference Logger, whose arrays
    # grow a column at a time) never sees growth padding.
    @property
    def timestamps(self):
        return self._timestamps[:, : self._len()]

    @property
    def states(self):
        return self._states[:, :, : self._len()]

    @property
    def controls(self):
        return self._controls[:, :, : self._len()]

    def _len(self) -> int:
        n = int(self.counters.max()) if self.counters.size else 0
        return max(n, self._prealloc_cap if self.PREALLOCATED_ARRAYS else 0)

    def _ensure_capacity(self, need: int):
        cap = self._timestamps.shape[1]
        if need <= cap:
            return
        new_cap = max(need, max(16, 2 * cap))
        grow = new_cap - cap
        self._timestamps = np.concatenate(
            [self._timestamps, np.zeros((self.NUM_DRONES, grow))], axis=1)
        self._states = np.concatenate(
            [self._states, np.zeros((self.NUM_DRONES, 16, grow))], axis=2)
        self._controls = np.concatenate(
            [self._controls, np.zeros((self.NUM_DRONES, 12, grow))], axis=2)

    def log(self, drone: int, timestamp, state, control=None):
        """Log one step of one drone: `state` is the 20-dim aviary state
        (Logger.log, :83-121); `control` the optional 12-dim target."""
        state = np.asarray(state)
        if control is None:
            control = np.zeros(12)
        control = np.asarray(control)
        if (drone < 0 or drone >= self.NUM_DRONES or timestamp < 0
                or state.shape[-1] != 20 or control.shape[-1] != 12):
            print("[ERROR] in Logger.log(), invalid data")
            return
        c = self.counters[drone]
        self._ensure_capacity(c + 1)
        self._timestamps[drone, c] = timestamp
        self._states[drone, :, c] = _reorder_state(state)
        self._controls[drone, :, c] = control
        self.counters[drone] = c + 1

    def log_trajectory(self, states, timestamps=None, controls=None):
        """Bulk-ingest a stacked rollout: `states` is (T, N, 20) (e.g. the
        stacked obs of a CtrlAviary rollout), optional `controls` (T, N, 12),
        numpy. Columns append after any scalar logs."""
        states = np.asarray(states)
        T, N = states.shape[0], states.shape[1]
        assert N == self.NUM_DRONES, (N, self.NUM_DRONES)
        start = int(self.counters.max())
        self._ensure_capacity(start + T)
        if timestamps is None:
            timestamps = (start + np.arange(T)) / self.LOGGING_FREQ_HZ
        self._timestamps[:, start:start + T] = np.broadcast_to(
            np.asarray(timestamps), (N, T))
        self._states[:, :, start:start + T] = np.transpose(
            _reorder_state(states), (1, 2, 0))
        if controls is not None:
            self._controls[:, :, start:start + T] = np.transpose(
                np.asarray(controls), (1, 2, 0))
        self.counters[:] = start + T

    # -- persistence -----------------------------------------------------------

    def _trim(self):
        return self.timestamps, self.states, self.controls

    def save(self):
        """npz with the reference's keys (Logger.save, :123-127)."""
        path = os.path.join(
            self.OUTPUT_FOLDER,
            "save-flight-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S") + ".npy",
        )
        ts, st, ct = self._trim()
        with open(path, "wb") as f:
            np.savez(f, timestamps=ts, states=st, controls=ct)
        return path

    def save_as_csv(self, comment: str = ""):
        """Per-series CSVs with the reference's filenames and derived series
        (Logger.save_as_csv, :131-201): x/y/z, r/p/ya, finite-diff rr/pr/yar,
        vx/vy/vz, wx/wy/wz, rpm0-3, pwm0-3."""
        csv_dir = os.path.join(
            self.OUTPUT_FOLDER,
            "save-flight-" + comment + "-" + datetime.now().strftime("%m.%d.%Y_%H.%M.%S"),
        )
        os.makedirs(csv_dir, exist_ok=True)
        _, states, _ = self._trim()
        n = states.shape[2]
        t = np.arange(n) / self.LOGGING_FREQ_HZ

        def out(name, series):
            np.savetxt(os.path.join(csv_dir, name + ".csv"),
                       np.stack([t, series], axis=1), delimiter=",")

        for i in range(self.NUM_DRONES):
            for ch, label in enumerate(_STATE_LABELS):
                out(f"{label}{i}", states[i, ch])
            for ch, label in zip((6, 7, 8), ("rr", "pr", "yar")):
                rate = np.concatenate(
                    [[0.0], np.diff(states[i, ch]) * self.LOGGING_FREQ_HZ])
                out(f"{label}{i}", rate)
            for k in range(4):
                pwm = (states[i, 12 + k] - _PWM2RPM_CONST) / _PWM2RPM_SCALE
                out(f"pwm{k}-{i}", pwm)
        return csv_dir

    # -- visualization ---------------------------------------------------------

    def plot(self, pwm=False):
        """10x2 dashboard with the reference's panel layout (Logger.plot,
        :205-379): col 0 = x/y/z, r/p/y, wx/wy/wz, time; col 1 = vx/vy/vz,
        rpy rates (finite diff), RPM (or PWM) 0-3."""
        import matplotlib.pyplot as plt
        from cycler import cycler

        plt.rc("axes", prop_cycle=(cycler(color=["r", "g", "b", "y"])
                                   + cycler(linestyle=["-", "--", ":", "-."])))
        _, states, _ = self._trim()
        n = states.shape[2]
        t = np.arange(n) / self.LOGGING_FREQ_HZ
        fig, axs = plt.subplots(10, 2, figsize=(14, 20))

        col0 = [(0, "x (m)"), (1, "y (m)"), (2, "z (m)"), (6, "r (rad)"),
                (7, "p (rad)"), (8, "y (rad)"), (9, "wx"), (10, "wy"), (11, "wz")]
        for row, (ch, label) in enumerate(col0):
            for j in range(self.NUM_DRONES):
                axs[row, 0].plot(t, states[j, ch], label=f"drone_{j}")
            axs[row, 0].set_xlabel("time")
            axs[row, 0].set_ylabel(label)
        axs[9, 0].plot(t, t, label="time")
        axs[9, 0].set_xlabel("time")
        axs[9, 0].set_ylabel("time")

        for row, (ch, label) in enumerate([(3, "vx (m/s)"), (4, "vy (m/s)"), (5, "vz (m/s)")]):
            for j in range(self.NUM_DRONES):
                axs[row, 1].plot(t, states[j, ch], label=f"drone_{j}")
            axs[row, 1].set_xlabel("time")
            axs[row, 1].set_ylabel(label)
        for row, (ch, label) in enumerate([(6, "rdot (rad/s)"), (7, "pdot (rad/s)"), (8, "ydot (rad/s)")], start=3):
            for j in range(self.NUM_DRONES):
                rate = np.concatenate([[0.0], np.diff(states[j, ch]) * self.LOGGING_FREQ_HZ])
                axs[row, 1].plot(t, rate, label=f"drone_{j}")
            axs[row, 1].set_xlabel("time")
            axs[row, 1].set_ylabel(label)
        for k in range(4):
            row = 6 + k
            for j in range(self.NUM_DRONES):
                series = states[j, 12 + k]
                if pwm and j > 0:  # reference quirk: drone_0 stays RPM (Logger.py:330-334)
                    series = (series - _PWM2RPM_CONST) / _PWM2RPM_SCALE
                axs[row, 1].plot(t, series, label=f"drone_{j}")
            axs[row, 1].set_xlabel("time")
            axs[row, 1].set_ylabel(f"PWM{k}" if pwm else f"RPM{k}")

        for i in range(10):
            for j in range(2):
                axs[i, j].grid(True)
                axs[i, j].legend(loc="upper right", frameon=True)
        fig.subplots_adjust(left=0.06, bottom=0.05, right=0.99, top=0.98,
                            wspace=0.15, hspace=0.0)
        if self.COLAB:
            plt.savefig(os.path.join("results", "output_figure.png"))
        else:
            plt.show()
        plt.close(fig)
