"""Interactive velocity-goal teleop.

Counterpart of ``iterative_learning_nmpc_tpu/utils/interactive.py`` (the
reference's ``mpc_controller/utils/interactive.py``). The reference uses mj_pin's viewer Keyboard hook (w/s/a/d/q/e/space). This
image is headless, so the teleop reads single characters from stdin on a
daemon thread when a TTY is attached; the programmatic `set_velocity` API is
always available (used by the DAgger pipelines).
"""
from __future__ import annotations

import sys
import threading

import numpy as np


class SetVelocityGoal:
    V_MAX = np.array([0.5, 0.3, 0.0])
    W_YAW_MAX = 0.6
    STEP = 0.05

    def __init__(self, use_stdin: bool = True):
        self.v_des = np.zeros(3)
        self.w_yaw = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        if use_stdin and sys.stdin is not None and sys.stdin.isatty():
            self._thread = threading.Thread(target=self._stdin_loop, daemon=True)
            self._thread.start()

    def _apply_key(self, key: str):
        with self._lock:
            if key == "w":
                self.v_des[0] += self.STEP
            elif key == "s":
                self.v_des[0] -= self.STEP
            elif key == "a":
                self.v_des[1] += self.STEP
            elif key == "d":
                self.v_des[1] -= self.STEP
            elif key == "q":
                self.w_yaw += self.STEP
            elif key == "e":
                self.w_yaw -= self.STEP
            elif key == " ":
                self.v_des[:] = 0.0
                self.w_yaw = 0.0
            self.v_des = np.clip(self.v_des, -self.V_MAX, self.V_MAX)
            self.w_yaw = float(np.clip(self.w_yaw, -self.W_YAW_MAX, self.W_YAW_MAX))

    def _stdin_loop(self):
        while not self._stop.is_set():
            ch = sys.stdin.read(1)
            if not ch:
                break
            self._apply_key(ch.lower())

    # programmatic API
    def set_velocity(self, v_des, w_yaw: float = 0.0):
        with self._lock:
            self.v_des = np.asarray(v_des, dtype=np.float64)
            self.w_yaw = float(w_yaw)

    def get_velocity(self):
        with self._lock:
            return self.v_des.copy(), self.w_yaw

    def stop(self):
        self._stop.set()
