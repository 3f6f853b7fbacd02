"""Run logger with the reference's directory and file contract.

The port's copy of ``uda_poseestimation_tpu/utils/logger.py`` (reference
lib/logger.py, CompleteLogger): the text log is tee'd to
``<root>/<phase>-<timestamp>.txt``, checkpoints go under
``checkpoints/<...>/checkpoints_<timestamp>/<name>.pth`` and debug images
under ``output_viz/<...>/visualize/<epoch>/``; the paths replace the leading
``logs`` component as the reference does, so tooling finds the port's
artifacts where it finds the JAX package's.
"""

from __future__ import annotations

import os
import sys
import time


class TextLogger:
    """Tee stream output to a file (lib/logger.py:9-31).

    The console stream is the *current* ``sys.stdout`` at write time, not
    the one at import time, so a later swap of stdout (pytest capture,
    ``contextlib.redirect_stdout``) is honoured.
    """

    def __init__(self, filename: str, stream=None):
        self._stream = stream
        self.log = open(filename, "a")

    @property
    def terminal(self):
        return self._stream if self._stream is not None else sys.stdout

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


class CompleteLogger:
    """Log/checkpoint/visualization directory manager (lib/logger.py:34-119).

    ``now`` pins the ``checkpoints_<ts>`` timestamp (default: the current
    local time). ``file_output=False`` (a rank other than 0) computes the
    same paths but makes no directory or file and writes nothing.
    """

    def __init__(self, root: str, phase: str = "train", now: str = None,
                 file_output: bool = True):
        self.root = root
        self.phase = phase
        self.file_output = file_output
        self.visualize_directory = os.path.join(self.root.replace("logs", "output_viz"),
                                                "visualize")
        self.epoch = 0
        if now is None:
            now = time.strftime("%Y-%m-%d-%H_%M_%S", time.localtime(time.time()))
        self.checkpoint_directory = os.path.join(
            self.root.replace("logs", "checkpoints"), "checkpoints_{}".format(now))
        log_filename = os.path.join(self.root, "{}-{}.txt".format(phase, now))
        self.log_filename = log_filename
        if not file_output:
            self.logger = None
            if phase != "train":
                self.epoch = phase
            return
        os.makedirs(self.root, exist_ok=True)
        os.makedirs(self.visualize_directory, exist_ok=True)
        os.makedirs(self.checkpoint_directory, exist_ok=True)
        if os.path.exists(log_filename):
            os.remove(log_filename)
        self.logger = TextLogger(log_filename)
        if phase != "train":
            self.set_epoch(phase)

        print(self.visualize_directory)
        print(self.checkpoint_directory)
        print(log_filename)
        self.write(self.visualize_directory)
        self.write(self.checkpoint_directory)
        self.write(log_filename)

    def set_epoch(self, epoch):
        if self.file_output:
            os.makedirs(os.path.join(self.visualize_directory, str(epoch)), exist_ok=True)
        self.epoch = epoch

    def write(self, message: str):
        if self.logger is not None:
            self.logger.write(message + "\n")

    def _get_phase_or_epoch(self):
        return str(self.epoch) if self.phase == "train" else self.phase

    def get_image_path(self, filename: str) -> str:
        return os.path.join(self.visualize_directory, self._get_phase_or_epoch(), filename)

    def get_checkpoint_path(self, name=None) -> str:
        if name is None:
            name = self._get_phase_or_epoch()
        return os.path.join(self.checkpoint_directory, str(name) + ".pth")

    def close(self):
        if self.logger is not None:
            self.logger.close()
