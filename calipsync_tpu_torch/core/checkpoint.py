"""Training checkpoints (counterpart of calipsync_tpu/core/checkpoint.py).

A checkpoint, ``{directory}/step_{N}.pt``, holds the generator's state_dict
(the reference layout), the Adam state, the update count and the state of
the data-order generator (numpy's ``bit_generator.state``), written with
``torch.save`` to a temporary name and renamed into place, and read back
with ``torch.load(weights_only=True)``. step2 keys them by epoch.

:class:`PreemptionGuard` turns SIGTERM/SIGINT into a flag that the training
loop polls at batch boundaries, so a preempted run checkpoints and returns.
"""

from __future__ import annotations

import os
import pathlib
import re
import signal
import threading
from typing import Optional

import numpy as np
import torch

_NAME = re.compile(r"step_(\d+)\.pt")


def checkpoint_path(directory, step: int) -> pathlib.Path:
    return pathlib.Path(directory).absolute() / f"step_{step}.pt"


def save_checkpoint(directory, step: int, state,
                    data_rng_state: Optional[dict] = None,
                    optimizer_state: Optional[dict] = None) -> pathlib.Path:
    """Save a :class:`~calipsync_tpu_torch.train.trainer.TrainState` under
    ``step``, with ``data_rng_state`` (a numpy ``bit_generator.state``:
    where the data order resumes) when given; returns the path.
    ``optimizer_state`` replaces ``state.optimizer.state_dict()`` (a
    ZeRO-1 state gathers its moments on every rank, and one rank
    writes)."""
    path = checkpoint_path(directory, step)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".pt.tmp")
    if optimizer_state is None:
        optimizer_state = state.optimizer.state_dict()
    saved = {"model": state.model.state_dict(),
             "optimizer": optimizer_state,
             "step": state.step}
    if data_rng_state is not None:
        saved["data_rng"] = data_rng_state
    torch.save(saved, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.is_dir():
        return None
    steps = [int(m.group(1)) for p in d.iterdir()
             if (m := _NAME.fullmatch(p.name))]
    return max(steps) if steps else None


def restore_checkpoint(directory, state, step: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None):
    """Load the checkpoint at ``step`` (default: the latest) into
    ``state`` (model and optimizer on their devices), and its data-order
    state into ``rng`` when both are there; returns ``state``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    saved = torch.load(checkpoint_path(directory, step), map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    if rng is not None and "data_rng" in saved:
        rng.bit_generator.state = saved["data_rng"]
    return state


class PreemptionGuard:
    """A SIGTERM/SIGINT latch for checkpointing at a safe point (own copy
    of the JAX package's).

    The handler only sets ``triggered``; the training loop polls it at
    batch boundaries, saves and returns, and ``resume=True`` continues. A
    second signal while the flag is set goes to the previous handler, so a
    stuck save can still be killed. Use as a context manager; the previous
    handlers come back on exit. Off the main thread (where handlers cannot
    be installed) it installs nothing and never triggers.
    """

    def __init__(self, signals=None):
        self.signals = (tuple(signals) if signals is not None
                        else (signal.SIGTERM, signal.SIGINT))
        self._prev: dict = {}
        self._triggered = False

    @property
    def triggered(self) -> bool:
        return self._triggered

    def _handle(self, signum, frame):
        if self._triggered:
            prev = self._prev.get(signum)
            if not callable(prev) and prev not in (signal.SIG_IGN,
                                                   signal.SIG_DFL):
                # installed from C: not reinstallable from Python
                prev = signal.SIG_DFL
            signal.signal(signum, prev)
            signal.raise_signal(signum)
            return
        self._triggered = True

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
