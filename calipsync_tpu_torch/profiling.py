"""Tracing, per-stage timers and FLOP counts (counterpart of
calipsync_tpu/profiling.py).

- ``device_sync``: a completion barrier before a timed region ends
  (``torch.cuda.synchronize`` on the device of the output).
- ``StageTimer``: accumulating wall-clock timers keyed by stage name (a
  copy of the JAX package's).
- ``trace``: a ``torch.profiler`` capture, written as a Chrome trace.
- ``compiled_cost`` / ``generator_cost``: the FLOP count of a call, by
  ``torch.utils.flop_counter.FlopCounterMode``. The generator's three
  CUDA kernels are ``torch.library`` ops with registered FLOP formulas
  (``kernels/``), so the count is the same whether the forward runs on the
  card or, through the plain versions, on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def device_sync(tree) -> None:
    """Wait until the device has finished the work that made ``tree`` (a
    tensor, or dicts, lists and tuples of them): ``torch.cuda.synchronize``
    on the device of its first tensor leaf. CPU tensors are computed when
    the call returns, so nothing is done for them. End every timed region
    with this: PyTorch returns before the card has run what it queued."""
    leaf = _first_tensor(tree)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] += time.time() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_ms": round(1000 * v / max(1, self.counts[k]), 3)}
                for k, v in self.totals.items()}

    def report(self) -> str:
        return " | ".join(
            f"{k}: {v['total_s']:.2f}s/{v['count']}x "
            f"({v['mean_ms']:.2f}ms)" for k, v in self.summary().items())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block, host and (where
    there is a card) device activity, and write it into ``log_dir`` as a
    Chrome trace (``trace_<pid>_<ms>.json``; open it in Perfetto or
    chrome://tracing). Yields the profiler; its ``trace_path`` attribute
    names the file once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json")
    prof.export_chrome_trace(prof.trace_path)


def compiled_cost(fn, *example_args, **example_kwargs) -> dict:
    """FLOP count of ``fn(*example_args, **example_kwargs)``, by running it
    under ``FlopCounterMode``.

    Returns {'flops', 'gflops', 'bytes_accessed', 'raw'}: ``raw`` holds the
    count of each op (``str(op) -> FLOP``). The counter counts the
    multiply-adds of products, convolutions and the ``calipsync::`` ops,
    two FLOP each, and no elementwise work, so it reads a few percent under
    XLA's cost analysis, which counts both. ``bytes_accessed`` is None:
    eager PyTorch compiles nothing, so there is no compiler's cost
    analysis to read the bytes from, and the bytes that the run moves
    depend on which kernels run.
    """
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*example_args, **example_kwargs)
    raw = {str(op): int(n) for op, n in
           counter.get_flop_counts()["Global"].items()}
    flops = int(counter.get_total_flops())
    return {"flops": flops, "gflops": flops / 1e9, "bytes_accessed": None,
            "raw": raw}


def generator_cost(batch: int = 1, device=None) -> dict:
    """:func:`compiled_cost` of the flagship generator's eval forward
    (hubert, 4 attention blocks, full width) at ``batch``, on ``device``
    (the card unless ``"cpu"``), in fp32 as the JAX package's. The count
    depends on the shapes only, so the weights are the default init."""
    from calipsync_tpu_torch.core.device import resolve_device
    from calipsync_tpu_torch.nn.unet import Generator

    dev = resolve_device(device)
    model = Generator(mode="hubert", n_blocks=4).to(dev).eval()
    x = torch.zeros((batch, 160, 160, 6), device=dev)
    audio = torch.zeros((batch, 32, 32, 32), device=dev)
    return compiled_cost(model, x, audio)
