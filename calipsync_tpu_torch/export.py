"""Model export and its numeric parity check (counterpart of
calipsync_tpu/export.py).

The JAX package serializes the jitted forward to StableHLO. The port's
artifact is a ``torch.export`` program (``.pt2``): the forward's graph,
with the generator's three CUDA kernels as ``calipsync::`` op nodes (their
``torch.library`` registrations give ``torch.export`` their output shapes),
and the weights it was exported with. A process that loads it needs this
package importable, because the ops are registered by importing
``calipsync_tpu_torch.kernels``; it then runs the same kernels on the
card, and the plain versions on the CPU. The parity bar is the
reference's ONNX check (module/unet.py:384-385), as in the JAX package.
"""

from __future__ import annotations

import pathlib
from typing import Any, Sequence

import torch

PARITY_RTOL = 1e-3  # the reference's own bar (module/unet.py:384-385)
PARITY_ATOL = 1e-5


def _as_module(fn) -> torch.nn.Module:
    if isinstance(fn, torch.nn.Module):
        return fn

    class Wrapped(torch.nn.Module):
        def forward(self, *args):
            return fn(*args)

    return Wrapped()


def export_program(fn, example_args: Sequence[Any],
                   path: str | pathlib.Path) -> pathlib.Path:
    """``torch.export`` a module (or a function of tensors) on the example
    arguments' shapes, dtypes and devices, and save the program to
    ``path``."""
    program = torch.export.export(_as_module(fn), tuple(example_args),
                                  strict=False)
    p = pathlib.Path(path)
    torch.export.save(program, p)
    return p


def load_program(path: str | pathlib.Path) -> torch.nn.Module:
    """A saved program -> a callable module holding its weights (loaded
    onto the devices it was exported on). ``load_state_dict`` on it swaps
    the weights, by the exported module's own names."""
    import calipsync_tpu_torch.kernels  # noqa: F401  (registers the ops)

    return torch.export.load(pathlib.Path(path)).module()


def kernel_nodes(program) -> dict:
    """How many ``calipsync::`` op nodes a program's graph holds, by op
    name; ``program`` is an ExportedProgram or the module of a loaded
    one."""
    counts: dict = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("calipsync."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts


def check_export_parity(fn, example_args: Sequence[Any],
                        path: str | pathlib.Path) -> None:
    """Round-trip the export and assert that the loaded program's outputs
    equal the eager call's at rtol 1e-3 / atol 1e-5 (the reference's ONNX
    allclose check, generalized)."""
    reloaded = load_program(export_program(fn, example_args, path))
    with torch.no_grad():
        want = fn(*example_args)
        got = reloaded(*example_args)
    if isinstance(want, torch.Tensor):
        want, got = [want], [got]
    for a, b in zip(want, got, strict=True):
        torch.testing.assert_close(b, a, rtol=PARITY_RTOL, atol=PARITY_ATOL)


def export_generator(model: torch.nn.Module, path: str | pathlib.Path,
                     batch: int = 1) -> pathlib.Path:
    """Export a generator's eval forward at a fixed batch, on the device of
    its parameters and in its compute dtype (``model.dtype``), to
    ``path``. Its folds of BatchNorm into the convs are traced from the
    parameters (``nn/blocks.py``), so loading another speaker's
    state_dict into the loaded program gives that speaker's frames."""
    dev = next(model.parameters()).device
    x = torch.zeros((batch, 160, 160, 6), device=dev)
    audio = torch.zeros((batch, 32 if model.mode == "hubert" else 16, 32,
                         32 if model.mode == "hubert" else 256), device=dev)
    return export_program(model.eval(), (x, audio), path)
