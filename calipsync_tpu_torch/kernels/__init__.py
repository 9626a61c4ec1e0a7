"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper calls its ``torch.library`` op (``calipsync::fused_ir``,
``calipsync::depthwise3x3``, ``calipsync::cross_attention``), registered
when its module is imported: the CUDA implementation launches the kernel,
the CPU one runs the plain version. The CUDA implementation counts its
launches in a plain integer attribute of the wrapper,
``<wrapper>.launches``; a run reads them to show which kernels it went
through. A launch recorded into a CUDA graph counts there each time the
graph is replayed (:func:`note_replay`), and also in
``<wrapper>.replayed`` (kernels/_counts.py).
"""

from .cross_attention import cross_attention
from .depthwise import depthwise3x3
from .fused_ir import fused_inverted_residual

WRAPPERS = {"fused_ir": fused_inverted_residual,
            "depthwise3x3": depthwise3x3,
            "cross_attention": cross_attention}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = fn.replayed = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def captured_counts() -> dict[str, int]:
    """Each kernel's launches recorded into CUDA graphs so far: taken
    before and after a capture, their difference is what one replay of
    that graph launches."""
    return {name: fn.captured for name, fn in WRAPPERS.items()}


def note_replay(launches: dict[str, int]) -> None:
    """Count one replay of a CUDA graph whose capture recorded
    ``launches`` (kernel name -> launches)."""
    for name, n in launches.items():
        WRAPPERS[name].launches += n
        WRAPPERS[name].replayed += n
