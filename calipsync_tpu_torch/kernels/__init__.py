"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``; a run reads them to show which kernels it went
through.
"""

from .cross_attention import cross_attention
from .depthwise import depthwise3x3
from .fused_ir import fused_inverted_residual

WRAPPERS = {"fused_ir": fused_inverted_residual,
            "depthwise3x3": depthwise3x3,
            "cross_attention": cross_attention}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
