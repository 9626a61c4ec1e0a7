"""Launch counts of the kernels' wrappers.

Each wrapper carries three integers: ``launches``, the kernel's launches
that ran; ``captured``, the launches recorded into CUDA graphs, which run
only when their graph is replayed; and ``replayed``, the share of
``launches`` that graph replays ran. A wrapper's CUDA implementation calls
:func:`count` where it launches its kernel; the owner of a graph calls
``kernels.note_replay`` at each replay with the launches its capture
recorded.
"""

import torch


def init(wrapper) -> None:
    wrapper.launches = wrapper.captured = wrapper.replayed = 0


def count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel on the current stream: it runs
    now, or, while that stream captures a CUDA graph, at each replay."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
