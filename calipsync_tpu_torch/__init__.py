"""calipsync_tpu_torch: the lip-sync system in PyTorch, audio in and video
out, with the TPU package's Pallas kernels rewritten as CUDA kernels for
the NVIDIA H100 (sm_90a).

Layout mirrors calipsync_tpu (nn/, kernels/, audio/, infer/, pipelines/,
serve/, media/, vision/, core/, cli.py). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a GPU and without that
request they raise.
"""
