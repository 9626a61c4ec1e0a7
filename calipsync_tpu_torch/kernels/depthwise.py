"""Depthwise 3x3 conv + folded BatchNorm + LeakyReLU (NHWC), CUDA kernel
``csrc/depthwise.cu`` and its plain PyTorch version.

Counterpart of calipsync_tpu/kernels/depthwise.py: ``depthwise3x3`` and
``depthwise3x3_blocked`` there are two TPU tilings of one op, and one
Hopper kernel serves both. ``fold_bn`` turns BatchNorm parameters into the
(scale, bias) the op consumes.

``depthwise3x3`` calls the op ``calipsync::depthwise3x3``
(``torch.library``): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, and it never falls back from one to
the other; a fake implementation and a FLOP formula serve
``torch.export`` and ``FlopCounterMode``. On the card, bf16
with C a multiple of 8 and 16-byte-aligned tensors takes the TMA kernel,
tiled by ``plan_tiles`` (host code, tested on the CPU); anything else takes
the simple CUDA kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build, _counts
from .fused_ir import as_fp32

LEAKY_SLOPE = 0.01


def _out_size(n: int, stride: int) -> int:
    return (n + 2 - 3) // stride + 1


def _taps9(kernel: torch.Tensor) -> torch.Tensor:
    """(3,3,C), (3,3,1,C) or (9,C) taps -> (9,C)."""
    c = kernel.shape[-1]
    if kernel.dim() == 4:
        kernel = kernel[:, :, 0, :]
    return kernel.reshape(9, c)


# ------------------------------------------- the TMA kernel's tiling
# The H100 limits the planner works to. dw3x3_tma_kernel is launch-bounded
# to 256 threads and 2 blocks an SM, so it holds at most 128 registers a
# thread.
SLAB = 64                # channels a tile: 128 bytes, the box's inner extent
MAX_THREADS = 256
REGS_PER_THREAD = 128
REGS_PER_SM = 65536
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
SMEM_PER_SM = 233472     # 228 KB
SMEM_PER_BLOCK = 232448  # 227 KB, the most one block may ask for
SMEM_RESERVED = 1024     # reserved by the system for each block
MAX_BOX = 256            # the most a TMA box dimension may hold
MAX_STAGES = 4
# The rule plan_tiles follows: a tile is the largest divisor of the output
# rows (columns) up to MAX_TILE, each thread walks at most RUN_ROWS rows
# of it, and a block keeps STAGES[stride] boxes in flight. Set by the
# tilings kernels/bench.py --dw-sweep times at the generator's launches.
MAX_TILE = 10
RUN_ROWS = 5
STAGES = {1: 2, 2: 3}


@dataclass(frozen=True)
class TilePlan:
    """One launch's tiling: tiles of tile_h x tile_w output pixels x slab
    channels (box_h x box_w input pixels with the halo), each column of a
    tile split into `segments` runs of rows, one thread a run and
    8-channel group; `stages` boxes in flight a block; `grid` persistent
    blocks of `threads`, `blocks_per_sm` of them an SM, each asking for
    `smem` bytes of shared memory."""
    tile_h: int
    tile_w: int
    segments: int
    slab: int
    stages: int
    threads: int
    grid: int
    smem: int
    blocks_per_sm: int
    box_h: int
    box_w: int
    tiles: int

    def kernel_args(self) -> tuple[int, ...]:
        """The `plan` array of calipsync_depthwise3x3."""
        return (self.tile_h, self.tile_w, self.segments, self.slab,
                self.stages, self.threads, self.grid, self.smem)


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def stage_bytes(box_h: int, box_w: int, slab: int) -> int:
    """Shared memory of one stage: the box, rounded to 128 bytes (TMA's
    alignment), and its 8-byte mbarrier."""
    return -(-box_h * box_w * slab * 2 // 128) * 128 + 8


def tiling(b: int, h: int, w: int, c: int, stride: int, tile_h: int,
           tile_w: int, segments: int, stages: int,
           sms: int = 132) -> TilePlan | None:
    """The plan of one choice of tile, segments and stages for a bf16
    (b, h, w, c) launch, C a multiple of 8, on a card with `sms` SMs; None
    where the choice breaks a limit or its tile does not divide the
    output."""
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    slab = min(SLAB, c)
    gp = slab // 8
    box_h, box_w = (tile_h - 1) * stride + 3, (tile_w - 1) * stride + 3
    rows = -(-tile_h // segments)          # the rows a thread walks
    units = gp * tile_w * segments
    smem = stages * stage_bytes(box_h, box_w, slab)
    if (ho % tile_h or wo % tile_w or max(box_h, box_w) > MAX_BOX
            or units > MAX_THREADS or (segments - 1) * rows >= tile_h
            or smem > SMEM_PER_BLOCK or not 2 <= stages <= MAX_STAGES):
        return None
    threads = -(-units // 32) * 32
    bps = min(REGS_PER_SM // (REGS_PER_THREAD * threads),
              THREADS_PER_SM // threads, BLOCKS_PER_SM,
              SMEM_PER_SM // (smem + SMEM_RESERVED))
    tiles = -(-c // slab) * b * (ho // tile_h) * (wo // tile_w)
    return TilePlan(tile_h, tile_w, segments, slab, stages, threads,
                    min(tiles, sms * bps), smem, bps, box_h, box_w, tiles)


def plan_tiles(b: int, h: int, w: int, c: int, stride: int,
               sms: int = 132) -> TilePlan:
    """The plan of a bf16 (b, h, w, c) launch, C a multiple of 8, by the
    rule above. Its tiles divide the output, so they cover it once and
    every box lies within the image and its pad of 1."""
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    tile_h = max(d for d in _divisors(ho) if d <= MAX_TILE)
    tile_w = max(d for d in _divisors(wo) if d <= MAX_TILE)
    plan = tiling(b, h, w, c, stride, tile_h, tile_w,
                  -(-tile_h // RUN_ROWS), STAGES[stride], sms)
    if plan is None:
        raise ValueError(f"depthwise3x3: no TMA tiling of {(b, h, w, c)} "
                         f"at stride {stride}")
    return plan


# (b, h, w, c, stride, device index) -> the plan as calipsync_depthwise3x3
# takes it
_PLANS: dict[tuple[int, ...], ctypes.Array] = {}


def _plan_array(key: tuple[int, ...]) -> ctypes.Array:
    plan = _PLANS.get(key)
    if plan is None:
        *shape, stride, index = key
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        plan = _PLANS[key] = (ctypes.c_int * 8)(
            *plan_tiles(*shape, stride, sms).kernel_args())
    return plan


def takes_tma_kernel(x: torch.Tensor, taps: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether a CUDA launch on x goes through the TMA kernel: bf16, C a
    multiple of 8, every tensor 16-byte aligned (out is a fresh
    allocation, so it is)."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and x.numel() > 0
            and (x.data_ptr() | taps.data_ptr() | scale.data_ptr()
                 | bias.data_ptr()) % 16 == 0)


def depthwise3x3_plain(x: torch.Tensor, kernel: torch.Tensor,
                       scale: torch.Tensor | None = None,
                       bias: torch.Tensor | None = None,
                       stride: int = 1) -> torch.Tensor:
    """The op in plain PyTorch: nine shifted fp32 multiply-adds over the
    zero-padded input, then scale, bias and LeakyReLU, cast to x.dtype."""
    b, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    taps = _taps9(kernel).float()
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((b, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + (ho - 1) * stride + 1:stride,
                     dx:dx + (wo - 1) * stride + 1:stride, :]
            acc = acc + tap * taps[dy * 3 + dx]
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    acc = torch.where(acc >= 0, acc, acc * LEAKY_SLOPE)
    return acc.to(x.dtype)


_FN = None
# calipsync_depthwise3x3's arguments: pointers and the stream as c_void_p
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, ctypes.POINTER(_I), _P]


def _kernel_fn():
    global _FN
    if _FN is None:
        _FN = _build.function("calipsync_depthwise3x3", ARGTYPES)
    return _FN


def launch(x: torch.Tensor, taps: torch.Tensor, scale: torch.Tensor,
           bias: torch.Tensor, stride: int, plan=None) -> torch.Tensor:
    """One launch on checked CUDA tensors (taps (9,C), scale and bias fp32
    and contiguous): the TMA kernel with `plan` (a ``TilePlan``'s
    ``kernel_args`` as a ctypes int array) or, with None, the simple
    kernel. Counts nothing."""
    b, h, w, c = x.shape
    ho, wo = _out_size(h, stride), _out_size(w, stride)
    out = torch.empty((b, ho, wo, c), dtype=x.dtype, device=x.device)
    status = _kernel_fn()(
        x.data_ptr(), taps.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), _build.dtype_code(x.dtype), b, h, w, c, ho, wo,
        stride, LEAKY_SLOPE, plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "depthwise3x3")
    return out


def depthwise3x3(x: torch.Tensor, kernel: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 stride: int = 1) -> torch.Tensor:
    """y = leaky_relu(dwconv3x3(x, kernel) * scale + bias), pad 1, the op
    ``calipsync::depthwise3x3``.

    x (B,H,W,C) NHWC float32 or bfloat16; kernel (3,3,C), (3,3,1,C) or
    (9,C); scale/bias (C,) (folded BN, default identity); stride 1 or 2.
    Returns (B, (H-1)//stride+1, (W-1)//stride+1, C) in x.dtype. The taps,
    scale and bias reach the op as fp32 (9,C), (C,) and (C,) on x's
    device. Not differentiable: a backward through it raises.
    """
    c, dev = x.shape[-1], x.device

    def fp32_on(t):
        if t.dtype != torch.float32 or t.device != dev:
            t = t.to(dev, torch.float32)
        return t if t.is_contiguous() else t.contiguous()

    taps = fp32_on(_taps9(kernel))
    scale = (torch.ones(c, device=dev) if scale is None else fp32_on(scale))
    bias = (torch.zeros(c, device=dev) if bias is None else fp32_on(bias))
    return torch.ops.calipsync.depthwise3x3.default(x, taps, scale, bias,
                                                    stride)


_counts.init(depthwise3x3)


def _depthwise_cuda(x, taps, scale, bias, stride):
    """The kernel's launch: checks, the TMA kernel's plan (or the simple
    kernel), one launch on the current stream, counted."""
    if x.device.type != "cuda":
        raise ValueError(f"depthwise3x3: x on {x.device}, the taps on the "
                         f"card")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("depthwise3x3: x must be a contiguous (B,H,W,C) "
                         "tensor")
    if stride not in (1, 2):
        raise ValueError(f"depthwise3x3: stride must be 1 or 2, not {stride}")
    b, h, w, c = x.shape
    _build.dtype_code(x.dtype)
    if taps.shape != (9, c):
        raise ValueError(f"depthwise3x3: {tuple(taps.shape)} taps for {c} "
                         f"channels")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("depthwise3x3: scale and bias must be (C,)")
    plan = (_plan_array((b, h, w, c, stride, x.device.index))
            if takes_tma_kernel(x, taps, scale, bias) else None)
    out = launch(x, taps, scale, bias, stride, plan)
    _counts.count(depthwise3x3)
    return out


def _depthwise_fake(x, taps, scale, bias, stride):
    b, h, w, c = x.shape
    return x.new_empty((b, _out_size(h, stride), _out_size(w, stride), c))


def _depthwise_backward(ctx, grad):
    raise RuntimeError("calipsync::depthwise3x3 has no gradient: it runs "
                       "eval-mode blocks with BatchNorm folded (train mode "
                       "runs the plain modules)")


def _depthwise_flops(x, taps, scale, bias, stride, *args, out_shape=None,
                     **kwargs) -> int:
    """The nine taps' multiply-adds, two FLOP each (scale, bias and the
    activation are elementwise, which FlopCounterMode does not count)."""
    b, h, w, c = x
    return 2 * 9 * b * _out_size(h, stride) * _out_size(w, stride) * c


_LIB = torch.library.Library("calipsync", "FRAGMENT")
_LIB.define("depthwise3x3(Tensor x, Tensor taps, Tensor scale, Tensor bias, "
            "int stride) -> Tensor")
_LIB.impl("depthwise3x3", depthwise3x3_plain, "CPU")
_LIB.impl("depthwise3x3", _depthwise_cuda, "CUDA")
torch.library.register_fake("calipsync::depthwise3x3", _depthwise_fake,
                            lib=_LIB)
torch.library.register_autograd("calipsync::depthwise3x3",
                                _depthwise_backward, lib=_LIB)
register_flop_formula(torch.ops.calipsync.depthwise3x3)(_depthwise_flops)


def fold_bn(bn_weight: torch.Tensor, bn_bias: torch.Tensor,
            running_mean: torch.Tensor, running_var: torch.Tensor,
            eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BatchNorm -> per-channel (scale, bias) in fp32:
    s = weight / sqrt(var + eps), b = bias - mean * s."""
    s = as_fp32(bn_weight) / torch.sqrt(as_fp32(running_var) + eps)
    return s, as_fp32(bn_bias) - as_fp32(running_mean) * s
