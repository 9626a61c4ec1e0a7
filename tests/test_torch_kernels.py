"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each port wrapper takes its plain PyTorch version (the CUDA
kernels are held against those on the card by chip_smoke.py). The JAX side
runs the Pallas kernels in interpret mode, as tests/test_kernels.py does.
Inputs come from numpy seeds. fp32 throughout; tolerance rtol 1e-3 /
atol 1e-5 (the repo's bar) unless a test states a tighter one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from calipsync_tpu.kernels import cross_attention as jax_attn
from calipsync_tpu.kernels import depthwise as jax_dw
from calipsync_tpu.kernels import fused_ir as jax_ir
from calipsync_tpu_torch.kernels import (cross_attention, depthwise3x3,
                                         fused_inverted_residual,
                                         launch_counts)
from calipsync_tpu_torch.kernels.cross_attention import \
    cross_attention_plain
from calipsync_tpu_torch.kernels import depthwise as port_dw
from calipsync_tpu_torch.kernels.depthwise import fold_bn
from calipsync_tpu_torch.kernels.fused_ir import fold_ir_params

RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(autouse=True)
def _interpret_mode():
    """Run Pallas kernels in interpreter mode on the CPU test backend."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(out, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape,stride", [
    ((2, 9, 7, 12), 1),    # odd spatial sizes, C not a multiple of 8
    ((2, 9, 7, 12), 2),
    ((1, 16, 16, 64), 2),
    ((2, 10, 10, 24), 1),
])
@pytest.mark.parametrize("blocked", [False, True])
def test_depthwise_matches_pallas(shape, stride, blocked):
    rng = np.random.default_rng(sum(shape) + stride)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, c)) * 0.3).astype(np.float32)
    s = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    fn = jax_dw.depthwise3x3_blocked if blocked else jax_dw.depthwise3x3
    ref = fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(s), jnp.asarray(b),
             stride=stride)
    out = depthwise3x3(_t(x), _t(k), _t(s), _t(b), stride=stride)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


@pytest.mark.parametrize("shape,stride", [
    ((1, 20, 20, 1024), 1),   # the main path's shape classes at batch 1
    ((1, 40, 40, 256), 2),
    ((1, 10, 10, 2048), 1),
    ((1, 32, 32, 64), 1),
])
def test_depthwise_plain_matches_xla_reference(shape, stride):
    """The plain version (what the card's kernel is held against) against
    the JAX package's XLA reference, at the main path's widths."""
    rng = np.random.default_rng(sum(shape) + stride)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, c)) * 0.3).astype(np.float32)
    s = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ref = jax_dw.depthwise3x3_reference(jnp.asarray(x), jnp.asarray(k),
                                        jnp.asarray(s), jnp.asarray(b),
                                        stride=stride)
    out = port_dw.depthwise3x3_plain(_t(x), _t(k), _t(s), _t(b),
                                     stride=stride)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


# The generator's 17 depthwise launches at B=128 (H, W, C, stride), and the
# odd shapes chip_smoke.py checks.
MAIN_PATH_DW = [(160, 160, 64, 2), (80, 80, 128, 2), (40, 40, 256, 2),
                (20, 20, 512, 1), (20, 20, 512, 2), (10, 10, 1024, 1),
                (32, 32, 64, 1), (32, 32, 128, 1), (16, 16, 512, 1),
                (10, 10, 1024, 1), (10, 10, 1024, 1), (10, 10, 2048, 1),
                (10, 10, 1024, 1), (10, 10, 1024, 1), (10, 10, 512, 1),
                (20, 20, 1024, 1), (20, 20, 256, 1)]


@pytest.mark.parametrize("b,h,w,c,stride", sorted(
    {(128, *s) for s in MAIN_PATH_DW}
    | {(2, 41, 23, 128, 2), (2, 19, 21, 72, 1), (2, 19, 21, 72, 2),
       (1, 20, 20, 1024, 1), (2, 160, 160, 64, 2), (2, 11, 13, 8, 1)}))
def test_depthwise_tile_plan(b, h, w, c, stride):
    """The TMA kernel's tiling, walked as the kernel walks it: the tiles
    cover the output exactly once, each haloed box lies within the image
    and its pad of 1, the blocks' runs of tiles cover every tile once, the
    threads cover each tile's columns and rows, and the plan fits the
    H100's limits."""
    p = port_dw.plan_tiles(b, h, w, c, stride)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    slabs = -(-c // p.slab)
    tiles_h, tiles_w = ho // p.tile_h, wo // p.tile_w
    assert p.tiles == slabs * b * tiles_h * tiles_w
    # the box: TMA's limits (<= 256 a dimension, inner extent a multiple
    # of 16 bytes)
    assert p.box_h == (p.tile_h - 1) * stride + 3 <= 256
    assert p.box_w == (p.tile_w - 1) * stride + 3 <= 256
    assert p.slab <= 64 and (p.slab * 2) % 16 == 0 and p.slab % 8 == 0
    # shared memory at the chosen blocks an SM
    assert p.smem == p.stages * port_dw.stage_bytes(p.box_h, p.box_w,
                                                    p.slab)
    assert p.smem <= port_dw.SMEM_PER_BLOCK
    assert (p.smem + port_dw.SMEM_RESERVED) * p.blocks_per_sm \
        <= port_dw.SMEM_PER_SM
    assert p.blocks_per_sm * p.threads <= port_dw.THREADS_PER_SM
    assert (p.blocks_per_sm * p.threads * port_dw.REGS_PER_THREAD
            <= port_dw.REGS_PER_SM)
    assert p.grid <= min(p.tiles, 132 * p.blocks_per_sm)
    assert 2 <= p.stages <= port_dw.MAX_STAGES
    # threads: one an (8-channel group, column, run of rows)
    units = p.slab // 8 * p.tile_w * p.segments
    assert units <= p.threads <= 256 and p.threads % 32 == 0
    run = -(-p.tile_h // p.segments)
    runs = [min(run, p.tile_h - r0) for r0 in range(0, p.tile_h, run)]
    assert len(runs) == p.segments and sum(runs) == p.tile_h

    cover = np.zeros((b, ho, wo, slabs), np.int32)
    per, extra = divmod(p.tiles, p.grid)
    walked = []
    for blk in range(p.grid):
        first = blk * per + min(blk, extra)
        walked += range(first, first + per + (blk < extra))
    assert walked == list(range(p.tiles))
    for t in walked:   # ((slab * images + b) * tiles_h + ty) * tiles_w + tx
        tx, r = t % tiles_w, t // tiles_w
        ty, r = r % tiles_h, r // tiles_h
        img, slab = r % b, r // b
        y0, x0 = ty * p.tile_h, tx * p.tile_w
        cover[img, y0:y0 + p.tile_h, x0:x0 + p.tile_w, slab] += 1
        top, left = y0 * stride - 1, x0 * stride - 1
        assert -1 <= top and top + p.box_h - 1 <= h
        assert -1 <= left and left + p.box_w - 1 <= w
    assert (cover == 1).all()


def test_depthwise_kernel_choice():
    """bf16 with C a multiple of 8 and 16-byte-aligned tensors takes the
    TMA kernel; fp32, C not a multiple of 8 or an unaligned view takes
    the simple one."""
    w = [torch.zeros(9, 16), torch.ones(16), torch.zeros(16)]
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    assert port_dw.takes_tma_kernel(x, *w)
    assert not port_dw.takes_tma_kernel(x.float(), *w)
    assert not port_dw.takes_tma_kernel(
        torch.zeros((1, 4, 4, 12), dtype=torch.bfloat16),
        torch.zeros(9, 12), torch.ones(12), torch.zeros(12))
    flat = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    assert not port_dw.takes_tma_kernel(flat[1:].view(x.shape), *w)
    assert not port_dw.takes_tma_kernel(x, torch.zeros(9 * 16 + 1)[1:], *w[1:])


def _ir_weights(rng, cin, ch, cout):
    return (rng.standard_normal((cin, ch)).astype(np.float32) * 0.3,
            rng.standard_normal(ch).astype(np.float32) * 0.1,
            rng.standard_normal((9, ch)).astype(np.float32) * 0.3,
            rng.standard_normal(ch).astype(np.float32) * 0.1,
            rng.standard_normal((ch, cout)).astype(np.float32) * 0.3,
            rng.standard_normal(cout).astype(np.float32) * 0.1)


@pytest.mark.parametrize("shape,ch,cout,residual,block_h", [
    ((2, 8, 8, 6), 12, 32, False, None),    # the inc stem's widths
    ((2, 12, 10, 16), 32, 16, True, 4),     # tile split across rows
    ((1, 9, 11, 12), 24, 12, True, 3),      # odd sizes, residual
    ((2, 7, 5, 10), 20, 6, False, 7),       # C not a multiple of 8
])
def test_fused_ir_matches_pallas(shape, ch, cout, residual, block_h):
    rng = np.random.default_rng(ch + cout)
    x = rng.standard_normal(shape).astype(np.float32)
    w = _ir_weights(rng, shape[-1], ch, cout)
    ref = jax_ir.fused_inverted_residual(
        jnp.asarray(x), *map(jnp.asarray, w), residual=residual,
        block_h=block_h)
    out = fused_inverted_residual(_t(x), *map(_t, w), residual=residual)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref)


def test_fused_ir_edges_are_zero_padded_hidden():
    """With a large b1, leaky(b1) at the halo would differ from the zero
    padding the depthwise conv takes; both sides must agree on zeros."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 6, 6, 4)).astype(np.float32)
    w = list(_ir_weights(rng, 4, 8, 4))
    w[1] = np.full(8, 3.0, np.float32)
    ref = jax_ir.fused_inverted_residual_reference(
        jnp.asarray(x), *map(jnp.asarray, w), residual=True)
    out = fused_inverted_residual(_t(x), *map(_t, w), residual=True)
    _close(out, ref)


@pytest.mark.parametrize("b,n,d,c", [(2, 100, 64, 512), (3, 37, 24, 40)])
def test_cross_attention_matches_pallas(b, n, d, c):
    rng = np.random.default_rng(n)
    q = (rng.standard_normal((b, n, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, n, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, n, c)).astype(np.float32)
    ref = jax_attn.cross_attention(*map(jnp.asarray, (q, k, v)))
    out = cross_attention(_t(q), _t(k), _t(v))
    assert tuple(out.shape) == (b, n, c)
    _close(out, ref)


def _attention_hi_lo(q, k, v, split=True, key_block=128):
    """The bf16 CUDA kernel's arithmetic in torch: fp32 scores from bf16
    inputs, e = exp(s - max) in fp32, e split into a bf16 high part and a
    bf16 remainder, the two products with v summed in fp32, the row sum
    divided out at the end. Keys go in blocks of key_block, as in the
    kernel: the row max and sum run over the blocks, and the sums so far
    are rescaled when the max rises. fp32 result, before the kernel's bf16
    cast. split=False multiplies a bf16 e alone, the arithmetic the kernel
    avoids."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = torch.full((*qf.shape[:2], 1), float("-inf"))
    total = torch.zeros(*qf.shape[:2], 1)
    out = torch.zeros(*qf.shape[:2], vf.shape[-1])
    for j0 in range(0, kf.shape[1], key_block):
        kb, vb = kf[:, j0:j0 + key_block], vf[:, j0:j0 + key_block]
        s = qf @ kb.transpose(1, 2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        rescale = torch.exp(m - m_new)
        e = torch.exp(s - m_new)
        hi = e.to(torch.bfloat16).float()
        part = hi @ vb
        if split:
            part = part + (e - hi).to(torch.bfloat16).float() @ vb
        out = out * rescale + part
        total = total * rescale + e.sum(-1, keepdim=True)
        m = m_new
    return out / total


@pytest.mark.parametrize("b,n,d,c", [(2, 100, 64, 512), (3, 37, 24, 40),
                                     (2, 300, 64, 96)])
def test_attention_hi_lo_split_keeps_fp32_p(b, n, d, c):
    """The hi/lo split keeps the Pallas body's fp32-p semantics. Against
    the Pallas kernel run in fp32 on the same bf16-rounded inputs: e_hi +
    e_lo is e to a relative 2^-18 (the remainder is rounded to 8 bits of
    itself, and is at most 2^-9 of e), so the output is within
    2^-18 sum|p v| <= 2^-18 max|v| (~1.6e-5 here) plus fp32 summation
    order: atol 2e-5. N=300 takes three key blocks, so the running max
    and its rescaling are held to the same bar. A bf16 e alone (relative
    2^-9) misses that bar by far. Against cross_attention_plain in bf16: within that atol plus one
    bf16 ulp of the output, where the final cast rounds the two fp32
    values apart."""
    rng = np.random.default_rng(n)
    q, k = (torch.from_numpy((rng.standard_normal((b, n, d)) * 0.3).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((b, n, c)).astype(
        np.float32)).to(torch.bfloat16)
    ref = np.asarray(jax_attn.cross_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v))))
    atol = 2e-5
    _close(_attention_hi_lo(q, k, v), ref, rtol=0.0, atol=atol)
    bf16_p = np.abs(_attention_hi_lo(q, k, v, split=False).numpy() - ref)
    assert bf16_p.max() > 10 * atol

    out = _attention_hi_lo(q, k, v).to(torch.bfloat16).float()
    plain = cross_attention_plain(q, k, v).float()
    big = torch.maximum(out.abs(), plain.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    assert bool(((out - plain).abs() <= ulp + atol).all())


def test_cpu_wrappers_launch_no_kernel():
    """On CPU tensors the wrappers take the plain versions and count no
    launch."""
    before = launch_counts()
    x = torch.zeros((1, 4, 4, 8))
    depthwise3x3(x, torch.zeros(3, 3, 8))
    fused_inverted_residual(x, torch.zeros(8, 8), torch.zeros(8),
                            torch.zeros(9, 8), torch.zeros(8),
                            torch.zeros(8, 8), torch.zeros(8))
    cross_attention(torch.zeros(1, 5, 4), torch.zeros(1, 5, 4),
                    torch.zeros(1, 5, 6))
    assert launch_counts() == before


def test_graph_replays_count_their_captured_launches():
    """A CUDA graph's replay counts, in ``launches`` and ``replayed``,
    the launches its capture recorded (``captured``, taken apart from
    ``launches``): kernels.note_replay, as train/trainer.py's graph calls
    it; reset_launches zeroes both counts and leaves ``captured``."""
    from calipsync_tpu_torch import kernels

    captured = kernels.captured_counts()
    assert set(captured) == set(launch_counts())
    kernels.reset_launches()
    kernels.note_replay({"cross_attention": 4, "fused_ir": 0})
    kernels.note_replay({"cross_attention": 4})
    assert launch_counts() == {"fused_ir": 0, "depthwise3x3": 0,
                               "cross_attention": 8}
    assert cross_attention.replayed == 8
    kernels.reset_launches()
    assert sum(launch_counts().values()) == cross_attention.replayed == 0
    assert kernels.captured_counts() == captured


def _bn_np(rng, c):
    return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}, \
           {"mean": (rng.standard_normal(c) * 0.2).astype(np.float32),
            "var": rng.uniform(0.25, 1.75, c).astype(np.float32)}


def test_bn_folds_match_jax():
    rng = np.random.default_rng(4)
    cin, ch, cout = 6, 12, 10
    kernels = {"expand": (1, 1, cin, ch), "depthwise": (3, 3, 1, ch),
               "project": (1, 1, ch, cout)}
    params, stats, torch_stages = {}, {}, []
    for name, kshape in kernels.items():
        k = rng.standard_normal(kshape).astype(np.float32)
        p, s = _bn_np(rng, kshape[-1])
        params[name] = {"conv": {"kernel": k}, "bn": p}
        stats[name] = {"bn": s}
        torch_stages.append((_t(k.transpose(3, 2, 0, 1).copy()),
                             _t(p["scale"]), _t(p["bias"]), _t(s["mean"]),
                             _t(s["var"])))
    ref = jax_ir.fold_ir_params(params, stats)
    out = fold_ir_params(*torch_stages)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == tuple(r.shape)
        _close(o, r, rtol=1e-6, atol=1e-7)  # a few fp32 ulps apart

    p, s = _bn_np(rng, 16)
    ref = jax_dw.fold_bn(p, s)
    out = fold_bn(_t(p["scale"]), _t(p["bias"]), _t(s["mean"]),
                  _t(s["var"]))
    for o, r in zip(out, ref):
        _close(o, r, rtol=1e-6, atol=1e-7)
