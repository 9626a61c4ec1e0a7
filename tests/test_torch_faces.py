"""The port's face models against the JAX package on the CPU, fp32: S3FD
(raw heads on an odd-sized input, decoded and NMS-ed boxes, the device
top-k path), PFLD-GhostOne (train form, deploy form and the MobileOne
fold), YOLOv8n-face (raw heads, decode, letterbox, detector) and the
LipDetector. Seeded random weights in the port's layout cross to the JAX
package through its importers and back through ``from_jax_*`` with a
strict load; the round trip is held exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calipsync_tpu.nn import pfld as jpfld
from calipsync_tpu.nn import s3fd as js3fd
from calipsync_tpu.nn import yolo as jyolo
from calipsync_tpu.vision.lip_detector import LipDetector as JaxLipDetector
from calipsync_tpu_torch.bench_assets import (mean_face, random_pfld_state,
                                              random_state_dict)
from calipsync_tpu_torch.core.weights import (from_jax_pfld, from_jax_s3fd,
                                              from_jax_yolo)
from calipsync_tpu_torch.nn import pfld, s3fd, yolo
from calipsync_tpu_torch.vision.lip_detector import LipDetector


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs beside other workers, and
    more threads spend more CPU for about the same wall time here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-3, 1e-5  # atol in units of the output's largest value


def _close(out, ref, what=""):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, what
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=ATOL * float(np.abs(ref).max()),
                               err_msg=what)


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def s3fd_pair():
    sd = random_state_dict(s3fd.S3FDBackbone(), seed=0)
    # face logits 3 below their random level: a few hundred priors score
    # above 0.05, so the compacted top-k path serves every frame
    for k in range(6):
        sd[f"conf.{k}.bias"][-1] -= 3.0
    variables = js3fd.import_s3fd(_np(sd))
    model = s3fd.S3FDBackbone().eval()
    model.load_state_dict(from_jax_s3fd(variables), strict=True)
    return sd, variables, model


@pytest.fixture(scope="module")
def pfld_pair():
    sd = random_pfld_state(seed=1)
    variables = jpfld.import_pfld(_np(sd))
    model = pfld.PFLDGhostOne().eval()
    model.load_state_dict(from_jax_pfld(variables), strict=True)
    return sd, variables, model


@pytest.fixture(scope="module")
def yolo_pair():
    sd = random_state_dict(yolo.YoloV8Face(), seed=2)
    variables = jyolo.import_yolov8_face(_np(sd))
    model = yolo.YoloV8Face().eval()
    model.load_state_dict(from_jax_yolo(variables), strict=True)
    return sd, variables, model


@pytest.mark.parametrize("which", ["s3fd", "pfld", "yolo"])
def test_state_dict_round_trips_through_the_jax_importers(
        which, s3fd_pair, pfld_pair, yolo_pair):
    """port state_dict -> JAX importer -> from_jax_* gives the same keys
    and values."""
    sd, variables, _ = {"s3fd": s3fd_pair, "pfld": pfld_pair,
                        "yolo": yolo_pair}[which]
    back = {"s3fd": from_jax_s3fd, "pfld": from_jax_pfld,
            "yolo": from_jax_yolo}[which](variables)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_yolo_keys_match_the_ultralytics_manifest(yolo_pair):
    import pathlib

    tsv = (pathlib.Path(__file__).parent / "fixtures"
           / "yolov8n_face_state_dict_keys.tsv")
    manifest = {}
    for line in tsv.read_text().splitlines():
        if not line.startswith("#"):
            key, shape = line.split("\t")
            manifest[key] = tuple(int(s) for s in shape.split(",") if s)
    ours = {k: tuple(v.shape) for k, v in yolo_pair[2].state_dict().items()}
    assert ours == manifest


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil,groups", [
    (3, 8, 3, 2, 1, 1, 1),     # strided, padded
    (8, 6, 1, 1, 0, 1, 1),     # 1x1: no unfold
    (8, 8, 3, 1, 1, 1, 8),     # depthwise
    (8, 12, 3, 1, 6, 6, 2),    # dilated, grouped (S3FD's fc6 is dilated)
    (4, 4, 5, 1, 0, 1, 1)])    # valid, as PFLD's conv8
def test_conv2d_products_match_conv2d(cin, cout, k, stride, pad, dil,
                                      groups):
    """The card's path of ProductConv2d against F.conv2d in float64."""
    from calipsync_tpu_torch.nn.product_conv import conv2d

    g = torch.Generator().manual_seed(cin * k + groups)
    conv = torch.nn.Conv2d(cin, cout, k, stride, pad, dil, groups).double()
    x = torch.randn(2, cin, 13, 11, generator=g, dtype=torch.float64)
    torch.testing.assert_close(
        conv2d(x, conv.weight, conv.bias, stride, pad, dil, groups),
        conv(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(5, 9), (4, 6)])
def test_ceil_mode_pool_matches_jax(shape):
    x = np.random.default_rng(3).standard_normal(
        (2,) + shape + (3,)).astype(np.float32)
    ref = js3fd._maxpool(jnp.asarray(x), ceil_mode=True)
    out = torch.nn.functional.max_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))


def test_s3fd_heads_match_jax(s3fd_pair):
    """Odd H and W: the ceil-mode pool pads, the extras round up."""
    _, variables, model = s3fd_pair
    x = np.random.default_rng(4).uniform(-120, 140, (2, 75, 61, 3)).astype(
        np.float32)
    loc, conf = jax.jit(js3fd.S3FDBackbone().apply)(variables, x)
    with torch.no_grad():
        o_loc, o_conf = model(torch.from_numpy(x))
    _close(o_loc, loc, "loc")
    _close(o_conf, conf, "conf")


def test_s3fd_detector_matches_jax(s3fd_pair):
    """Decoded, NMS-ed boxes against the JAX detector; the card's top-k
    compaction against the full grid (the same boxes, bit for bit)."""
    sd, variables, _ = s3fd_pair
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (160, 120, 3), np.uint8)
              for _ in range(3)]
    kw = dict(scale=0.5, det_conf_th=0.3)
    ref = js3fd.S3FDDetector(variables, **kw).detect(frames)
    ours = s3fd.S3FDDetector(sd, device="cpu", **kw)
    got = ours.detect(frames)
    assert not ours._topk_sticky_off  # every frame through the top-k
    full = s3fd.S3FDDetector(sd, device="cpu", topk_device=0,
                             **kw).detect(frames)
    n_boxes = 0
    for (rb, ri), (ob, oi), (fb, fi) in zip(ref, got, full):
        assert oi == ri == fi and len(ob) == len(rb)
        n_boxes += len(ob)
        np.testing.assert_array_equal(ob, fb)
        if len(rb):
            np.testing.assert_allclose(ob, rb, rtol=RTOL, atol=1e-3)
    assert n_boxes > 0


def test_pfld_train_and_deploy_forms_match_jax(pfld_pair):
    sd, variables, model = pfld_pair
    x = np.random.default_rng(6).random((2, 192, 192, 3), dtype=np.float32)
    ref = jax.jit(jpfld.PFLDGhostOne().apply)(variables, x)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref, "train form")

    folded = jpfld.fold_mobileone_params(variables)
    ours = pfld.fold_mobileone(sd)
    theirs = from_jax_pfld(folded)
    assert ours.keys() == theirs.keys()
    for k in ours:
        _close(ours[k], theirs[k].numpy(), k)
    deploy = pfld.PFLDGhostOne(deploy=True).eval()
    deploy.load_state_dict(ours, strict=True)
    ref_d = jax.jit(jpfld.PFLDGhostOne(deploy=True).apply)(folded, x)
    with torch.no_grad():
        out_d = deploy(torch.from_numpy(x))
    _close(out_d, ref_d, "deploy form")
    _close(out_d, ref, "deploy vs train form")


def test_auxiliary_net_matches_jax():
    rng = np.random.default_rng(7)
    feats = [rng.standard_normal((2, s, s, c)).astype(np.float32)
             for s, c in ((24, 32), (12, 40), (6, 48), (3, 72))]
    aux = jpfld.AuxiliaryNet()
    variables = jax.jit(aux.init)(jax.random.key(0), *feats)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), variables)
    ref = jax.jit(aux.apply)(variables, *feats)
    net = pfld.AuxiliaryNet().eval()
    sd = {}
    for name, p in variables["params"].items():  # e.g. merge3_conv
        block, part = name.rsplit("_", 1)
        if part == "conv":
            sd[f"{block}.conv.weight"] = torch.from_numpy(np.ascontiguousarray(
                p["kernel"].transpose(3, 2, 0, 1)))
        else:
            st = variables["batch_stats"][name]
            sd.update({f"{block}.bn.weight": p["scale"],
                       f"{block}.bn.bias": p["bias"],
                       f"{block}.bn.running_mean": st["mean"],
                       f"{block}.bn.running_var": st["var"],
                       f"{block}.bn.num_batches_tracked": np.int64(0)})
    net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        _close(net(*map(torch.from_numpy, feats)), ref)


def test_yolo_heads_decode_and_detector_match_jax(yolo_pair):
    sd, variables, model = yolo_pair
    x = np.random.default_rng(8).random((2, 64, 64, 3), dtype=np.float32)
    outs = jax.jit(lambda v, x: jyolo.YoloV8Face().apply(v, x))(variables, x)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))
    for (jb, jc, jk), (tb, tc, tk) in zip(outs, ours):
        for j, t in ((jb, tb), (jc, tc), (jk, tk)):
            _close(t, j)
    ref = jax.jit(jyolo.decode_outputs)(outs)
    got = yolo.decode_outputs(ours)
    for r, o in zip(ref, got):
        _close(o, r)
    # the decode alone, on the same raw outputs
    same = yolo.decode_outputs([tuple(torch.from_numpy(np.array(t))
                                      for t in o) for o in outs])
    for r, o in zip(ref, same):
        _close(o, r)

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (90, 70, 3), np.uint8) for _ in range(2)]
    kw = dict(conf_threshold=0.3, img_size=64, batch_size=2)
    r_det = jyolo.YoloV8FaceDetector(variables, **kw).detect(frames)
    o_det = yolo.YoloV8FaceDetector(sd, device="cpu", **kw).detect(frames)
    for (rb, ri), (ob, oi) in zip(r_det, o_det):
        assert oi == ri
        np.testing.assert_allclose(ob, rb, rtol=RTOL, atol=1e-3)


@pytest.mark.parametrize("hw", [(200, 100), (64, 80), (640, 640)])
def test_letterbox_and_upsample_match_jax(hw):
    img = np.random.default_rng(10).integers(0, 256, hw + (3,), np.uint8)
    for a, b in zip(yolo.letterbox(img, 640), jyolo.letterbox(img, 640)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(11).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    ref = jyolo._upsample2x_nearest(jnp.asarray(x))
    out = yolo.upsample2x_nearest(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))


class _StubFaces:
    """Fixed boxes, one inside the frame and one past its top-left edge
    (the crop is border-padded)."""

    def detect(self, images):
        boxes = np.array([[40.5, 60.2, 150.0, 170.9], [-30.0, -12.0, 110.0,
                                                         96.0]], np.float32)
        return [(boxes, [0, 1]) for _ in images]


@pytest.mark.parametrize("detect_stride", [1, 3])
def test_lip_detector_matches_jax(pfld_pair, synthetic_step3_dir,
                                  detect_stride):
    """int32 landmarks equal to the JAX detector's; a value may round
    across .5 apart by 1 px (counted and printed)."""
    import cv2

    sd, variables, _ = pfld_pair
    frames = [cv2.imread(str(p)) for p in sorted(
        (synthetic_step3_dir / "frames").glob("*.jpg"))[:5]]
    face = mean_face(0)
    ref = JaxLipDetector(jpfld.fold_mobileone_params(variables), face,
                         _StubFaces(), detect_stride=detect_stride
                         ).detect_landmarks(frames)
    lip = LipDetector(pfld.fold_mobileone(sd), face, _StubFaces(),
                      detect_stride=detect_stride, device="cpu")
    got = lip.submit(frames).result()
    lip.close()
    moved = total = 0
    for r, o in zip(ref, got):
        assert len(r) == len(o) == 2
        for a, b in zip(r, o):
            assert b.dtype == np.int32 and b.shape == (110, 2)
            d = np.abs(a.astype(np.int64) - b)
            assert d.max() <= 1
            moved += int((d > 0).sum())
            total += d.size
    print(f"landmarks 1 px apart: {moved} of {total}")
    assert moved <= 1e-3 * total
