"""The port's training data (data/dataset.py, the training geometry of
vision/geometry.py, bench_assets.make_synthetic_step1) against the JAX
package's, byte for byte, on the shared synthetic step-1 directory."""

import threading
import time

import numpy as np
import pytest
import torch

from calipsync_tpu.data import dataset as jax_ds
from calipsync_tpu.vision import geometry as jax_geo
from calipsync_tpu_torch.bench_assets import make_synthetic_step1
from calipsync_tpu_torch.data import dataset as port_ds
from calipsync_tpu_torch.vision import geometry as port_geo


def test_samples_and_batches_match_jax(synthetic_step1_dir):
    ours = port_ds.LipSyncDataset(str(synthetic_step1_dir))
    ref = jax_ds.LipSyncDataset(str(synthetic_step1_dir))
    assert len(ours) == len(ref) == 25
    np.testing.assert_array_equal(ours.audio_feats, ref.audio_feats)
    for idx in (0, 7, 24):
        a = ours.sample(idx, np.random.default_rng(idx))
        b = ref.sample(idx, np.random.default_rng(idx))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    got = list(port_ds.batch_iterator(ours, 4, np.random.default_rng(3),
                                      drop_last=True, num_workers=3))
    want = list(jax_ds.batch_iterator(ref, 4, np.random.default_rng(3),
                                      drop_last=True, num_workers=3))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_resident_store_and_indices_match_jax(synthetic_step1_dir):
    ours = port_ds.ResidentLipSyncDataset(str(synthetic_step1_dir),
                                          device="cpu", num_workers=2)
    ref = jax_ds.ResidentLipSyncDataset(str(synthetic_step1_dir),
                                        num_workers=2)
    assert ours.store.dtype == torch.uint8
    np.testing.assert_array_equal(ours.store.numpy(),
                                  np.asarray(ref.store_dev))
    assert len(ours) == len(ref) and ours.n_frames == ref.n_frames
    for shuffle, drop_last in ((True, True), (False, False)):
        got = list(ours.epoch_indices(4, np.random.default_rng(8),
                                      shuffle=shuffle, drop_last=drop_last))
        want = list(ref.epoch_indices(4, np.random.default_rng(8),
                                      shuffle=shuffle, drop_last=drop_last))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype == np.int32
                np.testing.assert_array_equal(x, y)


def test_training_geometry_matches_jax(synthetic_step1_dir):
    import cv2

    img = cv2.imread(str(synthetic_step1_dir / "full_body_img" / "3.jpg"))
    lms = port_geo.load_landmarks(str(synthetic_step1_dir / "landmarks" /
                                      "3.lms"))
    np.testing.assert_array_equal(lms, jax_geo.load_landmarks(
        str(synthetic_step1_dir / "landmarks" / "3.lms")))
    assert port_geo.mouth_bbox_train(lms) == jax_geo.mouth_bbox_train(lms)
    x0, y0, x1, y1 = port_geo.mouth_bbox_train(lms)
    crop = port_geo.crop_resize_168(img, y0, y1, x0, x1)
    np.testing.assert_array_equal(
        crop, jax_geo.crop_resize_168(img, y0, y1, x0, x1))
    c160 = port_geo.center_160(crop)
    np.testing.assert_array_equal(port_geo.mask_mouth(c160),
                                  jax_geo.mask_mouth(c160))
    assert (port_geo.mask_mouth(c160)[5:150, 5:155] == 0).all()


def test_synthetic_step1_reads_in_both_packages(tmp_path):
    root = make_synthetic_step1(str(tmp_path), n_frames=5, res=160, seed=1)
    ours = port_ds.LipSyncDataset(root)
    ref = jax_ds.LipSyncDataset(root)
    assert len(ours) == len(ref) == 5
    assert ours.audio_feats.shape == (6, 2, 1024)
    a = ours.sample(2, np.random.default_rng(0))
    b = ref.sample(2, np.random.default_rng(0))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # structured frames, not noise: the crop has large smooth areas
    assert np.abs(np.diff(a["target"].astype(np.int16), axis=1)).mean() < 20


def test_prefetcher_order_errors_and_close():
    with port_ds.Prefetcher(iter(range(5)), depth=2) as pf:
        assert list(pf) == list(range(5))

    def failing():
        yield 1
        raise ValueError("decode failed")

    pf = port_ds.Prefetcher(failing(), put_fn=lambda x: x * 10)
    assert next(pf) == 10
    with pytest.raises(ValueError, match="decode failed"):
        next(pf)
    pf.close()

    closed = threading.Event()

    def endless():
        try:
            while True:
                yield np.zeros(3)
        finally:
            closed.set()

    pf = port_ds.Prefetcher(endless(), depth=1)
    next(pf)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5
    assert not pf._thread.is_alive() and closed.is_set()
