"""The port's binding to the native data core (``data/native_decode.py``)
against the JAX package's: both load the committed ``csrc/libdatacore.so``,
so ``decode_jpeg``, ``resize_bilinear``, ``decode_letterbox``,
``load_letterbox_batch`` and ``NativeEvalLoader`` must agree bit for bit on
the five committed deploy-fixture JPEGs and on a generated PNG (which the
core cannot decode: the per-item PIL fallback, through the port's own
``transforms.ResizePad``). Skipped where the library does not load, as
tests/test_native_decode.py is; the decision is made in a fixture.

Without the library, ``available()`` is False, ``NativeEvalLoader``
refuses and ``PilEvalLoader`` gives the same batches through PIL (within
one count of the native resize, the scales and sizes equal).
"""
import glob
import os

import numpy as np
import pytest

from ood_object_detection_tpu.data import native_decode as jax_nd
from ood_object_detection_tpu_torch.data import native_decode as nd

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "deploy_fixture")
JPEGS = sorted(glob.glob(os.path.join(FIXTURE, "*.jpg")))


@pytest.fixture
def core():
    if not nd.available():
        pytest.skip("the native data core does not load here (libjpeg)")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The five JPEGs and a PNG, which only the PIL fallback reads."""
    from PIL import Image
    png = str(tmp_path_factory.mktemp("png") / "gradient.png")
    yy, xx = np.mgrid[0:90, 0:130]
    Image.fromarray(np.stack([xx * 2, yy * 2, xx + yy], -1)
                    .astype(np.uint8)).save(png)
    return JPEGS + [png]


def test_fixture_has_the_five_jpegs():
    assert len(JPEGS) == 5


@pytest.mark.parametrize("target", [(512, 512), (128, 128), (300, 200)])
def test_load_letterbox_batch_matches_jax(core, paths, target):
    ours = nd.load_letterbox_batch(paths, target)
    want = jax_nd.load_letterbox_batch(paths, target)
    for a, b in zip(ours, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert list(ours[3][:5]) == [0] * 5 and ours[3][5] != 0   # the PNG


@pytest.mark.parametrize("index", range(5))
def test_decode_letterbox_matches_jax(core, index):
    with open(JPEGS[index], "rb") as f:
        data = f.read()
    canvas, scale, hw = nd.decode_letterbox(data, (256, 192))
    canvas_j, scale_j, hw_j = jax_nd.decode_letterbox(data, (256, 192))
    np.testing.assert_array_equal(canvas, canvas_j)
    assert (scale, hw) == (scale_j, hw_j)
    decoded = nd.decode_jpeg(data)
    np.testing.assert_array_equal(decoded, jax_nd.decode_jpeg(data))
    np.testing.assert_array_equal(nd.resize_bilinear(decoded, (77, 101)),
                                  jax_nd.resize_bilinear(decoded, (77, 101)))


def test_decode_refuses_what_is_not_a_jpeg(core, paths):
    with open(paths[-1], "rb") as f:
        png = f.read()
    assert nd.decode_jpeg(png) is None
    assert nd.decode_letterbox(png, (64, 64)) is None


def _batches_equal(ours, want):
    assert len(ours) == len(want)
    for a, b in zip(ours, want):
        assert a["path"] == b["path"]
        for key in ("image", "img_scale", "img_size"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("batch", [4, 6])
def test_native_eval_loader_matches_jax(core, paths, batch):
    """Batches of 4 (the tail of 2 padded to 4) and of 6, the PNG through
    the PIL fallback on both sides."""
    ours = list(nd.NativeEvalLoader(paths, (128, 160), batch))
    want = list(jax_nd.NativeEvalLoader(paths, (128, 160), batch))
    _batches_equal(ours, want)
    assert len(ours) == len(nd.NativeEvalLoader(paths, (128, 160), batch))
    tail = ours[-1]
    assert tail["image"].shape[0] == batch
    pad = batch - len(tail["path"])
    assert (pad == 2) == (batch == 4)
    if pad:
        assert not tail["image"][-pad:].any()
        assert (tail["img_scale"][-pad:] == 1).all()


def test_drop_last_matches_jax(core, paths):
    ours = list(nd.NativeEvalLoader(paths, (96, 96), 4, drop_last=True))
    want = list(jax_nd.NativeEvalLoader(paths, (96, 96), 4, drop_last=True))
    _batches_equal(ours, want)
    assert len(ours) == 1


def test_pil_loader_matches_the_native_batches(core, paths):
    """Every image through PIL: the letterbox within one count of the
    native resize, the scales and original sizes equal."""
    native = list(nd.NativeEvalLoader(paths, (128, 160), 4))
    pil = list(nd.PilEvalLoader(paths, (128, 160), 4))
    assert len(native) == len(pil)
    for a, b in zip(native, pil):
        assert a["path"] == b["path"]
        diff = np.abs(a["image"].astype(np.int32) - b["image"])
        assert diff.max() <= 1
        np.testing.assert_array_equal(a["img_scale"], b["img_scale"])
        np.testing.assert_array_equal(a["img_size"], b["img_size"])


def test_without_the_library(paths, monkeypatch):
    """Where the committed library does not load, nothing is built:
    ``available()`` is False, the native loader refuses, and the PIL loader
    still gives padded batches."""
    monkeypatch.setattr(nd, "_LIB_PATH", os.path.join(FIXTURE, "absent.so"))
    monkeypatch.setattr(nd, "_lib", None)
    monkeypatch.setattr(nd, "_tried", False)
    assert not nd.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        nd.NativeEvalLoader(paths, (64, 64), 4)
    with pytest.raises(RuntimeError, match="does not load"):
        nd.load_letterbox_batch(paths, (64, 64))
    batches = list(nd.PilEvalLoader(paths, (64, 64), 4))
    assert [b["image"].shape for b in batches] == [(4, 64, 64, 3)] * 2
    assert batches[-1]["path"] == paths[4:]
    assert not os.path.exists(os.path.join(FIXTURE, "absent.so"))
