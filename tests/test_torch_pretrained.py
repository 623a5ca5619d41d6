"""Published pretrained weights in the port beside the JAX package's
``utils.pretrained``: the same URL table and cache, one fetch then cache
hits (``urllib.request.urlretrieve`` is replaced in every case, so nothing
is fetched), ``create_model(pretrained=True)`` over a filled cache loading
the same tensors, bit for bit, as ``checkpoint_path=`` on that file and as
the JAX ``create_model(pretrained=True)`` carried over by
``utils.from_jax``; and ``merge_into_variables`` against the JAX
function."""
import os
import urllib.request

import numpy as np
import pytest
import torch

from ood_object_detection_tpu import factory as jfactory
from ood_object_detection_tpu.utils import checkpoint_convert as jconvert
from ood_object_detection_tpu.utils import pretrained as jpretrained
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.utils import checkpoint_convert as convert
from ood_object_detection_tpu_torch.utils import pretrained
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

from test_torch_checkpoint_convert import reference_state_dict  # noqa: F401

IMG = 128
D0_FILE = os.path.basename(pretrained.PRETRAINED_URLS["efficientdet_d0"])


@pytest.fixture
def no_fetch(monkeypatch):
    """urlretrieve raising; returns the list of the URLs it was asked
    for."""
    calls = []

    def refuse(url, dst):
        calls.append(url)
        raise AssertionError(f"a test tried to fetch {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    return calls


@pytest.fixture
def filled_cache(reference_state_dict, tmp_path, monkeypatch,  # noqa: F811
                 no_fetch):
    """The cache variable pointing at a directory that holds a D0 file
    under the published name."""
    cache = tmp_path / "cache"
    cache.mkdir()
    torch.save(reference_state_dict, cache / D0_FILE)
    monkeypatch.setenv("OOD_TPU_CHECKPOINT_CACHE", str(cache))
    return cache


def _d0(**kw):
    return create_model("efficientdet_d0", num_classes=90,
                        image_size=(IMG, IMG), device="cpu", **kw)


def test_download_checkpoint_caches(tmp_path, monkeypatch):
    """tests/test_checkpoint_convert.py:143 on the port: one fetch into
    ``<file>.part``, renamed into place, then cache hits; no published
    weights for efficientdet_d3."""
    calls = []

    def fake_retrieve(url, dst):
        calls.append((url, dst))
        assert dst.endswith(".part") and not os.path.exists(dst[:-5])
        with open(dst, "wb") as f:
            f.write(b"ckpt")

    monkeypatch.setattr(urllib.request, "urlretrieve", fake_retrieve)
    p1 = pretrained.download_checkpoint("efficientdet_d0",
                                        cache_dir=str(tmp_path))
    p2 = pretrained.download_checkpoint("efficientdet_d0",
                                        cache_dir=str(tmp_path))
    assert p1 == p2 == str(tmp_path / D0_FILE)
    assert calls == [(pretrained.PRETRAINED_URLS["efficientdet_d0"],
                      p1 + ".part")]
    assert open(p1, "rb").read() == b"ckpt"
    assert sorted(os.listdir(tmp_path)) == [D0_FILE]
    with pytest.raises(ValueError, match="efficientdet_d3"):
        pretrained.download_checkpoint("efficientdet_d3",
                                       cache_dir=str(tmp_path))
    assert len(calls) == 1


def test_urls_and_cache_dir_match_jax(tmp_path, monkeypatch):
    assert pretrained.PRETRAINED_URLS == jpretrained.PRETRAINED_URLS
    assert len(pretrained.PRETRAINED_URLS) == 17
    monkeypatch.setenv("OOD_TPU_CHECKPOINT_CACHE", str(tmp_path))
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir()
    assert pretrained.default_cache_dir() == str(tmp_path)
    monkeypatch.delenv("OOD_TPU_CHECKPOINT_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert pretrained.default_cache_dir() == jpretrained.default_cache_dir()
    assert pretrained.default_cache_dir() == str(
        tmp_path / "home" / ".cache" / "ood_object_detection_tpu"
        / "checkpoints")


def test_create_model_pretrained_loads_the_cached_file(filled_cache,
                                                       no_fetch):
    """``pretrained=True`` over a filled cache: the tensors of
    ``checkpoint_path=`` on that file, and of the JAX package's
    ``create_model(pretrained=True)`` on the same cache carried over by
    ``load_jax_variables``; nothing fetched."""
    ours = _d0(pretrained=True).state_dict()
    from_file = _d0(checkpoint_path=str(filled_cache / D0_FILE)).state_dict()
    _, variables = jfactory.create_model(
        "efficientdet_d0", num_classes=90, pretrained=True,
        image_size=(IMG, IMG))
    via_jax = _d0()
    load_jax_variables(via_jax, {k: variables[k] for k in ("params",
                                                          "batch_stats")},
                       strict=True)
    want = via_jax.state_dict()
    seeded = _d0().state_dict()
    assert set(ours) == set(from_file) == set(want)
    for k in want:
        assert torch.equal(ours[k], from_file[k]), k
        assert torch.equal(ours[k], want[k]), k
    assert not torch.equal(ours["class_net.predict.conv_pw.bias"],
                           seeded["class_net.predict.conv_pw.bias"])
    assert no_fetch == []


def test_load_pretrained_reports_nothing_missing(filled_cache, no_fetch):
    model = _d0()
    report = pretrained.load_pretrained("efficientdet_d0", model)
    assert not report["missing"] and not report["unexpected"]
    assert len(report["loaded"]) > 300
    other = filled_cache.parent / "other"
    other.mkdir()
    os.replace(filled_cache / D0_FILE, other / D0_FILE)
    report = pretrained.load_pretrained("efficientdet_d0", _d0(),
                                        cache_dir=str(other))
    assert not report["missing"]
    assert no_fetch == []


def _small_tree(rng):
    return {
        "params": {"backbone": {"conv_stem": {
            "kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)}},
            "class_net": {"predict": {
                "bias": rng.normal(size=(6,)).astype(np.float32)}}},
        "batch_stats": {"backbone": {"bn_stem": {
            "mean": np.zeros(8, np.float32), "var": np.ones(8, np.float32)}}},
    }


def test_merge_into_variables_matches_jax(rng):
    variables = _small_tree(rng)
    converted = {
        "params": {"backbone": {"conv_stem": {
            "kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float64)}},
            "class_net": {"predict": {"bias": np.ones(5, np.float32)}},
            "extra": {"kernel": np.ones(2, np.float32)}},
        "batch_stats": {"backbone": {"bn_stem": {
            "mean": np.full(8, 0.25, np.float32)}}},
        "_unmatched": {},
    }
    got, report = convert.merge_into_variables(variables, converted)
    want, jreport = jconvert.merge_into_variables(variables, converted)
    assert report == jreport
    assert report["loaded"] == ["backbone/conv_stem/kernel",
                                "backbone/bn_stem/mean"]
    assert report["missing"] == ["backbone/bn_stem/var"]
    assert report["unexpected"] == ["class_net/predict/bias shape (5,) vs "
                                    "(6,)", "extra/kernel"]
    flat, jflat = convert._flatten(got), jconvert._flatten(want)
    assert flat.keys() == jflat.keys()
    for k in jflat:
        assert flat[k].dtype == jflat[k].dtype
        np.testing.assert_array_equal(flat[k], jflat[k])
    assert flat[("params", "backbone", "conv_stem", "kernel")].dtype == (
        np.float32)
    for module in (convert, jconvert):
        with pytest.raises(ValueError, match="checkpoint mismatch"):
            module.merge_into_variables(variables, converted, strict=True)
    _, clean = convert.merge_into_variables(variables, variables,
                                            strict=True)
    assert not clean["missing"] and not clean["unexpected"]
