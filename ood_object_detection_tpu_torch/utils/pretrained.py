"""Published pretrained weights: download into a local cache, then load.

Port of ``ood_object_detection_tpu.utils.pretrained``, the reference's
``load_pretrained`` (effdet/helpers.py:14-23, torch.hub's URL cache):
the published efficientdet-pytorch release weights (the zoo's ``url=``
fields, effdet/config/model_config.py) are fetched once into a cache
directory and read from there afterwards. The files are the same
reference ``.pth`` that the JAX package fetches, under the same cache
variable and default directory, so one download serves both packages.
Nothing is fetched unless a caller asks for published weights.
"""
from __future__ import annotations

import os
import urllib.request
from typing import Dict, Optional

from torch import nn

# published release weights (reference model_config.py url= fields)
PRETRAINED_URLS: Dict[str, str] = {
    "efficientdet_d0": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/efficientdet_d0-f3276ba8.pth",
    "efficientdet_d1": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/efficientdet_d1-bb7e98fe.pth",
    "resdet50": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/resdet50_416-08676892.pth",
    "cspresdext50pan": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/cspresdext50pan-92fdd094.pth",
    "efficientdet_q0": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/efficientdet_q0-bdf1bdb5.pth",
    "efficientdet_q1": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/efficientdet_q1-b238aba5.pth",
    "efficientdet_q2": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/efficientdet_q2-0f7564e5.pth",
    "tf_efficientdet_d0": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d0_34-f153e0cf.pth",
    "tf_efficientdet_d1": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d1_40-a30f94af.pth",
    "tf_efficientdet_d2": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d2_43-8107aa99.pth",
    "tf_efficientdet_d3": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d3_47-0b525f35.pth",
    "tf_efficientdet_d4": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d4_49-f56376d9.pth",
    "tf_efficientdet_d5": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d5_51-c79f9be6.pth",
    "tf_efficientdet_d6": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d6_52-4eda3773.pth",
    "tf_efficientdet_d7": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d7_53-6d1d7a95.pth",
    "tf_efficientdet_d7x": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_d7x-f390b87c.pth",
    "tf_efficientdet_lite0": "https://github.com/rwightman/efficientdet-pytorch/releases/download/v0.1/tf_efficientdet_lite0-f5f303a9.pth",
}


def default_cache_dir() -> str:
    """``$OOD_TPU_CHECKPOINT_CACHE``, else
    ``~/.cache/ood_object_detection_tpu/checkpoints``: the JAX package's
    cache, shared."""
    return os.environ.get(
        "OOD_TPU_CHECKPOINT_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "ood_object_detection_tpu", "checkpoints"))


def download_checkpoint(model_name: str,
                        cache_dir: Optional[str] = None,
                        url: Optional[str] = None) -> str:
    """Fetch the pretrained .pth for ``model_name`` into the cache and
    return its local path (already-cached files are not re-downloaded —
    the torch.hub behavior the reference relies on). A fetch writes
    ``<file>.part`` and renames it, so an interrupted one leaves no file
    that a later call would take as cached."""
    url = url or PRETRAINED_URLS.get(model_name)
    if not url:
        raise ValueError(
            f"no pretrained weights published for '{model_name}'")
    cache_dir = cache_dir or default_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    local = os.path.join(cache_dir, os.path.basename(url))
    if not os.path.exists(local):
        tmp = local + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, local)
    return local


def load_pretrained(model_name: str, model: nn.Module,
                    cache_dir: Optional[str] = None,
                    url: Optional[str] = None) -> Dict[str, list]:
    """Download (unless cached) and load the published weights into
    ``model`` in place (reference load_pretrained, helpers.py:14-23);
    returns ``load_pytorch_checkpoint``'s report ('loaded', 'missing',
    'unexpected'). The JAX function takes a variables tree and returns
    (new variables, report); the port loads into its module, as its
    ``load_pytorch_checkpoint`` does."""
    from .checkpoint_convert import load_pytorch_checkpoint
    path = download_checkpoint(model_name, cache_dir=cache_dir, url=url)
    return load_pytorch_checkpoint(path, model)
