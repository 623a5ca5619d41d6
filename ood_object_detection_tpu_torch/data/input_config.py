"""Copy of ``ood_object_detection_tpu.data.input_config``.

Input-pipeline config resolution.

Equivalent of the reference resolve_input_config
(effdet/data/input_config.py:4-70): merge CLI args with the model config
to produce the loader's image size, interpolation, normalization mean/std
and letterbox fill color. Precedence: explicit args > model config >
ImageNet defaults.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .transforms import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD


def resolve_input_config(args: Optional[Dict] = None,
                         model_config=None) -> Dict:
    """args: a dict (or argparse.Namespace) that may define 'interpolation',
    'mean', 'std', 'fill_color', 'image_size'. model_config: ModelConfig
    (or any object with the same optional attributes)."""
    if args is None:
        args = {}
    if not isinstance(args, dict):
        args = vars(args)

    def from_model(name, default):
        v = getattr(model_config, name, None)
        return v if v is not None else default

    in_chans = 3
    cfg: Dict = {}

    size = args.get("image_size") or from_model("image_size", (512, 512))
    if isinstance(size, int):
        size = (size, size)
    cfg["input_size"] = (in_chans,) + tuple(size)
    cfg["image_size"] = tuple(size)

    cfg["interpolation"] = (args.get("interpolation")
                            or from_model("interpolation", "bicubic"))

    mean = args.get("mean")
    if mean is not None:
        mean = tuple(mean) * in_chans if len(tuple(mean)) == 1 else tuple(mean)
        assert len(mean) == in_chans
    else:
        mean = tuple(from_model("mean", IMAGENET_DEFAULT_MEAN))
    cfg["mean"] = mean

    std = args.get("std")
    if std is not None:
        std = tuple(std) * in_chans if len(tuple(std)) == 1 else tuple(std)
        assert len(std) == in_chans
    else:
        std = tuple(from_model("std", IMAGENET_DEFAULT_STD))
    cfg["std"] = std

    fill = args.get("fill_color")
    if fill is None:
        fill = from_model("fill_color", "mean")
    if fill == "mean":
        fill = tuple(round(255 * m) for m in cfg["mean"])
    elif isinstance(fill, str):
        # numeric CLI string, e.g. --fill-color 128 (a bare tuple() of it
        # would split into characters)
        fill = (int(fill),) * in_chans
    elif isinstance(fill, (int, float)):
        fill = (int(fill),) * in_chans
    cfg["fill_color"] = tuple(fill)

    return cfg
