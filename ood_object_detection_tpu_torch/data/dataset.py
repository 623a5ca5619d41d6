"""Fixed-size ground-truth padding (the part of
``ood_object_detection_tpu.data.dataset`` the episode builder needs; the
rest of the host data pipeline waits for a later slice)."""
from __future__ import annotations

from typing import Dict

import numpy as np

MAX_INSTANCES = 100


def pad_annotations(anno: Dict, max_instances: int = MAX_INSTANCES) -> Dict:
    """Pad bbox/cls to fixed size with -1 fill (loader.py:31-33 semantics)."""
    n = min(len(anno["cls"]), max_instances)
    bbox = np.full((max_instances, 4), -1.0, np.float32)
    cls = np.full((max_instances,), -1, np.int32)
    bbox[:n] = anno["bbox"][:n]
    cls[:n] = anno["cls"][:n]
    out = dict(anno)
    out["bbox"] = bbox
    out["cls"] = cls
    for k in ("difficult", "group_of"):
        if k in anno:
            flags = np.zeros((max_instances,), np.int32)
            flags[:n] = anno[k][:n]
            out[k] = flags
    return out
