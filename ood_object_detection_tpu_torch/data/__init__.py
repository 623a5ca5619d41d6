"""Host data pipeline, on-device input preprocessing and episode assembly
(port of ``ood_object_detection_tpu.data``)."""
from .dataset import (
    DetectionDataset,
    PrefetchLoader,
    SkipSubset,
    SyntheticDetectionDataset,
    collate_batch,
    create_loader,
    pad_annotations,
)
from .dataset_factory import create_dataset
from .device_preproc import batched_letterbox_normalize, normalize_uint8
from .episodic import (
    EpisodeBuilder,
    EpisodePrefetcher,
    EpisodicDataset,
    QuerySupportFallback,
    SyntheticEpisodeSource,
)
from .input_config import resolve_input_config
from .native_decode import (
    NativeEvalLoader,
    PilEvalLoader,
    available as native_decode_available,
    decode_jpeg,
    load_letterbox_batch,
)
from .metadata import (
    build_category_pools,
    directory_support_source,
    load_annotation_index,
    load_category_counts,
    load_metadata_dicts,
    split_train_val_cats,
)
from .parsers import (
    CocoParser,
    OpenImagesParser,
    Parser,
    ParserConfig,
    VocParser,
    create_parser,
)
from .pretrain_stream import (
    ParserQuerySource,
    PretrainEpisodeStream,
    split_categories_by_count,
)
from .random_erasing import random_erasing
from .transforms import (
    Compose,
    ImageToNumpy,
    ProjResizePad,
    RandomFlip,
    RandomResizePad,
    ResizePad,
    clip_boxes_,
    transforms_coco_eval,
    transforms_coco_train,
    transforms_projection,
)
