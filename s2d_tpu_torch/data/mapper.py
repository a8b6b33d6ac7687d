"""The clip mappers: a YTVIS video record -> one sample.

`ClipMapper` is the port of `s2d_tpu/data/mapper.py:ClipMapper` in train
mode: `dense_frame_selection` (a random window of SAMPLING_FRAME_NUM
consecutive frames in which some instance is annotated throughout), else
`sparse_frame_selection` around a random reference frame; the clip
augmentation of `augment.py`; per-frame instance masks with stable
instance slots (a frame without a mask gives an empty one), padded to
`max_instances` with a validity mask; the frames as float32. With
`disentangle` (INPUT.DISENTANGLE_DISTILLATION_LOADER) a second view of the
same raw frames is augmented on its own (the distillation view): the
sample also holds "distill_image" and "distill_affine", the per-frame map
of primary-view pixels to distill-view pixels (D P^-1), which the train
step replays on the teacher's targets. It draws from its `RandomState` in
the JAX mapper's order, so one seed gives the same clip on both. The
frames come from `read_frames(record, indices)`, by default the record's
image files through `load_image_robust`.

`EvalMapper` is the evaluator's mapper (`evaluation/evaluator.py`): every
frame of the video, read as RGB and resized (INTER_LINEAR, the port's
bit-exact `transforms.resize_linear`), as the JAX mapper does, to
(T, H, W, 3) uint8; it decodes no target masks (the evaluator scores
against the record's own RLEs).

JPEG and PNG files are read by the port's own codecs (`data/jpeg.py`,
`data/png.py`), each equal to cv2's `imread` in RGB, whether or not cv2 or
PIL is installed (the card's machine has neither); cv2 or PIL is imported
only for a file of another format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from . import rle as rle_codec
from .augment import ClipAugConfig, augment_clip, resize_shortest_edge
from .jpeg import SOI as JPEG_SOI, read_jpeg
from .png import SIGNATURE as PNG_SIGNATURE, read_png
from .transforms import resize_linear


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _read_other(path: str) -> np.ndarray:
    """A file that is neither JPEG nor PNG, by cv2 and else by PIL, as the
    JAX mapper reads every file; OSError where neither reads it."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        if cv2 is None:
            raise ImportError(
                f"{path!r} is neither JPEG nor PNG, and reading other formats needs cv2 "
                "(opencv-python) or PIL (pillow); neither is installed") from None
        raise OSError(f"cv2 could not read {path!r}") from None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the image file at `path`. JPEG and PNG, told
    apart by their first bytes, go through the port's own codecs
    (`data/jpeg.py`, `data/png.py`) whether or not cv2 or PIL is installed,
    each equal to cv2's `imread(path, IMREAD_COLOR)` in RGB; other formats
    through cv2 or PIL where installed."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head.startswith(JPEG_SOI):
        return read_jpeg(path)
    if head.startswith(PNG_SIGNATURE):
        return read_png(path)
    return _read_other(path)


def load_image_robust(path: str, retries: int = 3, backoff: float = 0.5) -> np.ndarray:
    """`read_image` with retry and exponential backoff (network filesystems
    flake), as the JAX mapper; a file that no reader can read raises
    FileNotFoundError after the last try. A format the port's codecs refuse
    (an arithmetic-coded or CMYK JPEG, a 16-bit PNG) raises ValueError at
    once."""
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            return read_image(path)
        except ValueError:
            raise
        except OSError as err:
            last_err = err
        time.sleep(backoff * (2 ** attempt))
    raise FileNotFoundError(f"could not read {path!r}: {last_err}")


def resize_frames(frames: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (T, *size_hw, 3) uint8, bilinear: the port's
    `transforms.resize_linear`, equal to the JAX mapper's cv2.resize
    (INTER_LINEAR) on uint8, without cv2."""
    if tuple(frames.shape[1:3]) == tuple(size_hw):
        return frames
    return np.stack([resize_linear(f, size_hw) for f in frames])


class EvalMapper:
    """record -> {"video_id", "image": (T, H, W, 3) uint8, "height", "width",
    "selected_idx"}: all frames, resized to the test size."""

    def __init__(self, min_size_test: int = 360, max_size_test: int = 1333):
        self.min_size_test = min_size_test
        self.max_size_test = max_size_test

    def __call__(self, record: dict) -> dict:
        frames: List[np.ndarray] = [load_image_robust(f) for f in record["file_names"]]
        h, w = frames[0].shape[:2]
        size = resize_shortest_edge(h, w, self.min_size_test, self.max_size_test)
        return {
            "video_id": record["video_id"],
            "image": resize_frames(np.stack(frames), size),
            "height": record["height"],
            "width": record["width"],
            "selected_idx": list(range(record["length"])),
        }


@dataclasses.dataclass
class MapperConfig:
    sampling_frame_num: int = 3
    sampling_frame_range: int = 20
    sampling_frame_shuffle: bool = False
    dense_selection: bool = True
    max_instances: int = 40
    disentangle: bool = False  # a second, independently augmented view
    aug: ClipAugConfig = dataclasses.field(default_factory=ClipAugConfig)

    @classmethod
    def from_config(cls, cfg: Config) -> "MapperConfig":
        """The train mapper's configuration."""
        inp = cfg.input
        aug = ClipAugConfig(
            min_sizes=inp.min_size_train, max_size=inp.max_size_train,
            crop_enabled=inp.crop.enabled, crop_range=tuple(inp.crop.size),
            brightness="brightness" in inp.augmentations,
            contrast="contrast" in inp.augmentations,
            saturation="saturation" in inp.augmentations,
            rotation="rotation" in inp.augmentations,
        )
        return cls(
            sampling_frame_num=inp.sampling_frame_num,
            sampling_frame_range=inp.sampling_frame_range,
            sampling_frame_shuffle=inp.sampling_frame_shuffle,
            dense_selection=inp.dense_annotation_selection,
            disentangle=inp.disentangle_distillation_loader,
            # targets must fit in the query set (the matcher needs N <= Q)
            max_instances=min(40, cfg.model.mask_former.num_object_queries),
            aug=aug,
        )


def dense_frame_selection(
    rng: np.random.RandomState,
    anno_frames: Dict[int, List[int]],  # instance id -> frames with a mask
    video_length: int,
    num_frames: int,
    frame_range: int,
) -> List[int]:
    windows = []
    for frames in anno_frames.values():
        frames = sorted(frames)
        for i in range(len(frames) - num_frames + 1):
            if frames[i + num_frames - 1] - frames[i] == num_frames - 1:
                windows.append(list(range(frames[i], frames[i] + num_frames)))
    if windows:
        return windows[rng.randint(len(windows))]
    return sparse_frame_selection(rng, video_length, num_frames, frame_range)


def sparse_frame_selection(
    rng: np.random.RandomState, video_length: int, num_frames: int, frame_range: int
) -> List[int]:
    ref = rng.randint(video_length)
    lo = max(0, ref - frame_range)
    hi = min(video_length, ref + frame_range + 1)
    candidates = [i for i in range(lo, hi) if i != ref]
    k = min(num_frames - 1, len(candidates))
    picked = list(rng.choice(np.asarray(candidates), k, replace=False)) if k else []
    selected = sorted(picked + [ref])
    while len(selected) < num_frames:  # degenerate short videos: repeat ref
        selected.append(ref)
    return sorted(selected)


def _decode_segmentation(seg, h: int, w: int) -> np.ndarray:
    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, dict):
        return rle_codec.decode(seg)
    return rle_codec.polygons_to_mask(seg, h, w)


def read_record_frames(record: dict, indices: Sequence[int]) -> List[np.ndarray]:
    """The record's frames at `indices`, read from its image files."""
    return [load_image_robust(record["file_names"][i]) for i in indices]


class ClipMapper:
    """Maps a YTVIS record to one fixed-shape train sample: {"video_id",
    "image" (T, H, W, 3) float32, "masks" (max_instances, T, H, W) bool,
    "valid", "labels", "height", "width", "selected_idx"} and, with
    `cfg.disentangle`, "distill_image" (T, H', W', 3) float32 and
    "distill_affine" (T, 3, 3) float32."""

    def __init__(self, cfg: MapperConfig, seed: int = 0,
                 read_frames: Optional[Callable[[dict, Sequence[int]], List[np.ndarray]]] = None):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.read_frames = read_frames or read_record_frames

    def __call__(self, record: dict) -> dict:
        cfg = self.cfg
        length = record["length"]
        h, w = record["height"], record["width"]
        annos = record.get("annotations", [])

        anno_frames = {
            o["id"]: [i for i, s in enumerate(o["segmentations"]) if s is not None]
            for o in annos
        }
        anno_frames = {k: v for k, v in anno_frames.items() if v}
        if cfg.dense_selection and anno_frames:
            selected = dense_frame_selection(
                self.rng, anno_frames, length, cfg.sampling_frame_num, cfg.sampling_frame_range)
        else:
            selected = sparse_frame_selection(
                self.rng, length, cfg.sampling_frame_num, cfg.sampling_frame_range)

        frames = [np.asarray(f) for f in self.read_frames(record, selected)]

        # instances with any annotation in the selected frames keep a slot
        kept = [o for o in annos if any(o["segmentations"][i] is not None for i in selected)]
        kept = kept[: cfg.max_instances]
        masks = np.zeros((len(kept), len(selected), h, w), bool)
        labels = np.zeros((len(kept),), np.int64)
        for n, o in enumerate(kept):
            labels[n] = o["category_id"]
            for ti, fi in enumerate(selected):
                seg = o["segmentations"][fi]
                if seg is not None:
                    masks[n, ti] = _decode_segmentation(seg, h, w)

        if cfg.disentangle:
            raw = frames
            frames, masks, affines = augment_clip(self.rng, raw, masks, cfg.aug,
                                                  return_affines=True)
            distill, _, distill_affines = augment_clip(self.rng, raw, None, cfg.aug,
                                                       return_affines=True)
            rel = np.stack([d @ np.linalg.inv(a) for d, a in zip(distill_affines, affines)])
        else:
            frames, masks = augment_clip(self.rng, frames, masks, cfg.aug)
        t = len(frames)
        nh, nw = frames[0].shape[:2]
        masks_padded = np.zeros((cfg.max_instances, t, nh, nw), bool)
        valid = np.zeros((cfg.max_instances,), bool)
        labels_padded = np.zeros((cfg.max_instances,), np.int64)
        if masks.shape[0]:
            k = masks.shape[0]
            masks_padded[:k] = masks
            valid[:k] = True
            labels_padded[:k] = labels[:k]
        sample = {
            "video_id": record["video_id"],
            "image": np.stack(frames).astype(np.float32),
            "masks": masks_padded,
            "valid": valid,
            "labels": labels_padded,
            "height": record["height"],
            "width": record["width"],
            "selected_idx": selected,
        }
        if cfg.disentangle:
            sample["distill_image"] = np.stack(distill).astype(np.float32)
            sample["distill_affine"] = rel.astype(np.float32)  # primary px -> distill px
        return sample
