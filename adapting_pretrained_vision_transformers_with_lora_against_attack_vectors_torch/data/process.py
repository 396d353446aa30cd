"""Dataset unification ETL: five raw traffic-sign corpora into one 21+-class
224x224 crop corpus.

Counterpart of the JAX package's ``data/process.py``, with the same records,
the same PNG pixels and the same ``metadata.csv`` bytes for the same raw
layout. Each parser consumes its corpus' raw layout, applies its
class-remapping table (the tables below are this package's own copy), crops
the sign boxes, resizes them (aspect-preserving pad for GTSRB, CURE-TSD and
Roboflow; plain resize for LISA and Mapillary) and writes
``{out}/{split}/images/*.png`` + ``metadata.csv`` (columns ``image_path,
source, original_class, unified_class``; ``image_path`` as the output
directory was given, so a relative ``output_dir`` gives relative paths).

Host code only: numpy and the standard library. Images are read, resized and
written by OpenCV when ``cv2`` imports, otherwise by PIL, in the JAX module's
order of choice; a PNG written without OpenCV goes through the port's native
encoder (``utils/native.py``). Both libraries are imported at first use, so
importing this module imports neither. With neither installed, reading an
image raises and names both. CURE-TSD decodes video and needs OpenCV.

Crops are processed by a pool of 8 threads whose results keep input order.
"""

from __future__ import annotations

import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np

IMAGE_SIZE = (224, 224)
MIN_SIGN_SIZE = 24

# --- unified-class remapping tables ------------------------------------------

GTSRB_CLASSES = {
    **{str(i): "speed_limit" for i in (0, 1, 2, 3, 4, 5, 7, 8)},
    "6": "other", "9": "no_overtaking", "10": "no_overtaking",
    "11": "priority_road", "12": "priority_road", "13": "yield", "14": "stop",
    "15": "no_vehicles", "16": "goods_vehicles", "17": "no_entry",
    "18": "other", "19": "curve", "20": "curve", "21": "curve", "22": "bump",
    "23": "slippery_road", "24": "warning", "25": "road_work", "26": "warning",
    "27": "pedestrian_crossing", "28": "school_zone", "29": "bicycle_crossing",
    "30": "slippery_road", "31": "wild_animals", "32": "other",
    "33": "turn_right", "34": "turn_left", "35": "ahead_only",
    "36": "directional", "37": "directional", "38": "keep_right",
    "39": "keep_left", "40": "roundabout", "41": "no_overtaking",
    "42": "no_overtaking", "__default__": "other",
}

LISA_CLASSES = {
    0: "directional", 1: "curve", 2: "curve", 3: "bump", 4: "no_entry",
    5: "no_overtaking", 6: "warning", 7: "keep_right", 8: "warning",
    9: "warning", 10: "no_left_turn", 11: "no_right_turn",
    12: "pedestrian_crossing", **{i: "speed_limit" for i in range(13, 19)},
    19: "directional", 20: "roundabout", 21: "school_zone", 22: "speed_limit",
    23: "warning", 24: "warning", **{i: "speed_limit" for i in range(25, 35)},
    35: "stop", 36: "warning", 37: "directional", 38: "directional",
    39: "directional", 40: "speed_limit", 41: "turn_left", 42: "turn_right",
    43: "yield", 44: "warning", 45: "warning", 46: "warning",
}

MAPILLARY_CLASSES = {
    "speed-limit": "speed_limit", "speed-limit-zone": "speed_limit",
    "minimum-speed-limit": "speed_limit", "stop": "stop", "yield": "yield",
    "give-way": "yield", "no-entry": "no_entry", "no-parking": "no_parking",
    "no-stopping": "no_stopping", "no-overtaking": "no_overtaking",
    "no-left-turn": "no_left_turn", "no-right-turn": "no_right_turn",
    "no-u-turn": "no_u_turn", "priority-road": "priority_road",
    "one-way": "one_way", "weight-limit": "goods_vehicles",
    "pedestrian-crossing": "pedestrian_crossing",
    "children-crossing": "school_zone", "bicycle-crossing": "bicycle_crossing",
    "animal-crossing": "wild_animals", "slippery-road": "slippery_road",
    "curve-left": "curve", "curve-right": "curve", "double-curve": "curve",
    "bump": "bump", "dip": "bump", "hump": "bump", "road-narrows": "warning",
    "road-work": "road_work", "traffic-signals": "warning",
    "railway-crossing": "railway_crossing", "roundabout": "roundabout",
    "keep-right": "keep_right", "keep-left": "keep_left",
    "turn-left": "turn_left", "turn-right": "turn_right",
    "ahead-only": "ahead_only", "go-straight": "ahead_only",
    "go-straight-or-right": "directional", "go-straight-or-left": "directional",
    "parking": "parking", "bus-stop": "bus_stop", "tram-stop": "bus_stop",
    "rest-area": "rest_area", "__default__": "other",
}

CURE_TSD_CLASSES = {
    "01": "speed_limit", "02": "goods_vehicles", "03": "no_overtaking",
    "04": "no_stopping", "05": "no_parking", "06": "stop",
    "07": "bicycle_crossing", "08": "bump", "09": "no_left_turn",
    "10": "no_right_turn", "11": "priority_road", "12": "no_entry",
    "13": "yield", "14": "parking", "__default__": "other",
}

CURE_TSD_TEST_SEQUENCES = frozenset({
    "01_04", "01_05", "01_06", "01_07", "01_08", "01_18", "01_19", "01_21",
    "01_24", "01_26", "01_31", "01_38", "01_39", "01_41", "01_47", "02_02",
    "02_04", "02_06", "02_09", "02_12", "02_13", "02_16", "02_17", "02_18",
    "02_20", "02_22", "02_28", "02_31", "02_32", "02_36",
})

ROBOFLOW_CLASSES = {
    0: "warning", 1: "speed_limit", 2: "warning", 3: "school_zone",
    4: "bicycle_crossing", 5: "curve", 6: "curve", 7: "warning", 8: "yield",
    9: "directional", 10: "directional", 11: "keep_left", 12: "keep_right",
    13: "warning", 14: "no_entry", 15: "no_overtaking", 16: "no_overtaking",
    17: "pedestrian_crossing", 18: "roundabout", 19: "slippery_road",
    20: "speed_limit", 21: "speed_limit", 22: "stop", 23: "ahead_only",
    24: "warning", 25: "goods_vehicles", 26: "turn_left", 27: "turn_right",
    28: "bump",
}


# --- image helpers (OpenCV when it imports, else PIL) ------------------------

def _cv2():
    try:
        import cv2

        return cv2
    except ImportError:
        return None


def imread(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 BGR, or None for a file the decoder cannot read."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(str(path))
        return img if img is not None else None
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(f"{path}: no image decoder: neither OpenCV (cv2) nor PIL is "
                           "installed") from None
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))[..., ::-1].copy()  # to BGR
    except OSError:
        return None


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a BGR image; without OpenCV a PNG goes through the native encoder."""
    cv2 = _cv2()
    if cv2 is not None:
        cv2.imwrite(str(path), img)
        return
    if str(path).endswith(".png"):
        from ..utils import native

        data = native.encode_png_rgb(np.ascontiguousarray(img[..., ::-1]))
        with open(path, "wb") as f:
            f.write(data)
        return
    from PIL import Image

    Image.fromarray(img[..., ::-1]).save(path)  # BGR -> RGB


def resize_area(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size, Image.BOX))


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """cv2.resize's default interpolation (INTER_LINEAR), or PIL's BILINEAR:
    the plain-resize path of LISA and Mapillary crops, which are usually
    upscales where INTER_AREA would go blocky."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, size)  # default INTER_LINEAR
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(size, Image.BILINEAR))


def resize_with_padding(img: np.ndarray,
                        size: tuple[int, int] = IMAGE_SIZE) -> np.ndarray:
    """Aspect-preserving resize (``resize_area``) + centered black padding."""
    h, w = img.shape[:2]
    scale = min(size[0] / w, size[1] / h)
    new_w, new_h = int(w * scale), int(h * scale)
    resized = resize_area(img, (max(new_w, 1), max(new_h, 1)))
    out = np.zeros((size[1], size[0], 3), img.dtype)
    top = (size[1] - resized.shape[0]) // 2
    left = (size[0] - resized.shape[1]) // 2
    out[top:top + resized.shape[0], left:left + resized.shape[1]] = resized
    return out


# --- parsers -----------------------------------------------------------------

def _yolo_box_to_xyxy(parts, img_w, img_h):
    xc, yc = float(parts[1]) * img_w, float(parts[2]) * img_h
    bw, bh = float(parts[3]) * img_w, float(parts[4]) * img_h
    x1 = max(0, int(xc - bw / 2))
    y1 = max(0, int(yc - bh / 2))
    x2 = min(img_w, int(xc + bw / 2))
    y2 = min(img_h, int(yc + bh / 2))
    return x1, y1, x2, y2


def _valid_box(x1, y1, x2, y2):
    return x2 > x1 and y2 > y1 and (x2 - x1) >= MIN_SIGN_SIZE \
        and (y2 - y1) >= MIN_SIGN_SIZE


def process_gtsrb(base_dir, output_dir, split="train", *, log=print):
    """Kaggle GTSRB layout: versions/1/{Train,Test}.csv with Roi boxes.
    Pad-resize crops; classes Class_{id}. Every split but ``train`` reads
    ``Test.csv``."""
    base = Path(base_dir) / "versions" / "1"
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    csv_name = "Train.csv" if split == "train" else "Test.csv"
    csv_path = base / csv_name
    if not csv_path.exists():
        csv_path = base / csv_name.lower()
        if not csv_path.exists():
            return []

    with open(csv_path) as f:
        rows = list(csv.DictReader(f))

    def work(row):
        rel = row.get("Path", "")
        parts = rel.split("/")
        if split == "train":
            if len(parts) < 3:
                return None
            img_path = base / "Train" / parts[1] / parts[2]
        else:
            if len(parts) < 2:
                return None
            img_path = base / "Test" / parts[1]
        img = imread(img_path) if img_path.exists() else None
        if img is None:
            return None
        try:
            x1 = int(row.get("Roi.X1", row.get("roi.x1", 0)))
            y1 = int(row.get("Roi.Y1", row.get("roi.y1", 0)))
            x2 = int(row.get("Roi.X2", row.get("roi.x2", 0)))
            y2 = int(row.get("Roi.Y2", row.get("roi.y2", 0)))
        except (TypeError, ValueError):
            return None
        if x2 <= x1 or y2 <= y1:
            return None
        padded = resize_with_padding(img[y1:y2, x1:x2])
        class_id = row["ClassId"]
        save_path = out / f"{img_path.stem}.png"
        imwrite(str(save_path), padded)
        return {"source": "gtsrb", "image_path": str(save_path),
                "original_class": f"Class_{class_id}",
                "unified_class": GTSRB_CLASSES.get(class_id,
                                                   GTSRB_CLASSES["__default__"])}

    return _pooled(work, rows, f"GTSRB {split}", log)


def _process_yolo_layout(base_dir, output_dir, split, *, source, classes,
                         pad: bool, log=print):
    """The LISA and Roboflow parser: {split}/images + {split}/labels with
    YOLO-format txt boxes."""
    base = Path(base_dir)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    images_dir = base / split / "images"
    labels_dir = base / split / "labels"
    if not images_dir.exists() or not labels_dir.exists():
        return []

    def work(img_path):
        img = imread(img_path)
        if img is None:
            return None
        label_path = labels_dir / f"{img_path.stem}.txt"
        if not label_path.exists():
            return None
        h, w = img.shape[:2]
        recs = []
        with open(label_path) as f:
            lines = f.readlines()
        for idx, line in enumerate(lines):
            parts = line.strip().split()
            if len(parts) < 5:
                continue
            try:
                class_id = int(parts[0])
            except ValueError:
                continue
            if class_id not in classes:
                continue
            x1, y1, x2, y2 = _yolo_box_to_xyxy(parts, w, h)
            if not _valid_box(x1, y1, x2, y2):
                continue
            sign = img[y1:y2, x1:x2]
            crop = resize_with_padding(sign) if pad else resize_linear(sign, IMAGE_SIZE)
            save_path = out / f"{img_path.stem}_{idx}.png"
            imwrite(str(save_path), crop)
            recs.append({"source": source, "image_path": str(save_path),
                         "original_class": f"Class_{class_id}",
                         "unified_class": classes[class_id]})
        return recs

    return _pooled(work, sorted(images_dir.glob("*")), f"{source} {split}", log, flatten=True)


def process_lisa(base_dir, output_dir, split="train", *, log=print):
    return _process_yolo_layout(base_dir, output_dir, split, source="lisa",
                                classes=LISA_CLASSES, pad=False, log=log)


def process_roboflow(base_dir, output_dir, split="train", *, log=print):
    return _process_yolo_layout(base_dir, output_dir, split, source="roboflow",
                                classes=ROBOFLOW_CLASSES, pad=True, log=log)


def process_mapillary(base_dir, output_dir, split="train", *, log=print):
    """MTSD layout: fully and partially annotated image sets + per-image JSON
    annotations. A sign type holding a digit and "speed" is a speed limit."""
    base = Path(base_dir)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = []

    fully_ann = base / "mtsd_fully_annotated_annotation" / "mtsd_v2_fully_annotated"
    partial_ann = base / "mtsd_partially_annotated_annotation" / "mtsd_v2_partially_annotated"
    if split == "train":
        fully_imgs = [base / f"mtsd_fully_annotated_images.train.{i}" / "images"
                      for i in range(3)]
        partial_imgs = [base / f"mtsd_partially_annotated_images.train.{i}" / "images"
                        for i in range(4)]
    elif split in ("val", "test"):
        fully_imgs = [base / f"mtsd_fully_annotated_images.{split}" / "images"]
        partial_imgs = [base / f"mtsd_partially_annotated_images.{split}" / "images"]
    else:
        return records

    for dataset_type, ann_dir, img_dirs in (("fully", fully_ann, fully_imgs),
                                            ("partial", partial_ann, partial_imgs)):
        split_file = ann_dir / "splits" / f"{split}.txt"
        annotations_dir = ann_dir / "annotations"
        if not split_file.exists() or not annotations_dir.exists():
            continue
        valid_dirs = [d for d in img_dirs if d.exists()]
        if not valid_dirs:
            continue

        with open(split_file) as f:
            keys = [line.strip() for line in f if line.strip()]
        key_to_path = {}
        for d in valid_dirs:
            for p in d.glob("*.jpg"):
                key_to_path[p.stem] = p

        def work(key, _dt=dataset_type, _ann=annotations_dir, _k2p=key_to_path):
            img_path = _k2p.get(key)
            ann_path = _ann / f"{key}.json"
            if img_path is None or not ann_path.exists():
                return None
            img = imread(img_path)
            if img is None:
                return None
            with open(ann_path) as f:
                data = json.load(f)
            recs = []
            for obj in data.get("objects", []):
                bbox = obj.get("bbox", {})
                if not bbox or "cross_boundary" in bbox:
                    continue
                x1 = max(0, int(bbox.get("xmin", 0)))
                y1 = max(0, int(bbox.get("ymin", 0)))
                x2 = min(img.shape[1], int(bbox.get("xmax", 0)))
                y2 = min(img.shape[0], int(bbox.get("ymax", 0)))
                if not _valid_box(x1, y1, x2, y2):
                    continue
                crop = resize_linear(img[y1:y2, x1:x2], IMAGE_SIZE)
                save_path = out / f"{_dt}_{key}_{x1}_{y1}.png"
                imwrite(str(save_path), crop)
                label = obj.get("label", "unknown")
                sign_type = label.split("--")[1] if "--" in label else label
                if any(ch.isdigit() for ch in sign_type) and "speed" in sign_type:
                    sign_type = "speed-limit"
                recs.append({
                    "source": f"mapillary_{_dt}",
                    "image_path": str(save_path),
                    "original_class": label,
                    "unified_class": MAPILLARY_CLASSES.get(
                        sign_type, MAPILLARY_CLASSES["__default__"])})
            return recs

        records.extend(_pooled(work, keys, f"Mapillary {dataset_type} {split}",
                               log, flatten=True))
    return records


def process_cure_tsd(base_dir, output_dir, split="train", *, log=print):
    """CURE-TSD: mp4 sequences + underscore-delimited annotation txt files.
    Sequence-level train/test split by the fixed hold-out set; each annotated
    frame is decoded once (one seek) and every crop from it is written.
    Needs OpenCV, even when the corpus is absent."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("CURE-TSD processing requires OpenCV (video decode)")
    base = Path(base_dir)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    records = []

    data_dir = base / "data"
    labels_dir = base / "labels"
    if not data_dir.exists() or not labels_dir.exists():
        return records

    ann_files = {}
    for f in labels_dir.glob("*.txt"):
        ann_files["_".join(f.stem.split("_")[:2])] = f

    for video_path in sorted(data_dir.glob("*.mp4")):
        parts = video_path.stem.split("_")
        if len(parts) < 2:
            continue
        seq = f"{parts[0]}_{parts[1]}"
        is_test = seq in CURE_TSD_TEST_SEQUENCES
        if (split == "test" and not is_test) or (split == "train" and is_test):
            continue
        ann_file = ann_files.get(seq)
        if ann_file is None:
            continue

        frame_to_annots: dict[int, list[str]] = {}
        with open(ann_file) as f:
            next(f, None)  # header
            for line in f:
                line = line.strip()
                p = line.split("_")
                if len(p) < 10:
                    continue
                try:
                    frame_to_annots.setdefault(int(p[0]) - 1, []).append(line)
                except ValueError:
                    continue
        if not frame_to_annots:
            continue

        cap = cv2.VideoCapture(str(video_path))
        if not cap.isOpened():
            log(f"cannot open {video_path}")
            continue
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        # one seek per annotated frame, in frame order: CURE-TSD annotates a
        # sparse subset of each sequence, so decode-and-skip would read far
        # more frames
        for frame_idx in sorted(frame_to_annots):
            if frame_idx < 0 or frame_idx >= total:
                continue
            cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)
            ret, frame = cap.read()
            if not ret:
                continue
            for ann in frame_to_annots[frame_idx]:
                p = ann.split("_")
                sign_type = p[1]
                unified = CURE_TSD_CLASSES.get(sign_type,
                                               CURE_TSD_CLASSES["__default__"])
                if unified == "other":
                    continue
                try:
                    coords = list(map(int, p[2:10]))
                except ValueError:
                    continue
                xs, ys = coords[0::2], coords[1::2]
                x1, y1 = max(0, min(xs)), max(0, min(ys))
                x2 = min(frame.shape[1], max(xs))
                y2 = min(frame.shape[0], max(ys))
                if not _valid_box(x1, y1, x2, y2):
                    continue
                crop = resize_with_padding(frame[y1:y2, x1:x2])
                save_path = out / (f"{video_path.stem}_f{frame_idx + 1}"
                                   f"_{x1}_{y1}.png")
                imwrite(str(save_path), crop)
                records.append({"source": "cure_tsd",
                                "image_path": str(save_path),
                                "original_class": sign_type,
                                "unified_class": unified})
        cap.release()
    return records


# --- the whole ETL ------------------------------------------------------------

PROCESSORS: dict[str, Callable] = {
    "gtsrb-german-traffic-sign": process_gtsrb,
    "lisa-road-sign": process_lisa,
    "Mapillary": process_mapillary,
    "CURE-TSD": process_cure_tsd,
    "roboflow-traffic-signs-dataset": process_roboflow,
}


def _pooled(work, items, desc, log, *, flatten=False, max_workers=8):
    results = []
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for r in pool.map(work, items):
            if r is None:
                continue
            if flatten:
                results.extend(r)
            else:
                results.append(r)
    log(f"{desc}: {len(results)} records")
    return results


def save_metadata_records(records: Iterable[dict], output_path) -> None:
    """Always writes the file: an empty split gets a header-only CSV, so later
    stages see an empty dataset instead of a missing file."""
    records = list(records)
    os.makedirs(os.path.dirname(os.path.abspath(output_path)), exist_ok=True)
    with open(output_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image_path", "source",
                                          "original_class", "unified_class"])
        w.writeheader()
        w.writerows(records)


def process_all(base_dir, output_dir, *, datasets=tuple(PROCESSORS),
                splits=("train", "val", "test"), log=print) -> int:
    """The whole ETL: every dataset of ``datasets`` (``base_dir/<name>``) for
    every split into ``output_dir/<split>``; returns the number of records."""
    total = 0
    for split in splits:
        records = []
        out_images = Path(output_dir) / split / "images"
        out_images.mkdir(parents=True, exist_ok=True)
        for ds in datasets:
            if ds not in PROCESSORS:
                raise ValueError(f"unknown dataset {ds!r}")
            recs = PROCESSORS[ds](Path(base_dir) / ds, out_images, split, log=log)
            records.extend(recs)
            log(f"{ds} {split}: {len(recs)} images")
        save_metadata_records(records, Path(output_dir) / split / "metadata.csv")
        total += len(records)
    log(f"total images processed: {total}")
    return total
