"""The raw-corpus ETL (``<port>/data/process.py``) and the CLI stage
``process`` against the JAX package's.

Every case writes one raw fixture of a corpus' layout (as
``tests/test_process.py`` writes them, with noise pixels so that every
resize is seen) and runs it through the JAX function and the port's, each
from a working directory of its own with the same relative ``output_dir``,
so that the ``image_path`` strings agree. Equal, exactly (0 LSB): the record
lists, the files written, the decoded pixels of every crop, the PNG bytes
(in the PIL branch where the JAX package's native encoder is available; in
the OpenCV branch both write with ``cv2.imwrite``) and the ``metadata.csv``
bytes of every split.

Each case runs in the OpenCV branch and in the PIL branch (``_cv2`` patched
to return None in both modules, as ``test_imwrite_native_fallback`` does).
CURE-TSD decodes video and runs in the OpenCV branch; in the PIL branch both
packages raise.
"""

import csv
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import loader as tloader
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.data import process as tprocess
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils import native as tnative
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.utils.vocab import LabelVocabulary
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.data import process as jprocess
from adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.utils import native as jnative

cv2 = pytest.importorskip("cv2")
# the modules (each package's ``cli`` exports its function ``main`` under that name)
tcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch.cli.main")
jcli = importlib.import_module(
    "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu.cli.main")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_torch"
TABLES = ("GTSRB_CLASSES", "LISA_CLASSES", "MAPILLARY_CLASSES", "CURE_TSD_CLASSES",
          "CURE_TSD_TEST_SEQUENCES", "ROBOFLOW_CLASSES", "IMAGE_SIZE", "MIN_SIGN_SIZE")
HEADER = b"image_path,source,original_class,unified_class\r\n"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: under pytest-xdist the
    workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(params=["cv2", "pil"])
def branch(request, monkeypatch):
    """The decoder branch both packages take: OpenCV, or PIL with ``_cv2``
    returning None in both modules."""
    if request.param == "pil":
        monkeypatch.setattr(jprocess, "_cv2", lambda: None)
        monkeypatch.setattr(tprocess, "_cv2", lambda: None)
    return request.param


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _write(path, bgr):
    """A raw fixture image, written by OpenCV whatever the branch under test."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(str(path), bgr)


def _run_both(tmp_path, monkeypatch, name, *args, **kwargs):
    """``name`` of each package, from its own cwd with ``out`` as its output."""
    got = []
    for side, mod in (("jax", jprocess), ("port", tprocess)):
        cwd = tmp_path / side
        cwd.mkdir(exist_ok=True)
        monkeypatch.chdir(cwd)
        got.append(getattr(mod, name)(*args, **kwargs))
    monkeypatch.chdir(tmp_path)
    return got


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, files in os.walk(root) for f in files}


def _decode(path):
    with open(path, "rb") as f:
        return tnative.decode_png_rgb(f.read())


def _same_files(tmp_path, branch, n_png):
    """The same files under both sides' ``out`` (``n_png`` crops): every crop
    224 x 224 with equal pixels; equal bytes, PNGs too where both sides
    encode alike. Returns the port side's crops."""
    jfiles, tfiles = _files(tmp_path / "jax" / "out"), _files(tmp_path / "port" / "out")
    assert sorted(tfiles) == sorted(jfiles)
    crops = [p for p in tfiles if p.endswith(".png")]
    assert len(crops) == n_png
    for rel in tfiles:
        if rel in crops:
            got, want = _decode(tfiles[rel]), _decode(jfiles[rel])
            assert got.shape == (224, 224, 3) and np.array_equal(got, want), rel
        if branch == "cv2" or jnative.available() or rel not in crops:
            with open(tfiles[rel], "rb") as f, open(jfiles[rel], "rb") as g:
                assert f.read() == g.read(), rel
    return crops


def _same_outputs(tmp_path, branch, jrecs, trecs, n):
    """Equal records (``n`` of them), naming the crops written."""
    assert trecs == jrecs and len(trecs) == n
    crops = _same_files(tmp_path, branch, n)
    assert sorted(r["image_path"] for r in trecs) == sorted(os.path.join("out", p) for p in crops)


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_jax_tables(name):
    got, want = getattr(tprocess, name), getattr(jprocess, name)
    assert got == want
    if isinstance(want, dict):
        assert list(got.items()) == list(want.items())


def test_the_dataset_names_are_the_processors_and_the_jax_clis():
    assert tcli.DATASET_NAMES == tuple(tprocess.PROCESSORS) == jcli.DATASET_NAMES
    parser = tcli.build_parser()
    args = parser.parse_args(["process"])
    assert (args.base_dir, args.output_dir, args.datasets, args.splits) == (
        "./Datasets", "./processed", list(jcli.DATASET_NAMES), ["train", "val", "test"])


def test_resize_with_padding_geometry(branch):
    for w, h, seed in ((100, 50, 0), (37, 90, 1), (224, 224, 2), (500, 3, 3)):
        img = _noise(h, w, seed)
        out = tprocess.resize_with_padding(img, (224, 224))
        assert out.shape == (224, 224, 3)
        np.testing.assert_array_equal(out, jprocess.resize_with_padding(img, (224, 224)))
    out = tprocess.resize_with_padding(_noise(50, 100, 4) | 1)  # no zero pixel in the image
    # a 2:1 image fills the width and pads the height by 56 rows each side
    assert not out[:56].any() and not out[-56:].any() and out[56:-56].all()


def test_gtsrb(tmp_path, monkeypatch, branch):
    base = tmp_path / "raw" / "gtsrb-german-traffic-sign"
    root = base / "versions" / "1"
    _write(root / "Train" / "14" / "img0.png", _noise(80, 90, 0))
    _write(root / "Train" / "3" / "img1.png", _noise(60, 40, 1))
    _write(root / "Test" / "00001.png", _noise(70, 70, 2))
    fields = ["Path", "ClassId", "Roi.X1", "Roi.Y1", "Roi.X2", "Roi.Y2"]
    with open(root / "Train.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerow(dict(zip(fields, ["Train/14/img0.png", "14", 5, 6, 75, 70])))
        w.writerow(dict(zip(fields, ["Train/14/missing.png", "14", 0, 0, 10, 10])))
        w.writerow(dict(zip(fields, ["Train/3/img1.png", "3", 2, 3, 38, 57])))
    with open(root / "Test.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerow(dict(zip(fields, ["Test/00001.png", "99", 4, 4, 66, 60])))
    quiet = {"log": lambda s: None}
    jrecs, trecs = _run_both(tmp_path, monkeypatch, "process_gtsrb", base, "out", "train", **quiet)
    _same_outputs(tmp_path, branch, jrecs, trecs, 2)
    assert [(r["original_class"], r["unified_class"]) for r in trecs] == [
        ("Class_14", "stop"), ("Class_3", "speed_limit")]
    # every split but train reads Test.csv
    jrecs, trecs = _run_both(tmp_path, monkeypatch, "process_gtsrb", base, "val", "val", **quiet)
    assert trecs == jrecs and [r["unified_class"] for r in trecs] == ["other"]


def _write_yolo_fixture(base, split, class_id, seed=0):
    _write(base / split / "images" / "a.png", _noise(200, 260, seed))
    _write(base / split / "images" / "b.png", _noise(120, 90, seed + 1))
    os.makedirs(base / split / "labels", exist_ok=True)
    with open(base / split / "labels" / "a.txt", "w") as f:
        f.write(f"{class_id} 0.5 0.5 0.5 0.5\n")      # valid
        f.write(f"{class_id} 0.1 0.1 0.05 0.05\n")    # too small
        f.write("999 0.5 0.5 0.5 0.5\n")              # unknown class
        f.write(f"{class_id} 0.3 0.6 0.27 0.61\n")    # valid
    with open(base / split / "labels" / "b.txt", "w") as f:
        f.write(f"{class_id} 0.45 0.5 0.8 0.9\n")     # valid, narrow


@pytest.mark.parametrize("name, folder, class_id, unified", [
    ("process_lisa", "lisa-road-sign", 35, "stop"),
    ("process_roboflow", "roboflow-traffic-signs-dataset", 22, "stop")])
def test_yolo_layouts(tmp_path, monkeypatch, branch, name, folder, class_id, unified):
    base = tmp_path / "raw" / folder
    _write_yolo_fixture(base, "train", class_id)
    jrecs, trecs = _run_both(tmp_path, monkeypatch, name, base, "out", "train",
                             log=lambda s: None)
    _same_outputs(tmp_path, branch, jrecs, trecs, 3)
    assert {r["unified_class"] for r in trecs} == {unified}


def test_mapillary(tmp_path, monkeypatch, branch):
    base = tmp_path / "raw" / "Mapillary"
    for kind, images in (("fully", "mtsd_fully_annotated_images.val"),
                         ("partially", "mtsd_partially_annotated_images.val")):
        ann = base / f"mtsd_{kind}_annotated_annotation" / f"mtsd_v2_{kind}_annotated"
        os.makedirs(ann / "splits")
        os.makedirs(ann / "annotations")
        _write(base / images / "images" / f"{kind}1.jpg", _noise(300, 320, len(kind)))
        (ann / "splits" / "val.txt").write_text(f"{kind}1\nmissing\n")
        objects = [
            {"bbox": {"xmin": 10, "ymin": 12, "xmax": 200, "ymax": 150},
             "label": "regulatory--stop--g1"},
            {"bbox": {"xmin": 0, "ymin": 0, "xmax": 5, "ymax": 5},
             "label": "regulatory--stop--g1"},  # too small
            {"bbox": {"xmin": 10, "ymin": 10, "xmax": 100, "ymax": 100, "cross_boundary": {}},
             "label": "regulatory--yield--g1"},
            {"bbox": {"xmin": 150.7, "ymin": 40, "xmax": 330, "ymax": 99.2},
             "label": "regulatory--maximum-speed-limit-30--g1"},  # the digit rule
            {"bbox": {"xmin": 30, "ymin": 160, "xmax": 90, "ymax": 290},
             "label": "warning--unlisted-sign--g2"}]
        with open(ann / "annotations" / f"{kind}1.json", "w") as f:
            json.dump({"objects": objects}, f)
    jrecs, trecs = _run_both(tmp_path, monkeypatch, "process_mapillary", base, "out", "val",
                             log=lambda s: None)
    _same_outputs(tmp_path, branch, jrecs, trecs, 6)
    assert [(r["source"], r["unified_class"]) for r in trecs] == [
        (f"mapillary_{t}", c) for t in ("fully", "partial")
        for c in ("stop", "speed_limit", "other")]


def _write_cure_fixture(base):
    for seq in ("01_01", "01_04"):  # 01_04 is a test sequence
        path = str(base / "data" / f"{seq}_00_00_00.mp4")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 5, (160, 120))
        assert wr.isOpened()
        for i in range(5):
            wr.write(_noise(120, 160, 10 + i))
        wr.release()
        os.makedirs(base / "labels", exist_ok=True)
        with open(base / "labels" / f"{seq}.txt", "w") as f:
            f.write("header\n")
            f.write("2_06_10_10_110_10_110_90_10_90\n")   # stop
            f.write("2_99_10_10_110_10_110_90_10_90\n")   # other: dropped
            f.write("4_13_30_20_90_20_90_100_30_100\n")   # yield
            f.write("9_06_10_10_110_10_110_90_10_90\n")   # past the last frame


def test_cure_tsd(tmp_path, monkeypatch, branch):
    base = tmp_path / "raw" / "CURE-TSD"
    _write_cure_fixture(base)
    if branch == "pil":
        for mod in (jprocess, tprocess):
            with pytest.raises(RuntimeError, match="OpenCV"):
                mod.process_cure_tsd(base, tmp_path / "x", "train", log=lambda s: None)
        return
    assert "01_04" in tprocess.CURE_TSD_TEST_SEQUENCES
    for split, seq in (("train", "01_01"), ("test", "01_04")):
        jrecs, trecs = _run_both(tmp_path, monkeypatch, "process_cure_tsd", base, "out", split,
                                 log=lambda s: None)
        assert [(os.path.basename(r["image_path"]), r["unified_class"]) for r in trecs] == [
            (f"{seq}_00_00_00_f2_10_10.png", "stop"), (f"{seq}_00_00_00_f4_30_20.png", "yield")]
        assert trecs == jrecs
    _same_files(tmp_path, branch, 4)


def _write_raw_corpus(raw):
    """LISA with a train split, Roboflow with a test split: val is empty."""
    _write_yolo_fixture(raw / "lisa-road-sign", "train", 35)
    _write_yolo_fixture(raw / "roboflow-traffic-signs-dataset", "test", 18, seed=5)


def test_process_all(tmp_path, monkeypatch, branch):
    raw = tmp_path / "raw"
    _write_raw_corpus(raw)
    datasets = ("lisa-road-sign", "roboflow-traffic-signs-dataset")
    totals = _run_both(tmp_path, monkeypatch, "process_all", raw, "out", datasets=datasets,
                       log=lambda s: None)
    assert totals == [6, 6]
    for split, n in (("train", 3), ("val", 0), ("test", 3)):
        with open(tmp_path / "jax" / "out" / split / "metadata.csv", "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / "out" / split / "metadata.csv", "rb") as f:
            got = f.read()
        assert got == want and got.startswith(HEADER) and got.count(b"\r\n") == n + 1
    _same_files(tmp_path, branch, 6)


def test_imread_without_a_decoder_names_both(tmp_path, monkeypatch):
    base = tmp_path / "raw" / "lisa-road-sign"
    _write_yolo_fixture(base, "train", 35)
    monkeypatch.setattr(tprocess, "_cv2", lambda: None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    path = str(base / "train" / "images" / "a.png")
    with pytest.raises(RuntimeError) as err:
        tprocess.imread(path)
    assert "cv2" in str(err.value) and "PIL" in str(err.value) and path in str(err.value)
    # the parser's pool hands the error to the caller
    with pytest.raises(RuntimeError, match="neither OpenCV"):
        tprocess.process_lisa(base, tmp_path / "out", "train", log=lambda s: None)


def test_the_port_loader_reads_a_processed_split(tmp_path):
    raw = tmp_path / "raw"
    _write_raw_corpus(raw)
    out = tmp_path / "processed"
    assert tprocess.process_all(raw, out, datasets=("lisa-road-sign",), splits=("train", "val"),
                                log=lambda s: None) == 3
    vocab = LabelVocabulary.from_classes(["stop"])
    idx = tloader.MetadataIndex(str(out / "train" / "metadata.csv"), vocab)
    assert len(idx) == 3
    batch = next(iter(tloader.Loader(idx, batch_size=1)))
    assert batch.images.shape == (1, 224, 224, 3) and batch.labels.tolist() == [0]
    np.testing.assert_array_equal(batch.images[0],
                                  tnative.resize_center_crop(_decode(idx.paths[0]), 256, 224))
    empty = tloader.MetadataIndex(str(out / "val" / "metadata.csv"), vocab)
    assert len(empty) == 0 and list(tloader.Loader(empty, batch_size=1)) == []


def test_the_cli_stage_writes_what_the_jax_cli_writes(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    _write_raw_corpus(raw)
    _write_cure_fixture(raw / "CURE-TSD")
    for side, run in (("jax", lambda a: jcli.main(["--platform", "cpu", *a])),
                      ("port", lambda a: tcli.main(["--device", "cpu", *a]))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        assert run(["process", "--base_dir", str(raw), "--output_dir", "out"]) in (0, None)
    # CURE-TSD holds out test sequences from train only: val takes every sequence
    crops = _same_files(tmp_path, "cv2", 6 + 4 + 4)
    assert len([p for p in crops if p.startswith("val/images/01_")]) == 4
    assert sorted(_files(tmp_path / "port" / "out")) == sorted(
        [f"{s}/metadata.csv" for s in ("train", "val", "test")] + crops)


def test_importing_the_data_package_imports_no_decoder():
    code = (f"import sys, {PKG}.data as d\n"
            "assert d.process.PROCESSORS\n"
            "bad = sorted(m for m in ('cv2', 'PIL', 'jax') if m in sys.modules)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
