"""Host-side dataset sources: raw decoding, index building, crop precompute
(mirrors ``pixelwiseregression_tpu/data/sources.py``).

A numpy copy of the JAX module, which pulls in jax through its camera; a
test holds it against the JAX module field for field, down to the index
files the sources write. The division of labor with
``pixelwiseregression_tpu_torch.data.preprocess``: the host decodes
fixed-size raw depth frames and computes the per-sample *exact integer*
crop parameters in float64 (the reference computes these in python float64
and they feed normalization denominators, so float32 truncation boundaries
are not acceptable); all pixel work then happens on the device.

Dataset facts replicated from the reference:
  MSRA   21 joints, fx=fy=241.42, 320x240 frames from binary ``.bin`` tiles
         embedded into a zero canvas; labels xyz with y,z sign flips;
         COM = center-of-mass fallback; 9-fold LOSO splits.
  ICVL   16 joints, fx=fy=241.42, 320x240, 16-bit PNG depth (*65535);
         centers from icvl_center_{train,test}.txt; val==test;
         pre-augmented training rows skipped; bbox margin cube-30.
  NYU    14 of 36 joints, fx=588.037 fy=587.075, 640x480, depth packed
         into G,B channels ((g*256+b)*255); per-person cube shrink *5/6 for
         test index > 2440; bbox margin cube-40.
  HAND17 21 joints, fx=475.065948 fy=475.065857, 640x480, 16-bit PNG;
         train annotations xyz->uvd; 95/5 split with random.seed(0); test
         from frame/BoundingBox.txt; optional 'bb' process mode with
         iterative mean-depth background removal.

Pillow and ``scipy.io`` are imported inside the functions that use them.
"""

from __future__ import annotations

import dataclasses
import os
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pixelwiseregression_tpu_torch.core.camera import Camera


# --------------------------------------------------------------------------- #
# specs
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    camera: Camera
    cube_size: float
    joint_number: int
    frame_h: int
    frame_w: int
    bbox_margin: Optional[float]  # None -> no load-time bbox mask (MSRA)
    skeleton: Tuple[Tuple[int, ...], ...]  # finger chains, bottom-up


MSRA_SPEC = DatasetSpec(
    name="MSRA",
    camera=Camera(241.42, 241.42, 160.0, 120.0),
    cube_size=125.0,
    joint_number=21,
    frame_h=240,
    frame_w=320,
    bbox_margin=None,
    skeleton=(
        (0, 17, 18, 19, 20),  # thumb
        (0, 1, 2, 3, 4),      # index
        (0, 5, 6, 7, 8),      # mid
        (0, 9, 10, 11, 12),   # ring
        (0, 13, 14, 15, 16),  # small
    ),
)

ICVL_SPEC = DatasetSpec(
    name="ICVL",
    camera=Camera(241.42, 241.42, 160.0, 120.0),
    cube_size=125.0,
    joint_number=16,
    frame_h=240,
    frame_w=320,
    bbox_margin=30.0,
    skeleton=(
        (0, 1, 2, 3),
        (0, 4, 5, 6),
        (0, 7, 8, 9),
        (0, 10, 11, 12),
        (0, 13, 14, 15),
    ),
)

NYU_SPEC = DatasetSpec(
    name="NYU",
    camera=Camera(588.037, 587.075, 320.0, 240.0),
    cube_size=150.0,
    joint_number=14,
    frame_h=480,
    frame_w=640,
    bbox_margin=40.0,
    skeleton=(
        (13, 10, 9, 8),
        (13, 1, 0),
        (13, 3, 2),
        (13, 5, 4),
        (13, 7, 6),
        (11, 13, 12),
    ),
)

HAND17_SPEC = DatasetSpec(
    name="HAND17",
    camera=Camera(475.065948, 475.065857, 315.944855, 245.287079),
    cube_size=150.0,
    joint_number=21,
    frame_h=480,
    frame_w=640,
    bbox_margin=40.0,
    skeleton=(
        (0, 1, 6, 7, 8),
        (0, 2, 9, 10, 11),
        (0, 3, 12, 13, 14),
        (0, 4, 15, 16, 17),
        (0, 5, 18, 19, 20),
    ),
)

SPECS = {"MSRA": MSRA_SPEC, "ICVL": ICVL_SPEC, "NYU": NYU_SPEC, "HAND17": HAND17_SPEC}

# NYU keeps 14 of the 36 annotated joints (reference: datasets.py:700).
NYU_JOINT_INDEX = [0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 30, 31, 32]


# --------------------------------------------------------------------------- #
# raw decoders
# --------------------------------------------------------------------------- #


def load_bin(path: str):
    """MSRA binary depth tile: 6 little-endian int32 header
    (w, h, left, top, right, bottom) then float32 pixels for the bbox
    (reference: utils.py:253-260, reimplemented with one frombuffer instead
    of a per-pixel unpack loop)."""
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(24), dtype="<i4")
        img_w, img_h, left, top, right, bottom = (int(x) for x in header)
        n = (bottom - top) * (right - left)
        img = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(bottom - top, right - left)
    return img.astype(np.float64), left, top, right, bottom


def _native():
    from pixelwiseregression_tpu_torch import native

    return native if native.available() else None


def _use_native_png() -> bool:
    return os.environ.get("PWR_NATIVE_PNG", "0") == "1"


def load_png16(path: str, shape=None) -> np.ndarray:
    """16-bit grayscale PNG -> depth in mm, replicating
    ``plt.imread(path) * 65535`` float32 rounding (datasets.py:635, 940).

    With ``shape=(h, w)``, ``PWR_NATIVE_PNG=1`` and the native library
    available the WHOLE decode (zlib inflate + unfilter + scale) runs in C++
    (bit-identical, golden-tested vs PIL). zlib inflate dominates either
    path, so this only pays on many-core hosts via the batch API
    (native.png_decode_depth_batch); default stays PIL + native scale."""
    nat = _native()
    if nat is not None and shape is not None and _use_native_png():
        out, status = nat.png_decode_depth_batch(
            [path], nat.PNG_MODE_GRAY16, shape[0], shape[1], num_threads=1
        )
        if status[0] == 0:
            return out[0]
    from PIL import Image

    raw = np.asarray(Image.open(path))
    if nat is not None and raw.dtype == np.uint16:
        return nat.png16_scale_batch(raw[None], num_threads=1)[0]
    return (raw.astype(np.float32) / 65535.0) * 65535.0


def load_png_nyu(path: str, shape=None) -> np.ndarray:
    """NYU RGB-packed depth: ``(g*256 + b)*255`` on plt.imread's [0,1] floats
    (reference: datasets.py:809-810), replicated in float32.

    With ``shape=(h, w)`` and ``PWR_NATIVE_PNG=1`` the whole decode (zlib
    inflate + unfilter + pack) runs in the native library (see load_png16's
    note on when that pays); default is PIL + native pack (bit-identical,
    numpy fallback)."""
    nat = _native()
    if nat is not None and shape is not None and _use_native_png():
        out, status = nat.png_decode_depth_batch(
            [path], nat.PNG_MODE_NYU_RGB, shape[0], shape[1], num_threads=1
        )
        if status[0] == 0:
            return out[0]
    from PIL import Image

    raw = np.asarray(Image.open(path))
    if nat is not None and raw.dtype == np.uint8 and raw.ndim == 3 and raw.shape[2] == 3:
        return nat.nyu_pack_batch(raw[None], num_threads=1)[0]
    g = raw[:, :, 1].astype(np.float32) / 255.0
    b = raw[:, :, 2].astype(np.float32) / 255.0
    return (g * 256.0 + b) * 255.0


def center_of_mass_fallback(frame: np.ndarray) -> np.ndarray:
    """COM fallback when a dataset provides no center: center of mass of the
    positive support + mean positive depth (reference: datasets.py:208-211)."""
    pos = frame > 0
    total = pos.sum()
    if total == 0:
        raise ValueError("empty frame: no positive depth")
    rows = np.arange(frame.shape[0], dtype=np.float64)
    cols = np.arange(frame.shape[1], dtype=np.float64)
    r = (pos.sum(axis=1) * rows).sum() / total
    c = (pos.sum(axis=0) * cols).sum() / total
    mean = frame[pos].mean()
    return np.array([c, r, mean], dtype=np.float64)


# --------------------------------------------------------------------------- #
# text index helpers (reference line format: "<path> x0 y0 z0 x1 y1 z1 ...")
# --------------------------------------------------------------------------- #


def decode_line(text: str):
    parts = text.strip().split()
    path = parts[0]
    data = np.array(list(map(float, parts[1:])), dtype=np.float64)
    return path, data.reshape(-1, 3)


def encode_line(path: str, joints_flat: Sequence[float]) -> str:
    """Reference write_data_txt row format (datasets.py:113-127): str(float)."""
    return path + " " + " ".join(str(float(x)) for x in joints_flat)


# --------------------------------------------------------------------------- #
# raw sample record: everything the device pipeline needs
# --------------------------------------------------------------------------- #


def make_record(
    spec: DatasetSpec,
    frame: np.ndarray,
    joints_uvd: Optional[np.ndarray],
    com: np.ndarray,
    cube: float,
    bbox: Optional[Tuple[int, int, int, int]] = None,
) -> Dict[str, np.ndarray]:
    """Assemble the host record with exact float64->int crop parameters
    (reference arithmetic: datasets.py:244-259)."""
    cam = spec.camera
    du = cube / com[2] * cam.fx
    dv = cube / com[2] * cam.fy
    box = max(int(du + dv), 2)
    s = box // 2
    com_u, com_v = int(com[0]), int(com[1])
    if bbox is None:
        bbox = (0, 0, frame.shape[1], frame.shape[0])
    rec = {
        "frame": np.ascontiguousarray(frame, dtype=np.float32),
        "com": com.astype(np.float32),
        "com_int": np.array([com_u, com_v], np.int32),
        "cube": np.float32(cube),
        "bbox": np.array(bbox, np.int32),
        "crop_top": np.int32(com_v - s),
        "crop_left": np.int32(com_u - s),
        "box_size": np.int32(2 * s),
    }
    if joints_uvd is not None:
        rec["joints"] = joints_uvd.astype(np.float32)
    return rec


def load_bbox(spec: DatasetSpec, com: np.ndarray, cube: float) -> Tuple[int, int, int, int]:
    """Load-time background bbox (reference: datasets.py:666-678, 841-853,
    956-968): margin-shrunk projected cube, clamped to the frame."""
    cam = spec.camera
    margin = spec.bbox_margin
    du = (cube - margin) / com[2] * cam.fx
    dv = (cube - margin) / com[2] * cam.fy
    left = max(int(com[0] - du), 0)
    top = max(int(com[1] - dv), 0)
    right = int(min(int(com[0] + du), cam.halfu * 2))
    bottom = int(min(int(com[1] + dv), cam.halfv * 2))
    return left, top, right, bottom


# --------------------------------------------------------------------------- #
# sources
# --------------------------------------------------------------------------- #


class HandSource:
    """Base class: owns the index (text lines) and per-sample raw loading.

    Subclasses implement ``build_data`` (index construction, reference
    ``build_data`` per dataset) and ``load_raw`` (decode one line into
    (frame, joints_uvd, com, cube, bbox)).
    """

    SPEC: DatasetSpec = None  # type: ignore

    def __init__(
        self,
        path: str,
        dataset: str = "train",
        test_only: bool = False,
        process_mode: str = "uvd",
        cube_size: Optional[float] = None,
        build: bool = True,
        check_fn=None,
    ):
        self.spec = self.SPEC
        self.path = path
        self.dataset = dataset
        self.test_only = test_only
        self.process_mode = process_mode
        self.cube_size = float(cube_size if cube_size is not None else self.spec.cube_size)
        self.camera = self.spec.camera
        self.joint_number = self.spec.joint_number
        self.config = [list(f) for f in self.spec.skeleton]
        self._check_fn = check_fn

        if build:
            self.build_data()
            with open(os.path.join(self.path, self.index_filename()), "r") as f:
                self.lines = [l for l in f.read().splitlines() if l.strip()]
        else:
            self.lines = []

    # -- index --
    def index_filename(self) -> str:
        return f"{self.dataset}.txt"

    @property
    def data_ready(self) -> bool:
        return all(
            os.path.exists(os.path.join(self.path, f"{n}.txt"))
            for n in ("train", "val", "test")
        )

    def build_data(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.lines)

    # -- raw loading --
    def load_raw(self, text: str):
        """-> (frame f64 [H,W], joints_uvd f64 [J,3] | None, com f64 [3],
        cube float, bbox | None)"""
        raise NotImplementedError

    def record(self, text: str) -> Dict[str, np.ndarray]:
        frame, joints_uvd, com, cube, bbox = self.load_raw(text)
        return make_record(self.spec, frame, joints_uvd, com, cube, bbox)

    def check_lines(self, lines: List[str]) -> List[str]:
        """Validation filter replacing the reference's Ray fan-out
        (datasets.py:17-35): keep lines whose samples decode and synthesize
        valid labels. The heavy validity check runs batched on device via
        ``check_fn`` (see cli.check_dataset); host-side decode failures are
        caught here."""
        kept = []
        records, good_lines = [], []
        for line in lines:
            try:
                records.append(self.record(line))
                good_lines.append(line)
            except Exception:
                continue
        if not records:
            return kept
        if self._check_fn is None:
            return good_lines
        flags = self._check_fn(self, records)
        return [l for l, ok in zip(good_lines, flags) if ok]


class MSRASource(HandSource):
    SPEC = MSRA_SPEC

    def __init__(self, path, dataset="train", subject: int = 0, **kw):
        self.subject = subject
        super().__init__(path, dataset=dataset, **kw)

    def index_filename(self) -> str:
        return f"{self.dataset}_{self.subject}.txt"

    @property
    def data_ready(self) -> bool:
        return all(
            os.path.exists(os.path.join(self.path, f"{n}_{i}.txt"))
            for n in ("train", "val", "test")
            for i in range(9)
        )

    def build_data(self):
        """9-subject LOSO: per-subject test_i from joint.txt + bins; checked
        samples -> train_i (8 other subjects) / val_i (held-out subject)
        (reference: datasets.py:439-504)."""
        if self.data_ready:
            return
        persons = [f"P{i}" for i in range(9)]
        gestures = sorted(os.listdir(os.path.join(self.path, persons[0])))
        per_subject_lines: List[List[str]] = []
        for person in persons:
            lines = []
            for gesture in gestures:
                gdir = os.path.join(self.path, person, gesture)
                with open(os.path.join(gdir, "joint.txt")) as f:
                    n = int(f.readline())
                joints = np.loadtxt(os.path.join(gdir, "joint.txt"), skiprows=1)
                joints = joints.reshape(n, 21, 3)
                # reference flips y and z sign (datasets.py:459-460)
                joints[:, :, 1] *= -1
                joints[:, :, 2] *= -1
                flat = joints.reshape(n, 63)
                for j in range(n):
                    lines.append(
                        encode_line(os.path.join(gdir, f"{j:06d}_depth.bin"), flat[j])
                    )
            per_subject_lines.append(lines)

        for i in range(9):
            with open(os.path.join(self.path, f"test_{i}.txt"), "w") as f:
                f.write("\n".join(per_subject_lines[i]) + "\n")

        checked = [self.check_lines(lines) for lines in per_subject_lines]
        for i in range(9):
            train, val = [], []
            for j in range(9):
                if i == j:
                    val = checked[j]
                else:
                    train += checked[j]
            with open(os.path.join(self.path, f"train_{i}.txt"), "w") as f:
                f.write("\n".join(train) + "\n")
            with open(os.path.join(self.path, f"val_{i}.txt"), "w") as f:
                f.write("\n".join(val) + "\n")

    def load_raw(self, text):
        path, joint_xyz = decode_line(text)
        joint_uvd = self.camera.xyz2uvd(joint_xyz)
        tile, left, top, right, bottom = load_bin(path)
        frame = np.zeros((self.spec.frame_h, self.spec.frame_w), np.float64)
        frame[top:bottom, left:right] = tile
        com = center_of_mass_fallback(frame)
        return frame, joint_uvd, com, self.cube_size, None

    def batch_records(self, lines: List[str]) -> List[Dict[str, np.ndarray]]:
        """Batch fast path: GIL-free native decode of .bin tiles + COM
        (pixelwiseregression_tpu_torch.native), numpy fallback otherwise."""
        from pixelwiseregression_tpu_torch import native

        if not native.available():
            return [self.record(l) for l in lines]
        paths, joints = [], []
        for line in lines:
            path, joint_xyz = decode_line(line)
            paths.append(path)
            joints.append(self.camera.xyz2uvd(joint_xyz))
        frames, coms, status = native.msra_decode_batch(
            paths, self.spec.frame_h, self.spec.frame_w
        )
        out = []
        for i, line in enumerate(lines):
            if status[i] != 0:
                raise ValueError(f"failed to decode {paths[i]}")
            out.append(
                make_record(self.spec, frames[i], joints[i], coms[i], self.cube_size, None)
            )
        return out


class ICVLSource(HandSource):
    SPEC = ICVL_SPEC

    def __init__(self, path, dataset="train", **kw):
        with open(os.path.join(path, "icvl_train_list.txt")) as f:
            self.train_lookup = {name.strip(): i for i, name in enumerate(f)}
        self.train_centers = np.loadtxt(os.path.join(path, "icvl_center_train.txt")).reshape(-1, 3)
        self.test_centers = np.loadtxt(os.path.join(path, "icvl_center_test.txt")).reshape(-1, 3)
        super().__init__(path, dataset=dataset, **kw)

    def build_data(self):
        """test/val from test_seq_{1,2}.txt (val == test); train from
        Training/labels.txt minus pre-augmented rows, validity-checked
        (reference: datasets.py:550-624)."""
        if self.data_ready:
            return
        if not os.path.exists(os.path.join(self.path, "test.txt")):
            test_set = []
            for seq in (1, 2):
                with open(os.path.join(self.path, "Testing", f"test_seq_{seq}.txt")) as f:
                    rows = [l.strip() for l in f if l.strip()]
                for row in rows:
                    words = row.split()
                    name = os.path.join(self.path, "Testing", "Depth", words[0])
                    test_set.append(" ".join([name] + words[1:]))
            for fname in ("test.txt", "val.txt"):
                with open(os.path.join(self.path, fname), "w") as f:
                    f.write("\n".join(test_set))

        if not os.path.exists(os.path.join(self.path, "train.txt")):
            prev = self.dataset
            self.dataset = "train"
            rows = []
            with open(os.path.join(self.path, "Training", "labels.txt")) as f:
                for line in f:
                    words = line.split()
                    if not words:
                        continue
                    if len(words[0].split("/")) > 2:
                        continue  # pre-augmented rows skipped (datasets.py:602-604)
                    name = os.path.join(self.path, "Training", "Depth", words[0])
                    rows.append(" ".join([name] + words[1:]))
            kept = self.check_lines(rows)
            with open(os.path.join(self.path, "train.txt"), "w") as f:
                f.write("\n".join(kept))
            self.dataset = prev

    def load_raw(self, text):
        path, joint_uvd = decode_line(text)  # ICVL labels are already uvd
        frame = load_png16(path, shape=(self.spec.frame_h, self.spec.frame_w)).astype(np.float64)
        if self.dataset in ("val", "test"):
            seq, idx = re.findall(r"test_seq_(\d)/image_(\d+)", path)[0]
            index = int(idx) + (702 if int(seq) == 2 else 0)
            com = self.test_centers[index].astype(np.float64)
        else:
            key = "/".join(path.split("/")[-2:])
            com = self.train_centers[self.train_lookup[key]].astype(np.float64)
        cube = self.cube_size
        bbox = load_bbox(self.spec, com, cube)
        return frame, joint_uvd, com, cube, bbox


class NYUSource(HandSource):
    SPEC = NYU_SPEC

    def __init__(self, path, dataset="train", **kw):
        self.train_centers = np.loadtxt(os.path.join(path, "nyu_center_train.txt")).reshape(-1, 3)
        self.test_centers = np.loadtxt(os.path.join(path, "nyu_center_test.txt")).reshape(-1, 3)
        super().__init__(path, dataset=dataset, **kw)

    def build_data(self):
        """train from train/joint_data.mat (checked); test from
        test/joint_data.mat (unchecked); val = checked test
        (reference: datasets.py:717-795)."""
        if self.data_ready:
            return
        from scipy.io import loadmat

        if not os.path.exists(os.path.join(self.path, "train.txt")):
            prev = self.dataset
            self.dataset = "train"
            mat = loadmat(os.path.join(self.path, "train", "joint_data.mat"))
            uvds = mat["joint_uvd"][0]
            rows = []
            for i in range(uvds.shape[0]):
                uvd = uvds[i][NYU_JOINT_INDEX].reshape(-1)
                fn = os.path.join(self.path, "train", f"depth_1_{i + 1:07d}.png")
                rows.append(" ".join([fn] + [str(x) for x in uvd]))
            kept = self.check_lines(rows)
            with open(os.path.join(self.path, "train.txt"), "w") as f:
                f.write("\n".join(kept))
            self.dataset = prev

        if not os.path.exists(os.path.join(self.path, "test.txt")):
            prev = self.dataset
            self.dataset = "test"
            mat = loadmat(os.path.join(self.path, "test", "joint_data.mat"))
            uvds = mat["joint_uvd"][0]
            rows = []
            for i in range(uvds.shape[0]):
                uvd = uvds[i][NYU_JOINT_INDEX].reshape(-1)
                fn = os.path.join(self.path, "test", f"depth_1_{i + 1:07d}.png")
                rows.append(" ".join([fn] + [str(x) for x in uvd]))
            with open(os.path.join(self.path, "test.txt"), "w") as f:
                f.write("\n".join(rows))
            kept = self.check_lines(rows)
            with open(os.path.join(self.path, "val.txt"), "w") as f:
                f.write("\n".join(kept))
            self.dataset = prev

    def load_raw(self, text):
        path, joint_uvd = decode_line(text)  # NYU labels are uvd
        frame = load_png_nyu(path, shape=(self.spec.frame_h, self.spec.frame_w)).astype(np.float64)
        cube = self.cube_size
        index = int(re.findall(r"depth_1_(\d+)", path)[0]) - 1
        if self.dataset in ("val", "test"):
            if index > 2440:  # smaller-handed subject (datasets.py:818-819)
                cube = int(cube * 5 / 6)
            com = self.test_centers[index].astype(np.float64)
        else:
            com = self.train_centers[index].astype(np.float64)
        bbox = load_bbox(self.spec, com, cube)
        return frame, joint_uvd, com, cube, bbox


class HAND17Source(HandSource):
    SPEC = HAND17_SPEC

    def __init__(self, path, dataset="train", **kw):
        self.train_centers = np.loadtxt(os.path.join(path, "hands17_center_train.txt")).reshape(-1, 3)
        self.test_centers = np.loadtxt(os.path.join(path, "hands17_center_test.txt")).reshape(-1, 3)
        super().__init__(path, dataset=dataset, **kw)

    def build_data(self):
        """test from frame/BoundingBox.txt; train/val = checked
        Training_Annotation.txt shuffled with random.seed(0), 95/5 split
        (reference: datasets.py:881-926)."""
        if self.data_ready:
            return
        with open(os.path.join(self.path, "frame", "BoundingBox.txt")) as f:
            test_text = f.read()
        with open(os.path.join(self.path, "test.txt"), "w") as f:
            f.write(test_text)

        with open(os.path.join(self.path, "training", "Training_Annotation.txt")) as f:
            rows = [l for l in f.read().splitlines() if l.strip()]
        prev = self.dataset
        self.dataset = "train"
        kept = self.check_lines(rows)
        self.dataset = prev

        rng = random.Random()
        rng.seed(0)
        rng.shuffle(kept)
        train_size = len(kept) * 95 // 100
        with open(os.path.join(self.path, "train.txt"), "w") as f:
            f.write("\n".join(kept[:train_size]) + "\n")
        with open(os.path.join(self.path, "val.txt"), "w") as f:
            f.write("\n".join(kept[train_size:]) + "\n")

    def load_raw(self, text):
        if self.process_mode == "bb":
            return self._load_raw_bb(text)
        cube = self.cube_size
        if self.dataset != "test":
            path, joint_xyz = decode_line(text)
            joint_uvd = self.camera.xyz2uvd(joint_xyz)
            frame = load_png16(os.path.join(self.path, "training", "images", path),
                               shape=(self.spec.frame_h, self.spec.frame_w))
            index = int(re.findall(r"image_D(\d+)", path)[0]) - 1
            com = self.train_centers[index].astype(np.float64)
        else:
            path = text.strip().split()[0]
            joint_uvd = None
            frame = load_png16(os.path.join(self.path, "frame", "images", path),
                               shape=(self.spec.frame_h, self.spec.frame_w))
            index = int(re.findall(r"image_D(\d+)", path)[0]) - 1
            com = self.test_centers[index].astype(np.float64)
        bbox = load_bbox(self.spec, com, cube)
        return frame.astype(np.float64), joint_uvd, com, cube, bbox

    def _load_raw_bb(self, text):
        """'bb' process mode: crop by provided bounding box + iterative
        mean-depth background removal, COM fallback
        (reference: datasets.py:976-996)."""
        parts = text.strip().split()
        path = parts[0]
        ustart, vstart, du, dv = map(float, parts[1:])
        frame = load_png16(os.path.join(self.path, "frame", "images", path),
                           shape=(self.spec.frame_h, self.spec.frame_w)).astype(np.float64)
        mm = np.zeros_like(frame)
        mm[int(vstart) : int(vstart + dv), int(ustart) : int(ustart + du)] = 1
        frame = frame * mm
        mean = frame[frame > 0].mean()
        tmp = frame.copy()
        tmp[tmp > mean + 100] = 0
        mean = tmp[tmp > 0].mean()
        frame[frame > mean + 100] = 0
        com = center_of_mass_fallback(frame)
        return frame, None, com, self.cube_size, None


SOURCES = {
    "MSRA": MSRASource,
    "ICVL": ICVLSource,
    "NYU": NYUSource,
    "HAND17": HAND17Source,
}


def get_source(name: str, path: Optional[str] = None, **kw) -> HandSource:
    if path is None:
        path = os.path.join("Data", name)
    return SOURCES[name](path, **kw)
