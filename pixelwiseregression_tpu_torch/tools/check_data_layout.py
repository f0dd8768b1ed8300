"""Check a real dataset's directory layout before a training or grading run
(the port of the JAX package's ``tools/check_data_layout.py``; host code).

No real dataset ships with the repository, so the first contact with real
MSRA / ICVL / NYU / HAND17 data must not be a crash in the middle of a run:
this checks the layout against what the port's ``data/sources.py`` reads
(reference layouts: datasets.py:439-504, 550-624, 717-795, 881-926) and
decodes the first sample of each split.

    python -m pixelwiseregression_tpu_torch.tools.check_data_layout --dataset NYU \
        --data_path /data/nyu

Exit 0: the layout is valid (prints each split's sample count); exit 1: a
numbered list of everything missing or malformed, as the JAX tool prints it.
One check differs from the JAX tool's: HAND17's ``Training_Annotation.txt``
is looked for under ``training/``, where the sources read it (the JAX tool
looks at the root, and so refuses a valid layout).
"""

import argparse
import os

import numpy as np

from pixelwiseregression_tpu_torch.data.sources import get_source


def _exists(problems, path, what):
    if not os.path.exists(path):
        problems.append(f"missing {what}: {path}")
        return False
    return True


def check_msra(root, problems):
    persons = [f"P{i}" for i in range(9)]
    for p in persons:
        if not _exists(problems, os.path.join(root, p), f"subject dir ({p})"):
            continue
        gestures = sorted(os.listdir(os.path.join(root, p)))
        if not gestures:
            problems.append(f"no gesture dirs under {root}/{p}")
            continue
        g = os.path.join(root, p, gestures[0])
        if _exists(problems, os.path.join(g, "joint.txt"), "joint.txt"):
            with open(os.path.join(g, "joint.txt")) as f:
                n = int(f.readline())
            j = np.loadtxt(os.path.join(g, "joint.txt"), skiprows=1)
            if j.shape != (n, 63):
                problems.append(
                    f"{g}/joint.txt: expected ({n}, 63) xyz rows, got {j.shape}")
            b = os.path.join(g, "000000_depth.bin")
            if _exists(problems, b, "first .bin tile"):
                hdr = np.fromfile(b, np.int32, 6)
                w, h, l, t, r, bm = hdr
                if (w, h) != (320, 240) or not (0 <= l < r <= w and 0 <= t < bm <= h):
                    problems.append(f"{b}: bad header {hdr.tolist()}")


def check_icvl(root, problems):
    for f in ("icvl_center_train.txt", "icvl_center_test.txt", "icvl_train_list.txt"):
        _exists(problems, os.path.join(root, f), "center/list file")
    _exists(problems, os.path.join(root, "Training", "labels.txt"), "Training/labels.txt")
    _exists(problems, os.path.join(root, "Training", "Depth"), "Training/Depth dir")
    for seq in (1, 2):
        _exists(problems, os.path.join(root, "Testing", f"test_seq_{seq}.txt"),
                f"Testing/test_seq_{seq}.txt")
    _exists(problems, os.path.join(root, "Testing", "Depth"), "Testing/Depth dir")


def check_nyu(root, problems):
    for f in ("nyu_center_train.txt", "nyu_center_test.txt"):
        _exists(problems, os.path.join(root, f), "center file")
    for split in ("train", "test"):
        if _exists(problems, os.path.join(root, split, "joint_data.mat"),
                   f"{split}/joint_data.mat"):
            from scipy.io import loadmat
            mat = loadmat(os.path.join(root, split, "joint_data.mat"))
            if "joint_uvd" not in mat:
                problems.append(f"{split}/joint_data.mat has no joint_uvd")
            elif mat["joint_uvd"].shape[2:] != (36, 3):
                problems.append(
                    f"{split}/joint_data.mat joint_uvd shape {mat['joint_uvd'].shape}"
                    " (want [K, N, 36, 3])")
        _exists(problems, os.path.join(root, split, "depth_1_0000001.png"),
                f"first {split} frame (depth_1_0000001.png)")


def check_hand17(root, problems):
    for f in ("hands17_center_train.txt", "hands17_center_test.txt"):
        _exists(problems, os.path.join(root, f), "center file")
    # sources.py reads the training annotations from training/ (HAND17Source
    # build_data); the JAX tool looks for them at the root
    _exists(problems, os.path.join(root, "training", "Training_Annotation.txt"),
            "training/Training_Annotation.txt")
    _exists(problems, os.path.join(root, "frame", "BoundingBox.txt"),
            "frame/BoundingBox.txt")
    # sources.py reads training frames from training/images (HAND17Source
    # load_raw) and test frames from frame/images
    _exists(problems, os.path.join(root, "training", "images"), "training/images dir")
    _exists(problems, os.path.join(root, "frame", "images"), "test frame images dir")


CHECKS = {"MSRA": check_msra, "ICVL": check_icvl, "NYU": check_nyu,
          "HAND17": check_hand17}


def check(dataset: str, data_path: str, decode_sample: bool = True):
    """``(problems, decoded)``: the problems found, in order, and a line
    for each split whose first sample was decoded."""
    problems, decoded = [], []
    if not os.path.isdir(data_path):
        problems.append(f"data_path is not a directory: {data_path}")
    else:
        CHECKS[dataset](data_path, problems)

    if not problems and decode_sample:
        try:
            kw = {"subject": 0} if dataset == "MSRA" else {}
            for split in ("train", "test"):
                src = get_source(dataset, path=data_path, dataset=split,
                                 test_only=(split == "test"), **kw)
                rec = src.record(src.lines[0])
                frame = rec["frame"]
                decoded.append(f"{split}: {len(src)} samples; first frame "
                               f"{frame.shape} depth range [{frame[frame > 0].min():.0f}, "
                               f"{frame.max():.0f}] mm; com {np.round(rec['com'], 1)}")
        except Exception as e:  # noqa: BLE001 -- reported as a problem, not raised
            problems.append(f"decoding a sample failed: {type(e).__name__}: {e}")
    return problems, decoded


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, choices=sorted(CHECKS))
    p.add_argument("--data_path", required=True)
    p.add_argument("--decode_sample", action="store_true", default=True,
                   help="also build the index and decode one sample per split")
    p.add_argument("--no_decode_sample", dest="decode_sample", action="store_false")
    args = p.parse_args(argv)

    problems, decoded = check(args.dataset, args.data_path, args.decode_sample)
    for line in decoded:
        print(line)
    if problems:
        print(f"LAYOUT INVALID for {args.dataset} at {args.data_path}:")
        for i, pr in enumerate(problems, 1):
            print(f"  {i}. {pr}")
        return 1
    print(f"LAYOUT OK for {args.dataset} at {args.data_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
