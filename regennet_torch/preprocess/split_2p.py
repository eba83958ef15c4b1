"""NTU120 cross-subject train/test split of the two-person subset: `python
-m regennet_torch.preprocess.split_2p -d ntu.h5 -o out/` (the port's copy
of regennet_tpu/preprocess/split_2p.py).

Keeps the 26 mutual-action classes (50-60 and 106-120), splits by subject
id against the published xsub training subjects, and renumbers the
classes 1..26 in the key names. Host h5py.
"""

from __future__ import annotations

import argparse
import itertools
import os

TRAINING_SUBJECTS = [
    1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35, 38,
    45, 46, 47, 49, 50, 52, 53, 54, 55, 56, 57, 58, 59, 70, 74, 78, 80, 81,
    82, 83, 84, 85, 86, 89, 91, 92, 93, 94, 95, 97, 98, 100, 103,
]

SELECTED_CLASSES = list(range(50, 61)) + list(range(106, 121))  # two-person


def remap_class(action_class: int) -> int:
    return action_class - 49 if action_class < 61 else action_class - 94


def write_split(data_path: str, out_path: str, benchmark: str, split: str):
    import h5py

    if benchmark != "xsub":
        raise ValueError("only the cross-subject benchmark is published")
    with h5py.File(data_path, "r") as f, h5py.File(out_path, "w") as fout:
        for filename in list(f.keys()):
            a = filename.find("A")
            action_class = int(filename[a + 1:a + 4])
            if action_class not in SELECTED_CLASSES:
                continue
            p = filename.find("P")
            istraining = int(filename[p + 1:p + 4]) in TRAINING_SUBJECTS
            if (split == "train") != istraining:
                continue
            new_name = filename[:17] + "%03d" % remap_class(action_class) + filename[20:]
            fout.create_dataset(new_name, data=f[filename], dtype="f")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--data_path", required=True)
    p.add_argument("-o", "--out_path", required=True)
    return p.parse_args(argv)


def main(args=None):
    if args is None:
        args = parse_args()
    os.makedirs(args.out_path, exist_ok=True)
    for b, s in itertools.product(["xsub"], ["train", "test"]):
        out = os.path.join(args.out_path, f"{b}.{s}.h5")
        write_split(args.data_path, out, b, s)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
