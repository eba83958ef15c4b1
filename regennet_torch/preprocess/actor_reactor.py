"""Apply actor/reactor order labels to a two-person h5 archive: `python -m
regennet_torch.preprocess.actor_reactor` (the port's copy of
regennet_tpu/preprocess/actor_reactor.py).

Per clip, a label file says whether person 0 is the actor (0) or the
reactor (1); for 1 the two persons' channel halves are swapped, so the
actor always holds channels 0:3, as the conditional collate expects. Host
numpy and h5py.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def swap_persons(clip: np.ndarray) -> np.ndarray:
    out = np.zeros_like(clip)
    out[:, :, 0:3] = clip[:, :, 3:6]
    out[:, :, 3:6] = clip[:, :, 0:3]
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", required=True, help="input h5")
    p.add_argument("--dest", required=True, help="output h5")
    p.add_argument("--label_folder", required=True, help="dir of <clip>.mp4.txt order labels")
    return p.parse_args(argv)


def main(args=None):
    import h5py

    if args is None:
        args = parse_args()
    os.makedirs(os.path.dirname(args.dest) or ".", exist_ok=True)
    with h5py.File(args.src, "r") as f, h5py.File(args.dest, "w") as f_out:
        for filename in list(f.keys()):
            with open(os.path.join(args.label_folder, filename + ".mp4.txt")) as lf:
                label = int(lf.readlines()[0])
            clip = f[filename][:]
            if label == 1:
                clip = swap_persons(clip)
            f_out.create_dataset(filename, data=clip, dtype="f")
    print(f"wrote {args.dest}")


if __name__ == "__main__":
    main()
