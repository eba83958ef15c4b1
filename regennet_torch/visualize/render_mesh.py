"""Export OBJ meshes for a rendered sample: `python -m
regennet_torch.visualize.render_mesh --input_path .../sampleXX_repYY.mp4`
(counterpart of regennet_tpu/visualize/render_mesh.py).

Finds the `results.npy` beside the video, exports one OBJ per valid frame
into `<input>_obj/` and the SMPL parameter dict to
`<input>_smpl_params.npy` (vis_utils.Npy2Obj, on the card unless
`--device cpu`).
"""

from __future__ import annotations

import argparse
import os
import shutil

from regennet_torch.device import resolve_device
from regennet_torch.utils.parser_util import device_arg


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input_path", type=str, required=True,
                   help="stick-figure mp4 file to be mesh-exported")
    p.add_argument("--body_model", type=str, default="",
                   help="smpl/smplx override (default: inferred)")
    p.add_argument("--fit_steps", type=int, default=300,
                   help="SMPLify iterations when the input is xyz")
    p.add_argument("--device", default=0, type=device_arg,
                   help="CUDA device id (the run is on cuda:<id>), or 'cpu'.")
    return p.parse_args(argv)


def main(args=None, device=None):
    from regennet_torch.visualize.vis_utils import Npy2Obj

    if args is None:
        args = parse_args()
    device = resolve_device(device, getattr(args, "device", 0))
    if not args.input_path.endswith(".mp4"):
        raise ValueError(f"--input_path must name a sampleXX_repYY.mp4, got {args.input_path}")
    parsed_name = (os.path.basename(args.input_path)
                   .replace(".mp4", "").replace("sample", "").replace("rep", ""))
    sample_i, rep_i = [int(e) for e in parsed_name.split("_")]
    npy_path = os.path.join(os.path.dirname(args.input_path), "results.npy")
    if not os.path.exists(npy_path):
        raise FileNotFoundError(npy_path)
    out_npy_path = args.input_path.replace(".mp4", "_smpl_params.npy")
    results_dir = args.input_path.replace(".mp4", "_obj")
    if os.path.exists(results_dir):
        shutil.rmtree(results_dir)
    os.makedirs(results_dir)

    converter = Npy2Obj(npy_path, sample_i, rep_i, body_model=args.body_model or None,
                        fit_steps=args.fit_steps, device=device)
    print(f"Saving obj files to [{os.path.abspath(results_dir)}]")
    for frame_i in range(converter.real_num_frames):
        converter.save_obj(os.path.join(results_dir, f"frame{frame_i:03d}.obj"), frame_i)
    print(f"Saving SMPL params to [{os.path.abspath(out_npy_path)}]")
    converter.save_npy(out_npy_path)
    return converter


if __name__ == "__main__":
    main()
