#!/usr/bin/env python3
"""Where the forward attention kernel's time goes: ablations of
regennet_torch/csrc/attention_fwd.cu on the card.

    python3 scripts/ablate_attention_fwd.py

Builds the source as it is and in variants with one part taken out (the
softmax, the tensor-core products, the copies into shared memory, the output
stores), each into its own library in a temporary directory, and times every
variant's kernel under torch.profiler (device time per call, 20 calls after
a warm-up) at the main path's shapes: B1 bf16 [128, 150, 512]
and f32 [64, 150, 512], causal, 4 heads of 128, q, k, v column views of one
packed projection. A variant computes wrong values; only its time means
something: the base time less a variant's is what the part costs, overlap
with the other parts included, and the compiler also drops whatever only
fed the removed part (no_stores loses W V and the weights with the stores,
so it is an upper bound). Also prints the SASS instruction mix of the
flagship instantiation (cuobjdump). Prints one JSON line with the card's
name and power limit. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (variant, [(text in the source, replacement)]): each text must occur once
VARIANTS = {
    "base": [],
    "no_softmax": [("""    row_max(s, m, wmax);
    reduce_max(m);
    exponentiate<T, SF32>(s, m, l, wmax);
    reduce_sum<T, SF32>(l);
    weights<T, SF32>(s, l, wmax);
""", "")],
    "no_products": [
        ("if (active) Mma::scores(", "if (false) Mma::scores("),
        ("      if (active && dc + DC <= p.hdp)\n", "      if (false)\n"),
        ("      else if (active)\n        Mma::template weighted_sum<false>",
         "      else if (false)\n        Mma::template weighted_sum<false>"),
    ],
    "no_copies": [
        ("if (threadIdx.x == 0) mbar_expect_tx(bar, n * row);", ""),
        ("for (int r = threadIdx.x; r < n; r += 32) bulk_copy(",
         "for (int r = threadIdx.x; r < 0; r += 32) bulk_copy("),
    ],
    "no_stores": [
        ("      if (active && staged)\n", "      if (false)\n"),
        ("      else if (active)\n        store_rows<T, DC>",
         "      else if (false)\n        store_rows<T, DC>"),
    ],
}
SHAPES = (("bfloat16", 128), ("float32", 64))
FLAGSHIP = "attention_fwd_kernelI13__nv_bfloat16Li160ELb0ELb0ELb0E"


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the ablation no longer matches the source: {old!r}")
        src = src.replace(old, new)
    return src


def build(out: Path):
    from regennet_torch.ops import kernels

    src = (kernels.CSRC / "attention_fwd.cu").read_text()
    for header in kernels.sources("attention_fwd")[1:]:
        (out / header.name).write_text(header.read_text())
    procs = {}
    for name, edits in VARIANTS.items():
        (out / f"{name}.cu").write_text(variant_source(src, edits))
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
               str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")


def sass_mix(lib: Path):
    """Static instruction counts of the flagship instantiation, by opcode."""
    from regennet_torch.ops import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass):
        if FLAGSHIP in fn.splitlines()[0]:
            ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
            return dict(ops.most_common(20))
    return {}


def device_us(lib, dtype, batch):
    """Mean device time of one launch, in microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from regennet_torch.ops import attention

    T, D, H = 150, 512, 4
    hd = D // H
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn(batch, T, 3 * D, device="cuda", generator=gen).to(td).split(D, -1)
    out = torch.empty(batch, T, D, device="cuda", dtype=td)
    strides = [(x.stride(0), hd, x.stride(1), x.stride(2)) for x in (q, k, v, out)]
    a = attention.forward_args((batch, H, T, hd), strides, td, [x.data_ptr() for x in (q, k, v)],
                               float(torch.tensor(hd ** -0.5, dtype=td)), 1.0, True, None, False)

    def call():
        rc = lib.attention_forward(
            a.dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), a.batch, a.seq,
            a.heads, a.hd, a.hdp, *a.strides, a.scale_q, a.score_scale, a.causal, a.kv_len,
            a.softmax_f32, a.copy_bytes, None, 0, 0, 1.0, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "attention_fwd" in e.key)
    return total / 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_attention_fwd: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from regennet_torch.ops import attention

    result = {"card": chip_smoke.card_line(), "device_us": {}}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        build(out)
        result["sass_flagship"] = sass_mix(out / "base.so")
        for name in VARIANTS:
            lib = ctypes.CDLL(str(out / f"{name}.so"))
            for fn, (restype, argtypes) in attention.PROTOTYPES["attention_fwd"].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            for dtype, batch in SHAPES:
                us = device_us(lib, dtype, batch)
                result["device_us"][f"{dtype} B={batch} {name}"] = us
                print(f"  {dtype} [{batch}, 150, 512] {name}: {us:.1f} us", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
