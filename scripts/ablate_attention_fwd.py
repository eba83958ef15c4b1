#!/usr/bin/env python3
"""Where the forward attention kernel's time goes: ablations of
regennet_torch/csrc/attention_fwd.cu on the card.

    python3 scripts/ablate_attention_fwd.py [--root CHECKOUT]

Builds the forward source of CHECKOUT (default: this script's checkout) as
it is and in variants with one part taken out, each into its own library in
a temporary directory; an edit applies to the source and to the headers it
includes (attention_mma.cuh holds the copies). The variants: no_softmax
(the single-chunk routes' softmax), no_recompute (the three-pass route's
passes 2 and 3 keep the scores of pass 1's last chunk in place of scoring
each chunk again), no_products (the tensor-core products of the
single-chunk and three-pass routes), no_copies (the bulk copies into shared
memory) and no_stores (the output stores of those routes). Each variant's
kernel is timed under torch.profiler (device time per call, 20 calls after
a warm-up) for B1 at: bf16 [128, 150, 512] and f32 [64, 150, 512], causal
(the sampling and evaluation shapes), and the text CMDM's f32 and bf16
[64, 197, 512], non-causal (rows past 160 keys: the route the checkout's
dispatch takes there), 4 heads of 128, q, k, v column views of one packed
projection. A variant computes wrong values; only its time means something:
the base time less a variant's is what the part costs, overlap with the
other parts included, and the compiler also drops whatever only fed the
removed part (no_stores loses W V and the weights with the stores, so it is
an upper bound). Also prints each variant's ptxas spill lines (bytes a
thread of spill stores and loads, per instantiation that spills) and the
SASS instruction mix (cuobjdump) of the flagship instantiation and of the
f32 three-pass one (LDL/STL: local-memory loads and stores, the spills).
Prints one JSON line with the card's name and power limit. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

# (variant, [(text in the source or its headers, replacement)]): each text
# must occur somewhere, and every occurrence is replaced
VARIANTS = {
    "base": [],
    "no_softmax": [("""    row_max(s, m, wmax);
    reduce_max(m);
    exponentiate<T, SF32>(s, m, l, wmax);
    reduce_sum<T, SF32>(l);
    weights<T>(s, l, wmax);
""", "")],
    "no_recompute": [("      chunk_scores(c, false);\n", ""),
                     ("    chunk_scores(c, false);\n", "")],
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
        ("    if (active) store_rows<T, DC>(o, ob,", "    if (false) store_rows<T, DC>(o, ob,"),
    ],
}
SHAPES = (  # (dtype, B, T, causal)
    ("bfloat16", 128, 150, True), ("float32", 64, 150, True),
    ("float32", 64, 197, False), ("bfloat16", 64, 197, False))
# the flagship sampling instantiation and the f32 three-pass one
SASS_ENTRIES = ("attention_fwd_kernelI13__nv_bfloat16Li160ELb0ELb0ELb0E",
                "attention_fwd_kernelIfLi160ELb1ELb1ELb0E")


def variant_sources(sources, edits):
    """{name: text} of the source and its headers after `edits`."""
    sources = dict(sources)
    for old, new in edits:
        if not any(old in text for text in sources.values()):
            raise RuntimeError(f"the ablation no longer matches the source: {old!r}")
        sources = {name: text.replace(old, new) for name, text in sources.items()}
    return sources


def spills(log):
    """{instantiation: "S bytes spill stores, L bytes spill loads"} of the
    instantiations that spill, from nvcc -Xptxas -v's log."""
    found, entry = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = re.sub(r"^.*?_cu_[0-9a-f]+\d+", "", line.split("'")[1])[:60]
        elif "spill stores" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            found[entry] = line.split(",", 1)[1].strip()
    return found


def build(out: Path, root: Path):
    """Every variant of CHECKOUT `root`'s forward source, built in parallel
    into out/<variant>/lib.so; returns {variant: its spills}."""
    from regennet_torch.ops import kernels

    csrc = root / "regennet_torch" / "csrc"
    names = ["attention_fwd.cu"] + sorted(p.name for p in csrc.glob("*.cuh"))
    sources = {name: (csrc / name).read_text() for name in names}
    procs = {}
    for variant, edits in VARIANTS.items():
        folder = out / variant
        folder.mkdir()
        for name, text in variant_sources(sources, edits).items():
            (folder / name).write_text(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(folder / "lib.so"),
               str(folder / "attention_fwd.cu")]
        procs[variant] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True)
    found = {}
    for variant, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        found[variant] = spills(log)
    return found


def sass_mix(lib: Path):
    """{instantiation: static instruction counts by opcode} of
    SASS_ENTRIES found in the library."""
    from regennet_torch.ops import kernels

    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for fn in re.split(r"\n\s+Function : ", sass):
        for entry in SASS_ENTRIES:
            if entry in fn.splitlines()[0]:
                ops = collections.Counter(m.group(1).split(".")[0] for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", fn))
                found[entry] = dict(ops.most_common(20), LDL=ops["LDL"], STL=ops["STL"])
    return found


def device_us(lib, dtype, batch, T, causal):
    """Mean device time of one B1 launch at [batch, T, 512], in
    microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from regennet_torch.ops import attention

    D, H = 512, 4
    hd = D // H
    td = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = torch.randn(batch, T, 3 * D, device="cuda", generator=gen).to(td).split(D, -1)
    out = torch.empty(batch, T, D, device="cuda", dtype=td)
    strides = [(x.stride(0), hd, x.stride(1), x.stride(2)) for x in (q, k, v, out)]
    a = attention.forward_args((batch, H, T, hd), strides, td, [x.data_ptr() for x in (q, k, v)],
                               float(torch.tensor(hd ** -0.5, dtype=td)), 1.0, causal, None,
                               False)

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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(REPO))
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ablate_attention_fwd: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from regennet_torch.ops import attention

    result = {"root": opts.root, "card": chip_smoke.card_line(), "device_us": {}}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        result["spills"] = build(out, Path(opts.root))
        result["sass"] = sass_mix(out / "base" / "lib.so")
        for name in VARIANTS:
            lib = ctypes.CDLL(str(out / name / "lib.so"))
            for fn, (restype, argtypes) in attention.PROTOTYPES["attention_fwd"].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            for dtype, batch, T, causal in SHAPES:
                us = device_us(lib, dtype, batch, T, causal)
                shape = f"{dtype} [{batch}, {T}, 512] {'causal' if causal else 'non-causal'}"
                result["device_us"][f"{shape} {name}"] = us
                print(f"  {shape} {name}: {us:.1f} us", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
