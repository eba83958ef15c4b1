"""Device operations grouped by name, for the traced run's breakdown: a
frozen copy of chip_smoke.TRAIN_KERNEL_GROUPS and chip_smoke._kernel_group
at commit b14d20cb6bbaa9fb4189ca13e12634674eb6d23e, with memory copies
and sets named apart. The breakdown only: no metric reads a kernel's
name."""

TRAIN_KERNEL_GROUPS = (  # (group, substrings of CUDA kernel names), first match wins
    ("dense GEMMs (cuBLAS)", ("gemm", "Gemm", "xmma", "cutlass", "nvjet")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("random draws (dropout masks, seeds, noise)", ("distribution", "philox", "Philox")),
    ("AdamW and EMA (foreach)", ("multi_tensor_apply",)),
    ("indexing (joint decode levels, gathers)", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
)


def kernel_group(name):
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name.split(" ", 1)[0]
    if "attention_fwd_kernel<" in name:
        # the last template argument is DROP: the training forward's dropout
        # (at rate 0 the training forward runs B1's instantiation)
        args = name.split("attention_fwd_kernel<", 1)[1].split(">", 1)[0]
        return ("training attention forward" if args.endswith("true")
                else "attention forward (B1, B3)")
    if "attention_fwd_stored<" in name:
        args = name.split("attention_fwd_stored<", 1)[1].split(">", 1)[0]
        return ("training attention forward" if args.endswith("true")
                else "attention forward (B1, B3)")
    if "attention_train_rows" in name or "attention_train_cols" in name:
        return "training attention backward"
    return next((g for g, keys in TRAIN_KERNEL_GROUPS if any(k in name for k in keys)),
                "other elementwise")
