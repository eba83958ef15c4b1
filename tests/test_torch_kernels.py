"""The port's kernel build and binding, checked on the CPU without nvcc:
every source is built, a header edit rebuilds what includes it, each
library's ctypes prototypes match the C functions in its source, and the
forward kernel's layout rule (copy width, padded head dim, what raises)."""

import ctypes
import re

import pytest
import torch

from regennet_torch.ops import attention, kernels

# ctypes type of each C parameter or return type the sources use
C_TYPES = {
    "int": ctypes.c_int,
    "unsigned int": ctypes.c_uint,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
    "const char*": ctypes.c_char_p,
}


def _c_type(decl: str):
    """The ctypes type of a C declaration such as `const void* q`."""
    if "*" in decl:
        pointee = decl.split("*")[0].split()
        return ctypes.c_char_p if pointee == ["const", "char"] else ctypes.c_void_p
    return C_TYPES[" ".join(decl.split()[:-1])]  # the words before the name


def _extern_c_prototypes(name):
    """{function: (restype, [argtypes])} of the extern "C" block of
    csrc/<name>.cu."""
    text = (kernels.CSRC / f"{name}.cu").read_text()
    block = text[text.index('extern "C" {'):]
    found = {}
    for ret, fn, params in re.findall(
            r"^(int|const char\*)\s+(\w+)\(([^)]*)\)\s*\{", block, re.M):
        found[fn] = (_c_type(ret + " r"), [_c_type(p) for p in params.split(",")])
    return found


def test_every_source_is_built():
    sources = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    assert sorted(kernels.KERNELS) == sources
    assert sorted(attention.PROTOTYPES) == sources


@pytest.mark.parametrize("name", kernels.KERNELS)
def test_prototypes_match_the_c_functions(name):
    parsed = _extern_c_prototypes(name)
    assert parsed, f"no extern C functions found in {name}.cu"
    declared = attention.PROTOTYPES[name]
    assert sorted(parsed) == sorted(declared)
    for fn, (restype, argtypes) in declared.items():
        want_ret, want_args = parsed[fn]
        assert restype is want_ret, fn
        assert len(argtypes) == len(want_args), fn
        for i, (ours, theirs) in enumerate(zip(argtypes, want_args)):
            assert ours is theirs, f"{fn} argument {i}: {ours} vs {theirs}"


def test_library_path_follows_included_headers(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return 0; }\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    first = kernels.library_path("k")
    assert kernels.sources("k") == [tmp_path / n for n in ("k.cu", "a.cuh", "b.cuh")]
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = kernels.library_path("k")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint f() { return 1; }\n')
    assert len({first, second, kernels.library_path("k")}) == 3
    assert first.parent == kernels.BUILD and first.name.startswith("k-")


def test_real_sources_hash_the_shared_header():
    for name in kernels.KERNELS:
        for header in ("attention_math.cuh", "attention_mma.cuh"):
            assert kernels.CSRC / header in kernels.sources(name)


def _layout(x, heads, dtype):
    """kernel_layout of q, k, v = x.split(D) read as [B, H, T, hd]."""
    D = x.shape[-1] // 3
    q, k, v = x.split(D, dim=-1)
    B, T, _ = q.shape
    hd = D // heads
    return attention.kernel_layout(
        (B, heads, T, hd), [(y.stride(0), hd, y.stride(1), y.stride(2)) for y in (q, k, v)],
        dtype, [y.data_ptr() for y in (q, k, v)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_of_the_models_packed_views(dtype):
    # the model's packed QKV projection: [B, T, 3D], D = 512, 4 heads
    x = torch.zeros(2, 150, 3 * 512, dtype=dtype)
    assert _layout(x, 4, dtype) == (16, 128)
    # contiguous [B, H, T, hd] tensors (fused_causal_attention's path)
    q = torch.zeros(2, 4, 151, 128, dtype=dtype)
    assert attention.kernel_layout(q.shape, [q.stride()] * 3, dtype,
                                   [q.data_ptr()] * 3) == (16, 128)


@pytest.mark.parametrize("dtype,offset,width", [
    (torch.bfloat16, 1, 2), (torch.bfloat16, 2, 4), (torch.bfloat16, 4, 8),
    (torch.bfloat16, 8, 16), (torch.float32, 1, 4), (torch.float32, 2, 8),
    (torch.float32, 4, 16),
])
def test_layout_of_misaligned_views(dtype, offset, width):
    x = torch.zeros(2, 20, 3 * 256 + 8, dtype=dtype)
    assert _layout(x[..., offset:offset + 3 * 256], 4, dtype) == (width, 64)


@pytest.mark.parametrize("dtype,hd,row,width,padded", [
    (torch.bfloat16, 40, 3 * 80, 16, 48),   # 80-byte rows
    (torch.bfloat16, 36, 3 * 72, 8, 48),    # 72-byte rows
    (torch.bfloat16, 33, 3 * 66, 2, 48),    # odd head dim
    (torch.float32, 33, 3 * 66, 4, 48),
    (torch.float32, 256, 3 * 512, 16, 256),
    (torch.float32, 1, 3 * 2, 4, 16),
])
def test_layout_pads_the_head_dim(dtype, hd, row, width, padded):
    x = torch.zeros(2, 7, row, dtype=dtype)
    assert _layout(x, 2, dtype) == (width, padded)


def test_layout_raises_where_the_wrapper_did():
    q = torch.zeros(2, 4, 10, 8)
    strides = [q.stride()] * 3
    with pytest.raises(ValueError, match="exceeds"):
        attention.kernel_layout((2, 1, 10, 257), strides, torch.float32, [0] * 3)
    with pytest.raises(ValueError, match="grid"):
        attention.kernel_layout((65536, 4, 10, 8), strides, torch.float32, [0] * 3)
    with pytest.raises(ValueError, match="grid"):
        attention.kernel_layout((2, 65536, 10, 8), strides, torch.float32, [0] * 3)
    with pytest.raises(ValueError, match="grid"):
        attention.kernel_layout((2, 4, 0, 8), strides, torch.float32, [0] * 3)
    with pytest.raises(ValueError, match="k must be contiguous"):
        attention.kernel_layout((2, 4, 10, 8), [q.stride(), (320, 80, 8, 2), q.stride()],
                                torch.float32, [0] * 3)
    # the largest shapes it takes
    assert attention.kernel_layout((65535, 65535, 1, 256), strides, torch.bfloat16,
                                   [0] * 3) == (16, 256)


def test_wrappers_refuse_other_devices():
    q = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.fused_attention_btd(q, q, q, 2)
    q4 = torch.zeros(1, 2, 4, 8, device="meta")
    with pytest.raises(ValueError, match="no attention kernel"):
        attention.fused_causal_attention(q4, q4, q4)


def test_training_forward_runs_through_attention_forward():
    """The training forward has no entry of its own: attention_forward takes
    the seed, its layout, the threshold and the keep scale before the
    stream."""
    for where in (_extern_c_prototypes("attention_btd_train"),
                  attention.PROTOTYPES["attention_btd_train"]):
        assert "attention_train_forward" not in where
    _, args = _extern_c_prototypes("attention_fwd")["attention_forward"]
    assert args[-5:] == [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
                         ctypes.c_void_p]


def _train_args(x, dtype, cfg, seed_shape=(2, 2)):
    """train_forward_args of q, k, v = x.split(D)."""
    q, k, v = x.split(x.shape[-1] // 3, dim=-1)
    return attention.train_forward_args(q.shape, [y.stride() for y in (q, k, v)], dtype,
                                        [y.data_ptr() for y in (q, k, v)], seed_shape, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_training_forward_args_of_the_models_packed_views(dtype, rate):
    # the model's packed QKV projection: [B, T, 3D], D = 512, 4 heads
    x = torch.zeros(2, 150, 3 * 512, dtype=dtype)
    cfg = attention._TrainConfig(4, rate, True, False, 0)
    args = _train_args(x, dtype, cfg)
    # B1's head strides (column slices of D) and copy width on the same
    # views, into a contiguous [B, T, D] output
    q, k, v = x.split(512, dim=-1)
    out = torch.empty(2, 150, 512, dtype=dtype)
    b1 = attention.forward_args(
        (2, 4, 150, 128), [(y.stride(0), 128, y.stride(1), y.stride(2)) for y in (q, k, v, out)],
        dtype, [y.data_ptr() for y in (q, k, v)], attention._scale_in(dtype, 128), 1.0, True,
        None, False)
    assert args._replace(seed_per_row=0, threshold=0, keep_w=1.0) == b1
    assert args.strides == (150 * 1536, 128, 1536) * 3 + (150 * 512, 128, 512)
    assert (args.copy_bytes, args.hdp, args.kv_len, args.causal) == (16, 128, 0, 1)
    assert args.threshold == (attention.dropout_threshold(rate) if rate > 0 else 0)
    assert args.keep_w == float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype))
    assert args.seed_per_row == 1
    assert _train_args(x, dtype, cfg, seed_shape=(2,)).seed_per_row == 0


def test_training_forward_args_carry_the_config():
    x = torch.zeros(3, 60, 3 * 256, dtype=torch.bfloat16)
    args = _train_args(x, torch.bfloat16, attention._TrainConfig(2, 0.1, False, True, 50))
    assert (args.dtype, args.batch, args.seq, args.heads, args.hd) == (1, 3, 60, 2, 128)
    assert (args.causal, args.kv_len, args.softmax_f32, args.score_scale) == (0, 50, 1, 1.0)
    assert args.scale_q == attention._scale_in(torch.bfloat16, 128)
    assert args.threshold == 429496729 and args.keep_w == 1.109375


@pytest.mark.parametrize("dtype,offset,width", [
    (torch.bfloat16, 1, 2), (torch.bfloat16, 4, 8), (torch.float32, 1, 4),
    (torch.float32, 4, 16),
])
def test_training_forward_args_of_misaligned_views(dtype, offset, width):
    x = torch.zeros(2, 20, 3 * 256 + 8, dtype=dtype)[..., offset:offset + 3 * 256]
    cfg = attention._TrainConfig(4, 0.1, True, False, 0)
    assert _train_args(x, dtype, cfg).copy_bytes == _layout(x, 4, dtype)[0] == width
