"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here is marked `cuda` and skips without a CUDA device. The
file imports no JAX, so it also runs where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
Tolerances as in tests/test_torch_attention.py.
"""

import math

import numpy as np
import pytest
import torch

from regennet_torch.ops import attention

DTYPE_MODES = [("float32", False), ("bfloat16", False), ("bfloat16", True)]
MASKS = ["causal", "full", "kv_len"]


def _tolerance(dtype, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    return (1e-5 if dtype == "float32" else 2.0 ** -6) * scale


def _longest_rows(qt, dtype, softmax_f32, hd=128):
    """The longest rows (keys) that the stored-row routes of both kernels
    take in blocks of `qt` query rows at head dim `hd` (attention_mma.cuh
    stored_block): qt rows of P in the score dtype beside qt rows of q and
    a slab of one group of 32 keys, in the device's shared memory."""
    cap = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    elem = 4 if dtype == "float32" else 2
    score = 4 if dtype == "float32" or softmax_f32 else 2
    row = (hd + 16 // elem) * elem  # a shared row, padded by 16 bytes
    return (cap - (qt + 32) * row - 16) // (qt * score) // 32 * 32


# sequence lengths at the stored-row route's edges: its first rows (161
# keys), 7 whole groups (224) and one key into the 8th (225), with the key
# count as causal rows see it (T) and as kv_len = T - 10 leaves it (T + 10)
EDGES = [161, 171, 197, 224, 225, 234, 235]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [60, 151, 161, 168, 197, 224, 225, 231, 232, 1024])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_cuda_kernel_matches_plain_version(T, mask, dtype, softmax_f32):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    batch, dmodel, heads = 8, 512, 4
    gen = torch.Generator(device="cuda").manual_seed(T)
    packed = torch.randn(batch, T, 3 * dmodel, device="cuda", generator=gen)
    packed = packed.to(getattr(torch, dtype))
    q, k, v = packed.split(dmodel, dim=-1)
    causal = mask == "causal"
    kv_len = T - 7 if mask == "kv_len" else None  # (168, 231, 232: 161, 224, 225 keys)
    before = attention.fused_attention_btd.launches
    out = attention.fused_attention_btd(q, k, v, heads, causal, softmax_f32, kv_len)
    torch.cuda.synchronize()
    assert attention.fused_attention_btd.launches == before + 1
    ref = attention.attention_btd_reference(q, k, v, heads, causal, softmax_f32, kv_len)
    ref_np = ref.float().cpu().numpy()
    np.testing.assert_allclose(
        out.float().cpu().numpy(), ref_np, rtol=0,
        atol=_tolerance(dtype, ref_np),
    )
    assert math.isfinite(float(out.float().abs().max()))


def _train_case(B, T, dtype, causal, kv_len, rate, softmax_f32=False, seed=0, offset=0,
                heads=4, hd=128, head0=None):
    """Kernel and plain version of the training attention on the same
    packed inputs (q, k, v column views starting `offset` elements into each
    row; `heads` heads of `hd`; head0: [B, 3] seeds whose heads are those
    from head0 of a larger model): (out, grads) of each, then the grads of
    the backward kernel's plain version."""
    dmodel = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed + T)
    td = getattr(torch, dtype)
    packed = torch.randn(B, T, 3 * dmodel + offset, device="cuda", generator=gen).to(td)
    dout = torch.randn(B, T, dmodel, device="cuda", generator=gen).to(td)
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, 2), device="cuda",
                          generator=gen, dtype=torch.int32)
    if head0 is not None:
        seeds = torch.cat([seeds, torch.full((B, 1), head0, dtype=torch.int32,
                                             device="cuda")], dim=1)
    results = []
    for fn in (attention.fused_attention_btd_train,
               attention.attention_btd_train_reference):
        x = packed.clone().requires_grad_()
        q, k, v = x[..., offset:].split(dmodel, dim=-1)
        out = fn(q, k, v, heads, rate, seeds, causal, softmax_f32, kv_len)
        out.backward(dout)
        results.append((out.detach(), x.grad[..., offset:].split(dmodel, dim=-1)))
    q, k, v = packed[..., offset:].split(dmodel, dim=-1)
    results.append(attention.attention_btd_train_backward_reference(
        q, k, v, dout, heads, rate, seeds, causal, softmax_f32, kv_len))
    return results


def _check_train_case(B, T, dtype, causal, kv_len, rate, softmax_f32=False, offset=0,
                      heads=4, hd=128, head0=None):
    """_train_case's kernels against both plain versions, with the launch
    counters: one forward and one backward launch, none of B1's."""
    fn = attention.fused_attention_btd_train
    before = (fn.launches, fn.backward_launches, attention.fused_attention_btd.launches)
    (out, grads), (ref, ref_grads), plain_grads = _train_case(
        B, T, dtype, causal, kv_len, rate, softmax_f32, offset=offset, heads=heads, hd=hd,
        head0=head0)
    torch.cuda.synchronize()
    assert (fn.launches, fn.backward_launches, attention.fused_attention_btd.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    for name, ours, theirs in zip(("out", "dq", "dk", "dv"), (out, *grads),
                                  (ref, *ref_grads)):
        theirs_np = theirs.float().cpu().numpy()
        np.testing.assert_allclose(
            ours.float().cpu().numpy(), theirs_np, rtol=0,
            atol=_tolerance(dtype, theirs_np), err_msg=name,
        )
    for name, ours, theirs in zip(("dq", "dk", "dv"), grads, plain_grads):
        theirs_np = theirs.float().cpu().numpy()
        np.testing.assert_allclose(
            ours.float().cpu().numpy(), theirs_np, rtol=0,
            atol=_tolerance(dtype, theirs_np), err_msg=f"plain backward {name}",
        )


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 60, 64, 65, 150, 151, 160, *EDGES, 256])
@pytest.mark.parametrize("mask", ["causal", "kv_len"])
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_cuda_train_kernels_match_plain_version(T, mask, dtype, softmax_f32, rate):
    """Every route of the forward kernel and of the backward's row pass (P
    in registers for rows of up to 64 or 160 keys, in shared memory past
    them; the stored-row route at its edges), with and without dropout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    causal = mask == "causal"
    _check_train_case(8, T, dtype, causal, None if causal else T - 10, rate, softmax_f32)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["causal", "kv_len"])
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_cuda_train_kernels_at_1024_keys(mask, dtype, softmax_f32, rate):
    """T 1024: both kernels' stored-row routes take several chunks of scores
    and several slabs of keys and values (f32 and an f32 softmax in blocks
    of 32 rows), the backward's column pass a long walk over the queries; as
    test_cuda_train_kernels_match_plain_version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    causal = mask == "causal"
    _check_train_case(8, 1024, dtype, causal, None if causal else 1014, rate, softmax_f32)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,hd", [(4, 16), (4, 32), (4, 40), (8, 64), (2, 256)])
@pytest.mark.parametrize("T", [60, 151, 197])
@pytest.mark.parametrize("mask", ["causal", "kv_len"])
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_train_kernels_at_other_head_dims(heads, hd, T, mask, dtype, softmax_f32, rate):
    """The backward's column pass at the learning guard's head dim (16:
    latent 64 over 4 heads), the full-scale capability study's (32: latent
    128 over 4 heads), a padded head dim (40: 48 columns of
    products), half the models' (64) and the widest a launch takes (256:
    two sweeps of 128 columns), with the forward and the row pass at the
    same shapes (T 197: the row pass with P in shared memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    causal = mask == "causal"
    _check_train_case(8, T, dtype, causal, None if causal else T - 10, rate, softmax_f32,
                      heads=heads, hd=hd)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(2, 2048), (1, 3232), (1, "longest at 64 rows"),
                                 (1, "longest at 32 rows"), (1, "longest at 16 rows")])
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_cuda_train_kernels_at_the_longest_rows(B, T, dtype, softmax_f32):
    """Both kernels' stored-row routes with P in shared memory in blocks of
    16 rows (f32 and an f32 softmax at T 2048; bf16 with a bf16 softmax in
    blocks of 32), at 3,232 keys (f32 at head dim 128: its longest, 16 rows
    of P, 16 of q and a group of 32 keys in 227 KB), and at each dtype's
    longest rows for blocks of 64, 32 and 16 rows (_longest_rows: f32 704,
    1,536, 3,232; bf16 1,600, 3,328, 6,848; bf16 with an f32 softmax 800,
    1,664, 3,424), causal, rate 0.1, one head of 128.
    The output and the gradients are held against the plain versions at
    this file's tolerances, and the gradients against autograd of the plain
    forward as chip_smoke phase 2b holds them (gradient_tolerance: at bf16
    the plain backward's own distance from autograd plus 2^-7 x max(1,
    max|plain backward|); at 2,048 keys that distance alone passes 2^-6)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    import chip_smoke

    if isinstance(T, str):
        T = _longest_rows(int(T.split()[-2]), dtype, softmax_f32)
    fn = attention.fused_attention_btd_train
    before = (fn.launches, fn.backward_launches)
    (out, grads), (ref, ref_grads), plain_grads = _train_case(
        B, T, dtype, True, None, 0.1, softmax_f32, heads=1)
    torch.cuda.synchronize()
    assert (fn.launches, fn.backward_launches) == (before[0] + 1, before[1] + 1)
    ref_np = ref.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_np, rtol=0,
                               atol=_tolerance(dtype, ref_np), err_msg="out")
    for name, ours, autograd, plain in zip(("dq", "dk", "dv"), grads, ref_grads, plain_grads):
        plain_np = plain.float().cpu().numpy()
        np.testing.assert_allclose(ours.float().cpu().numpy(), plain_np, rtol=0,
                                   atol=_tolerance(dtype, plain_np),
                                   err_msg=f"plain backward {name}")
        chip_smoke.hold_gradient(name, ours, autograd, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_cuda_train_backward_raises_past_its_longest_rows(dtype, softmax_f32):
    """Rows one key longer than the stored-row routes take at head dim 128
    (f32: 3,233 keys) raise from the backward's launch; the forward takes
    its three-pass route there, and B1 and B2 (rate 0.5, a key mask:
    kv_len = T - 10) match their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    B, hd = 1, 128
    kv_len = _longest_rows(16, dtype, softmax_f32) + 1
    T = kv_len + 10
    gen = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(B, T, 3 * hd, device="cuda", generator=gen)
    x = x.to(getattr(torch, dtype)).requires_grad_()
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (B, 2), device="cuda", generator=gen,
                          dtype=torch.int32)
    q, k, v = x.split(hd, dim=-1)
    fn = attention.fused_attention_btd_train
    before = fn.launches
    out = fn(q, k, v, 1, 0.5, seeds, False, softmax_f32, kv_len)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    with torch.no_grad():
        for ours, plain in (
                (out.detach(), attention.attention_btd_train_reference(
                    q, k, v, 1, 0.5, seeds, False, softmax_f32, kv_len)),
                (attention.fused_attention_btd(q, k, v, 1, False, softmax_f32, kv_len),
                 attention.attention_btd_reference(q, k, v, 1, False, softmax_f32, kv_len))):
            plain_np = plain.float().cpu().numpy()
            np.testing.assert_allclose(ours.float().cpu().numpy(), plain_np, rtol=0,
                                       atol=_tolerance(dtype, plain_np))
    before = fn.backward_launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        out.backward(torch.ones_like(out))
    assert fn.backward_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("offset,dtype", [(1, "bfloat16"), (2, "bfloat16"), (1, "float32")])
def test_cuda_train_kernels_on_unaligned_views(offset, dtype):
    """Views that start `offset` elements into a row: the forward takes
    copies narrower than 16 bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    _check_train_case(4, 151, dtype, True, None, 0.1, offset=offset)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [60, 150, 200])
@pytest.mark.parametrize("dtype,softmax_f32", DTYPE_MODES)
def test_cuda_train_kernels_with_a_head_offset_seed(T, dtype, softmax_f32):
    """[B, 3] seeds (tensor parallelism: a rank's 2 heads of 128 are heads
    2 and 3 of the model) on both kernels, against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    _check_train_case(3, T, dtype, True, None, 0.1, softmax_f32, heads=2, head0=2)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [48, 200])
def test_cuda_train_forward_mask_with_a_head_offset(T):
    """The forward kernel's mask under a [B, 3] seed is the whole model's
    dropout_bits at the heads from the offset."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    import chip_smoke

    B, H = 2, chip_smoke.FLAGSHIP["heads"]
    seeds = torch.tensor([[7, -1], [2 ** 30, 5]], dtype=torch.int32, device="cuda")
    offset = torch.cat([seeds, torch.full((B, 1), 3, dtype=torch.int32, device="cuda")], 1)
    kept = chip_smoke.train_mask(B, T, 0.5, offset, True)
    seen = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    bits = attention.dropout_bits(seeds, B, H + 3, T)[:, 3:]
    assert torch.equal(kept, (bits >= attention.dropout_threshold(0.5)) & seen)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [48, 128, 200])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_cuda_train_forward_mask_equals_dropout_bits(T, causal, rate):
    """The forward kernel's kept weights on each route (T 48: a chunk of 64
    keys; 128: a chunk of 160; 200: the rows of P in shared memory), read
    from its output by chip_smoke.train_mask (one launch for each 128
    keys)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    import chip_smoke

    B, H = 4, chip_smoke.FLAGSHIP["heads"]
    seeds = torch.tensor([[7, -1], [2 ** 30, 5], [-9, 123456], [0, 1]], dtype=torch.int32,
                         device="cuda")
    fn = attention.fused_attention_btd_train
    before = fn.launches
    kept = chip_smoke.train_mask(B, T, rate, seeds, causal)
    torch.cuda.synchronize()
    assert fn.launches == before + -(-T // 128)
    seen = torch.ones(T, T, dtype=torch.bool, device="cuda")
    if causal:
        seen = seen.tril()
    want = (attention.dropout_bits(seeds, B, H, T) >= attention.dropout_threshold(rate)) & seen
    assert torch.equal(kept, want)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 151, 161, 197, 224, 225, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_causal_attention_matches_plain_version(T, causal, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    gen = torch.Generator(device="cuda").manual_seed(T)
    q, k, v = (torch.randn(2, 4, T, 128, device="cuda", generator=gen)
               .to(getattr(torch, dtype)) for _ in range(3))
    before = attention.fused_causal_attention.launches
    out = attention.fused_causal_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert attention.fused_causal_attention.launches == before + 1
    ref = attention.attention_reference(q, k, v, causal).float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref, rtol=0,
                               atol=_tolerance(dtype, ref))


@pytest.mark.cuda
def test_cuda_train_kernels_are_deterministic_and_match_plain_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    first = _train_case(4, 150, "float32", True, None, 0.1)[0]
    again = _train_case(4, 150, "float32", True, None, 0.1)[0]
    for a, b in zip((first[0], *first[1]), (again[0], *again[1])):
        assert torch.equal(a, b)
    # the plain bits computed on the card equal those computed on the CPU
    seeds = torch.tensor([[5, -3], [2 ** 30, 7]], dtype=torch.int32)
    torch.testing.assert_close(
        attention.dropout_bits(seeds.cuda(), 2, 4, 33).cpu(),
        attention.dropout_bits(seeds, 2, 4, 33), rtol=0, atol=0)


def _b3_tolerance(dtype, ref):
    """fused_causal_attention rounds where its plain version does: at bf16
    one output ulp."""
    scale = max(1.0, float(np.abs(ref).max()))
    return (1e-5 if dtype == "float32" else 2.0 ** -8) * scale


def _check_forward(q, k, v, heads, causal, kv_len, dtype):
    """The forward kernel through fused_attention_btd on [B, T, D] views,
    and, without a key-length mask, through fused_causal_attention on the
    same data read as [B, H, T, hd] views; each against its plain version,
    with its launch counter."""
    before = attention.fused_attention_btd.launches
    out = attention.fused_attention_btd(q, k, v, heads, causal, False, kv_len)
    torch.cuda.synchronize()
    assert attention.fused_attention_btd.launches == before + 1
    ref = attention.attention_btd_reference(q, k, v, heads, causal, False, kv_len)
    ref_np = ref.float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref_np, rtol=0,
                               atol=_tolerance(dtype, ref_np))
    if kv_len is not None:
        return
    B, T, D = q.shape
    q4, k4, v4 = (x.view(B, T, heads, D // heads).transpose(1, 2) for x in (q, k, v))
    before = attention.fused_causal_attention.launches
    out = attention.fused_causal_attention(q4, k4, v4, causal)
    torch.cuda.synchronize()
    assert attention.fused_causal_attention.launches == before + 1
    ref = attention.attention_reference(q4, k4, v4, causal).float().cpu().numpy()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref, rtol=0,
                               atol=_b3_tolerance(dtype, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16, 64])
@pytest.mark.parametrize("T", [16, 20, 60, 150, 151, 197, 256, 512])
@pytest.mark.parametrize("hd", [16, 32, 40, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", MASKS)
def test_cuda_forward_kernel_matches_plain_versions(B, T, hd, dtype, mask):
    """attention_fwd.cu at every sequence length (one chunk of keys in
    registers, or the rows of P in shared memory), head dim (padded to 16 or
    not) and mask, on packed [B, T, 3D] views with 2 heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    heads = 2
    D = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(T * hd + B)
    packed = torch.randn(B, T, 3 * D, device="cuda", generator=gen).to(getattr(torch, dtype))
    q, k, v = packed.split(D, dim=-1)
    _check_forward(q, k, v, heads, mask == "causal", T - 7 if mask == "kv_len" else None,
                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,dtype,width", [
    (1, "bfloat16", 2), (2, "bfloat16", 4), (4, "bfloat16", 8),
    (1, "float32", 4), (2, "float32", 8), (0, "float32", 16),
])
@pytest.mark.parametrize("mask", MASKS)
def test_cuda_forward_kernel_on_unaligned_views(offset, dtype, width, mask):
    """Views that start `offset` elements into a row take narrower copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    B, T, heads, hd = 4, 151, 4, 64
    D = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(offset)
    packed = torch.randn(B, T, 3 * D + 8, device="cuda", generator=gen).to(getattr(torch, dtype))
    q, k, v = packed[..., offset:offset + 3 * D].split(D, dim=-1)
    strides = [(x.stride(0), hd, x.stride(1), 1) for x in (q, k, v)]
    assert attention.kernel_layout((B, heads, T, hd), strides, q.dtype,
                                   [x.data_ptr() for x in (q, k, v)]) == (width, hd)
    _check_forward(q, k, v, heads, mask == "causal", T - 7 if mask == "kv_len" else None,
                   dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 60, 161])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_train_backward_keeps_its_graph_under_create_graph(T, rate):
    """A gradient penalty's second derivative through the kernels: the
    backward under create_graph=True returns gradients with a graph (it
    fails if the kernel's dq, dk, dv come back graph-less), and the
    gradient of a penalty on them equals the plain version's under
    autograd, f32 within 1e-4 x max(1, max|plain|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    B, heads, hd = 4, 4, 64
    dmodel = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn(B, T, 3 * dmodel, device="cuda", generator=gen).requires_grad_()
    w = torch.randn(B, T, dmodel, device="cuda", generator=gen)
    seed = torch.randint(-2 ** 31, 2 ** 31, (B, 2), device="cuda", generator=gen,
                         dtype=torch.int32)
    b2 = attention.fused_attention_btd_train
    grads = {}
    for route, fn in (("kernel", b2), ("plain", attention.attention_btd_train_reference)):
        q, k, v = x.split(dmodel, dim=-1)
        out = fn(q, k, v, heads, rate, seed, causal=False)
        g, = torch.autograd.grad((out * w).sum(), x, create_graph=True)
        assert g.requires_grad and g.grad_fn is not None, route
        before = b2.double_backward_launches
        gg, = torch.autograd.grad((g ** 2).sum(), x)
        if route == "kernel":
            assert b2.double_backward_launches == before + 1
        grads[route] = (g.detach(), gg)
    for a, b in zip(grads["kernel"], grads["plain"]):
        ref = b.cpu().numpy()
        np.testing.assert_allclose(a.cpu().numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.cuda
def test_cuda_train_stgcn_pins_the_f32_contract(tmp_path):
    """train_stgcn.main on the card (the reduced classifier, one epoch of 8
    clips) leaves both TF32 flags False, having started True."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the GPU")
    from argparse import Namespace

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.eval import train_stgcn

    T = 16
    pair = synthetic.make_clip_pair("chi3d", 8, min_len=T + 4, max_len=T + 16, learnable=True)
    data = Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=T, num_person=2)
    args = Namespace(dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
                     glob=True, translation=True, num_frames=T, batch_size=4, lr=1e-3,
                     num_epochs=1, save_every=1, save_dir=str(tmp_path / "stgcn"), seed=0,
                     keep_best=False, stgcn_channels=(8, 8), stgcn_strides=(1, 1))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        train_stgcn.main(args, device="cuda", data=data)
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert flags == (False, False)
