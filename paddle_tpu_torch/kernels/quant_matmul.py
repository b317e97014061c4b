"""Weight-only quantized matmul (counterpart of
``paddle_tpu/kernels/quant_matmul.py``).

``y = x @ dequant(W)``: the weight stays int8 ``[k, n]`` (or int4 packed
two rows per byte, ``[k/2, n]``) in device memory with float32 group
scales ``[k/g, n]``, and is dequantized inside the kernel, so a decode
step streams half (int8) or a quarter (int4) of the bf16 weight bytes.
As in the JAX package, the dequantized weight is rounded to x's dtype
before the product, and the products accumulate in float32.

On the card ``weight_only_matmul`` launches the hand-written Hopper kernel
in ``csrc/quant_matmul.cu`` for every shape it is given; for tensors on
the CPU it runs ``weight_only_matmul_plain``, the port of the JAX
package's ``weight_only_matmul_xla``. A CUDA tensor never falls back to
the plain version: the wrapper launches the kernel or raises.

The quantizers run in torch on the weight's device and give the JAX
package's bytes: ``torch.round`` rounds half to even as ``jnp.round``
does, values are divided by their scale, and int4 nibbles are packed in
int32 before narrowing to int8.
"""

from __future__ import annotations

import ctypes

import torch

from .decode_attention import _ACT_CODE

# kernel launches by ``weight_only_matmul`` in this process: one per call
# on CUDA tensors, none for the plain version
LAUNCHES = 0

# the largest m of the kernel's decode bodies for 16-bit x
# (csrc/quant_matmul.cu: kDecMaxM); larger m takes the wgmma prefill body
SKINNY_MAX_M = 16

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _P]


def quantize_weight_int8_grouped(w: torch.Tensor, group_size: int = 128):
    """Symmetric group-wise int8 along the in (k) axis.

    w: [k, n] -> (q int8 [k, n], scale float32 [k // group_size, n])."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"k={k} not divisible by group_size={group_size}")
    wf = w.float().reshape(k // group_size, group_size, n)
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q.reshape(k, n), scale[:, 0, :]


def _largest_group(k: int, group_size: int) -> int:
    """Largest divisor of ``k`` that is <= group_size (>= 1): the
    suggestion the int4 error message offers."""
    g = min(group_size, k)
    while g > 1 and k % g:
        g -= 1
    return g


def quantize_weight_int4_grouped(w: torch.Tensor, group_size: int = 128):
    """Symmetric group-wise int4, packed two values per int8 byte along k.

    w: [k, n] -> (packed int8 [k // 2, n], scale float32
    [k // group_size, n]). Row 2i lives in the low nibble of packed row
    i, row 2i+1 in the high nibble (the order ``_unpack_int4``
    inverts)."""
    k, n = w.shape
    if k % 2:
        raise ValueError(
            f"int4 packing stores two rows per byte, so the in (k) "
            f"dimension must be even; got k={k}. Pad the weight with "
            f"one zero row (scales are per-group, a zero row is "
            f"exact) or keep this layer at int8.")
    if k % group_size:
        raise ValueError(
            f"k={k} is not divisible by group_size={group_size}: "
            f"group-wise scales cover whole [group_size, n] row "
            f"blocks. Pick a group_size that divides k (e.g. "
            f"group_size={_largest_group(k, group_size)}), or pass "
            f"group_size=k for one degenerate whole-column group — "
            f"WeightOnlyLinear does that fallback automatically.")
    wf = w.float().reshape(k // group_size, group_size, n)
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax / 7.0, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    q = q.reshape(k, n)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)  # 0..255 in int32
    return packed.to(torch.uint8).view(torch.int8), scale[:, 0, :]


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[k//2, n] packed -> [k, n] int32 in [-8, 7] (sign-extended
    nibbles; the low nibble holds the even row)."""
    kk, n = packed.shape
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=1).reshape(2 * kk, n)
    return (nib ^ 8) - 8


def weight_only_matmul_plain(x, qweight, scale, *, group_size=128,
                             weight_dtype="int8"):
    """Plain PyTorch version of the kernel, ported from the JAX package's
    ``weight_only_matmul_xla``: dequantize in float32, round to x's
    dtype, matmul. x [m, k]; returns [m, n] in x's dtype."""
    if weight_dtype == "int4":
        qweight = _unpack_int4(qweight)
    k, n = qweight.shape
    w = qweight.float().reshape(k // group_size, group_size, n)
    w = (w * scale.float()[:, None, :]).reshape(k, n)
    return torch.matmul(x, w.to(x.dtype))


def kernel_body(m: int, n: int, k: int, dtype: torch.dtype) -> str:
    """The body of the kernel that a call of these shapes launches on the
    card (csrc/quant_matmul.cu: launch_t): prefill_kernel (wgmma) or
    decode_tc_kernel (mma.sync over a cluster of k splits) for 16-bit x
    with n and k multiples of 8, decode_kernel (SIMT FMAs) otherwise."""
    if dtype != torch.float32 and n % 8 == 0 and k % 8 == 0:
        return "prefill_kernel" if m > SKINNY_MAX_M else "decode_tc_kernel"
    return "decode_kernel"


def _check(x, qweight, scale, group_size, weight_dtype):
    for name, t in (("x", x), ("qweight", qweight), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dim() != 2 or x.dtype not in _ACT_CODE:
        raise ValueError(f"x must be 2-D in one of {list(_ACT_CODE)}; got "
                         f"{x.dtype} {tuple(x.shape)}")
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be int8 or int4; got "
                         f"{weight_dtype!r}")
    m, k = x.shape
    rows = k // 2 if weight_dtype == "int4" else k
    if qweight.dtype != torch.int8 or qweight.dim() != 2 \
            or qweight.shape[0] != rows or (weight_dtype == "int4" and k % 2):
        raise ValueError(f"{weight_dtype} qweight must be int8 "
                         f"[{rows}, n] for k={k}; got {qweight.dtype} "
                         f"{tuple(qweight.shape)}")
    n = qweight.shape[1]
    if not isinstance(group_size, int) or group_size < 1 or k % group_size:
        raise ValueError(f"group_size={group_size!r} must divide k={k}")
    if scale.dtype != torch.float32 \
            or tuple(scale.shape) != (k // group_size, n):
        raise ValueError(f"scale must be float32 [{k // group_size}, {n}]; "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if m < 1 or n < 1 or k < 1:
        raise ValueError(f"empty product ({m}, {k}) x ({k}, {n})")


def weight_only_matmul(x, qweight, scale, *, group_size=128,
                       weight_dtype="int8"):
    """y = x @ dequant(qweight): x [m, k] in f32, f16 or bf16; qweight
    int8 [k, n] (int8) or [k/2, n] (int4 packed); scale float32
    [k/group_size, n], any ``group_size`` that divides k. Returns [m, n]
    in x's dtype.

    CPU tensors run ``weight_only_matmul_plain``; CUDA tensors launch the
    kernel on the current stream without synchronising, or raise."""
    global LAUNCHES
    if x.device.type == "cpu":
        return weight_only_matmul_plain(x, qweight, scale,
                                        group_size=group_size,
                                        weight_dtype=weight_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, qweight, scale, group_size, weight_dtype)
    from . import _build

    m, k = x.shape
    n = qweight.shape[1]
    fn = _build.library().pt_weight_only_matmul
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), _ACT_CODE[x.dtype], qweight.data_ptr(),
                 int(weight_dtype == "int4"), scale.data_ptr(), y.data_ptr(),
                 m, n, k, group_size, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"weight-only matmul kernel failed to launch: "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return y
