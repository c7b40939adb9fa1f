"""Batched L2 / inner-product distances, the port of the JAX package's
ops/distance.py.

One function, (Q, D) queries x (B, D) points -> (Q, B) squared L2 in fp32,
in the reference's formula and order:

    max((||q||^2 + ||p||^2) - 2 q.p, 0)

Two versions of it:
  - l2_distance_plain: norms, one fp32 matrix product (TF32 off on CUDA,
    as the JAX package's Precision.HIGHEST), the clamp;
  - l2_distance_cuda: kernel K6 (csrc/l2_distance.cu), register-tiled FFMA.
l2_distance routes a CPU tensor to the plain version and a CUDA tensor to
the kernel (use_pallas=False keeps the plain matmul form on CUDA); there is
no fallback between them. Arrays that are not tensors go to `device`, which
is CUDA unless the caller asks for the CPU (cuda_lib.default_device).

With integer-valued inputs in [0, 255] and D <= 128 every partial sum is
below 2^24, so the two versions and the JAX package agree bit for bit
whatever their order of summation.
"""

from __future__ import annotations

import ctypes

import torch

from pacmann_tpu_torch.utils import cuda_lib

# the inner product's int64 products per chunk (bounds its scratch memory)
_IP_CHUNK = 1 << 24


def _f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.float32)


def l2_distance_plain(queries, points, device=None) -> torch.Tensor:
    """Plain torch version: (Q, D) x (B, D) -> (Q, B) squared L2, f32, on
    `device` (as in l2_distance)."""
    dev = cuda_lib.default_device(queries, device)
    q, p = _f32(queries, dev), _f32(points, dev)
    qn = (q * q).sum(dim=-1, keepdim=True)                 # (Q, 1)
    pn = (p * p).sum(dim=-1, keepdim=True).T               # (1, B)
    with cuda_lib.fp32_matmul(q.device):
        cross = q @ p.T
    # (qn + pn) - 2*cross in place: one (Q, B) buffer besides the product
    out = qn + pn
    out.sub_(cross.mul_(2.0))
    return out.clamp_(min=0.0)


def l2_distance_cuda(queries: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Kernel K6: same contract as l2_distance_plain, on contiguous f32
    CUDA tensors. Counts its launches in l2_distance_cuda.launches."""
    cuda_lib.require_cuda_tensor(queries, "queries", torch.float32)
    cuda_lib.require_cuda_tensor(points, "points", torch.float32)
    if queries.dim() != 2 or points.dim() != 2 \
            or queries.shape[1] != points.shape[1] \
            or queries.device != points.device:
        raise ValueError(f"queries {tuple(queries.shape)} and points "
                         f"{tuple(points.shape)} are not (Q, D) and (B, D) "
                         "on one device")
    Q, D = queries.shape
    B = points.shape[0]
    out = torch.empty((Q, B), dtype=torch.float32, device=queries.device)
    fn = cuda_lib.function("l2_distance", "l2_distance", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    cuda_lib.check(
        fn(queries.data_ptr(), points.data_ptr(), out.data_ptr(), Q, B, D,
           cuda_lib.stream_ptr(queries.device)), "l2_distance")
    l2_distance_cuda.launches += 1
    return out


l2_distance_cuda.launches = 0


def l2_distance(queries, points, use_pallas: bool | None = None,
                device=None) -> torch.Tensor:
    """Public entry: (Q, D) queries x (B, D) points -> (Q, B) squared L2.

    The inputs live on `device`; None means the queries' own device if they
    are a tensor, else CUDA (which raises where CUDA is not available). On
    the CPU the plain version runs; on CUDA kernel K6 is launched unless
    use_pallas is False, which takes the plain matmul form there."""
    dev = cuda_lib.default_device(queries, device)
    q, p = _f32(queries, dev), _f32(points, dev)
    if dev.type == "cpu" or use_pallas is False:
        return l2_distance_plain(q, p)
    return l2_distance_cuda(q.contiguous(), p.contiguous())


def _low32_signed(x, device: torch.device) -> torch.Tensor:
    """Any integer array -> int64 tensor on `device` of its low 32 bits read
    as int32 (jnp's astype(int32) wrap)."""
    t = torch.as_tensor(x)
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    t = t.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    return (t ^ 0x80000000) - 0x80000000


def inner_product(a, b, device=None) -> torch.Tensor:
    """(Q, D) x (B, D) -> (Q, B) dot products, int32, wrapping mod 2^32
    like the reference's uint32 accumulation, on `device` (as in
    l2_distance). torch has no int32 matrix product on CUDA, so each
    product of two int32 values is taken in int64 (no overflow), masked to
    its low 32 bits and summed in int64 (exact for D < 2^31), a chunk of
    points at a time."""
    dev = cuda_lib.default_device(a, device)
    a64, b64 = _low32_signed(a, dev), _low32_signed(b, dev)
    Q, D = a64.shape
    step = max(1, _IP_CHUNK // max(Q * D, 1))
    parts = [((a64[:, None, :] * b64[None, b0:b0 + step, :]) & 0xFFFFFFFF)
             .sum(dim=-1) for b0 in range(0, b64.shape[0], step)]
    acc = torch.cat(parts, dim=1) if parts else a64.new_zeros((Q, 0))
    acc &= 0xFFFFFFFF
    return torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)


def l2_distance_single(v1, v2, device=None) -> torch.Tensor:
    """Scalar twin of the reference's L2Dist (build_graph.go:106-114), on
    `device` (as in l2_distance)."""
    dev = cuda_lib.default_device(v1, device)
    d = _f32(v1, dev) - _f32(v2, dev)
    return (d * d).sum()
