"""Batched R3 spline evaluation at arbitrary times (counterpart of
``kontiki_tpu.ops.spline_kernels``): B7 ``r3_evaluate_kernel``, the CUDA
kernel ``csrc/r3_evaluate.cu``, beside its plain PyTorch version
``r3_evaluate_plain``. A CPU tensor goes to the plain version; a CUDA
tensor launches the kernel.
"""
import ctypes

import torch

from ..trajectories import spline_eval as ev
from .linearize_kernels import _host_f64, count_in_chunks


def r3_evaluate_plain(knots, t0, dt, ts):
    """Plain PyTorch B7: ``spline_eval.index_and_u`` + ``gather_windows`` +
    ``r3_window``. knots [N, 3], ts [B] -> (p, v, a), each [B, 3]."""
    i0, u = ev.index_and_u(ts, t0, dt, knots.shape[0])
    return ev.r3_window(ev.gather_windows(knots, i0), u, dt)


def _check(knots, ts):
    if knots.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"r3_evaluate_kernel: unsupported dtype {knots.dtype}")
    if knots.dim() != 2 or knots.shape[1] != 3:
        raise ValueError(f"r3_evaluate_kernel: knots must be [N, 3], got {tuple(knots.shape)}")
    if knots.shape[0] < 4:
        raise ValueError("Spline had too few control points")
    if ts.dim() != 1 or ts.dtype != knots.dtype or ts.device != knots.device:
        raise ValueError(f"r3_evaluate_kernel: ts must be [B] {knots.dtype} on "
                         f"{knots.device}, got {tuple(ts.shape)} {ts.dtype} on {ts.device}")
    if not (knots.is_contiguous() and ts.is_contiguous()):
        raise ValueError("r3_evaluate_kernel: knots and ts must be contiguous")
    return knots.shape[0], ts.shape[0]


def r3_evaluate_kernel(knots, t0, dt, ts):
    """B7, the counterpart of the JAX package's ``r3_evaluate_pallas``: the
    R3 spline with knots [N, 3] (N >= 4) starting at ``t0`` with spacing
    ``dt``, at times ts [B] in any order -> (p, v, a), each [B, 3], with
    ``spline_eval.r3_evaluate``'s clamped window rule. CPU tensors run the
    plain version, CUDA tensors the hand-written kernel (four times a
    thread, no sort, any span); B = 0 launches nothing."""
    N, B = _check(knots, ts)
    if knots.device.type == "cpu":
        return r3_evaluate_plain(knots, t0, dt, ts)
    if knots.device.type != "cuda":
        raise ValueError(f"r3_evaluate_kernel: unsupported device {knots.device}")
    out = torch.empty(3, B, 3, dtype=knots.dtype, device=knots.device)
    p, v, a = out
    if B == 0:
        return p, v, a
    from .build import load_library

    lib = load_library()
    fn = lib.kontiki_r3_evaluate_f64 if knots.dtype == torch.float64 else lib.kontiki_r3_evaluate_f32
    with torch.cuda.device(knots.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(knots.data_ptr(), N, float(t0), float(dt), ts.data_ptr(), p.data_ptr(),
                 v.data_ptr(), a.data_ptr(), B, ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"r3_evaluate_kernel: kernel launch failed (CUDA error {err})")
    r3_evaluate_kernel.launches += 1
    return p, v, a


#: kernel launches since the count was last reset (CUDA tensors only)
r3_evaluate_kernel.launches = 0


def r3_evaluate_host(knots, t0, dt, ts):
    """B7's CUDA row code compiled for the host, in float64 (CPU tensors),
    in its kernel's block schedule: knots staged when a block's times span
    few, outputs written from a staged copy."""
    from .build import load_host_library

    N, B = _check(knots, ts)
    k, t = _host_f64(knots), _host_f64(ts)
    p, v, a = torch.zeros(3, B, 3, dtype=torch.float64)
    load_host_library().kontiki_host_r3_evaluate_f64(
        k.data_ptr(), N, float(t0), float(dt), t.data_ptr(), p.data_ptr(), v.data_ptr(),
        a.data_ptr(), B)
    return p, v, a


def r3_evaluate_ops(knots, t0, dt, ts):
    """Floating-point operations B7's function needs on these times, counted
    by running its row code on the host once per time."""
    from .build import load_host_library

    N, B = _check(knots, ts)
    k, t = _host_f64(knots), _host_f64(ts)
    fn = load_host_library().kontiki_count_r3_evaluate
    return count_in_chunks(
        lambda a, b: fn(k.data_ptr(), N, float(t0), float(dt), t.data_ptr() + 8 * a, b - a), B)
