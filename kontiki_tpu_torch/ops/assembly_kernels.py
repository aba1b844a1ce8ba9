"""Gauss-Newton and landmark-elimination assembly from compressed rows: the
CUDA kernel ``csrc/assemble_schur.cu`` and its plain PyTorch version
(counterpart of ``kontiki_tpu.ops.assembly_kernels.assemble_schur_blocks``,
kernel B2).

From one bucket's whitened rows ``Jw [M, rdim, C]`` with column ids
``cols [M, C]`` (c-space, int32), residuals ``rw [M, rdim]``, landmark
columns ``J_rho [M, rdim]`` and landmark ids ``lid [M]`` (int32):

    H [P, P] = sum_m Jd_m^T Jd_m        g [P] = sum_m Jd_m^T rw_m
    E[lid_m] += J_rho_m^T Jd_m          D[lid_m] += |J_rho_m|^2
    g_l[lid_m] += J_rho_m . rw_m

where ``Jd_m [rdim, P]`` is row m scattered to dense columns; duplicate
column ids within a row accumulate. With ``with_rho=False`` the landmark
outputs are ``None``. A CPU tensor goes to the plain version; a CUDA tensor
launches the kernel.
"""
import ctypes

import torch


def assemble_schur_blocks_plain(Jw, cols, rw, J_rho, lid, *, P, L, with_rho):
    """Plain PyTorch B2: the dense per-row scatter, then matrix products."""
    M, rdim, C = Jw.shape
    Jd = torch.zeros(M, rdim, P, dtype=Jw.dtype, device=Jw.device)
    Jd.scatter_add_(2, cols.long()[:, None, :].expand(M, rdim, C), Jw)
    Jd2 = Jd.reshape(-1, P)
    H = Jd2.T @ Jd2
    g = Jd2.T @ rw.reshape(-1)
    if not with_rho:
        return H, g, None, None, None
    lid = lid.long()
    E = torch.zeros(L, P, dtype=Jw.dtype, device=Jw.device)
    E.index_add_(0, lid, torch.einsum("mr,mrp->mp", J_rho, Jd))
    D = torch.zeros(L, dtype=Jw.dtype, device=Jw.device)
    D.index_add_(0, lid, torch.sum(J_rho * J_rho, dim=1))
    g_l = torch.zeros(L, dtype=Jw.dtype, device=Jw.device)
    g_l.index_add_(0, lid, torch.sum(J_rho * rw, dim=1))
    return H, g, E, D, g_l


def _check_inputs(Jw, cols, rw, J_rho, lid):
    if Jw.dim() != 3 or Jw.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"assemble_schur_blocks: Jw must be [M, rdim, C] float, "
                         f"got {tuple(Jw.shape)} {Jw.dtype}")
    M, rdim, C = Jw.shape
    expect = (
        ("cols", cols, (M, C), torch.int32), ("rw", rw, (M, rdim), Jw.dtype),
        ("J_rho", J_rho, (M, rdim), Jw.dtype), ("lid", lid, (M,), torch.int32),
    )
    for name, a, shape, dtype in expect:
        if a.shape != shape or a.dtype != dtype or a.device != Jw.device:
            raise ValueError(
                f"assemble_schur_blocks: {name} must be {list(shape)} {dtype} on "
                f"{Jw.device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
            )
    for name, a in (("Jw", Jw),) + tuple((n, a) for n, a, _, _ in expect):
        if not a.is_contiguous():
            raise ValueError(f"assemble_schur_blocks: {name} must be contiguous")
    return M, rdim, C


def assemble_schur_blocks(Jw, cols, rw, J_rho, lid, *, P, L, with_rho):
    """B2: (H [P,P], g [P], E [L,P], D [L], g_l [L]) from one bucket's rows
    (see the module docstring). ``Jw``, ``rw`` and ``J_rho`` must already be
    robust-whitened; ``cols`` must lie in ``[0, P)`` and ``lid`` in
    ``[0, L)``."""
    M, rdim, C = _check_inputs(Jw, cols, rw, J_rho, lid)
    if Jw.device.type == "cpu":
        return assemble_schur_blocks_plain(
            Jw, cols, rw, J_rho, lid, P=P, L=L, with_rho=with_rho
        )
    if Jw.device.type != "cuda":
        raise ValueError(f"assemble_schur_blocks: unsupported device {Jw.device}")
    from .build import load_library

    lib = load_library()
    suffix = "_f64" if Jw.dtype == torch.float64 else "_f32"
    fn = getattr(lib, "kontiki_assemble_schur" + suffix)
    opts = dict(dtype=Jw.dtype, device=Jw.device)
    H = torch.zeros(P, P, **opts)
    g = torch.zeros(P, **opts)
    Lo = L if with_rho else 0
    E = torch.zeros(Lo, P, **opts)
    D = torch.zeros(Lo, **opts)
    g_l = torch.zeros(Lo, **opts)
    if M:
        with torch.cuda.device(Jw.device):
            # the blocks' heads, summed into H and g by the kernel's second launch
            n = getattr(lib, "kontiki_assemble_schur_workspace" + suffix)(M, rdim, C, P)
            if n < 0:
                raise ValueError(f"assemble_schur_blocks: rows of rdim {rdim}, C {C} do not "
                                 f"fit the card's shared memory")
            ws = torch.empty(n, **opts)
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(*[ctypes.c_void_p(a.data_ptr())
                       for a in (Jw, cols, rw, J_rho, lid, H, g, E, D, g_l)],
                     ctypes.c_int(M), ctypes.c_int(rdim), ctypes.c_int(C),
                     ctypes.c_int(P), ctypes.c_int(L), ctypes.c_int(int(with_rho)),
                     ctypes.c_void_p(ws.data_ptr()), ctypes.c_void_p(stream))
        if err:
            raise RuntimeError(
                f"assemble_schur_blocks: kernel launch failed (CUDA error {err})"
            )
        assemble_schur_blocks.launches += 1
        assemble_schur_blocks.f32_launches += int(Jw.dtype == torch.float32)
        shape = f"rdim {rdim} C {C}"
        assemble_schur_blocks.shape_launches[shape] = (
            assemble_schur_blocks.shape_launches.get(shape, 0) + 1)
    if not with_rho:
        return H, g, None, None, None
    return H, g, E, D, g_l


#: kernel launches since the count was last reset (CUDA tensors only), how
#: many of them were in float32, and per row shape ("rdim 2 C 85")
assemble_schur_blocks.launches = 0
assemble_schur_blocks.f32_launches = 0
assemble_schur_blocks.shape_launches = {}


def assemble_schur_blocks_host(Jw, cols, rw, J_rho, lid, *, P, L, with_rho, head, blocks,
                               warps):
    """B2 as its CUDA kernel accumulates it (``csrc/assemble_schur.cu``),
    compiled for the host, in float64: the rows cut into ``blocks`` x
    ``warps`` ranges, each block adding the products of ids below ``head``
    into its own copy of the head triangle, the other products straight
    into H, the landmark outputs in runs of rows per warp; the blocks'
    heads then summed into H and g. Same outputs as
    ``assemble_schur_blocks`` (CPU tensors); ids out of range are
    dropped."""
    from .build import load_host_library

    M, rdim, C = _check_inputs(Jw, cols, rw, J_rho, lid)
    f64 = [a.detach().to("cpu", torch.float64).contiguous() for a in (Jw, rw, J_rho)]
    i32 = [a.detach().to("cpu").contiguous() for a in (cols, lid)]
    outs = [torch.zeros(P, P, dtype=torch.float64), torch.zeros(P, dtype=torch.float64),
            *[torch.zeros(*s, dtype=torch.float64) for s in ((L, P), (L,), (L,))]]
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in (f64[0], i32[0], f64[1], f64[2], i32[1], *outs)]
    load_host_library().kontiki_host_assemble_schur_f64(
        *ptrs, M, rdim, C, P, L, int(with_rho), head, blocks, warps)
    H, g, E, D, g_l = outs
    return (H, g, E, D, g_l) if with_rho else (H, g, None, None, None)
