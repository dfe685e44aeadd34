"""Wrappers of the port's hand-written Hopper kernels, each beside its plain
PyTorch version.

A CPU tensor goes to the plain version (it is the kernel's oracle and what
the CPU tests run).  A CUDA tensor launches the kernel on the current stream
or raises: there is no fallback.  Each wrapper counts its launches in a
plain integer attribute (`symmetric_downdate.launches`,
`householder_qr_blocks.launches`, `imu_rk4_window.launches`,
`msckf_linearize.launches`), one per launch whether the call was batched or
not.

Each kernel is a `torch.library.custom_op` with a vmap rule, so a wrapper
runs under `torch.func.vmap` (the filter ensemble vmaps the frame step over
its streams, as the JAX package's `jax.vmap` does) and a batched call is one
launch over the whole batch: the counterpart of the `custom_vmap` rule of
open_vins_tpu/ops/pallas_kernels.py:72-88, except that on Hopper the batch
axis of the grid costs nothing, so the batched call runs the kernel too.
`imu_rk4_window` and `msckf_linearize` send CPU tensors to their plain
versions before the custom op, so that under vmap on the CPU their plain
operations are batched as they were before they had a kernel.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.ops import _build

_NS = "open_vins_tpu_torch"


def symmetric_downdate_ref(P, K, PHt):
    """sym(P − K·PHtᵀ), plain PyTorch (over leading batch dimensions too)."""
    cov = P - K @ PHt.mT
    return 0.5 * (cov + cov.mT)


def _check_downdate_args(P, K, PHt):
    """Types, ranks, shapes and device, as a vmapped call sees them (one
    stream's); contiguity is checked where the tensors are real (`_op`)."""
    for name, t in (("P", P), ("K", K), ("PHt", PHt)):
        if t.dtype != torch.float32:
            raise TypeError(f"symmetric_downdate: {name} must be float32, "
                            f"got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"symmetric_downdate: {name} must be 2-D, "
                             f"got shape {tuple(t.shape)}")
    D = P.shape[0]
    if P.shape != (D, D) or K.shape[0] != D or K.shape != PHt.shape:
        raise ValueError("symmetric_downdate: need P [D,D] and K, PHt [D,m]; "
                         f"got {tuple(P.shape)}, {tuple(K.shape)}, "
                         f"{tuple(PHt.shape)}")
    if not (P.device == K.device == PHt.device):
        raise ValueError("symmetric_downdate: P, K and PHt must lie on one "
                         f"device, got {P.device}, {K.device}, {PHt.device}")


def _require_contiguous(kernel, **tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _require_cuda(kernel, t):
    if t.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {t.device}")


def same_operand(K, PHt):
    """True when K and PHt are one tensor: the same storage offset, shape and
    strides.  An equal copy or another view of K's storage is not."""
    return (K.data_ptr() == PHt.data_ptr() and K.shape == PHt.shape
            and K.stride() == PHt.stride())


def _launch_downdate(P, K, PHt, same):
    """One launch of `csrc/symmetric_downdate.cu` over every problem of P
    [..., D, D], K and PHt [..., D, m] (contiguous CUDA tensors with the
    same leading dimensions)."""
    _require_cuda("symmetric_downdate", P)
    D, m = K.shape[-2:]
    batch = P.numel() // (D * D)
    out = torch.empty_like(P)
    lib = _build.load("symmetric_downdate")
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = lib.symmetric_downdate_f32(P.data_ptr(), K.data_ptr(),
                                         PHt.data_ptr(), out.data_ptr(),
                                         batch, D, m, D * D, D * m,
                                         int(same), stream)
    if err != 0:
        raise RuntimeError(f"symmetric_downdate kernel launch failed: "
                           f"cudaError {err}")
    symmetric_downdate.launches += 1
    return out


@torch.library.custom_op(f"{_NS}::symmetric_downdate", mutates_args=(),
                         schema="(Tensor P, Tensor K, Tensor PHt) -> Tensor")
def _downdate_op(P, K, PHt):
    _require_contiguous("symmetric_downdate", P=P, K=K, PHt=PHt)
    if P.device.type == "cpu":
        return symmetric_downdate_ref(P, K, PHt)
    return _launch_downdate(P, K, PHt, same_operand(K, PHt))


@_downdate_op.register_fake
def _(P, K, PHt):
    return torch.empty_like(P)


def _batch_first(x, dim, n):
    """x with its batch dimension `dim` in front (broadcast to n when x is
    unbatched, as the JAX rule's `bc`), contiguous."""
    x = x.movedim(dim, 0) if dim is not None else x.expand(n, *x.shape)
    return x.contiguous()


@_downdate_op.register_vmap
def _(info, in_dims, P, K, PHt):
    """A batch of downdates in one launch.  K and PHt are one operand when
    they are one tensor under vmap too (the EKF update passes K twice): the
    test runs on the unwrapped tensors, before the broadcast copies."""
    n = info.batch_size
    same = in_dims[1] == in_dims[2] and same_operand(K, PHt)
    P, K = _batch_first(P, in_dims[0], n), _batch_first(K, in_dims[1], n)
    PHt = K if same else _batch_first(PHt, in_dims[2], n)
    if P.device.type == "cpu":
        return symmetric_downdate_ref(P, K, PHt), 0
    return _launch_downdate(P, K, PHt, same), 0


def symmetric_downdate(P, K, PHt):
    """sym(P − K·PHtᵀ) = ½(P+Pᵀ) − ½(K·PHtᵀ + PHt·Kᵀ) — the covariance store
    of every EKF update (P [D,D], K and PHt [D,m], float32, contiguous).

    On CUDA it runs `csrc/symmetric_downdate.cu`, which replaces the TPU
    kernel `_downdate_kernel` of open_vins_tpu/ops/pallas_kernels.py; when
    K and PHt are one tensor (`same_operand`) the kernel forms the single
    product K·Kᵀ.  Under `torch.func.vmap` the batch is one launch.
    """
    _check_downdate_args(P, K, PHt)
    return _downdate_op(P, K, PHt)


symmetric_downdate.launches = 0


_QR_PANEL = 32  # NBMAX of csrc/householder_qr_blocks.cu


def householder_qr_blocks_ref(A_blocks):
    """R factors [g, n, n] of a column-by-column Householder QR of each
    [B, n] row block, plain PyTorch — the TPU kernel's algorithm: sign +1
    when α ≥ 0, scale = 2/‖v‖² only when ‖v‖² > 1e-30 (a zero column is an
    identity reflector), the top n rows kept and the strict lower triangle
    set to exactly 0."""
    g, B, n = A_blocks.shape
    A = A_blocks
    ridx = torch.arange(B, device=A.device)[:, None]  # [B, 1]
    for j in range(n):
        x = torch.where(ridx >= j, A[:, :, j:j + 1], 0.0)  # [g, B, 1]
        normx = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        alpha = A[:, j:j + 1, j:j + 1]
        beta = -torch.where(alpha >= 0, 1.0, -1.0) * normx
        v = x - torch.where(ridx == j, beta, 0.0)
        vn2 = torch.sum(v * v, dim=1, keepdim=True)
        scale = torch.where(vn2 > 1e-30, 2.0 / vn2, 0.0)
        A = A - scale * (v @ (v.mT @ A))
    return torch.triu(A[:, :n, :])


def _check_qr_args(A_blocks):
    if A_blocks.dtype != torch.float32:
        raise TypeError("householder_qr_blocks: A_blocks must be float32, "
                        f"got {A_blocks.dtype}")
    if A_blocks.dim() != 3:
        raise ValueError("householder_qr_blocks: A_blocks must be [g, B, n], "
                         f"got shape {tuple(A_blocks.shape)}")
    g, B, n = A_blocks.shape
    if g < 1 or n < 1 or B < n:
        raise ValueError("householder_qr_blocks: need g >= 1, n >= 1 and "
                         f"B >= n; got [g, B, n] = {[g, B, n]}")


def _qr_blocks(A_blocks):
    """The plain version on the CPU; on CUDA one launch of
    `csrc/householder_qr_blocks.cu` (contiguous [g, B, n])."""
    if A_blocks.device.type == "cpu":
        return householder_qr_blocks_ref(A_blocks)
    _require_cuda("householder_qr_blocks", A_blocks)
    g, B, n = A_blocks.shape
    out = torch.empty((g, n, n), dtype=A_blocks.dtype, device=A_blocks.device)
    work = torch.empty_like(A_blocks)  # each block's working copy
    # a panel's reflectors V [B, 32] and triangular factor T [32, 32]
    vt = torch.empty((g, B * _QR_PANEL + _QR_PANEL ** 2),
                     dtype=A_blocks.dtype, device=A_blocks.device)
    lib = _build.load("householder_qr_blocks")
    with torch.cuda.device(A_blocks.device):
        stream = torch.cuda.current_stream(A_blocks.device).cuda_stream
        err = lib.householder_qr_blocks_f32(A_blocks.data_ptr(),
                                            work.data_ptr(), vt.data_ptr(),
                                            out.data_ptr(), g, B, n, stream)
    if err != 0:
        raise RuntimeError("householder_qr_blocks kernel launch failed: "
                           f"cudaError {err}")
    householder_qr_blocks.launches += 1
    return out


@torch.library.custom_op(f"{_NS}::householder_qr_blocks", mutates_args=(),
                         schema="(Tensor A_blocks) -> Tensor")
def _qr_op(A_blocks):
    _require_contiguous("householder_qr_blocks", A_blocks=A_blocks)
    return _qr_blocks(A_blocks)


@_qr_op.register_fake
def _(A_blocks):
    g, _, n = A_blocks.shape
    return A_blocks.new_empty((g, n, n))


@_qr_op.register_vmap
def _(info, in_dims, A_blocks):
    """The batch folded into the kernel's block axis: [b, g, B, n] →
    [b·g, B, n], one launch, then unfolded (what `pallas_call`'s grid gets
    under `jax.vmap`)."""
    A = _batch_first(A_blocks, in_dims[0], info.batch_size)
    b, g, B, n = A.shape
    return _qr_blocks(A.reshape(b * g, B, n)).reshape(b, g, n, n), 0


def householder_qr_blocks(A_blocks):
    """R factors [g, n, n] of the row blocks A_blocks [g, B, n] (float32,
    contiguous, B >= n): upper triangular, strict lower triangle exactly 0.

    On CUDA it runs `csrc/householder_qr_blocks.cu` (blocked Householder in
    compact WY form: a panel kernel and a trailing-update kernel per panel of
    32 columns, all on the current stream, counted as one launch), which
    replaces the TPU kernel `_house_qr_block_kernel` of
    open_vins_tpu/ops/pallas_kernels.py.  Under `torch.func.vmap` the batch
    is one launch.
    """
    _check_qr_args(A_blocks)
    return _qr_op(A_blocks)


householder_qr_blocks.launches = 0


# imu_rk4_window's packed per-stream inputs: x holds q, p, v, q_fej, p_fej,
# v_fej, bg, ba; mats holds Dw, Da, Tg, R_w, R_a
_RK4_X = 26
_RK4_MEAN = 10  # q | p | v


def imu_rk4_window_ref(x, mats, t, w, a, gravity_mag, sigma_w, sigma_a,
                       sigma_wb, sigma_ab):
    """rk4 over one IMU window, plain PyTorch: `models/propagator`'s Python
    loop of `_step_mean_rk4`, `_phi_qd`, `_mask_padded` and
    `_compose_transitions`, as `propagate` runs them for the other
    integrators.  Returns (q|p|v [10], Φ [15, 15], symmetrized Qd
    [15, 15])."""
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import propagator as P  # models use ops

    q, p, v, q_fej, p_fej, v_fej, bg, ba = torch.split(
        x, (4, 3, 3, 4, 3, 3, 3, 3))
    gravity = torch.tensor([0.0, 0.0, gravity_mag], dtype=x.dtype,
                           device=x.device)
    cfg = FilterConfig(sigma_w=sigma_w, sigma_a=sigma_a, sigma_wb=sigma_wb,
                       sigma_ab=sigma_ab)
    (q, p, v), dts, trans = P._loop_window(
        P._step_mean_rk4, (q, p, v), (q_fej, p_fej, v_fej), (bg, ba),
        tuple(mats.unbind(0)), P.ImuWindow(t=t, w=w, a=a), gravity, cfg)
    Phi, _, Qd = P._window_transition(*trans, dts)
    return torch.cat([q, p, v]), Phi, Qd


def _check_rk4_args(x, mats, t, w, a):
    """Types, ranks, shapes and device of one stream's operands."""
    named = (("x", x), ("mats", mats), ("t", t), ("w", w), ("a", a))
    for name, arg in named:
        if arg.dtype != torch.float32:
            raise TypeError(f"imu_rk4_window: {name} must be float32, "
                            f"got {arg.dtype}")
    K = t.shape[0] if t.dim() == 1 else -1
    if (x.shape != (_RK4_X,) or mats.shape != (5, 3, 3) or K < 2
            or w.shape != (K, 3) or a.shape != (K, 3)):
        raise ValueError(
            "imu_rk4_window: need x [26], mats [5, 3, 3], t [K], w and a "
            f"[K, 3] with K >= 2; got {tuple(x.shape)}, {tuple(mats.shape)}, "
            f"{tuple(t.shape)}, {tuple(w.shape)}, {tuple(a.shape)}")
    if len({arg.device for _, arg in named}) != 1:
        raise ValueError("imu_rk4_window: x, mats, t, w and a must lie on "
                         "one device, got "
                         + ", ".join(str(arg.device) for _, arg in named))


def _per_stream(arg, dim):
    """(tensor, batch stride in floats): the batch dimension `dim` in front
    with each stream's entries contiguous; an unbatched operand (dim None)
    is read by every stream (stride 0)."""
    if dim is None:
        return arg.contiguous(), 0
    arg = arg.movedim(dim, 0)
    if not arg[0].is_contiguous():
        arg = arg.contiguous()
    return arg, arg.stride(0)


def _launch_rk4(batch, operands, gravity_mag, sigmas):
    """One launch of `csrc/imu_rk4_window.cu` over `batch` streams;
    `operands` are (tensor, batch stride) of x, mats, t, w and a."""
    (x, _), _, (t, _), _, _ = operands
    _require_cuda("imu_rk4_window", x)
    K = t.shape[-1]
    mean = x.new_empty((batch, _RK4_MEAN))
    phi = x.new_empty((batch, 15, 15))
    qd = x.new_empty((batch, 15, 15))
    args = [v for arg, stride in operands for v in (arg.data_ptr(), stride)]
    lib = _build.load("imu_rk4_window")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.imu_rk4_window_f32(
            *args, mean.data_ptr(), phi.data_ptr(), qd.data_ptr(), batch, K,
            gravity_mag, *(s * s for s in sigmas), stream)
    if err != 0:
        raise RuntimeError(f"imu_rk4_window kernel launch failed: "
                           f"cudaError {err}")
    imu_rk4_window.launches += 1
    return mean, phi, qd


@torch.library.custom_op(
    f"{_NS}::imu_rk4_window", mutates_args=(),
    schema="(Tensor x, Tensor mats, Tensor t, Tensor w, Tensor a, "
           "float gravity_mag, float sigma_w, float sigma_a, float sigma_wb, "
           "float sigma_ab) -> (Tensor, Tensor, Tensor)")
def _rk4_op(x, mats, t, w, a, gravity_mag, sigma_w, sigma_a, sigma_wb,
            sigma_ab):
    operands = [_per_stream(arg, None) for arg in (x, mats, t, w, a)]
    mean, phi, qd = _launch_rk4(1, operands, gravity_mag,
                                (sigma_w, sigma_a, sigma_wb, sigma_ab))
    return mean[0], phi[0], qd[0]


@_rk4_op.register_fake
def _(x, mats, t, w, a, gravity_mag, sigma_w, sigma_a, sigma_wb, sigma_ab):
    return (x.new_empty((_RK4_MEAN,)), x.new_empty((15, 15)),
            x.new_empty((15, 15)))


@_rk4_op.register_vmap
def _(info, in_dims, x, mats, t, w, a, *consts):
    """A batch of windows in one launch, each operand read in place at its
    batch stride (0 for an unbatched one)."""
    tensors = (x, mats, t, w, a)
    operands = [_per_stream(arg, dim) for arg, dim in zip(tensors, in_dims)]
    return (_launch_rk4(info.batch_size, operands, consts[0], consts[1:]),
            (0, 0, 0))


def imu_rk4_window(x, mats, t, w, a, gravity_mag, sigma_w, sigma_a, sigma_wb,
                   sigma_ab):
    """rk4 over one IMU window of K samples (K - 1 intervals), with no
    online IMU-intrinsic calibration: the samples corrected by the biases and
    the matrices (`propagator.correct_imu`), the K - 1 rk4 mean steps, each
    interval's Φ and Qd (the first at the FEJ point, then at the mean; a
    dt = 0 interval an exact no-op) and their pairwise tree composition.

    x [26] packs q, p, v, q_fej, p_fej, v_fej, bg, ba; mats [5, 3, 3] is
    (Dw, Da, Tg, R_w, R_a); t [K], w and a [K, 3]; all float32 on one
    device.  Returns (q|p|v [10], Φ [15, 15], symmetrized Qd [15, 15]).

    On CUDA it runs `csrc/imu_rk4_window.cu`, one warp per window; the JAX
    package has no Pallas kernel here (XLA fuses its loop).  Under
    `torch.func.vmap` the batch is one launch.
    """
    _check_rk4_args(x, mats, t, w, a)
    if x.device.type == "cpu":  # under vmap too: vmap runs the plain ops
        return imu_rk4_window_ref(x, mats, t, w, a, gravity_mag, sigma_w,
                                  sigma_a, sigma_wb, sigma_ab)
    return _rk4_op(x, mats, t, w, a, float(gravity_mag), float(sigma_w),
                   float(sigma_a), float(sigma_wb), float(sigma_ab))


imu_rk4_window.launches = 0


def msckf_linearize_ref(state, cfg, gobs, p_f):
    """The MSCKF update's linearize stage, plain PyTorch:
    `manager.msckf_build`'s composition of `update_helper.obs_context`,
    `feature_jacobian_batch` (p_f is also the FEJ point),
    `nullspace_project` and `chi2_statistic` on the camera support.
    Returns (H_proj [F, m, D], res_proj [F, m], n_rows [F] int32,
    gamma [F]), m = 2O - 3."""
    from open_vins_tpu_torch.models import update_helper as uh  # uses ops

    ctx = uh.obs_context(state, cfg, gobs.clone_slot[0], gobs.cam[0])
    H_x, H_f, res, row_mask = uh.feature_jacobian_batch(
        state, cfg, gobs, p_f, p_f, ctx)
    H_proj, res_proj = uh.nullspace_project(H_x, H_f, res)
    return (H_proj, res_proj, row_mask.sum(dim=-1, dtype=torch.int32),
            _support_chi2(state, cfg, H_proj, res_proj))


def _support_chi2(state, cfg, H_proj, res_proj):
    """`update_helper.chi2_statistic` of the projected rows on the camera
    support, against the support's block of the covariance."""
    from open_vins_tpu_torch.models import update_helper as uh

    sup = cfg.cam_meas_support_ranges
    P_ss = uh.take_cols(uh.take_cols(state.cov, sup).T, sup)
    return uh.chi2_statistic(P_ss, uh.take_cols(H_proj, sup), res_proj,
                             cfg.sigma_pix)


_LIN_MAX_OBS = 32  # MAX_O of csrc/msckf_linearize.cu
_LIN_GAMMA_ROWS = 24  # the kernel forms γ when the 2O rows are at most this
_LIN_MODELS = {"radtan": 0, "equi": 1}


def _check_linearize_args(state, cfg, gobs, p_f):
    """Types, ranks, shapes and device of one stream's operands."""
    named = (("uv", gobs.uv), ("p_f", p_f), ("cov", state.cov),
             ("clones_q", state.clones_q), ("clones_p", state.clones_p),
             ("clones_q_fej", state.clones_q_fej),
             ("clones_p_fej", state.clones_p_fej),
             ("calib_ext_q", state.calib_ext_q),
             ("calib_ext_p", state.calib_ext_p),
             ("calib_intr", state.calib_intr))
    for name, arg in named:
        if arg.dtype != torch.float32:
            raise TypeError(f"msckf_linearize: {name} must be float32, "
                            f"got {arg.dtype}")
    if gobs.mask.dtype != torch.bool:
        raise TypeError("msckf_linearize: mask must be bool, "
                        f"got {gobs.mask.dtype}")
    for name, arg in (("clone_slot", gobs.clone_slot), ("cam", gobs.cam)):
        if arg.dtype.is_floating_point or arg.dtype == torch.bool:
            raise TypeError(f"msckf_linearize: {name} must be an integer "
                            f"tensor, got {arg.dtype}")
    C, N, D = cfg.max_clones, cfg.num_cams, cfg.state_dim
    F, O = gobs.mask.shape if gobs.mask.dim() == 2 else (-1, -1)
    # the state may hold more cameras' calibration than the filter uses
    n_cal = max(N, state.calib_ext_q.shape[0])
    want = {"uv": (F, O, 2), "p_f": (F, 3), "cov": (D, D),
            "clones_q": (C, 4), "clones_p": (C, 3), "clones_q_fej": (C, 4),
            "clones_p_fej": (C, 3), "calib_ext_q": (n_cal, 4),
            "calib_ext_p": (n_cal, 3), "calib_intr": (n_cal, 8)}
    bad = [f"{name} {tuple(arg.shape)}" for name, arg in named
           if tuple(arg.shape) != want[name]]
    bad += [f"{name} {tuple(arg.shape)}" for name, arg in
            (("clone_slot", gobs.clone_slot), ("cam", gobs.cam))
            if tuple(arg.shape) != (F, O)]
    if F < 1 or O != C * N or bad:
        raise ValueError(
            f"msckf_linearize: need mask [F, O] with O = {C} x {N}, uv "
            f"[F, O, 2], p_f [F, 3], cov [{D}, {D}], the clones [{C}, 4|3], "
            f"the calibration [>= {N}, 4|3|8]; got mask "
            f"{tuple(gobs.mask.shape)}, " + ", ".join(bad))
    devices = {arg.device for _, arg in named} | {
        gobs.mask.device, gobs.clone_slot.device, gobs.cam.device}
    if len(devices) != 1:
        raise ValueError("msckf_linearize: the operands must lie on one "
                         f"device, got {sorted(map(str, devices))}")


def _launch_linearize(batch, operands, layout, sigma):
    """One launch of `csrc/msckf_linearize.cu` over `batch` streams;
    `operands` are (tensor, batch stride) of uv, mask, p_f, the clones, the
    calibration, cov, clone_slot and cam."""
    (uv, _), (mask, _) = operands[:2]
    cov = operands[10][0]
    _require_cuda("msckf_linearize", uv)
    F, O = mask.shape[-2:]
    D = cov.shape[-1]
    m = 2 * O - 3
    H = uv.new_empty((batch, F, m, D))
    res = uv.new_empty((batch, F, m))
    n_rows = torch.empty((batch, F), dtype=torch.int32, device=uv.device)
    gamma = uv.new_empty((batch, F))
    args = [v for arg, stride in operands for v in (arg.data_ptr(), stride)]
    lib = _build.load("msckf_linearize")
    with torch.cuda.device(uv.device):
        stream = torch.cuda.current_stream(uv.device).cuda_stream
        err = lib.msckf_linearize_f32(
            *args, H.data_ptr(), res.data_ptr(), n_rows.data_ptr(),
            gamma.data_ptr(), batch, F, O, D, *layout, sigma * sigma, stream)
    if err != 0:
        raise RuntimeError(f"msckf_linearize kernel launch failed: "
                           f"cudaError {err}")
    msckf_linearize.launches += 1
    return H, res, n_rows, gamma


@torch.library.custom_op(
    f"{_NS}::msckf_linearize", mutates_args=(),
    schema="(Tensor uv, Tensor mask, Tensor p_f, Tensor clones_q, "
           "Tensor clones_p, Tensor clones_q_fej, Tensor clones_p_fej, "
           "Tensor calib_ext_q, Tensor calib_ext_p, Tensor calib_intr, "
           "Tensor cov, Tensor clone_slot, Tensor cam, int[] layout, "
           "float sigma) -> (Tensor, Tensor, Tensor, Tensor)")
def _linearize_op(uv, mask, p_f, clones_q, clones_p, clones_q_fej,
                  clones_p_fej, calib_ext_q, calib_ext_p, calib_intr, cov,
                  clone_slot, cam, layout, sigma):
    tensors = (uv, mask, p_f, clones_q, clones_p, clones_q_fej, clones_p_fej,
               calib_ext_q, calib_ext_p, calib_intr, cov, clone_slot, cam)
    out = _launch_linearize(1, [_per_stream(t, None) for t in tensors],
                            layout, sigma)
    return tuple(o[0] for o in out)


@_linearize_op.register_fake
def _(uv, mask, p_f, *rest):
    F, O = mask.shape
    D = rest[7].shape[-1]
    return (uv.new_empty((F, 2 * O - 3, D)), uv.new_empty((F, 2 * O - 3)),
            mask.new_empty((F,), dtype=torch.int32), uv.new_empty((F,)))


@_linearize_op.register_vmap
def _(info, in_dims, *args):
    """A batch of streams in one launch, each operand read in place at its
    batch stride (0 for an unbatched one)."""
    operands = [_per_stream(t, d) for t, d in zip(args[:13], in_dims[:13])]
    return (_launch_linearize(info.batch_size, operands, *args[13:]),
            (0, 0, 0, 0))


def msckf_linearize(state, cfg, gobs, p_f):
    """The MSCKF update's linearize stage for the F candidate features of
    one update (`manager.msckf_build`): each feature's stacked measurement
    rows (GLOBAL_3D, FEJ, the 5 cm depth gate, the calibration columns that
    cfg calibrates online), projected onto the left nullspace of its
    feature block, and its χ² statistic on the camera support.  `gobs`
    holds the observations ([F, O], O = max_clones · num_cams, the same
    (slot, camera) in every row), p_f [F, 3] the triangulated points.
    Returns (H_proj [F, m, D], res_proj [F, m], n_rows [F] int32,
    gamma [F]) with m = 2O - 3: `msckf_linearize_ref`'s results.

    On CUDA it runs `csrc/msckf_linearize.cu`, one warp per feature, with
    no one-hot expansion and S formed from the unprojected blocks in
    float64; with more than 24 rows (two cameras) γ comes from
    `chi2_statistic` on its outputs, as the plain version's does.  Under
    `torch.func.vmap` the batch is one launch.  The JAX package has no
    Pallas kernel here (XLA fuses the stage).
    """
    _check_linearize_args(state, cfg, gobs, p_f)
    if state.cov.device.type == "cpu":  # under vmap too
        return msckf_linearize_ref(state, cfg, gobs, p_f)
    if cfg.cam_model not in _LIN_MODELS:
        raise ValueError(f"msckf_linearize: unknown camera model "
                         f"{cfg.cam_model!r}")
    if gobs.mask.shape[-1] > _LIN_MAX_OBS:
        raise ValueError("msckf_linearize: the kernel takes at most "
                         f"{_LIN_MAX_OBS} observations a feature, got "
                         f"{gobs.mask.shape[-1]}")
    sup = cfg.cam_meas_support_ranges
    ranges = [i for span in sup for i in span]
    ranges += [0, 0] * (4 - len(sup))
    layout = [cfg.max_clones, cfg.num_cams, cfg.clones_off,
              cfg.calib_ext_off, cfg.calib_intr_off,
              _LIN_MODELS[cfg.cam_model], int(cfg.calib_cam_extrinsics),
              int(cfg.calib_cam_intrinsics), len(sup), *ranges]
    q_fej, p_fej = ((state.clones_q_fej, state.clones_p_fej) if cfg.use_fej
                    else (state.clones_q, state.clones_p))
    H_proj, res_proj, n_rows, gamma = _linearize_op(
        gobs.uv, gobs.mask, p_f, state.clones_q, state.clones_p, q_fej, p_fej,
        state.calib_ext_q, state.calib_ext_p, state.calib_intr, state.cov,
        gobs.clone_slot[0].long(), gobs.cam[0].long(), layout,
        float(cfg.sigma_pix))
    if 2 * gobs.mask.shape[-1] > _LIN_GAMMA_ROWS:  # the kernel's γ is NaN
        gamma = _support_chi2(state, cfg, H_proj, res_proj)
    return H_proj, res_proj, n_rows, gamma


msckf_linearize.launches = 0
