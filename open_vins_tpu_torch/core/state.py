"""The filter state: fixed-shape value storage + dense covariance.

Counterpart of `open_vins_tpu/core/state.py`.  `VioState` is a dataclass of
tensors with the field names and shapes of the JAX NamedTuple: the clone
window is a ring of `max_clones` slots with a validity mask, SLAM landmarks
live in `max_slam` fixed slots.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from open_vins_tpu_torch.core.layout import FilterConfig


def _flatten(record):
    return [getattr(record, f.name) for f in dataclasses.fields(record)], None


class TensorRecord:
    """Mixin for the port's dataclasses of tensors.  Every subclass is
    registered as a pytree of its fields, in field order, so that
    `torch.func.vmap` takes and returns records (the JAX package's records
    are NamedTuples, pytrees by birth)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        pytree.register_pytree_node(
            cls, _flatten, lambda values, _: cls(*values),
            serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def items(self):
        return ((f.name, getattr(self, f.name))
                for f in dataclasses.fields(self))


def select(cond, a, b):
    """Field-wise torch.where(cond, a, b) of two records of one type — the
    device-side select of a whole state (no host sync on `cond`).  Fields
    that are the same tensor in both records are kept as they are."""
    out = {}
    for k, va in a.items():
        vb = getattr(b, k)
        out[k] = va if va is vb else torch.where(cond, va, vb)
    return type(a)(**out)


@dataclasses.dataclass
class VioState(TensorRecord):
    """All filter values + covariance.  Every field has a static shape."""

    # current IMU state (JPL q is GtoI)
    q: torch.Tensor  # [4]
    p: torch.Tensor  # [3]
    v: torch.Tensor  # [3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]
    # FEJ linearization points
    q_fej: torch.Tensor
    p_fej: torch.Tensor
    v_fej: torch.Tensor
    # clone window (ring buffer)
    clones_q: torch.Tensor  # [C, 4]
    clones_p: torch.Tensor  # [C, 3]
    clones_q_fej: torch.Tensor
    clones_p_fej: torch.Tensor
    clone_t: torch.Tensor  # [C]
    clone_valid: torch.Tensor  # [C] bool
    head: torch.Tensor  # int32 slot of the newest clone (-1 when empty)
    n_clones: torch.Tensor  # int32
    # SLAM landmark slots
    slam_p: torch.Tensor  # [L, 3]
    slam_p_fej: torch.Tensor  # [L, 3]
    slam_id: torch.Tensor  # [L] int32, -1 = free
    slam_valid: torch.Tensor  # [L] bool
    slam_fail: torch.Tensor  # [L] int32
    slam_anchor_slot: torch.Tensor  # [L] int32
    slam_anchor_cam: torch.Tensor  # [L] int32
    # calibration
    calib_dt: torch.Tensor  # scalar
    calib_ext_q: torch.Tensor  # [N, 4] R_ItoC as JPL quat
    calib_ext_p: torch.Tensor  # [N, 3] p_IinC
    calib_intr: torch.Tensor  # [N, 8]
    # IMU intrinsics
    imu_dw: torch.Tensor  # [6]
    imu_da: torch.Tensor  # [6]
    imu_tg: torch.Tensor  # [9] column-major
    imu_q_gyro: torch.Tensor  # [4]
    imu_q_acc: torch.Tensor  # [4]
    # dense covariance over the static layout
    cov: torch.Tensor  # [D, D]
    # bookkeeping
    t: torch.Tensor  # scalar
    t_init: torch.Tensor  # scalar
    moved: torch.Tensor  # bool


def init_state(cfg: FilterConfig, device, dtype=torch.float32) -> VioState:
    """Zero-initialized state (identity orientation, empty window)."""
    C, L, N, D = cfg.max_clones, cfg.max_slam, cfg.num_cams, cfg.state_dim
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    qid = torch.tensor([0.0, 0.0, 0.0, 1.0], **kw)
    z3 = torch.zeros(3, **kw)
    ident6 = ([1.0, 0.0, 1.0, 0.0, 0.0, 1.0] if cfg.imu_model == "rpng"
              else [1.0, 0.0, 0.0, 1.0, 0.0, 1.0])
    return VioState(
        q=qid, p=z3, v=z3, bg=z3, ba=z3,
        q_fej=qid, p_fej=z3, v_fej=z3,
        clones_q=qid.repeat(C, 1),
        clones_p=torch.zeros((C, 3), **kw),
        clones_q_fej=qid.repeat(C, 1),
        clones_p_fej=torch.zeros((C, 3), **kw),
        clone_t=torch.full((C,), -1.0, **kw),
        clone_valid=torch.zeros((C,), dtype=torch.bool, device=device),
        head=torch.tensor(-1, **i32),
        n_clones=torch.tensor(0, **i32),
        slam_p=torch.zeros((L, 3), **kw),
        slam_p_fej=torch.zeros((L, 3), **kw),
        slam_id=torch.full((L,), -1, **i32),
        slam_valid=torch.zeros((L,), dtype=torch.bool, device=device),
        slam_fail=torch.zeros((L,), **i32),
        slam_anchor_slot=torch.zeros((L,), **i32),
        slam_anchor_cam=torch.zeros((L,), **i32),
        calib_dt=torch.zeros((), **kw),
        calib_ext_q=qid.repeat(N, 1),
        calib_ext_p=torch.zeros((N, 3), **kw),
        calib_intr=torch.zeros((N, 8), **kw),
        imu_dw=torch.tensor(ident6, **kw),
        imu_da=torch.tensor(ident6, **kw),
        imu_tg=torch.zeros((9,), **kw),
        imu_q_gyro=qid,
        imu_q_acc=qid,
        cov=torch.zeros((D, D), **kw),
        t=torch.tensor(0.0, **kw),
        t_init=torch.tensor(0.0, **kw),
        moved=torch.tensor(False, device=device),
    )


def oldest_slot(state: VioState, cfg: FilterConfig):
    """Ring slot of the oldest clone (State::margtimestep parity)."""
    C = cfg.max_clones
    return torch.where(state.n_clones < C,
                       (state.head - state.n_clones + 1) % C,
                       (state.head + 1) % C)


def next_slot(state: VioState, cfg: FilterConfig):
    """Slot the next clone will occupy."""
    return (state.head + 1) % cfg.max_clones


def clone_age_order(state: VioState, cfg: FilterConfig):
    """Slots ordered newest-first: [head, head-1, ...] mod C."""
    C = cfg.max_clones
    return (state.head - torch.arange(C, dtype=torch.int32,
                                      device=state.head.device)) % C


def _quat_boxplus(q, dth):
    """JPL left-multiplicative update: q_new = [0.5 dθ, 1] ⊗ q (normalized)."""
    dq = torch.cat([0.5 * dth, torch.ones_like(dth[..., :1])], dim=-1)
    dq = dq / torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
    qv, q4 = dq[..., :3], dq[..., 3:4]
    pv, p4 = q[..., :3], q[..., 3:4]
    vec = q4 * pv + p4 * qv - torch.linalg.cross(qv, pv, dim=-1)
    sca = q4 * p4 - torch.sum(qv * pv, dim=-1, keepdim=True)
    out = torch.cat([vec, sca], dim=-1)
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return torch.where(out[..., 3:4] < 0, -out, out)


def boxplus(state: VioState, cfg: FilterConfig, dx) -> VioState:
    """Apply the error update dx [D] to all value blocks."""
    C, L, N = cfg.max_clones, cfg.max_slam, cfg.num_cams
    q = _quat_boxplus(state.q, dx[cfg.th_off:cfg.th_off + 3])
    p = state.p + dx[cfg.p_off:cfg.p_off + 3]
    v = state.v + dx[cfg.v_off:cfg.v_off + 3]
    bg = state.bg + dx[cfg.bg_off:cfg.bg_off + 3]
    ba = state.ba + dx[cfg.ba_off:cfg.ba_off + 3]

    dclone = dx[cfg.clones_off:cfg.clones_off + 6 * C].reshape(C, 6)
    live = state.clone_valid[:, None]
    clones_q = torch.where(live, _quat_boxplus(state.clones_q, dclone[:, :3]),
                           state.clones_q)
    clones_p = torch.where(live, state.clones_p + dclone[:, 3:],
                           state.clones_p)

    dslam = dx[cfg.slam_off:cfg.slam_off + 3 * L].reshape(L, 3)
    slam_p = torch.where(state.slam_valid[:, None], state.slam_p + dslam,
                         state.slam_p)

    calib_dt = state.calib_dt + dx[cfg.calib_dt_off]
    dext = dx[cfg.calib_ext_off:cfg.calib_ext_off + 6 * N].reshape(N, 6)
    calib_ext_q = _quat_boxplus(state.calib_ext_q, dext[:, :3])
    calib_ext_p = state.calib_ext_p + dext[:, 3:]
    dintr = dx[cfg.calib_intr_off:cfg.calib_intr_off + 8 * N].reshape(N, 8)
    calib_intr = state.calib_intr + dintr

    imu_dw = state.imu_dw + dx[cfg.imu_dw_off:cfg.imu_dw_off + 6]
    imu_da = state.imu_da + dx[cfg.imu_da_off:cfg.imu_da_off + 6]
    imu_tg = state.imu_tg + dx[cfg.imu_tg_off:cfg.imu_tg_off + 9]
    # the thw slot corrects whichever sensor-frame rotation the model
    # estimates (kalibr: R_GYROtoIMU; rpng: R_ACCtoIMU)
    dthw = dx[cfg.imu_thw_off:cfg.imu_thw_off + 3]
    if cfg.imu_model == "rpng":
        imu_q_gyro = state.imu_q_gyro
        imu_q_acc = _quat_boxplus(state.imu_q_acc, dthw)
    else:
        imu_q_gyro = _quat_boxplus(state.imu_q_gyro, dthw)
        imu_q_acc = state.imu_q_acc

    return state.replace(
        q=q, p=p, v=v, bg=bg, ba=ba,
        clones_q=clones_q, clones_p=clones_p,
        slam_p=slam_p,
        calib_dt=calib_dt,
        calib_ext_q=calib_ext_q, calib_ext_p=calib_ext_p,
        calib_intr=calib_intr,
        imu_dw=imu_dw, imu_da=imu_da, imu_tg=imu_tg, imu_q_gyro=imu_q_gyro,
        imu_q_acc=imu_q_acc,
    )
