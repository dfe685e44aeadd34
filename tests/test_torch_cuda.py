"""The port's hand-written CUDA kernels against their plain versions, on a
machine with an NVIDIA GPU (each test skips without one).  This file
imports neither JAX nor the JAX package, so it runs where only the port is
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: the repository's root conftest.py imports JAX.)
"""

import pytest
import torch

from open_vins_tpu_torch.models import runner
from open_vins_tpu_torch.ops import kernels
from open_vins_tpu_torch.sim import simulator
from torch_port_helpers import (LINEARIZE_CASES, check_r_factors,
                                downdate_inputs, imu_window_inputs,
                                linearize_inputs, np_of, oracle_blocks,
                                stack_blocks)

# symmetric_downdate: the oracle shapes of tests/test_pallas_kernels.py, the
# main paths' (D, support), a 1434-wide state and the large map's (D,
# support)
DOWNDATE_SHAPES = [(96, 64), (171, 171), (256, 40), (130, 200), (120, 81),
                   (270, 231), (1434, 231), (1434, 1395)]
# householder_qr_blocks: the oracle [B, n] blocks (g = 3), then the [m, n]
# stacks cut into row blocks (MSCKF-only and the operating point's)
QR_CASES = [("oracle", 256, 128), ("oracle", 512, 128), ("oracle", 384, 256),
            ("stack", 760, 121), ("stack", 1174, 271)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", DOWNDATE_SHAPES)
def test_cuda_kernel_matches_plain_version(D, m, same):
    """symmetric_downdate at 1e-5·max(1, ‖P‖∞), exactly symmetric, one
    launch."""
    _need_gpu()
    P, K, PHt = (torch.from_numpy(a).cuda()
                 for a in downdate_inputs(D, m, same))
    before = kernels.symmetric_downdate.launches
    out = kernels.symmetric_downdate(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, PHt)
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out, out.T)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows,n", QR_CASES)
def test_cuda_qr_kernel_matches_plain_version(kind, rows, n):
    """householder_qr_blocks element by element at 1e-5·max|R| (the same
    reflectors; only the order of the f32 sums differs), RᵀR = AᵀA at 2e-3,
    strict lower triangle exactly 0, one launch."""
    _need_gpu()
    A = oracle_blocks(rows, n) if kind == "oracle" else stack_blocks(rows, n)
    A_d = torch.from_numpy(A).cuda()
    before = kernels.householder_qr_blocks.launches
    R = kernels.householder_qr_blocks(A_d)
    torch.cuda.synchronize()
    assert kernels.householder_qr_blocks.launches == before + 1
    ref = kernels.householder_qr_blocks_ref(A_d)
    tol = 1e-5 * ref.abs().max().item()
    assert (R - ref).abs().max().item() <= tol
    check_r_factors(np_of(R), A)


# edge shapes of the redesigned kernels: D = 1 and a D that is not a
# multiple of the 32-wide tile, m = 0 (out = ½(P + Pᵀ))
DOWNDATE_EDGE_SHAPES = [(1, 5), (1, 0), (33, 20), (33, 0), (120, 0)]
# (g, B, n): n < 32 (one ragged panel), B = n, g = 1 at the operating
# point's n = 271 (eight panels of 32 and a ragged one of 15), and a block
# taller than the 640 rows of the register panel (shared-memory panel)
QR_EDGE_SHAPES = [(2, 40, 15), (1, 71, 71), (1, 544, 271), (2, 271, 271),
                  (1, 704, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("D,m", DOWNDATE_EDGE_SHAPES)
def test_cuda_kernel_edge_shapes(D, m, same):
    """symmetric_downdate at the edge shapes: 1e-5·max(1, ‖P‖∞), exactly
    symmetric, one launch."""
    _need_gpu()
    P, K, PHt = (torch.from_numpy(a).cuda()
                 for a in downdate_inputs(D, m, same))
    if same:
        PHt = K
    before = kernels.symmetric_downdate.launches
    out = kernels.symmetric_downdate(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, PHt)
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(out, out.T)


@pytest.mark.cuda
@pytest.mark.parametrize("D,m", [(120, 81), (270, 231)])
def test_cuda_kernel_single_product_matches_two(D, m):
    """K passed twice takes the single product K·Kᵀ; an equal copy takes the
    two-product form: both agree within the tolerance."""
    _need_gpu()
    P, K, _ = (torch.from_numpy(a).cuda() for a in downdate_inputs(D, m, True))
    one = kernels.symmetric_downdate(P, K, K)
    two = kernels.symmetric_downdate(P, K, K.clone())
    tol = 1e-5 * max(1.0, P.abs().sum(dim=1).max().item())
    assert (one - two).abs().max().item() <= tol
    assert torch.equal(one, one.T) and torch.equal(two, two.T)


@pytest.mark.cuda
@pytest.mark.parametrize("g,B,n", QR_EDGE_SHAPES)
def test_cuda_qr_kernel_edge_shapes(g, B, n):
    """householder_qr_blocks at the edge shapes: element by element at
    1e-5·max|R|, RᵀR = AᵀA at 2e-3, strict lower triangle exactly 0, one
    launch."""
    _need_gpu()
    A = oracle_blocks(B, n, g=g)
    A_d = torch.from_numpy(A).cuda()
    before = kernels.householder_qr_blocks.launches
    R = kernels.householder_qr_blocks(A_d)
    torch.cuda.synchronize()
    assert kernels.householder_qr_blocks.launches == before + 1
    ref = kernels.householder_qr_blocks_ref(A_d)
    assert (R - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    check_r_factors(np_of(R), A)


@pytest.mark.cuda
@pytest.mark.parametrize("num_cams,model", [(1, "radtan"), (2, "equi")])
def test_cuda_staging_matches_cpu_staging(num_cams, model):
    """The simulator on the card against the same draws on the CPU: ids and
    masks equal except in a (frame, camera) with a map point within 1e-3 px
    of the border or 1e-6 m of the depth gate; pixels within 1e-3 px where
    both are valid, IMU samples and groundtruth within 1e-4 (accel)."""
    _need_gpu()
    params = simulator.SimParams(num_cams=num_cams, cam_model=model,
                                 num_pts=50, map_size=256, duration=2.0,
                                 start_offset=3.0)
    draws = simulator.draw(params, 0)
    sims = {d: simulator.build(params, draws=draws, device=d)
            for d in ("cpu", "cuda")}
    runs = {d: runner.stage_run(s, params) for d, s in sims.items()}
    fc, fg = runs["cpu"].frames, runs["cuda"].frames
    differ = ((np_of(fc.ids) != np_of(fg.ids)).any(-1)
              | (np_of(fc.mask) != np_of(fg.mask)).any(-1))
    for k, c in zip(*differ.nonzero()):
        edge, depth = simulator.view_margins(sims["cpu"], params, k + 1, c)
        assert bool(((edge < 1e-3) | (depth < 1e-6)).any()), (k, c)
    same = torch.as_tensor(~differ[..., None]) & fc.mask & fg.mask.cpu()
    assert (fc.uv[same] - fg.uv.cpu()[same]).abs().max() <= 1e-3
    for a, b, tol in ((fc.win.w, fg.win.w, 1e-5), (fc.win.a, fg.win.a, 1e-4),
                      (runs["cpu"].gt_p, runs["cuda"].gt_p, 1e-5),
                      (runs["cpu"].gt_q, runs["cuda"].gt_q, 1e-5)):
        assert (a - b.cpu()).abs().max() <= tol


def _batched_inputs(n, D, m, same):
    """n problems of `downdate_inputs` (seeds 0..n-1) stacked on the card."""
    ins = [downdate_inputs(D, m, same, seed=b) for b in range(n)]
    return [torch.stack([torch.from_numpy(x[i]) for x in ins]).cuda()
            for i in range(3)]


# batched symmetric_downdate: the ensemble's (270, 231) and the MSCKF-only
# (120, 81) at 8 streams, one and three streams, a ragged D, m = 0, and a
# batch of 32 with m under one chunk
BATCHED_SHAPES = [(8, 270, 231), (8, 120, 81), (1, 270, 231), (3, 120, 81),
                  (3, 33, 20), (3, 33, 0), (8, 270, 0), (32, 100, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("n,D,m", BATCHED_SHAPES)
def test_cuda_batched_downdate(n, D, m, same):
    """symmetric_downdate under vmap: one launch for the batch, each matrix
    within 1e-5·max(1, ‖P‖∞) of its plain version and exactly symmetric."""
    _need_gpu()
    P, K, PHt = _batched_inputs(n, D, m, same)
    before = kernels.symmetric_downdate.launches
    if same:
        out = torch.func.vmap(
            lambda p, k: kernels.symmetric_downdate(p, k, k))(P, K)
    else:
        out = torch.func.vmap(kernels.symmetric_downdate)(P, K, PHt)
    torch.cuda.synchronize()
    assert kernels.symmetric_downdate.launches == before + 1
    ref = kernels.symmetric_downdate_ref(P, K, K if same else PHt)
    for b in range(n):
        tol = 1e-5 * max(1.0, P[b].abs().sum(dim=1).max().item())
        assert (out[b] - ref[b]).abs().max().item() <= tol
        assert torch.equal(out[b], out[b].T)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(None, 0, 0), (0, None, None), (1, 0, 2)],
                         ids=str)
def test_cuda_batched_downdate_broadcast(dims):
    """Unbatched operands broadcast to the batch, and a batch dimension that
    is not the first: against single kernel calls at 1e-5·max(1, ‖P‖∞)."""
    _need_gpu()
    P, K, PHt = _batched_inputs(3, 270, 231, False)
    args = [x[0] if d is None else x.movedim(0, d).contiguous()
            for x, d in zip((P, K, PHt), dims)]
    out = torch.func.vmap(kernels.symmetric_downdate, in_dims=dims)(*args)
    for b in range(3):
        one = kernels.symmetric_downdate(*(
            a if d is None else a.select(d, b).contiguous()
            for a, d in zip(args, dims)))
        tol = 1e-5 * max(1.0, one.abs().sum(dim=1).max().item())
        assert (out[b] - one).abs().max().item() <= tol
        assert torch.equal(out[b], out[b].T)


@pytest.mark.cuda
def test_cuda_batched_single_product_matches_two():
    """K passed twice under vmap takes the single product; an equal copy
    the two-product form: both agree within the tolerance."""
    _need_gpu()
    P, K, _ = _batched_inputs(8, 270, 231, True)
    one = torch.func.vmap(lambda p, k: kernels.symmetric_downdate(p, k, k))(
        P, K)
    two = torch.func.vmap(kernels.symmetric_downdate)(P, K, K.clone())
    tol = 1e-5 * max(1.0, P.abs().sum(dim=2).max().item())
    assert (one - two).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_qr_vmap_rule():
    """householder_qr_blocks under vmap: the streams folded into the block
    axis, one launch, equal to per-stream launches (the same kernel on the
    same blocks)."""
    _need_gpu()
    A = torch.stack([torch.from_numpy(stack_blocks(1174, 271, seed=b))
                     for b in range(3)]).cuda()
    before = kernels.householder_qr_blocks.launches
    R = torch.func.vmap(kernels.householder_qr_blocks)(A)
    torch.cuda.synchronize()
    assert kernels.householder_qr_blocks.launches == before + 1
    for b in range(3):
        assert torch.equal(R[b], kernels.householder_qr_blocks(A[b]))


@pytest.mark.cuda
def test_cuda_ensemble_step_matches_single_streams():
    """`runner.run_ensemble`'s batched step on the card at a small size (3
    streams, 5 clones, 4 landmarks, ACI²), frame by frame from one state,
    against each stream's own step: covariance within 1e-5·‖P‖∞ (5e-5 in
    a step that initializes a landmark), one downdate launch per batched
    step."""
    _need_gpu()
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import manager
    from open_vins_tpu_torch.models import triangulation as tri

    params = simulator.SimParams(imu_rate=100.0, cam_rate=10.0, num_cams=1,
                                 num_pts=12, map_size=128, duration=1.0)
    cfg = FilterConfig(max_clones=5, max_slam=4, num_cams=1,
                       max_msckf_in_update=8, integration="analytical")
    opts = tri.TriangulationOptions(max_runs=2)
    calibs, runs = runner.stage_ensemble(params, range(3), "cuda")
    state, table = runner.ensemble_start(cfg, calibs, runs, 64)
    step = runner.ensemble_step(cfg, opts)
    for k in range(runs.frames.t_new.shape[1]):
        frame = runner.ensemble_frame(runs, k)
        before = kernels.symmetric_downdate.launches
        post = step(state, table, frame)
        assert kernels.symmetric_downdate.launches == before + 1
        for b in range(3):
            one = manager.step_frame(runner.record_at(state, b),
                                     runner.record_at(table, b), cfg, opts,
                                     runner.record_at(frame, b))
            new = bool((one[0].slam_valid
                        & ~runner.record_at(state, b).slam_valid).any())
            norm = one[0].cov.abs().sum(dim=1).max().item()
            gap = (post[0].cov[b] - one[0].cov).abs().max().item()
            assert gap <= (5e-5 if new else 1e-5) * norm, (k, b, gap / norm)
            assert torch.equal(post[1].ids[b], one[1].ids)
        state, table = post[0], post[1]


@pytest.mark.cuda
def test_cuda_front_end_matches_cpu():
    """The renderer and the stereo KLT tracker on the card against the
    same code on the CPU, on one 320x240 stream built on the CPU (a stream
    staged on each device differs by up to 1e-3 px in its projections):
    images within 5e-5 (each device's f32 image is within about 2e-5 of a
    float64 evaluation, tests/test_torch_render.py, so two differ by up to
    twice that; 3.1e-5 was seen), every frame's ids and masks equal and
    points within 1e-3 px, both drawing the same RANSAC sets (from one CPU
    generator each, seeded alike)."""
    _need_gpu()
    import torch.utils._pytree as pytree

    from open_vins_tpu_torch.frontend import klt, ransac

    params = simulator.SimParams(num_cams=2, num_pts=40, map_size=256,
                                 duration=0.25, width=320, height=240,
                                 min_depth=4.0, max_depth=9.0)
    kp = klt.KltParams(num_pyr=4, win=7, iters=12, num_features=40,
                       grid_x=8, grid_y=6)
    sim_cpu = simulator.build(params, seed=0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        sim = pytree.tree_map(lambda v, dev=dev: v.to(dev), sim_cpu)
        gen = torch.Generator().manual_seed(3)
        sets_of = (lambda mask, gen=gen, dev=dev: ransac.draw_sets(
            mask.cpu(), gen).to(dev))
        imgs = runner.render_frames(sim, params, 5, device=dev)
        tstate = runner.start_tracker(sim.cam_intr, params, kp, "STRETCH",
                                      sets_of, imgs[0])
        packets = []
        for k in range(1, 5):
            tstate, *pk = runner.track_images(tstate, imgs[k], sim.cam_intr,
                                              params, kp, False, "STRETCH",
                                              sets_of)
            packets.append([np_of(x) for x in pk])
        out[dev] = (np_of(imgs), packets)
    assert abs(out["cuda"][0] - out["cpu"][0]).max() <= 5e-5
    for k, (got, want) in enumerate(zip(out["cuda"][1], out["cpu"][1])):
        (ids, uv, _, mask), (ids0, uv0, _, mask0) = got, want
        assert (mask == mask0).all() and (ids == ids0).all(), k
        assert abs(uv[mask] - uv0[mask]).max() <= 1e-3, k
        assert mask.sum() > 30, k


# imu_rk4_window: (streams, padded samples) of the fixture's 11-sample
# windows with seeded non-identity intrinsics and a FEJ point off the
# estimate; q, p, v to 1e-5 absolute, Φ and Qd to 1e-5 of their largest entry
RK4_SIGMAS = (1.6968e-4, 2.0e-3, 1.9393e-5, 3.0e-3)
RK4_CASES = [(1, 0), (1, 3), (7, 0), (7, 3), (4096, 0), (4096, 3)]


def _rk4_batched(fn, in_dims=0):
    return torch.func.vmap(lambda *o: fn(*o, 9.81, *RK4_SIGMAS),
                           in_dims=in_dims)


def _check_rk4(got, want):
    got = [g.cpu() for g in got]
    assert (got[0] - want[0]).abs().max().item() <= 1e-5
    for g, w in zip(got[1:], want[1:]):
        err = (g - w).abs().amax(dim=(-2, -1))
        assert (err <= 1e-5 * w.abs().amax(dim=(-2, -1))).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,pad", RK4_CASES)
def test_cuda_rk4_window_matches_plain_version(B, pad):
    """The kernel against the plain version (on the CPU), one launch per
    batched call; at B = 1 the unbatched call too."""
    _need_gpu()
    ops = [torch.from_numpy(z) for z in imu_window_inputs(B, pad, seed=B)]
    want = _rk4_batched(kernels.imu_rk4_window_ref)(*ops)
    before = kernels.imu_rk4_window.launches
    got = _rk4_batched(kernels.imu_rk4_window)(*(o.cuda() for o in ops))
    torch.cuda.synchronize()
    assert kernels.imu_rk4_window.launches == before + 1
    _check_rk4(got, want)
    if B == 1:
        one = kernels.imu_rk4_window(*(o[0].cuda() for o in ops), 9.81,
                                     *RK4_SIGMAS)
        assert kernels.imu_rk4_window.launches == before + 2
        _check_rk4([r[None] for r in one], want)


@pytest.mark.cuda
@pytest.mark.parametrize("in_dims", [(0, 0, None, None, None),
                                     (1, None, 0, 0, 0)])
def test_cuda_rk4_window_vmap_rule(in_dims):
    """An unbatched operand (the window, or the matrices) is read by every
    stream, a batch dimension that is not the first is moved: one launch."""
    _need_gpu()
    full = [torch.from_numpy(z) for z in imu_window_inputs(5, 3, seed=1)]
    full = [o if d is not None else o[:1].expand_as(o).contiguous()
            for o, d in zip(full, in_dims)]
    want = _rk4_batched(kernels.imu_rk4_window_ref)(*full)
    ops = [o if d == 0 else (o[0] if d is None else o.movedim(0, d))
           for o, d in zip(full, in_dims)]
    before = kernels.imu_rk4_window.launches
    got = _rk4_batched(kernels.imu_rk4_window, in_dims)(
        *(o.cuda() for o in ops))
    torch.cuda.synchronize()
    assert kernels.imu_rk4_window.launches == before + 1
    _check_rk4(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("integration,launches", [("rk4", 1),
                                                  ("analytical", 0)])
def test_cuda_propagate_routes_rk4_window(integration, launches):
    """propagate on the card launches the kernel for rk4 and not for ACI²,
    and matches the CPU's propagate (the plain version for rk4)."""
    _need_gpu()
    from open_vins_tpu_torch.core import state as tstate
    from open_vins_tpu_torch.core.layout import FilterConfig
    from open_vins_tpu_torch.models import propagator

    cfg = FilterConfig(max_clones=11, max_slam=0, integration=integration)
    x, _, t, w, a = (torch.from_numpy(z[0]) for z in imu_window_inputs(1, 3))
    q, p, v, q_fej, p_fej, v_fej, bg, ba = torch.split(
        x, (4, 3, 3, 4, 3, 3, 3, 3))
    outs = []
    for dev in ("cpu", "cuda"):
        st = tstate.init_state(cfg, dev).replace(
            q=q.to(dev), p=p.to(dev), v=v.to(dev), q_fej=q_fej.to(dev),
            p_fej=p_fej.to(dev), v_fej=v_fej.to(dev), bg=bg.to(dev),
            ba=ba.to(dev))
        before = kernels.imu_rk4_window.launches
        outs.append(propagator.propagate(
            st, cfg, propagator.ImuWindow(t=t.to(dev), w=w.to(dev),
                                          a=a.to(dev)), float(t[-1])))
    torch.cuda.synchronize()
    assert kernels.imu_rk4_window.launches == before + launches
    cpu, card = outs
    for k in ("q", "p", "v"):
        assert (getattr(card, k).cpu() - getattr(cpu, k)).abs().max() <= 1e-5
    assert ((card.cov.cpu() - cpu.cov).abs().max()
            <= 1e-5 * cpu.cov.abs().max())


# msckf_linearize: H_proj and res_proj element by element to LIN_TOL of
# each feature's largest entry, γ to LIN_GAMMA_TOL of max(γ, 1), the rows
# exactly.  The kernel sums in other orders and with FMA, and forms S from
# the unprojected blocks in float64; on these inputs the plain version
# itself lies within 3e-6, 7e-5 and 4e-5 of its own float64 run
LIN_TOL, LIN_GAMMA_TOL = 2e-4, 1e-3


def _check_linearize(got, want):
    (H, r, n, g), (H0, r0, n0, g0) = [o.cpu() for o in got], want
    assert torch.equal(n, n0)
    assert H.shape == H0.shape and r.shape == r0.shape
    scale = H0.abs().amax(dim=(-2, -1)).clamp(min=1.0)
    assert ((H - H0).abs().amax(dim=(-2, -1)) <= LIN_TOL * scale).all()
    scale = r0.abs().amax(dim=-1).clamp(min=1.0)
    assert ((r - r0).abs().amax(dim=-1) <= LIN_TOL * scale).all()
    assert ((g - g0).abs() <= LIN_GAMMA_TOL * g0.abs().clamp(min=1.0)).all()


def _to_cuda(record):
    return type(record)(**{k: v.cuda() for k, v in record.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kw", LINEARIZE_CASES)
def test_cuda_msckf_linearize_matches_plain_version(layout, kw):
    """The kernel against the plain version (on the CPU), vmapped over 5
    streams in one launch, and one stream unbatched."""
    _need_gpu()
    cfg, st, gobs, p_f = linearize_inputs(layout, F=40, streams=5, **kw)
    fn = torch.func.vmap(
        lambda s, g, p: kernels.msckf_linearize(s, cfg, g, p))
    want = fn(st, gobs, p_f)
    before = kernels.msckf_linearize.launches
    got = fn(_to_cuda(st), _to_cuda(gobs), p_f.cuda())
    torch.cuda.synchronize()
    assert kernels.msckf_linearize.launches == before + 1
    _check_linearize(got, want)
    one = kernels.msckf_linearize(
        type(st)(**{k: v[0].cuda() for k, v in st.items()}), cfg,
        type(gobs)(**{k: v[0].cuda() for k, v in gobs.items()}),
        p_f[0].cuda())
    assert kernels.msckf_linearize.launches == before + 2
    _check_linearize([o[None] for o in one], [o[:1] for o in want])
