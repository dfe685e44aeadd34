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
from torch_port_helpers import (check_r_factors, downdate_inputs, np_of,
                                oracle_blocks, stack_blocks)

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
