"""Sparse pyramidal Lucas-Kanade tracking, grid corner detection and the
pre-tracking equalizations.

Counterpart of `open_vins_tpu/frontend/klt.py` (TrackKLT.cpp:34-886 and
Grider_GRID.h:46-74), everything in it: the 2x2 average-pooled pyramid,
central-difference gradients with wrap-around, the patch samplers, both LK
level paths (the full-image one, `iter_margin=0`, and the patch-local
default) and `track`, the Shi-Tomasi grid detector with occupancy dedup and
sub-pixel refinement, and the NONE / HISTOGRAM / CLAHE / STRETCH
equalizations.

The reference extracts patches with one-hot matrix products (a TPU
workaround for slow gathers); here a patch is plain clamped integer
indexing of the image on [F, S] row and column grids.  The one-hot products
pick single elements exactly, so the patches are the same numbers.  The
reference's `fori_loop`s are fixed Python loops with the same masks: no
data-dependent exit, so no host read.

Images are float32 [H, W] in [0, 1]; points are [N, 2] (x, y) pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class KltParams(NamedTuple):
    num_pyr: int = 4  # pyramid levels (TrackKLT pyr_levels)
    win: int = 10  # half window -> patch (2*win+1)^2 (win_size 21x21)
    iters: int = 10  # LK iterations per level
    min_eig: float = 1e-4  # minimum GN conditioning
    max_flow: float = 40.0  # per-level divergence guard (pixels)
    grid_x: int = 10  # detection grid (grid_x × grid_y cells)
    grid_y: int = 8
    min_px_dist: int = 10  # occupancy dedup radius
    num_features: int = 200
    # patch-local LK: per level ONE img1 patch with this margin ring is
    # taken per feature and every iteration samples inside it; a track
    # whose in-level excursion exceeds the margin is dropped.  0 = the
    # full-image iteration.
    iter_margin: int = 8


def _avgpool2(x):
    """2x2 / stride-2 average pool; odd sizes are cropped first.  The four
    taps are summed in window order, as XLA's reduce_window sums them."""
    h2, w2 = (x.shape[-2] // 2) * 2, (x.shape[-1] // 2) * 2
    x = x[..., :h2, :w2]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    s = s + x[..., 1::2, 1::2]
    return 0.25 * s


def build_pyramid(img, levels):
    """[H, W] -> list of `levels` images (2x2 average pooled)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_avgpool2(pyr[-1]))
    return pyr


def _grad(img):
    """Central-difference gradients with wrap-around at the borders."""
    gx = 0.5 * (torch.roll(img, -1, dims=-1) - torch.roll(img, 1, dims=-1))
    gy = 0.5 * (torch.roll(img, -1, dims=-2) - torch.roll(img, 1, dims=-2))
    return gx, gy


def _bilinear(img, y, x):
    """Bilinear sample of img [H, W] at float coordinates y, x [...],
    clamped to the image."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 2)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 2)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x0i + 1]
    v10 = img[y0i + 1, x0i]
    v11 = img[y0i + 1, x0i + 1]
    return (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx
            + v10 * dy * (1 - dx) + v11 * dy * dx)


def _window(base, half, size, limit):
    """[F, size] clamped indices base - half + 0..size-1 into [0, limit)."""
    ar = torch.arange(size, device=base.device)
    return torch.clamp(base[:, None] - half + ar[None, :], 0, limit - 1)


def extract_patches(img, centers, half):
    """Integer-base patches around float centers [F, 2] (x, y).

    Returns (patches [F, S, S], fx [F], fy [F]) with S = 2·half + 2,
    patches[f, i, j] = img[y0 + i, x0 + j] (indices clamped), y0 =
    floor(cy) − half, x0 = floor(cx) − half, and (fx, fy) the fractional
    parts; `shift_patches` turns them into the bilinear sample at the
    center."""
    H, W = img.shape
    S = 2 * half + 2
    x0 = torch.floor(centers[:, 0])
    y0 = torch.floor(centers[:, 1])
    ridx = _window(y0.to(torch.int64), half, S, H)
    cidx = _window(x0.to(torch.int64), half, S, W)
    patches = img[ridx[:, :, None], cidx[:, None, :]]
    return patches, centers[:, 0] - x0, centers[:, 1] - y0


def shift_patches(patches, fx, fy):
    """Bilinear sample of integer-base patches at their fractional center:
    [F, S, S] -> [F, S-1, S-1] (the four weights are scalars per
    feature)."""
    wx = fx[:, None, None]
    wy = fy[:, None, None]
    return ((1 - wy) * (1 - wx) * patches[:, :-1, :-1]
            + (1 - wy) * wx * patches[:, :-1, 1:]
            + wy * (1 - wx) * patches[:, 1:, :-1]
            + wy * wx * patches[:, 1:, 1:])


def _sample_patches(img, centers, half):
    """[F, 2·half+1, 2·half+1] bilinear patches at float centers."""
    p, fx, fy = extract_patches(img, centers, half)
    return shift_patches(p, fx, fy)


def sample_inpatch(P, cy, cx, half):
    """Bilinear (2·half+1)² windows sampled inside integer-base patches
    P [F, S, S] at float centers (cy, cx) [F] in patch coordinates;
    out-of-patch indices clamp (callers gate on the excursion)."""
    Fn, S, _ = P.shape
    So = 2 * half + 2
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    ridx = _window(y0.to(torch.int64), half, So, S)
    cidx = _window(x0.to(torch.int64), half, So, S)
    f = torch.arange(Fn, device=P.device)[:, None, None]
    Q = P[f, ridx[:, :, None], cidx[:, None, :]]
    return shift_patches(Q, cx - x0, cy - y0)


def _structure(ix, iy, params: KltParams):
    """The LK normal matrix [[a, b], [b, c]] per feature, its conditioning
    gate and 1/det (0 where singular)."""
    a = torch.sum(ix * ix, dim=(1, 2))
    b = torch.sum(ix * iy, dim=(1, 2))
    c = torch.sum(iy * iy, dim=(1, 2))
    det = a * c - b * b
    tr = a + c
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det,
                                                 min=0.0)))
    npix = (2 * params.win + 1) ** 2
    cond_ok = min_eig / npix > params.min_eig
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
    return a, b, c, cond_ok, inv_det


def _lk_step(flow, e, ix, iy, a, b, c, inv_det):
    bx = torch.sum(e * ix, dim=(1, 2))
    by = torch.sum(e * iy, dim=(1, 2))
    du = inv_det * (c * bx - b * by)
    dv = inv_det * (-b * bx + a * by)
    return flow - torch.stack([du, dv], dim=-1)


def _track_level(img0, img1, gx0, gy0, pts0, guess, params: KltParams):
    """One pyramid level of LK over the full image (`iter_margin=0`).
    pts0 [N, 2] in this level's pixels, guess [N, 2] the current flow.
    Returns (flow [N, 2], ok [N])."""
    w = params.win
    t0 = _sample_patches(img0, pts0, w)
    ix = _sample_patches(gx0, pts0, w)
    iy = _sample_patches(gy0, pts0, w)
    a, b, c, cond_ok, inv_det = _structure(ix, iy, params)
    flow = guess
    for _ in range(params.iters):
        t1 = _sample_patches(img1, pts0 + flow, w)
        flow = _lk_step(flow, t1 - t0, ix, iy, a, b, c, inv_det)
    ok = cond_ok & (torch.linalg.vector_norm(flow - guess, dim=-1)
                    < params.max_flow)
    return flow, ok


def _track_level_local(img0, img1, pts0, guess, params: KltParams):
    """One pyramid level of LK, patch-local: template and gradients from
    one img0 patch (central differences inside it), one img1 patch with a
    margin ring of `iter_margin` per feature, and every iteration samples
    inside that patch.  Tracks whose in-level excursion from the warm start
    reaches `iter_margin − 1` are dropped."""
    w = params.win
    m = params.iter_margin
    B = _sample_patches(img0, pts0, w + 1)  # [F, 2w+3, 2w+3]
    t0 = B[:, 1:-1, 1:-1]
    ix = 0.5 * (B[:, 1:-1, 2:] - B[:, 1:-1, :-2])
    iy = 0.5 * (B[:, 2:, 1:-1] - B[:, :-2, 1:-1])
    a, b, c, cond_ok, inv_det = _structure(ix, iy, params)

    base = pts0 + guess
    P1, _, _ = extract_patches(img1, base, w + m)  # [F, S1, S1]
    bx0 = torch.floor(base[:, 0]) - (w + m)
    by0 = torch.floor(base[:, 1]) - (w + m)
    flow = guess
    maxexc = torch.zeros(pts0.shape[0], dtype=img0.dtype, device=img0.device)
    for _ in range(params.iters):
        ctr = pts0 + flow
        t1 = sample_inpatch(P1, ctr[:, 1] - by0, ctr[:, 0] - bx0, w)
        flow = _lk_step(flow, t1 - t0, ix, iy, a, b, c, inv_det)
        exc = torch.amax(torch.abs(flow - guess), dim=-1)
        maxexc = torch.maximum(maxexc, exc)
    ok = (cond_ok & (maxexc < m - 1.0)
          & (torch.linalg.vector_norm(flow - guess, dim=-1)
             < params.max_flow))
    return flow, ok


def track(img0, img1, pts0, params: KltParams, initial_flow=None):
    """Pyramidal LK: track pts0 [N, 2] (x, y) from img0 to img1
    (TrackKLT::perform_matching's calcOpticalFlowPyrLK, TrackKLT.cpp:829-886,
    with an initial-flow warm start).  Returns (pts1 [N, 2], ok [N])."""
    if 0 < params.iter_margin < 3:
        # the local path's gate is `maxexc < iter_margin - 1`: margin 1
        # drops every track and margin 2 allows under 1 px of refinement
        raise ValueError(
            f"iter_margin={params.iter_margin}: use 0 (exact full-image "
            "path) or >= 3 (patch-local path needs >= 2 px of usable "
            "excursion before its margin gate)")
    L = params.num_pyr
    pyr0 = build_pyramid(img0, L)
    pyr1 = build_pyramid(img1, L)
    local = params.iter_margin > 0
    grads = None if local else [_grad(p) for p in pyr0]

    N = pts0.shape[0]
    flow = (initial_flow if initial_flow is not None
            else torch.zeros((N, 2), dtype=img0.dtype, device=img0.device)
            ) / (2.0 ** (L - 1))
    ok_all = torch.ones((N,), dtype=torch.bool, device=img0.device)
    for lev in range(L - 1, -1, -1):
        pts_l = pts0 / 2.0 ** lev
        if local:
            flow, ok = _track_level_local(pyr0[lev], pyr1[lev], pts_l, flow,
                                          params)
        else:
            flow, ok = _track_level(pyr0[lev], pyr1[lev], grads[lev][0],
                                    grads[lev][1], pts_l, flow, params)
        ok_all = ok_all & ok
        if lev > 0:
            flow = flow * 2.0
    pts1 = pts0 + flow
    H, W = img0.shape
    inb = ((pts1[:, 0] > 2) & (pts1[:, 0] < W - 3)
           & (pts1[:, 1] > 2) & (pts1[:, 1] < H - 3))
    return pts1, ok_all & inb


def _boxsum(x, win):
    """Zero-padded (2·win+1)² box sums of x [..., H, W] (reduce_window
    "SAME"), as shifted-slice sums along each axis."""
    H, W = x.shape[-2:]
    k = 2 * win + 1
    xp = F.pad(x, (win, win, win, win))
    rows = xp[..., 0:H, :]
    for i in range(1, k):
        rows = rows + xp[..., i:i + H, :]
    out = rows[..., 0:W]
    for j in range(1, k):
        out = out + rows[..., j:j + W]
    return out


def shi_tomasi_response(img, win=2):
    """Dense min-eigenvalue corner response (goodFeaturesToTrack analog)."""
    gx, gy = _grad(img)
    a, b, c = _boxsum(torch.stack([gx * gx, gx * gy, gy * gy]), win)
    tr = a + c
    det = a * c - b * b
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def detect_grid(img, occupancy_pts, occupancy_mask, params: KltParams,
                max_new: int):
    """Grid corner detection with occupancy dedup
    (TrackKLT::perform_detection_monocular, TrackKLT.cpp:395-529, with
    Grider_GRID): the best corner of every grid cell away from existing
    features, the top `max_new` over cells, refined to sub-pixel.

    Returns (pts [max_new, 2], ok [max_new])."""
    H, W = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    border = 8
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    inb = ((xx >= border) & (xx < W - border) & (yy >= border)
           & (yy < H - border))
    neg = torch.full((), -1.0, dtype=resp.dtype, device=dev)
    resp = torch.where(inb, resp, neg)

    # occupancy: cells of min_px_dist pixels that hold a kept feature (the
    # reference's scatter-max of booleans; an int sum is order-free)
    cell = params.min_px_dist
    gw, gh = (W + cell - 1) // cell, (H + cell - 1) // cell
    ox = torch.clamp((occupancy_pts[:, 0] / cell).to(torch.int64), 0, gw - 1)
    oy = torch.clamp((occupancy_pts[:, 1] / cell).to(torch.int64), 0, gh - 1)
    occ = torch.zeros((gh, gw), dtype=torch.int32, device=dev)
    occ.index_put_((oy, ox), occupancy_mask.to(torch.int32), accumulate=True)
    occ_full = (occ > 0)[:, None, :, None].expand(gh, cell, gw, cell)
    occ_full = occ_full.reshape(gh * cell, gw * cell)[:H, :W]
    resp = torch.where(occ_full, neg, resp)

    # per-cell best corner (first maximum, as jnp.argmax)
    gx_n, gy_n = params.grid_x, params.grid_y
    ch = (H + gy_n - 1) // gy_n
    cw = (W + gx_n - 1) // gx_n
    rp = torch.full((ch * gy_n, cw * gx_n), -1.0, dtype=resp.dtype,
                    device=dev)
    rp[:H, :W] = resp
    cells = rp.reshape(gy_n, ch, gx_n, cw).permute(0, 2, 1, 3)
    cells = cells.reshape(-1, ch * cw)
    best = torch.argmax(cells, dim=1)
    best_val = torch.gather(cells, 1, best[:, None])[:, 0]
    cy = best // cw
    cx = best % cw
    g = torch.arange(gy_n * gx_n, device=dev)
    px = ((g % gx_n) * cw + cx).to(img.dtype)
    py = ((g // gx_n) * ch + cy).to(img.dtype)

    # lax.top_k: descending, ties by lower index — a stable sort
    k = min(max_new, px.shape[0])
    val, idx = torch.sort(best_val, descending=True, stable=True)
    val, idx = val[:k], idx[:k]
    pts = torch.stack([px[idx], py[idx]], dim=1)
    ok = val > 1e-6
    if k < max_new:
        pts = torch.cat([pts, torch.zeros((max_new - k, 2), dtype=img.dtype,
                                          device=dev)])
        ok = torch.cat([ok, torch.zeros((max_new - k,), dtype=torch.bool,
                                        device=dev)])
    # sub-pixel refinement (cv::cornerSubPix on every detection,
    # Grider_FAST.h:46-73)
    pts = corner_subpix(img, pts, ok)
    return pts, ok


def corner_subpix(img, pts, ok, win=4, iters=3):
    """Sub-pixel corner refinement (cv::cornerSubPix): at the true corner q
    the gradient at every window pixel p is orthogonal to q − p, so q solves
    [Σ ∇I∇Iᵀ] q = Σ (∇I∇Iᵀ) p over the (2·win+1)² window.  `iters` fixed
    re-centered iterations with the step clamped to 1 px inside one
    gradient patch per corner; singular or diverged refinements keep the
    integer corner.  Returns the refined pts [N, 2] (invalid rows pass
    through)."""
    gx, gy = _grad(img)
    half_base = win + iters + 1
    Pgx, _, _ = extract_patches(gx, pts, half_base)
    Pgy, _, _ = extract_patches(gy, pts, half_base)
    bx0 = torch.floor(pts[:, 0]) - half_base
    by0 = torch.floor(pts[:, 1]) - half_base
    offs = torch.arange(-win, win + 1, device=img.device).to(img.dtype)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    q = pts
    for _ in range(iters):
        lx = q[:, 0] - bx0
        ly = q[:, 1] - by0
        ixp = sample_inpatch(Pgx, ly, lx, win)
        iyp = sample_inpatch(Pgy, ly, lx, win)
        px = q[:, 0, None, None] + ox
        py = q[:, 1, None, None] + oy
        a = torch.sum(ixp * ixp, dim=(1, 2))
        b = torch.sum(ixp * iyp, dim=(1, 2))
        c = torch.sum(iyp * iyp, dim=(1, 2))
        bx = torch.sum(ixp * ixp * px + ixp * iyp * py, dim=(1, 2))
        by = torch.sum(ixp * iyp * px + iyp * iyp * py, dim=(1, 2))
        det = a * c - b * b
        inv = torch.where(torch.abs(det) > 1e-12, 1.0 / det,
                          torch.zeros_like(det))
        qn = torch.stack([inv * (c * bx - b * by), inv * (-b * bx + a * by)],
                         dim=-1)
        qn = torch.where((inv == 0.0)[:, None], q, qn)
        q = q + torch.clamp(qn - q, -1.0, 1.0)
    good = ok & (torch.linalg.vector_norm(q - pts, dim=-1) < win)
    return torch.where(good[:, None], q, pts)


def equalize(img):
    """Global contrast stretch between mean ± 2.3σ (population σ, as
    jnp.std), clipped to [0, 1] — the reference's rank-free STRETCH."""
    mu = torch.mean(img)
    sd = torch.std(img, correction=0)
    lo = mu - 2.3 * sd
    hi = mu + 2.3 * sd
    return torch.clamp((img - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


_EQ_BINS = 256


def _hist_lut(counts, total):
    """Equalization LUTs [..., 256] from bin counts [..., 256]: the
    normalized cdf with the cdf-min offset (cv::equalizeHist)."""
    cdf = torch.cumsum(counts, dim=-1)
    first = torch.argmax((counts > 0).to(torch.int32), dim=-1, keepdim=True)
    cdf_min = torch.gather(cdf, -1, first)
    denom = torch.clamp(total - cdf_min, min=1.0)
    return torch.clamp((cdf - cdf_min) / denom, 0.0, 1.0)


def _quantize(img):
    return torch.clamp((img * (_EQ_BINS - 1)).to(torch.int64), 0,
                       _EQ_BINS - 1)


def equalize_hist(img):
    """Full-image histogram equalization (cv::equalizeHist,
    TrackKLT.cpp:58-60)."""
    q = _quantize(img)
    counts = torch.bincount(q.reshape(-1), minlength=_EQ_BINS).to(img.dtype)
    total = torch.full((1,), float(img.numel()), dtype=img.dtype,
                       device=img.device)
    return _hist_lut(counts, total)[q]


def equalize_clahe(img, clip_limit=10.0, grid=8):
    """Contrast-limited adaptive histogram equalization
    (cv::createCLAHE(10, (8, 8)), TrackKLT.cpp:61-64): per-tile histograms
    (ceil-sized tiles), each bin clipped at clip_limit × the uniform level
    with the excess spread uniformly, and every pixel interpolated
    bilinearly between its four neighbouring tiles' LUTs."""
    H, W = img.shape
    dev = img.device
    th = -(-H // grid)
    tw = -(-W // grid)
    q = _quantize(img)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)
    tile = (yy // th) * grid + (xx // tw)
    flat = (tile * _EQ_BINS + q).reshape(-1)
    counts = torch.bincount(flat, minlength=grid * grid * _EQ_BINS)
    counts = counts.to(img.dtype).reshape(grid * grid, _EQ_BINS)
    tile_total = counts.sum(dim=1, keepdim=True)
    limit = clip_limit * torch.clamp(tile_total / _EQ_BINS, min=1.0)
    clipped = torch.minimum(counts, limit)
    excess = (counts - clipped).sum(dim=1, keepdim=True)
    luts = _hist_lut(clipped + excess / _EQ_BINS, tile_total)  # [T, 256]

    cy = (yy + 0.5) / th - 0.5  # tile-center coordinates
    cx = (xx + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, grid - 1)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, grid - 1)
    y1 = torch.clamp(y0 + 1, 0, grid - 1)
    x1 = torch.clamp(x0 + 1, 0, grid - 1)
    fy = torch.clamp(cy - y0, 0.0, 1.0).to(img.dtype)
    fx = torch.clamp(cx - x0, 0.0, 1.0).to(img.dtype)
    v00 = luts[y0 * grid + x0, q]
    v01 = luts[y0 * grid + x1, q]
    v10 = luts[y1 * grid + x0, q]
    v11 = luts[y1 * grid + x1, q]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def equalize_method(img, method: str):
    """The configured pre-tracking normalization
    (TrackBase::HistogramMethod NONE / HISTOGRAM / CLAHE,
    TrackKLT.cpp:56-75, and the STRETCH of `equalize`)."""
    m = method.upper()
    if m == "NONE":
        return img
    if m == "CLAHE":
        return equalize_clahe(img)
    if m == "HISTOGRAM":
        return equalize_hist(img)
    if m == "STRETCH":
        return equalize(img)
    raise ValueError(f"unknown histogram_method: {method}")


def downsample2(img):
    """2x2 average-pool halving (the reference's downsample_cameras pyrDown
    role, TrackBase.h:106; pair with halved fx, fy, cx, cy)."""
    return _avgpool2(img)
