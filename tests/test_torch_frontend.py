"""The port's KLT, RANSAC and equalizers against the JAX package's, on the
same numpy-made images and points (CPU, small sizes).

Tolerances: patches from `extract_patches` and `sample_inpatch` bit-equal
(the reference's one-hot products pick single elements exactly); the
pyramid and gradients bit-equal; `klt.track` points within 1e-3 px where
both keep a track, `ok` differing in at most 1 % of tracks (both LK paths);
`detect_grid` points identical in at least 95 % of detections (the
Shi-Tomasi response within 1e-5 of its largest value); the
equalizers within 1e-5; `_eight_point` F equal up to sign and scale at
1e-4; `ransac_from_sets` inliers equal to JAX's `ransac_fundamental` on the
same hypothesis sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_vins_tpu.frontend import klt as jklt
from open_vins_tpu.frontend import ransac as jransac
from open_vins_tpu_torch.frontend import klt, ransac
from torch_port_helpers import np_of, one_torch_thread, t  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PARAMS = klt.KltParams(num_pyr=4, win=7, iters=12, num_features=60,
                       grid_x=8, grid_y=6)
JPARAMS = jklt.KltParams(*PARAMS)


def texture(h=240, w=320, seed=0, octaves=4):
    """Smooth random multi-scale texture in [0, 1] (numpy, float32)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w))
    for o in range(octaves):
        s = 2 ** o
        small = rng.normal(size=(h // (4 * s) + 2, w // (4 * s) + 2))
        img += np.kron(small, np.ones((4 * s, 4 * s)))[:h, :w] / (o + 1)
    for ax in (0, 1):
        img = (0.25 * np.roll(img, 1, axis=ax) + 0.5 * img
               + 0.25 * np.roll(img, -1, axis=ax))
    img -= img.min()
    return (img / img.max()).astype(np.float32)


def warp(img, dx, dy, deg=0.0):
    """Bilinear warp in numpy: a point p of img appears at
    R(p − c) + c + (dx, dy) in the output."""
    H, W = img.shape
    th = np.deg2rad(deg)
    c, s = np.cos(th), np.sin(th)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    ux, uy = xx - dx - cx, yy - dy - cy
    sx = c * ux + s * uy + cx
    sy = -s * ux + c * uy + cy
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    fx, fy = np.clip(sx - x0, 0, 1), np.clip(sy - y0, 0, 1)
    out = (img[y0, x0] * (1 - fy) * (1 - fx) + img[y0, x0 + 1] * (1 - fy) * fx
           + img[y0 + 1, x0] * fy * (1 - fx) + img[y0 + 1, x0 + 1] * fy * fx)
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    img0 = texture(seed=3)
    img1 = warp(img0, 4.2, -2.6, deg=1.5)
    rng = np.random.default_rng(7)
    pts = np.concatenate([
        rng.uniform([12, 12], [308, 228], size=(56, 2)),
        np.array([[0.3, 0.2], [319.5, 239.2], [-3.5, 100.0], [150.0, 244.0]])
    ]).astype(np.float32)
    return img0, img1, pts


def test_extract_and_inpatch_bit_equal(scene):
    img0, _, pts = scene
    for half in (3, 8, 15):
        pj, fxj, fyj = jklt.extract_patches(jnp.asarray(img0),
                                            jnp.asarray(pts), half)
        pt_, fx, fy = klt.extract_patches(t(img0), t(pts), half)
        np.testing.assert_array_equal(np_of(pt_), np.asarray(pj))
        np.testing.assert_array_equal(np_of(fx), np.asarray(fxj))
        np.testing.assert_array_equal(np_of(fy), np.asarray(fyj))
        # sub-windows at fractional centers inside (and past) the patch
        rng = np.random.default_rng(half)
        S = 2 * half + 2
        cy = rng.uniform(-1.0, S + 1.0, size=len(pts)).astype(np.float32)
        cx = rng.uniform(-1.0, S + 1.0, size=len(pts)).astype(np.float32)
        qj = jklt.sample_inpatch(pj, jnp.asarray(cy), jnp.asarray(cx), 2)
        q = klt.sample_inpatch(pt_, t(cy), t(cx), 2)
        np.testing.assert_array_equal(np_of(q), np.asarray(qj))
        sj = jklt._sample_patches(jnp.asarray(img0), jnp.asarray(pts), half)
        np.testing.assert_array_equal(
            np_of(klt._sample_patches(t(img0), t(pts), half)),
            np.asarray(sj))


def test_pyramid_grad_and_bilinear_bit_equal(scene):
    img0, _, pts = scene
    img = img0[:239, :317]  # odd sizes are cropped
    for a, b in zip(klt.build_pyramid(t(img), 4),
                    jklt.build_pyramid(jnp.asarray(img), 4)):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    for a, b in zip(klt._grad(t(img)), jklt._grad(jnp.asarray(img))):
        np.testing.assert_array_equal(np_of(a), np.asarray(b))
    np.testing.assert_array_equal(
        np_of(klt.downsample2(t(img))), np.asarray(jklt.downsample2(
            jnp.asarray(img))))
    y, x = pts[:, 1] + 0.37, pts[:, 0] - 0.61
    np.testing.assert_allclose(
        np_of(klt._bilinear(t(img), t(y), t(x))),
        np.asarray(jklt._bilinear(jnp.asarray(img), jnp.asarray(y),
                                  jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("iter_margin", [8, 0])
def test_track_matches_jax(scene, iter_margin):
    img0, img1, pts = scene
    p = PARAMS._replace(iter_margin=iter_margin)
    flow0 = np.tile(np.float32([[3.0, -2.0]]), (len(pts), 1))
    for init in (None, flow0):
        pj, okj = jax.jit(lambda a, b, c, f: jklt.track(
            a, b, c, JPARAMS._replace(iter_margin=iter_margin), f))(
            jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pts),
            None if init is None else jnp.asarray(init))
        pp, ok = klt.track(t(img0), t(img1), t(pts), p,
                           None if init is None else t(init))
        okj, ok = np.asarray(okj), np_of(ok)
        both = okj & ok
        assert both.sum() > 40
        assert (okj != ok).mean() <= 0.01
        np.testing.assert_allclose(np_of(pp)[both], np.asarray(pj)[both],
                                   rtol=0, atol=1e-3)


def test_small_iter_margin_rejected(scene):
    img0, _, pts = scene
    with pytest.raises(ValueError, match="iter_margin"):
        klt.track(t(img0), t(img0), t(pts), PARAMS._replace(iter_margin=2))


def test_detect_grid_matches_jax(scene):
    img0, img1, pts = scene
    occ = np.zeros(len(pts), bool)
    occ[::3] = True
    for img, occ_mask, n in ((img0, np.zeros(1, bool), 60), (img1, occ, 40),
                             (img0, occ, 70)):
        occ_pts = pts[:len(occ_mask)]
        pj, okj = jax.jit(lambda a, b, c: jklt.detect_grid(
            a, b, c, JPARAMS, n))(jnp.asarray(img), jnp.asarray(occ_pts),
                                  jnp.asarray(occ_mask))
        pp, ok = klt.detect_grid(t(img), t(occ_pts), torch.as_tensor(occ_mask),
                                 PARAMS, n)
        same = ((np_of(ok) == np.asarray(okj))
                & (np.abs(np_of(pp) - np.asarray(pj)).max(1) < 1e-4))
        assert same.mean() >= 0.95, same.mean()
        assert np_of(ok).sum() > 20
    # min-eigenvalue responses cancel: compare against the largest one
    want = np.asarray(jklt.shi_tomasi_response(jnp.asarray(img0)))
    np.testing.assert_allclose(np_of(klt.shi_tomasi_response(t(img0))),
                               want, rtol=0, atol=1e-5 * want.max())


@pytest.mark.parametrize("method", ["NONE", "STRETCH", "HISTOGRAM", "CLAHE"])
def test_equalizers_match_jax(scene, method):
    img0, _, _ = scene
    img = np.clip(0.6 * img0[:237, :301] + 0.1, 0, 1)  # not divisible by 8
    got = np_of(klt.equalize_method(t(img), method))
    want = np.asarray(jax.jit(lambda a: jklt.equalize_method(a, method))(
        jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        klt.equalize_method(t(img), "bogus")


def _two_view(rng, n, outliers):
    """n correspondences of a random scene seen from two poses, normalized
    coordinates, the given number corrupted."""
    X = rng.uniform(-2, 2, size=(n, 3)) + np.array([0, 0, 6.0])
    t_ = np.array([0.4, 0.1, 0.0])
    p0 = X[:, :2] / X[:, 2:3]
    X2 = X - t_
    p1 = X2[:, :2] / X2[:, 2:3] + rng.normal(size=(n, 2)) * 5e-4
    bad = rng.choice(n, outliers, replace=False)
    p1[bad] += rng.uniform(0.05, 0.2, size=(outliers, 2)) * rng.choice(
        [-1, 1], (outliers, 2))
    return p0.astype(np.float32), p1.astype(np.float32), bad


def draw_jax_sets(key, mask, num_hyp=64):
    """The hypothesis sets `ransac_fundamental` draws from `key` for
    `mask` (its Gumbel top-k), as a JAX array (traceable)."""
    def sample(k):
        g = jax.random.gumbel(k, (mask.shape[0],))
        return jax.lax.top_k(jnp.where(mask, g, -jnp.inf), 8)[1]

    return jax.vmap(sample)(jax.random.split(key, num_hyp))


def jax_sets(key, mask, num_hyp=64):
    """`draw_jax_sets` as numpy."""
    return np.array(draw_jax_sets(key, mask, num_hyp))


def test_eight_point_matches_jax():
    """On tests/test_frontend.py's 8-point data (a random translation,
    1e-4 noise): with 5e-4 noise the f32 solve's conditioning alone moves
    an entry by up to about 1e-4."""
    rng = np.random.default_rng(11)
    for trial in range(10):
        X = rng.uniform(-2, 2, size=(8, 3)) + np.array([0, 0, 6.0])
        X2 = X - rng.normal(size=3) * 0.3
        p0 = (X[:, :2] / X[:, 2:3]).astype(np.float32)
        p1 = (X2[:, :2] / X2[:, 2:3]).astype(np.float32)
        p1 += rng.normal(size=p1.shape).astype(np.float32) * 1e-4
        Fj = np.asarray(jransac._eight_point(jnp.asarray(p0),
                                             jnp.asarray(p1)))
        F = np_of(ransac._eight_point(t(p0), t(p1)))
        Fj, F = Fj / np.linalg.norm(Fj), F / np.linalg.norm(F)
        F = F * np.sign(np.sum(F * Fj))
        np.testing.assert_allclose(F, Fj, rtol=0, atol=1e-4,
                                   err_msg=f"trial {trial}")
    # batched over hypotheses: the same as one at a time
    sets = np.stack([rng.choice(30, 8, replace=False) for _ in range(5)])
    p0, p1, _ = _two_view(rng, 30, 0)
    Fb = np_of(ransac._eight_point(t(p0)[sets], t(p1)[sets]))
    for k, s in enumerate(sets):
        np.testing.assert_allclose(
            Fb[k], np_of(ransac._eight_point(t(p0[s]), t(p1[s]))),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["outliers", "masked", "few"])
def test_ransac_from_sets_matches_jax(case):
    rng = np.random.default_rng({"outliers": 5, "masked": 6, "few": 7}[case])
    n = 100
    p0, p1, bad = _two_view(rng, n, 20)
    mask = np.ones(n, bool)
    if case == "masked":
        mask[rng.choice(n, 30, replace=False)] = False
    if case == "few":
        mask[:] = False
        mask[:9] = True
    key = jax.random.PRNGKey({"outliers": 0, "masked": 3, "few": 1}[case])
    thresh = 2.0 / 460.0
    inl_j, _ = jransac.ransac_fundamental(jnp.asarray(p0), jnp.asarray(p1),
                                          jnp.asarray(mask), key, thresh)
    sets = torch.as_tensor(jax_sets(key, jnp.asarray(mask)))
    inl, F = ransac.ransac_from_sets(t(p0), t(p1), torch.as_tensor(mask),
                                     sets, thresh)
    np.testing.assert_array_equal(np_of(inl), np.asarray(inl_j))
    if case == "outliers":
        assert np_of(inl)[bad].sum() <= 2
        assert F.shape == (3, 3)
    if case == "few":
        np.testing.assert_array_equal(np_of(inl), mask)


def test_draw_sets_are_valid_and_seeded():
    mask = torch.zeros(50, dtype=torch.bool)
    mask[torch.arange(0, 50, 3)] = True
    gen = torch.Generator().manual_seed(4)
    sets = ransac.draw_sets(mask, gen)
    assert sets.shape == (ransac.NUM_HYP, 8)
    assert bool(mask[sets].all())
    assert all(len(set(s.tolist())) == 8 for s in sets)
    again = ransac.sampler(torch.Generator().manual_seed(4))(mask)
    assert torch.equal(sets, again)
    assert not torch.equal(sets, ransac.draw_sets(mask, gen))
