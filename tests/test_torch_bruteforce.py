"""Port's brute-force intersector against the reference
(cadrays_tpu_torch.ops.bruteforce).

``trace_bruteforce_ref`` (the plain version of the CUDA kernel K3) is
held against the reference's ``trace_bruteforce``, whose Pallas kernel
runs in its built-in interpret mode on the CPU, under the reference's
own contract (tests/test_geometry.py:276-284): hit masks equal, t
within rtol 1e-4, tri equal on more than 99% of hit lanes (two
triangles sharing a seam may both claim a ray). Any-hit queries run the
same reduction, so their occlusion masks are equal too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadrays_tpu_torch.testing.regression import compare


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread in these tests. The plain versions run
    many elementwise ops on blocks large enough for torch's intra-op
    threads; under pytest-xdist's several workers those threads
    oversubscribe the cores, and each op waits on threads that are not
    scheduled (the bruteforce render test took 311 s in a 6-worker run
    against 3.5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _flatten_both(jmesh, pmesh):
    from cadrays_tpu.core.bsdf import material as jmaterial
    from cadrays_tpu.scene.flatten import flatten_parts as jflatten
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.scene.flatten import flatten_parts

    ref = jflatten([jmesh], [jmaterial()], [0])
    port = flatten_parts([pmesh], [material()], [0], device="cpu")
    return ref.geometry, port.geometry


@pytest.fixture(scope="module")
def sphere_box():
    """The reference test's scene: a sphere over a thin box."""
    from cadrays_tpu.geometry import primitives as jprim
    from cadrays_tpu.geometry.mesh import TriangleMesh as JMesh
    from cadrays_tpu_torch.geometry import primitives
    from cadrays_tpu_torch.geometry.mesh import TriangleMesh

    jm = JMesh.merge([jprim.sphere(1.0, 24, 12),
                      jprim.box(3, 3, 0.2, origin_corner=False)])
    pm = TriangleMesh.merge([primitives.sphere(1.0, 24, 12),
                             primitives.box(3, 3, 0.2, origin_corner=False)])
    np.testing.assert_array_equal(jm.vertices, pm.vertices)
    return _flatten_both(jm, pm)


@pytest.fixture(scope="module")
def cornell_geoms():
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    ref = jcornell(full=True, sphere_res=24).flatten(jcam())
    port = cornell_box(full=True, sphere_res=24).flatten(cornell_camera(),
                                                         device="cpu")
    return ref.geometry, port.geometry


def _ref(jgeom, o, d, tm, any_hit=False):
    from cadrays_tpu.ops.mxu_intersect import trace_bruteforce

    res = trace_bruteforce(jgeom, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm), any_hit=any_hit)
    return {k: np.asarray(v) for k, v in res.items()}


def _port(pgeom, o, d, tm, any_hit=False):
    from cadrays_tpu_torch.ops.bruteforce import trace_bruteforce_ref

    res = trace_bruteforce_ref(pgeom, torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(tm),
                               any_hit=any_hit)
    return {k: v.numpy() for k, v in res.items()}


def _assert_reference_contract(got, ref):
    hit = ref["tri"] >= 0
    np.testing.assert_array_equal(got["tri"] >= 0, hit)
    np.testing.assert_allclose(got["t"][hit], ref["t"][hit], rtol=1e-4)
    assert (got["tri"] == ref["tri"])[hit].mean() > 0.99
    np.testing.assert_array_equal(got["t"][~hit], ref["t"][~hit])


@pytest.mark.parametrize("any_hit", [False, True])
def test_sphere_box_matches_reference(sphere_box, any_hit):
    """R = 700 is not a multiple of the reference's 256-ray tile."""
    jgeom, pgeom = sphere_box
    rs = np.random.RandomState(11)
    R = 700
    o = (np.float32([0, 0, 5])
         + 0.5 * rs.randn(R, 3).astype(np.float32)).astype(np.float32)
    d = np.float32([0, 0, -1]) + 0.7 * rs.randn(R, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = np.full(R, 1e30, np.float32)
    ref = _ref(jgeom, o, d, tm, any_hit=any_hit)
    got = _port(pgeom, o, d, tm, any_hit=any_hit)
    assert 0 < (ref["tri"] >= 0).sum() < R
    _assert_reference_contract(got, ref)
    # any-hit runs the closest-hit reduction
    closest = _port(pgeom, o, d, tm)
    np.testing.assert_array_equal(got["tri"], closest["tri"])


def test_finite_tmax_clips(sphere_box):
    from cadrays_tpu_torch.ops.bruteforce import trace_bruteforce

    jgeom, pgeom = sphere_box
    o = np.float32([[0.0, 0.0, 5.0]] * 3)
    d = np.float32([[0.0, 0.0, -1.0]] * 3)
    tm = np.float32([1e30, 2.0, 0.0])  # hit, clipped, dead lane
    got = _port(pgeom, o, d, tm)
    ref = _ref(jgeom, o, d, tm)
    np.testing.assert_array_equal(got["tri"] >= 0, [True, False, False])
    np.testing.assert_array_equal(got["tri"], ref["tri"])
    np.testing.assert_array_equal(got["t"][1:], [2.0, 0.0])
    wrapped = trace_bruteforce(pgeom, torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(tm))
    for k in wrapped:
        np.testing.assert_array_equal(wrapped[k].numpy(), got[k])


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_cornell_matches_reference(cornell_geoms, kind):
    """The full Cornell box: 4,578 triangle rows, padded to 4,608."""
    from cadrays_tpu_torch.ops.bruteforce import tri_tables
    from cadrays_tpu_torch.testing.scenes import cornell_camera

    jgeom, pgeom = cornell_geoms
    assert tri_tables(pgeom).shape == (4608, 16)
    n = 2048
    rng = np.random.default_rng(31)
    if kind == "camera":
        W = H = 64
        pix = rng.integers(0, W * H, n)
        px = (pix % W + rng.uniform(size=n)).astype(np.float32)
        py = (pix // W + rng.uniform(size=n)).astype(np.float32)
        o, d = (a.numpy() for a in cornell_camera().generate_rays(
            torch.from_numpy(px), torch.from_numpy(py), torch.zeros(n),
            torch.zeros(n), W, H))
    else:
        o = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(n, 1e30, np.float32)
    tm[::11] = 0.0
    ref = _ref(jgeom, o, d, tm)
    got = _port(pgeom, o, d, tm)
    assert np.all(got["tri"][::11] == -1)
    _assert_reference_contract(got, ref)
    occ = _port(pgeom, o, d, tm, any_hit=True)
    occ_ref = _ref(jgeom, o, d, tm, any_hit=True)
    np.testing.assert_array_equal(occ["tri"] >= 0, occ_ref["tri"] >= 0)


def test_coplanar_faces_tie_break_as_the_reference_does(cornell_geoms):
    """The glass box of the full Cornell box rests on the glossy box: its
    bottom face and the glossy top face are coplanar, of opposite
    orientation. A ray reaching that plane hits both at t equal to the
    last ulp, and which of the two wins depends on rounding. The
    reference's own bruteforce and gather walks disagree there; the
    port's K3 plain version keeps to the reference's bruteforce under
    the reference's contract, and its disagreements with the port's K1
    plain version are all ties at that plane."""
    from cadrays_tpu.ops.traverse import trace_gather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    jgeom, pgeom = cornell_geoms
    n = 2048
    rng = np.random.default_rng(0)
    # origins inside the glass box (0.15 x 0.15 x 0.3 at (0.7, 0.25, 0.2),
    # turned by 10 degrees), directions downwards
    loc = rng.uniform(-0.05, 0.05, (n, 2))
    c, s = np.cos(np.radians(10)), np.sin(np.radians(10))
    o = np.stack([0.7 + c * loc[:, 0] - s * loc[:, 1],
                  0.25 + s * loc[:, 0] + c * loc[:, 1],
                  rng.uniform(0.25, 0.45, n)], axis=1).astype(np.float32)
    d = np.concatenate([rng.normal(0, 0.3, (n, 2)), -np.ones((n, 1))], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tm = np.full(n, 1e30, np.float32)
    ref = _ref(jgeom, o, d, tm)
    gather = {k: np.asarray(v) for k, v in trace_gather(
        jgeom, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)).items()}
    got = _port(pgeom, o, d, tm)
    k1 = {k: v.numpy() for k, v in trace_wide_ref(
        pgeom, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(tm)).items()}
    _assert_reference_contract(got, ref)
    mat = pgeom.tri_mat.numpy()
    hit = ref["tri"] >= 0
    glossy, glass = 6, 7  # materials of the boxes "c" and "g"
    for a, b in ((gather, ref), (k1, got)):
        diff = hit & (a["tri"] != b["tri"])
        assert diff.sum() > 0.02 * hit.sum()  # the reference's own walks too
        pairs = set(zip(mat[a["tri"][diff]], mat[b["tri"][diff]]))
        assert pairs <= {(glossy, glass), (glass, glossy)}, pairs
        np.testing.assert_allclose(a["t"][diff], b["t"][diff], rtol=1e-6)


def test_ray_along_an_edge_splits_the_walkers_as_in_the_reference(
        cornell_geoms):
    """A camera ray of a 1024x1024 spp-1 render of the full Cornell box
    that meets triangle 3269 on its edge (float64 u = 6.4e-9). Which
    walkers count it a hit depends on their rounding: the reference's
    trace_bruteforce and trace_gather hit it, its BVH kernels
    trace_wide and trace_pallas miss it (in interpret mode, too slow
    to repeat here). The port's plain versions split as their
    counterparts do: K3 hits, K1 and K2 miss. chip_smoke.py lets K3's
    hit mask differ from K1's only on lanes this close to a decision
    boundary."""
    from cadrays_tpu.ops.traverse import trace_gather
    from cadrays_tpu_torch.ops.binary import trace_binary_ref
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    jgeom, pgeom = cornell_geoms
    o = np.array([[0.5, float.fromhex("-0x1.99999ap+0"), 0.5]], np.float32)
    d = np.array([[float.fromhex("-0x1.c64bdep-3"),
                   float.fromhex("0x1.f2c51ap-1"),
                   float.fromhex("0x1.5c23d4p-5")]], np.float32)
    tm = np.full(1, 1e30, np.float32)
    p0, e1, e2 = pgeom.tris_packed[3269].double().numpy().reshape(4, 3)[:3]
    pv = np.cross(d[0], e2)
    u = (o[0] - p0) @ pv / (e1 @ pv)
    assert 0.0 < u < 1e-8  # on the edge u = 0, in float64
    ref = _ref(jgeom, o, d, tm)
    got = _port(pgeom, o, d, tm)
    assert ref["tri"][0] == got["tri"][0] == 3269
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    gather = trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tm))
    assert int(gather["tri"][0]) == 3269
    args = [torch.from_numpy(a) for a in (o, d, tm)]
    assert int(trace_wide_ref(pgeom, *args)["tri"][0]) == -1
    assert int(trace_binary_ref(pgeom, *args)["tri"][0]) == -1


def test_tri_tables_match_reference_and_are_cached(sphere_box):
    from cadrays_tpu.ops.mxu_intersect import _tri_tables
    from cadrays_tpu_torch.ops.bruteforce import TRI_TILE, tri_tables

    jgeom, pgeom = sphere_box
    table = tri_tables(pgeom)
    T = pgeom.tris_packed.shape[0]
    assert table.shape == (-(-T // TRI_TILE) * TRI_TILE, 16)
    assert not table[T:].any()
    W = np.asarray(_tri_tables(jgeom.tris_packed))  # (4, 16, Tpad)
    t = table.numpy()
    n, k, c2, c3, e1, e2 = (t[:, 0:3], t[:, 3], t[:, 4:7], t[:, 7:10],
                            t[:, 10:13], t[:, 13:16])
    # W's columns: det = X.(-n), t.det = X.(n, -k), u.det = X.(-c2, e2),
    # v.det = X.(-c3, -e1); features o(0:3) d(3:6) m(6:9) 1(9)
    for got, want in ((-n, W[0, 3:6]), (n, W[1, 0:3]), (-k, W[1, 9]),
                      (-c2, W[2, 3:6]), (e2, W[2, 6:9]), (-c3, W[3, 3:6]),
                      (-e1, W[3, 6:9])):
        np.testing.assert_allclose(got, want.T, rtol=1e-6, atol=1e-6)
    assert tri_tables(pgeom) is table
    pgeom.tris_packed.add_(0.0)  # an in-place change rebuilds the table
    assert tri_tables(pgeom) is not table


def test_fits_bruteforce():
    from cadrays_tpu_torch.ops.bruteforce import (MAX_TRIS, fits_bruteforce,
                                                  trace_bruteforce)
    from cadrays_tpu_torch.scene.flatten import GeometryData

    def geom(rows, instanced=False):
        z = torch.zeros(1)
        return GeometryData(*([z] * 11), tris_packed=torch.zeros(rows, 12),
                            instanced=instanced)

    assert MAX_TRIS == 24576
    assert fits_bruteforce(geom(MAX_TRIS))
    assert not fits_bruteforce(geom(MAX_TRIS + 1))
    assert not fits_bruteforce(geom(16, instanced=True))
    o = torch.zeros(1, 3)
    # K3 refuses two-level scenes, as the reference's does; trace()
    # sends them to K1 variant (b) (tests/test_torch_instances.py)
    with pytest.raises(ValueError, match="instanced"):
        trace_bruteforce(geom(16, instanced=True), o, o, torch.ones(1))


def test_render_under_bruteforce_matches_reference(cornell_geoms):
    """The slice as a whole: the port's CPU render with K3's plain
    version as its walker against the reference's CPU render (its
    gather walk), at equal seed and spp."""
    from cadrays_tpu.integrator.params import RenderParams as JParams
    from cadrays_tpu.integrator.renderer import (
        render_persistent_image as jimage)
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.renderer import render_persistent_image
    from cadrays_tpu_torch.ops import traverse
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    jc, pc = jcam(), cornell_camera()
    a = np.asarray(jimage(jcornell(full=True, sphere_res=24).flatten(jc), jc,
                          JParams(), 16, 16, spp=4))
    port = cornell_box(full=True, sphere_res=24).flatten(pc, device="cpu")
    before = traverse.get_backend()
    try:
        traverse.set_backend("bruteforce")
        b = render_persistent_image(port, pc, RenderParams(), 16, 16,
                                    spp=4).numpy()
    finally:
        traverse.set_backend(before)
    assert b.shape == (16, 16, 3) and np.isfinite(b).all()
    res = compare(b, a, pix_tol=0.02)
    assert res["match"], res
