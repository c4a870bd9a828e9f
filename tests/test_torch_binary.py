"""Port's binary-tree walkers and traversal backend switch against the
reference (cadrays_tpu_torch.ops.binary, ops.traverse).

``trace_binary_ref`` (the plain version of the CUDA kernel K2) and the
port's ``trace_gather`` are held against the reference's ``trace_gather``
and its Pallas kernel ``trace_pallas``, run in TPU interpret mode on
the CPU (one 2,048-ray block per call). Contract, as for K1
(tests/test_torch_wide.py): hit masks equal, t within rtol 1e-5,
atol 1e-6, tri equal except on tie lanes where t agrees, any-hit
occlusion masks equal, t_max caps respected, t_max = 0 lanes miss.

u and v: within rtol 1e-5, atol 1e-6 of the Pallas kernel on the
random mesh. On the Cornell box's walls they are ill-conditioned in
fp32 (o - p0 cancels at the scale of the box): there the reference's
own two walkers differ by more than that on a few lanes per 2,048 rays,
and each of them is up to 8.3e-5 off the float64 value. So there the
port's u and v are held to the float64 value, no farther from it than
twice the reference walkers' worst error on the same rays.

The backend switch is module-global: every test that sets it restores
it in the ``backend`` fixture's ``finally``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cadrays_tpu_torch.testing.regression import compare

RTOL, ATOL = 1e-5, 1e-6


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


def _random_mesh(n_tri, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.1, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1, (n_tri, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], axis=0)
    idx = np.arange(3 * n_tri, dtype=np.int32).reshape(3, n_tri).T.copy()
    return verts, idx


def _rays(n, seed, lo=-1.5, hi=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _camera_rays(n, seed):
    from cadrays_tpu_torch.testing.scenes import cornell_camera

    rng = np.random.default_rng(seed)
    W = H = 64
    pix = rng.integers(0, W * H, n)
    px = (pix % W + rng.uniform(size=n)).astype(np.float32)
    py = (pix // W + rng.uniform(size=n)).astype(np.float32)
    o, d = cornell_camera().generate_rays(
        torch.from_numpy(px), torch.from_numpy(py), torch.zeros(n),
        torch.zeros(n), W, H)
    return o.numpy(), d.numpy()


@pytest.fixture(scope="module")
def mesh_geoms():
    from cadrays_tpu.core.bsdf import material as jmaterial
    from cadrays_tpu.geometry.mesh import TriangleMesh as JMesh
    from cadrays_tpu.scene.flatten import flatten_parts as jflatten
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.mesh import TriangleMesh
    from cadrays_tpu_torch.scene.flatten import flatten_parts

    verts, idx = _random_mesh(400, seed=5)
    ref = jflatten([JMesh(verts, idx)], [jmaterial()], [0])
    port = flatten_parts([TriangleMesh(verts, idx)], [material()], [0],
                         device="cpu")
    return ref.geometry, port.geometry


@pytest.fixture(scope="module")
def cornell_geoms():
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    ref = jcornell(full=True, sphere_res=24).flatten(jcam())
    port = cornell_box(full=True, sphere_res=24).flatten(cornell_camera(),
                                                         device="cpu")
    return ref.geometry, port.geometry


@pytest.fixture
def backend():
    """set_backend for one test; the previous backend comes back after."""
    from cadrays_tpu_torch.ops import traverse

    before = traverse.get_backend()
    try:
        yield traverse.set_backend
    finally:
        traverse.set_backend(before)


def _ref_gather(jgeom, o, d, tm, any_hit=False):
    from cadrays_tpu.ops.traverse import trace_gather

    res = trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(tm), any_hit=any_hit)
    return {k: np.asarray(v) for k, v in res.items()}


def _ref_pallas(jgeom, o, d, tm, any_hit=False):
    from cadrays_tpu.ops.pallas_traverse import trace_pallas

    assert o.shape[0] <= 2048
    with pltpu.force_tpu_interpret_mode():
        res = trace_pallas(jgeom, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm), any_hit=any_hit)
        return {k: np.asarray(v) for k, v in res.items()}


def _ports(pgeom, o, d, tm, any_hit=False):
    from cadrays_tpu_torch.ops.binary import trace_binary_ref
    from cadrays_tpu_torch.ops.traverse import trace_gather

    args = (pgeom, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(tm))
    return [{k: v.numpy() for k, v in f(*args, any_hit=any_hit).items()}
            for f in (trace_gather, trace_binary_ref)]


def _assert_tie_contract(got, other, keys=("t", "u", "v")):
    hit = other["tri"] >= 0
    np.testing.assert_array_equal(got["tri"] >= 0, hit)
    diff = got["tri"] != other["tri"]
    # tri may differ only where the two t agree (a tie between triangles)
    assert np.all(np.isclose(got["t"][diff], other["t"][diff], rtol=RTOL,
                             atol=ATOL))
    same = hit & ~diff
    for k in keys:
        np.testing.assert_allclose(got[k][same], other[k][same], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(got["t"][hit], other["t"][hit], rtol=RTOL,
                               atol=ATOL)
    return int(diff[hit].sum())


def _assert_uv_as_accurate(got, refs, o, d, tris):
    """On lanes where every walker hit the same triangle: the port's u
    and v are no farther from the float64 values than twice the worst
    error of the reference walkers."""
    lanes = got["tri"] >= 0
    for r in refs:
        lanes &= r["tri"] == got["tri"]
    idx = np.nonzero(lanes)[0]
    row = tris[got["tri"][idx]].astype(np.float64)
    p0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    o64, d64 = o[idx].astype(np.float64), d[idx].astype(np.float64)
    pv = np.cross(d64, e2)
    det = np.sum(e1 * pv, axis=1)
    tv = o64 - p0
    exact = {"u": np.sum(tv * pv, axis=1) / det,
             "v": np.sum(d64 * np.cross(tv, e1), axis=1) / det}
    for k, x in exact.items():
        worst_ref = max(np.abs(r[k][idx] - x).max() for r in refs)
        assert np.abs(got[k][idx] - x).max() <= 2.0 * worst_ref, k


@pytest.mark.parametrize("any_hit", [False, True])
def test_random_mesh_matches_gather_and_pallas(mesh_geoms, any_hit):
    jgeom, pgeom = mesh_geoms
    o, d = _rays(1024, seed=7)
    tm = np.full(1024, 1e30, np.float32)
    ref = _ref_gather(jgeom, o, d, tm, any_hit=any_hit)
    pal = _ref_pallas(jgeom, o, d, tm, any_hit=any_hit)
    hit = ref["tri"] >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(pal["tri"] >= 0, hit)
    for got in _ports(pgeom, o, d, tm, any_hit=any_hit):
        np.testing.assert_array_equal(got["tri"] >= 0, hit)
        if not any_hit:
            # u, v against the Pallas kernel, whose arithmetic the port
            # keeps; the gather walk's XLA cross products round u apart
            # by 2e-5 relative on an ill-conditioned lane (det -0.0026)
            for other, keys in ((pal, ("t", "u", "v")), (ref, ("t",))):
                assert _assert_tie_contract(got, other, keys) == 0
                np.testing.assert_array_equal(got["tri"], other["tri"])


def test_random_mesh_tmax_caps_and_dead_lanes(mesh_geoms):
    jgeom, pgeom = mesh_geoms
    o, d = _rays(1024, seed=13)
    full = _ref_gather(jgeom, o, d, np.full(1024, 1e30, np.float32))
    tm = np.full(1024, 1e30, np.float32)
    hit = full["tri"] >= 0
    capped = hit & (np.arange(1024) % 2 == 0)
    tm[capped] = full["t"][capped] * 0.5
    tm[::7] = 0.0
    ref = _ref_gather(jgeom, o, d, tm)
    pal = _ref_pallas(jgeom, o, d, tm)
    np.testing.assert_array_equal(pal["tri"], ref["tri"])
    for any_hit in (False, True):
        for got in _ports(pgeom, o, d, tm, any_hit=any_hit):
            assert np.all(got["tri"][::7] == -1)
            assert np.all(got["t"][::7] == 0.0)
            assert not np.any(got["tri"][capped] >= 0)
            np.testing.assert_array_equal(got["tri"] >= 0, ref["tri"] >= 0)
            lanes = got["tri"] >= 0
            assert np.all(got["t"][lanes] < tm[lanes])
            if not any_hit:
                np.testing.assert_array_equal(got["tri"], ref["tri"])


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_cornell_matches_gather_and_pallas(cornell_geoms, kind):
    """The full Cornell box (the main path's tables), 2,048 rays: one
    block of the reference kernel."""
    jgeom, pgeom = cornell_geoms
    n = 2048
    o, d = _camera_rays(n, 21) if kind == "camera" else _rays(n, 21, 0, 1)
    tm = np.full(n, 1e30, np.float32)
    tm[::11] = 0.0
    ref = _ref_gather(jgeom, o, d, tm)
    pal = _ref_pallas(jgeom, o, d, tm)
    ties = 0
    for got in _ports(pgeom, o, d, tm):
        assert np.all(got["tri"][::11] == -1)
        ties += (_assert_tie_contract(got, ref, ("t",))
                 + _assert_tie_contract(got, pal, ("t",)))
        _assert_uv_as_accurate(got, (ref, pal), o, d,
                               np.asarray(jgeom.tris_packed))
    assert ties <= n // 100
    occ_ref = _ref_gather(jgeom, o, d, tm, any_hit=True)
    for occ in _ports(pgeom, o, d, tm, any_hit=True):
        np.testing.assert_array_equal(occ["tri"] >= 0, occ_ref["tri"] >= 0)


def test_default_backend_is_wide():
    from cadrays_tpu_torch.ops import traverse

    assert traverse.get_backend() == "wide"
    assert traverse._BACKENDS == ("bruteforce", "wide", "pallas", "stream",
                                  "gather")


@pytest.mark.parametrize("name,target", [
    ("bruteforce", "trace_bruteforce"), ("wide", "trace_wide"),
    ("pallas", "trace_binary"), ("gather", "trace_gather")])
def test_each_backend_reaches_its_function(cornell_geoms, backend,
                                           monkeypatch, name, target):
    from cadrays_tpu_torch.ops import traverse

    called = []
    for fn in ("trace_bruteforce", "trace_wide", "trace_binary",
               "trace_gather"):
        monkeypatch.setattr(traverse, fn,
                            lambda *a, _fn=fn, **k: called.append(_fn))
    _, pgeom = cornell_geoms
    o, d = _rays(8, seed=3, lo=0, hi=1)
    backend(name)
    for any_hit in (False, True):
        traverse.trace(pgeom, torch.from_numpy(o), torch.from_numpy(d),
                       torch.full((8,), 1e30), any_hit=any_hit)
    assert called == [target, target]


def test_fall_through_is_decided_by_the_geometry(cornell_geoms, backend):
    """bruteforce -> wide above MAX_TRIS; wide -> pallas (K2) when no
    wide tree fits; the results are those of the walker fallen to."""
    from cadrays_tpu_torch.ops import bruteforce, wide
    from cadrays_tpu_torch.ops.binary import trace_binary_ref
    from cadrays_tpu_torch.ops.traverse import trace

    _, pgeom = cornell_geoms
    o, d = (torch.from_numpy(a) for a in _rays(256, seed=4, lo=0, hi=1))
    tm = torch.full((256,), 1e30)
    big = pgeom.replace(tris_packed=torch.cat([
        pgeom.tris_packed,
        torch.zeros(bruteforce.MAX_TRIS + 1 - pgeom.tris_packed.shape[0],
                    12)]))
    assert bruteforce.fits_bruteforce(pgeom)
    assert not bruteforce.fits_bruteforce(big)
    backend("bruteforce")
    got = trace(big, o, d, tm)
    want = wide.trace_wide_ref(big, o, d, tm)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="MAX_TRIS"):
        bruteforce.trace_bruteforce(big, o, d, tm)

    no_wide = pgeom.replace(wmeta=torch.full((1, 1), 0x7FFFFFFF,
                                             dtype=torch.int32))
    assert not wide.fits_wide(no_wide)
    for name in ("bruteforce", "wide"):
        backend(name)
        src = big.replace(wmeta=no_wide.wmeta) if name == "bruteforce" \
            else no_wide
        got = trace(src, o, d, tm)
        want = trace_binary_ref(src, o, d, tm)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)


def test_stream_unknown_and_instanced_raise(cornell_geoms, backend):
    """"stream" and unknown names raise. An instanced (two-level) scene
    raises under "pallas" too, which falls through to "stream" (item
    12), as the reference's K2 refuses it; under "wide" and
    "bruteforce" it traces through K1 variant (b), and under "gather"
    through the gather walk's instanced branch."""
    from cadrays_tpu_torch.ops.traverse import trace, trace_gather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    _, pgeom = cornell_geoms
    o, d = (torch.from_numpy(a) for a in _rays(4, seed=5, lo=0, hi=1))
    tm = torch.full((4,), 1e30)
    backend("stream")
    with pytest.raises(NotImplementedError, match="item 12"):
        trace(pgeom, o, d, tm)
    with pytest.raises(ValueError, match="unknown traversal backend"):
        backend("cuda")
    inst = cornell_box(full=False).flatten(
        cornell_camera(), instancing=True, device="cpu").geometry
    o, d = (torch.from_numpy(a) for a in _rays(64, seed=5, lo=0, hi=1))
    tm = torch.full((64,), 1e30)
    want = {"bruteforce": trace_wide_ref(inst, o, d, tm),
            "wide": trace_wide_ref(inst, o, d, tm),
            "gather": trace_gather(inst, o, d, tm)}
    assert int((want["wide"]["tri"] >= 0).sum()) > 32
    assert torch.equal(want["gather"]["tri"] >= 0, want["wide"]["tri"] >= 0)
    for name in ("bruteforce", "wide", "pallas", "gather"):
        backend(name)
        if name == "pallas":
            with pytest.raises(NotImplementedError, match="item 12"):
                trace(inst, o, d, tm)
            continue
        got = trace(inst, o, d, tm)
        for k in got:
            assert torch.equal(got[k], want[name][k]), (name, k)


def test_trace_sorted_skips_the_sort_under_bruteforce(cornell_geoms, backend,
                                                      monkeypatch):
    from cadrays_tpu_torch.ops import traverse

    _, pgeom = cornell_geoms
    o, d = (torch.from_numpy(a) for a in _rays(512, seed=6, lo=0, hi=1))
    tm = torch.full((512,), 1e30)
    seen = []
    real = traverse.trace

    def spy(g, oo, dd, tt, any_hit=False):
        seen.append(oo)
        return real(g, oo, dd, tt, any_hit=any_hit)

    monkeypatch.setattr(traverse, "trace", spy)
    for name in ("bruteforce", "pallas"):
        backend(name)
        a = traverse.trace_sorted(pgeom, o, d, tm)
        b = real(pgeom, o, d, tm)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    assert seen[0] is o  # bruteforce: the caller's order, not a copy
    assert not torch.equal(seen[1], o)  # pallas: sorted for coherence


def test_cpu_tensors_launch_no_kernel(cornell_geoms, backend):
    from cadrays_tpu_torch.ops import binary, bruteforce, wide
    from cadrays_tpu_torch.ops.traverse import occluded, trace

    _, pgeom = cornell_geoms
    o, d = (torch.from_numpy(a) for a in _rays(256, seed=8, lo=0, hi=1))
    tm = torch.full((256,), 1e30)
    counts = lambda: (wide.trace_wide.launches,  # noqa: E731
                      binary.trace_binary.launches,
                      bruteforce.trace_bruteforce.launches)
    before = counts()
    for name in ("pallas", "bruteforce"):
        backend(name)
        res = trace(pgeom, o, d, tm)
        assert torch.equal(occluded(pgeom, o, d, tm), res["tri"] >= 0)
    assert counts() == before


@pytest.fixture(scope="module")
def reference_render_16():
    from cadrays_tpu.integrator.params import RenderParams as JParams
    from cadrays_tpu.integrator.renderer import (
        render_persistent_image as jimage)
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam

    jc = jcam()
    ref = jcornell(full=True, sphere_res=24).flatten(jc)
    return np.asarray(jimage(ref, jc, JParams(), 16, 16, spp=4))


def test_render_under_pallas_matches_reference(reference_render_16,
                                               cornell_geoms, backend):
    """The slice as a whole: the port's CPU render with K2's plain
    version as its walker against the reference's CPU render (its
    gather walk), at equal seed and spp."""
    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.renderer import render_persistent_image
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    pc = cornell_camera()
    port = cornell_box(full=True, sphere_res=24).flatten(pc, device="cpu")
    backend("pallas")
    b = render_persistent_image(port, pc, RenderParams(), 16, 16,
                                spp=4).numpy()
    assert b.shape == (16, 16, 3) and np.isfinite(b).all()
    res = compare(b, reference_render_16, pix_tol=0.02)
    assert res["match"], res
