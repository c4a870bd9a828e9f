"""Port's BVH8 traversal (ops/wide.trace_wide_ref, the plain version of
the CUDA kernel K1) against the reference walkers: the per-ray
``trace_gather`` and the Pallas kernel ``trace_wide`` in interpret mode.

Contract (tests/test_wide_bvh.py:70-111): hit masks equal, t allclose
at rtol 1e-5, atol 1e-6, t_max caps respected, t_max = 0 lanes miss.
tri must be equal on a random mesh; on Cornell it may differ only on
lanes whose t agree within that tolerance (ties on shared edges, which
the two walk orders resolve differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL, ATOL = 1e-5, 1e-6


def _random_mesh(n_tri, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-scale, scale, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.1 * scale, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1 * scale, (n_tri, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], axis=0)
    idx = np.stack([np.arange(n_tri), np.arange(n_tri) + n_tri,
                    np.arange(n_tri) + 2 * n_tri], axis=1).astype(np.int32)
    return verts.astype(np.float32), idx


def _rays(n, seed=1, scale=1.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5 * scale, 1.5 * scale, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _flatten_both(verts, idx):
    from cadrays_tpu.core.bsdf import material as jmaterial
    from cadrays_tpu.geometry.mesh import TriangleMesh as JMesh
    from cadrays_tpu.scene.flatten import flatten_parts as jflatten
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.mesh import TriangleMesh
    from cadrays_tpu_torch.scene.flatten import flatten_parts

    ref = jflatten([JMesh(verts, idx)], [jmaterial(kd=(1, 1, 1))], [0])
    port = flatten_parts([TriangleMesh(verts, idx)], [material(kd=(1, 1, 1))],
                         [0], device="cpu")
    return ref.geometry, port.geometry


def _recollapse(jgeom, pgeom, wide_leaf=8):
    """Both geometries with the wide tree rebuilt at ``wide_leaf``
    triangles per leaf: a deeper tree than the default 64, and a Pallas
    leaf body small enough to interpret in seconds."""
    from cadrays_tpu_torch.geometry.wide_bvh import build_wide_bvh

    w = build_wide_bvh(*(getattr(pgeom, f"bvh_{k}").numpy()
                         for k in ("min", "max", "skip", "first", "count")),
                       wide_leaf=wide_leaf)
    tables = dict(wboxes=w.wboxes, wmeta=w.wmeta, winst=w.winst,
                  worder=w.worder)
    statics = dict(wide_leaf=w.max_leaf, wide_depth=w.max_depth)
    return (jgeom.replace(**{k: jnp.asarray(v) for k, v in tables.items()},
                          **statics),
            pgeom.replace(**{k: torch.from_numpy(v)
                             for k, v in tables.items()}, **statics))


def _port(geom, o, d, tm, any_hit=False):
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    res = trace_wide_ref(geom, torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tm), any_hit=any_hit)
    return {k: v.numpy() for k, v in res.items()}


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


@pytest.fixture(scope="module")
def mesh_geoms():
    return _recollapse(*_flatten_both(*_random_mesh(400, seed=5)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_random_mesh_matches_gather_and_pallas(mesh_geoms, any_hit):
    from cadrays_tpu.ops.pallas_wide import trace_wide
    from cadrays_tpu.ops.traverse import trace_gather

    jgeom, pgeom = mesh_geoms
    o, d = _rays(256, seed=7)
    tm = np.full(256, 1e30, np.float32)
    ref = _np(trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm), any_hit=False))
    pal = _np(trace_wide(jgeom, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tm), any_hit=any_hit, interpret=True))
    got = _port(pgeom, o, d, tm, any_hit=any_hit)

    hit = ref["tri"] >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(got["tri"] >= 0, hit)
    np.testing.assert_array_equal(got["tri"] >= 0, pal["tri"] >= 0)
    if not any_hit:
        np.testing.assert_array_equal(got["tri"], ref["tri"])
        np.testing.assert_array_equal(got["tri"], pal["tri"])
        for other in (ref, pal):
            for k in ("t", "u", "v"):
                np.testing.assert_allclose(got[k][hit], other[k][hit],
                                           rtol=RTOL, atol=ATOL, err_msg=k)
    else:
        # an any-hit ray reports a real hit no farther than t_max
        assert np.all(got["t"][hit] <= 1e30)


def test_random_mesh_tmax_caps_and_dead_lanes(mesh_geoms):
    from cadrays_tpu.ops.pallas_wide import trace_wide
    from cadrays_tpu.ops.traverse import trace_gather

    jgeom, pgeom = mesh_geoms
    o, d = _rays(256, seed=13)
    full = _np(trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                            jnp.full((256,), 1e30)))
    tm = np.full(256, 1e30, np.float32)
    hit = full["tri"] >= 0
    tm[hit] = full["t"][hit] * 0.5
    tm[::7] = 0.0
    ref = _np(trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm)))
    pal = _np(trace_wide(jgeom, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tm), interpret=True))
    for any_hit in (False, True):
        got = _port(pgeom, o, d, tm, any_hit=any_hit)
        assert np.all(got["tri"][::7] == -1)
        assert np.all(got["t"][::7] == 0.0)
        np.testing.assert_array_equal(got["tri"] >= 0, ref["tri"] >= 0)
        capped = got["tri"] >= 0
        assert np.all(got["t"][capped] < tm[capped])
        if not any_hit:
            np.testing.assert_array_equal(got["tri"], ref["tri"])
            np.testing.assert_array_equal(got["tri"], pal["tri"])


@pytest.fixture(scope="module")
def cornell_geoms():
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    ref = jcornell(full=True, sphere_res=24).flatten(jcam())
    port = cornell_box(full=True, sphere_res=24).flatten(cornell_camera(),
                                                         device="cpu")
    return (ref.geometry, port.geometry), _recollapse(ref.geometry,
                                                      port.geometry)


def _cornell_rays(kind, n=4096):
    rng = np.random.default_rng(21)
    if kind == "camera":
        from cadrays_tpu_torch.testing.scenes import cornell_camera

        W = H = 64
        pix = rng.integers(0, W * H, n)
        px = (pix % W + rng.uniform(size=n)).astype(np.float32)
        py = (pix // W + rng.uniform(size=n)).astype(np.float32)
        o, d = cornell_camera().generate_rays(
            torch.from_numpy(px), torch.from_numpy(py),
            torch.zeros(n), torch.zeros(n), W, H)
        return o.numpy(), d.numpy()
    o = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_tie_contract(got, other):
    hit = other["tri"] >= 0
    np.testing.assert_array_equal(got["tri"] >= 0, hit)
    np.testing.assert_allclose(got["t"][hit], other["t"][hit], rtol=RTOL,
                               atol=ATOL)
    diff = got["tri"] != other["tri"]
    # tri may differ only where the two t agree (a tie between triangles)
    assert np.all(np.isclose(got["t"][diff], other["t"][diff], rtol=RTOL,
                             atol=ATOL))
    return int(diff.sum())


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_cornell_matches_gather_and_pallas(cornell_geoms, kind):
    """The main path's tables (leaf 64, depth 3) against trace_gather;
    the Pallas kernel in interpret mode on the same scene re-collapsed
    to leaf 8 (its 64-wide leaf body alone takes ~30 s to interpret-
    compile on the CPU)."""
    from cadrays_tpu.ops.pallas_wide import trace_wide
    from cadrays_tpu.ops.traverse import trace_gather

    (jgeom, pgeom), (jgeom8, pgeom8) = cornell_geoms
    o, d = _cornell_rays(kind)
    tm = np.full(o.shape[0], 1e30, np.float32)
    tm[::11] = 0.0  # dead lanes
    ref = _np(trace_gather(jgeom, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm)))
    pal = _np(trace_wide(jgeom8, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tm), interpret=True))
    got = _port(pgeom, o, d, tm)
    got8 = _port(pgeom8, o, d, tm)
    for g in (got, got8):
        assert np.all(g["tri"][::11] == -1)
    ties = _assert_tie_contract(got, ref) + _assert_tie_contract(got8, pal)
    assert ties <= o.shape[0] // 100
    occ = _port(pgeom, o, d, tm, any_hit=True)
    np.testing.assert_array_equal(occ["tri"] >= 0, ref["tri"] >= 0)


def test_trace_dispatch_and_wide_guards(cornell_geoms):
    """trace() on CPU tensors runs the plain version and launches no
    kernel; trace_wide raises on a scene without a usable wide tree, and
    trace() then takes the binary walker, chosen by the geometry."""
    from cadrays_tpu_torch.ops import wide
    from cadrays_tpu_torch.ops.traverse import occluded, trace, trace_sorted

    (_, pgeom), _ = cornell_geoms
    o, d = _cornell_rays("bounce", n=512)
    tm = torch.full((512,), 1e30)
    before = wide.trace_wide.launches
    a = trace(pgeom, torch.from_numpy(o), torch.from_numpy(d), tm)
    b = trace_sorted(pgeom, torch.from_numpy(o), torch.from_numpy(d), tm)
    assert wide.trace_wide.launches == before
    for k in a:
        assert torch.equal(a[k], b[k]), k
    occ = occluded(pgeom, torch.from_numpy(o), torch.from_numpy(d), tm)
    assert torch.equal(occ, a["tri"] >= 0)
    with pytest.raises(ValueError, match="STACK_CAP"):
        wide.trace_wide(pgeom.replace(wide_depth=40), torch.from_numpy(o),
                        torch.from_numpy(d), tm)
    placeholder = pgeom.replace(wmeta=torch.full((1, 1), 0x7FFFFFFF,
                                                 dtype=torch.int32))
    assert not wide.fits_wide(placeholder)
    with pytest.raises(ValueError):
        wide.trace_wide(placeholder, torch.from_numpy(o),
                        torch.from_numpy(d), tm)
    # the backend switch decides by the geometry, before any launch: with
    # no wide tree the "wide" backend goes on to the binary walker (K2),
    # as the reference's traverse.py:130-142 does
    from cadrays_tpu_torch.ops.binary import trace_binary_ref

    got = trace(placeholder, torch.from_numpy(o), torch.from_numpy(d), tm)
    want = trace_binary_ref(placeholder, torch.from_numpy(o),
                            torch.from_numpy(d), tm)
    for k in want:
        assert torch.equal(got[k], want[k]), k
