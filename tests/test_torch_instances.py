"""Port's instanced (two-level TLAS/BLAS) scenes against the reference
(cadrays_tpu_torch.scene.instances, K1 variant (b) in ops/wide.py, the
instanced branches of ops/hit.py and ops/traverse.py).

- Tables: every GeometryData field of ``build_instanced`` is bit-equal
  to the reference's on four scenes (the small Cornell box flattened
  with instancing, a 3x3 torus grid, three scaled instances of one
  random mesh, one non-uniformly scaled sphere).
- Traversal: ``trace_wide_ref`` (the plain version of K1 (b)) against
  the reference's ``trace_wide`` run in TPU interpret mode on the CPU
  (one block of at most 2,048 rays) and against both packages'
  ``trace_gather``. Closest-hit: hit masks equal, t within rtol 1e-5
  (atol 1e-6), tri equal except on ties, which need t within rtol 1e-6
  and the float64 hit point on both triangles (the arbiter of
  tests/test_torch_bruteforce.py). Any-hit: hit masks equal.
- Hit attributes and shading rows allclose to the reference's at rtol
  1e-5, atol 1e-5 (normals: a 3x3 transform, a cross product and a
  normalisation in fp32).
- Renders: 16x16 ``render_persistent`` images of the lit torus grid and
  the instanced Cornell box pass ``compare(pix_tol=0.02)`` against the
  reference's, and the port's instanced renders match its baked ones as
  tests/test_instances.py:48-78 asks of the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadrays_tpu_torch.testing.regression import compare

RTOL, ATOL = 1e-5, 1e-6
ROUNDING = 2.0 ** -20  # float64 distance of a tie's hit point off a triangle


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one thread: under pytest-xdist's several workers its
    intra-op threads oversubscribe the cores (tests/test_torch_binary.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def backend():
    from cadrays_tpu_torch.ops.traverse import get_backend, set_backend

    old = get_backend()
    try:
        yield set_backend
    finally:
        set_backend(old)


# ---------------------------------------------------------------------------
# the four scenes, built by each package from the same inputs
# ---------------------------------------------------------------------------

def _torus_grid_ref(grid, segments, rings, lit):
    """The reference's bench/cad_scale.py:53-79 scene, with the light of
    cadrays_tpu_torch.testing.scenes.torus_grid when lit."""
    from cadrays_tpu.core.bsdf import material
    from cadrays_tpu.core.camera import Camera
    from cadrays_tpu.core.lights import positional_light
    from cadrays_tpu.geometry.primitives import torus
    from cadrays_tpu.scene.instances import build_instanced

    mesh = torus(1.0, 0.35, segments, rings)
    meshes, tfs = [], []
    rng = np.random.default_rng(7)
    for i in range(grid):
        for j in range(grid):
            m = np.eye(4, dtype=np.float32)
            ang = rng.uniform(0, np.pi)
            c, s = np.cos(ang), np.sin(ang)
            m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                 np.float32) @ np.array(
                [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
            m[:3, 3] = (i * 2.6, j * 2.6, rng.uniform(0, 1.5))
            meshes.append(mesh)
            tfs.append(m)
    side = grid * 2.6
    lights = (positional_light(position=(side / 2, -side * 0.3, side * 1.2),
                               intensity=900.0) if lit else None)
    data = build_instanced(meshes, tfs, [material(kd=(0.8, 0.8, 0.8))],
                           [0] * len(meshes), lights=lights)
    cam = Camera.look_at(eye=(side / 2, -side * 0.8, side * 0.55),
                         at=(side / 2, side / 2, 0.5), up=(0, 0, 1),
                         fovy_deg=45.0)
    return data, cam


def _random_mesh(n_tri, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-scale, scale, (n_tri, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.1 * scale, (n_tri, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1 * scale, (n_tri, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2], axis=0)
    idx = np.stack([np.arange(n_tri), np.arange(n_tri) + n_tri,
                    np.arange(n_tri) + 2 * n_tri], axis=1).astype(np.int32)
    return verts.astype(np.float32), idx


def _scaled_three(pkg):
    """tests/test_wide_bvh.py:114-131: three scaled instances of one
    random mesh."""
    mat = __import__(f"{pkg}.core.bsdf", fromlist=["material"]).material
    Mesh = __import__(f"{pkg}.geometry.mesh",
                      fromlist=["TriangleMesh"]).TriangleMesh
    build = __import__(f"{pkg}.scene.instances",
                       fromlist=["build_instanced"]).build_instanced
    verts, idx = _random_mesh(120, seed=17, scale=0.4)
    mesh = Mesh(verts, idx)

    def tf(tx, ty, tz, s=1.0):
        m = np.eye(4, dtype=np.float32) * s
        m[3, 3] = 1.0
        m[:3, 3] = (tx, ty, tz)
        return m

    transforms = [tf(0, 0, 0), tf(1.5, 0.2, -0.3, 0.7),
                  tf(-1.2, -0.5, 0.8, 1.3)]
    kw = {"device": "cpu"} if pkg == "cadrays_tpu_torch" else {}
    return build([mesh] * 3, transforms, [mat(kd=(1, 1, 1))], [0, 0, 0],
                 **kw)


def _squashed(pkg, instancing):
    """tests/test_instances.py:59-78: one sphere under diag(3, 1, 0.5)."""
    mat = __import__(f"{pkg}.core.bsdf", fromlist=["material"]).material
    Camera = __import__(f"{pkg}.core.camera", fromlist=["Camera"]).Camera
    light = __import__(f"{pkg}.core.lights",
                       fromlist=["directional_light"]).directional_light
    prim = __import__(f"{pkg}.geometry.primitives", fromlist=["sphere"])
    Scene = __import__(f"{pkg}.scene.scene", fromlist=["Scene"]).Scene
    sc = Scene()
    sc.clear_lights()
    sc.add_light(light(direction=(0, 0, -1), intensity=2.0))
    tf = np.diag([3.0, 1.0, 0.5, 1.0]).astype(np.float32)
    sc.add_mesh("squashed", prim.sphere(1.0, 24, 12),
                mat(kd=(0.7, 0.7, 0.7)), tf)
    cam = Camera.look_at(eye=(0, 0, 6), at=(0, 0, 0), up=(0, 1, 0),
                         fovy_deg=45.0)
    kw = {"device": "cpu"} if pkg == "cadrays_tpu_torch" else {}
    return sc.flatten(cam, instancing=instancing, **kw), cam


def _build(name):
    """(reference SceneData, port SceneData, port camera or None)."""
    if name == "cornell":
        from cadrays_tpu.testing.scenes import cornell_box as jcornell
        from cadrays_tpu.testing.scenes import cornell_camera as jcam
        from cadrays_tpu_torch.testing.scenes import (cornell_box,
                                                      cornell_camera)

        return (jcornell(full=False).flatten(jcam(), instancing=True),
                cornell_box(full=False).flatten(
                    cornell_camera(), instancing=True, device="cpu"))
    if name == "torus_grid":
        from cadrays_tpu_torch.testing.scenes import torus_grid

        return (_torus_grid_ref(3, 24, 12, lit=True)[0],
                torus_grid(3, 24, 12, lit=True, device="cpu")[0])
    if name == "scaled_three":
        return _scaled_three("cadrays_tpu"), _scaled_three("cadrays_tpu_torch")
    return (_squashed("cadrays_tpu", True)[0],
            _squashed("cadrays_tpu_torch", True)[0])


SCENES = ("cornell", "torus_grid", "scaled_three", "squashed")


@pytest.fixture(scope="module")
def built():
    return {name: _build(name) for name in SCENES}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_tables_bit_equal(built, name):
    ref, port = built[name]
    g, pg = ref.geometry, port.geometry
    assert pg.instanced and g.instanced
    for f in dataclasses.fields(pg):
        want, got = getattr(g, f.name), getattr(pg, f.name)
        if isinstance(got, torch.Tensor):
            assert _bits(np.asarray(want)) == _bits(got.numpy()), f.name
        else:
            assert got == want, f.name
    assert port.emissive.count == ref.emissive.count
    np.testing.assert_array_equal(port.materials.kd.numpy(),
                                  np.asarray(ref.materials.kd))
    # the compact shared-BLAS table holds each (mesh, material) group once
    if name == "torus_grid":
        assert pg.wtris_packed.shape[0] == 24 * 12 * 2 + 128
        assert pg.tri_v.shape[0] == 9 * 24 * 12 * 2


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _rays(geom, n, seed):
    """n rays aimed at random points near the scene's triangles (world
    space), from origins spread around the scene's box; every 13th lane
    is dead (t_max = 0)."""
    rng = np.random.default_rng(seed)
    tf = geom.inst_tf.numpy()
    tri = rng.integers(0, geom.tri_v.shape[0], n)
    v = geom.vertices.numpy()[geom.tri_v.numpy()[tri]].mean(1)
    m = tf[geom.tri_inst.numpy()[tri]]
    target = np.einsum("nij,nj->ni", m[:, :, :3], v) + m[:, :, 3]
    lo, hi = geom.inst_lo.numpy().min(0), geom.inst_hi.numpy().max(0)
    pad = 0.25 * (hi - lo)
    o = rng.uniform(lo - pad, hi + pad, (n, 3)).astype(np.float32)
    d = target + rng.normal(0, 0.01 * (hi - lo).max(), (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = np.full(n, 1e30, np.float32)
    tm[::13] = 0.0
    return o, d, tm


def _inside64(geom, o, d, tri):
    """Float64 signed distance of each ray's hit point to the nearest
    edge of its (instanced) triangle, scaled by the cosine of incidence,
    and the hit's t."""
    tf = geom.inst_tf.numpy().astype(np.float64)
    full = np.zeros((tf.shape[0], 4, 4))
    full[:, :3] = tf
    full[:, 3, 3] = 1.0
    minv = np.linalg.inv(full)[geom.tri_inst.numpy()[tri]]
    o = np.einsum("nij,nj->ni", minv[:, :3, :3], o) + minv[:, :3, 3]
    d = np.einsum("nij,nj->ni", minv[:, :3, :3], d)
    v = geom.vertices.numpy().astype(np.float64)
    tv = geom.tri_v.numpy()[tri]
    p0, e1, e2 = v[tv[:, 0]], v[tv[:, 1]] - v[tv[:, 0]], v[tv[:, 2]] - v[tv[:, 0]]
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    tvec = o - p0
    qv = np.cross(tvec, e1)
    u = (tvec * pv).sum(-1) / det
    w = (d * qv).sum(-1) / det
    nrm = np.cross(e1, e2)
    cos = np.abs((d * nrm).sum(-1)) / (np.linalg.norm(nrm, axis=-1)
                                        * np.linalg.norm(d, axis=-1))
    return np.minimum(np.minimum(u, w), 1 - u - w) * cos, \
        (e2 * qv).sum(-1) / det


def _assert_closest(pgeom, o, d, got, want, what):
    """got, want: dicts of numpy arrays."""
    hit = want["tri"] >= 0
    np.testing.assert_array_equal(got["tri"] >= 0, hit, err_msg=what)
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=RTOL,
                               atol=ATOL, err_msg=what)
    diff = hit & (got["tri"] != want["tri"])
    if diff.any():
        # ties: equal t within a few ulp, the hit point on both triangles
        np.testing.assert_allclose(got["t"][diff], want["t"][diff],
                                   rtol=1e-6, atol=0, err_msg=what)
        for tri in (got["tri"][diff], want["tri"][diff]):
            inside, _ = _inside64(pgeom, o[diff].astype(np.float64),
                                  d[diff].astype(np.float64), tri)
            assert np.all(inside >= -ROUNDING), (what, inside.min())
    assert diff.sum() <= 0.01 * hit.sum(), (what, int(diff.sum()))


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _check_walkers(pg, o, d, tm, any_hit, walkers):
    """trace_wide_ref (b) against each of the other walkers' results."""
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    to, td, ttm = (torch.from_numpy(a) for a in (o, d, tm))
    got = _np(trace_wide_ref(pg, to, td, ttm, any_hit=any_hit))
    assert (got["tri"] >= 0).sum() > o.shape[0] // 8
    assert np.all(got["tri"][::13] == -1)
    for what, want in walkers.items():
        if any_hit:
            np.testing.assert_array_equal(got["tri"] >= 0, want["tri"] >= 0,
                                          err_msg=what)
        else:
            _assert_closest(pg, o, d, got, want, what)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_wide_ref_matches_both_gather_walks(built, name, any_hit):
    from cadrays_tpu.ops.traverse import trace_gather as jgather
    from cadrays_tpu_torch.ops.traverse import trace_gather
    from cadrays_tpu_torch.ops.wide import fits_wide

    ref, port = built[name]
    pg = port.geometry
    assert fits_wide(pg)
    o, d, tm = _rays(pg, 1024, seed=11)
    _check_walkers(pg, o, d, tm, any_hit, {
        f"{name}: reference trace_gather": _np(jgather(
            ref.geometry, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit=any_hit)),
        f"{name}: port trace_gather": _np(trace_gather(
            pg, *(torch.from_numpy(a) for a in (o, d, tm)),
            any_hit=any_hit))})


@pytest.mark.parametrize("name,n,any_hit", [("torus_grid", 2048, False),
                                            ("torus_grid", 2048, True),
                                            ("squashed", 512, False)])
def test_trace_wide_ref_matches_reference_kernel(built, name, n, any_hit):
    """Against the reference's Pallas kernel in interpret mode: one
    block (each call compiles the interpreted kernel for about 10 s on
    the CPU, so two scenes: the 3x3 torus grid, closest and any-hit, and
    the non-uniformly scaled sphere)."""
    from cadrays_tpu.ops.pallas_wide import trace_wide as jtrace_wide

    ref, port = built[name]
    o, d, tm = _rays(port.geometry, n, seed=13)
    _check_walkers(port.geometry, o, d, tm, any_hit, {
        f"{name}: reference trace_wide": _np(jtrace_wide(
            ref.geometry, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
            any_hit=any_hit, interpret=True, block=n))})


def test_finite_t_max_caps_instanced_hits(built):
    """A lane capped at half its hit distance misses; capped lanes agree
    with the port's gather walk at the same t_max."""
    from cadrays_tpu_torch.ops.traverse import trace_gather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    pg = built["scaled_three"][1].geometry
    o, d, _ = _rays(pg, 512, seed=3)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    full = trace_wide_ref(pg, to, td, torch.full((512,), 1e30))
    hit = full["tri"] >= 0
    tm = torch.where(hit, full["t"] * 0.5, 1e30)
    got = trace_wide_ref(pg, to, td, tm)
    assert int(hit.sum()) > 20
    assert bool((got["tri"][hit] == -1).all())
    assert torch.equal(got["tri"], trace_gather(pg, to, td, tm)["tri"])


def test_dispatch_on_instanced_scenes(built, backend):
    """"wide" and "bruteforce" reach K1 (b) (its plain version on the
    CPU); "pallas" falls through to "stream", which is not ported; K2
    and K3 refuse instanced scenes when called directly."""
    from cadrays_tpu_torch.ops import binary, bruteforce
    from cadrays_tpu_torch.ops.traverse import trace, trace_gather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    pg = built["scaled_three"][1].geometry
    o, d, tm = (torch.from_numpy(a) for a in _rays(pg, 256, 4))
    want = trace_wide_ref(pg, o, d, tm)
    for name in ("wide", "bruteforce"):
        backend(name)
        got = trace(pg, o, d, tm)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    backend("gather")
    got = trace(pg, o, d, tm)
    ref = trace_gather(pg, o, d, tm)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    for name in ("pallas", "stream"):
        backend(name)
        with pytest.raises(NotImplementedError, match="item 12"):
            trace(pg, o, d, tm)
    with pytest.raises(ValueError, match="instanced"):
        binary.trace_binary(pg, o, d, tm)
    with pytest.raises(ValueError, match="instanced"):
        bruteforce.trace_bruteforce(pg, o, d, tm)


def test_compact_tables_above_200k_rows_build_and_trace():
    """Above the reference's 200,000-row threshold, where its trace
    takes the streamed-triangle variant (c), the port builds the compact
    table with no padded (T, 128) copy, and K1's plain version walks it
    as the port's gather walk does."""
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.primitives import torus
    from cadrays_tpu_torch.ops.traverse import trace_gather
    from cadrays_tpu_torch.scene.instances import build_instanced

    mesh = torus(1.0, 0.35, 330, 310)  # 204,600 triangles
    tfs = [np.eye(4, dtype=np.float32) for _ in range(2)]
    tfs[1][:3, 3] = (2.5, 0.5, 0.3)
    pg = build_instanced([mesh, mesh], tfs, [material()], [0, 0],
                         device="cpu").geometry
    assert pg.wtris_packed.shape[0] == 204_600 + 128 > 200_000
    assert tuple(pg.wtris_hbm.shape) == (1, 128)
    o, d, tm = _rays(pg, 1024, seed=23)
    for any_hit in (False, True):
        _check_walkers(pg, o, d, tm, any_hit, {"port trace_gather": _np(
            trace_gather(pg, *(torch.from_numpy(a) for a in (o, d, tm)),
                         any_hit=any_hit))})


def test_compact_table_row_limit():
    """Leaves pack their first row in 24 bits: a compact table of 2^24
    rows (Tw + 128 >= 2^24) raises, one row fewer builds."""
    from cadrays_tpu_torch.scene.instances import _check_compact_rows

    _check_compact_rows((1 << 24) - 1)
    with pytest.raises(ValueError, match="2\\^24"):
        _check_compact_rows(1 << 24)


def test_coherence_key_reads_the_tlas_root(built):
    from cadrays_tpu.ops.traverse import _coherence_key as jkey
    from cadrays_tpu_torch.ops.traverse import _coherence_key

    ref, port = built["torus_grid"]
    pg = port.geometry
    # node 0 of the fused array is the TLAS root: the union of the
    # instances' world boxes
    root = pg.nodes_packed[0]
    assert torch.equal(root[0:3], pg.inst_lo.amin(0))
    assert torch.equal(root[3:6], pg.inst_hi.amax(0))
    o, d, _ = _rays(pg, 512, seed=9)
    got = _coherence_key(pg, torch.from_numpy(o), torch.from_numpy(d))
    want = jkey(ref.geometry, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# hit attributes, shading rows, carried state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["torus_grid", "squashed"])
def test_hit_attributes_match_reference(built, name):
    from cadrays_tpu.ops.hit import build_shade_table as jtable
    from cadrays_tpu.ops.hit import hit_attributes as jattrs
    from cadrays_tpu.ops.hit import hit_attributes_packed as jpacked
    from cadrays_tpu_torch.ops.hit import (build_shade_table,
                                           hit_attributes_packed)
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    ref, port = built[name]
    g, pg = ref.geometry, port.geometry
    jtab = jtable(g, ref.materials)
    tab = build_shade_table(pg, port.materials)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    # the last column is the instance id
    np.testing.assert_array_equal(tab[:, -1].numpy(), pg.tri_inst.numpy())

    o, d, tm = _rays(pg, 1024, seed=21)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tri = trace_wide_ref(pg, to, td, torch.from_numpy(tm))["tri"]
    assert int((tri >= 0).sum()) > 50
    h, mat = hit_attributes_packed(pg, tab, to, td, tri)
    jh, jmat = jpacked(g, jtab, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(tri.numpy()))
    jh2 = jattrs(g, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri.numpy()))
    hit = tri.numpy() >= 0
    for k in ("t", "position", "n_geom", "n_shade", "uv"):
        for want in (jh, jh2):
            np.testing.assert_allclose(h[k].numpy()[hit],
                                       np.asarray(want[k])[hit],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
    for k in ("hit", "front"):
        np.testing.assert_array_equal(h[k].numpy(), np.asarray(jh[k]))
    np.testing.assert_array_equal(mat.kd.numpy(), np.asarray(jmat.kd))
    # t is world-parameterised: the world hit point lies at o + t d
    np.testing.assert_allclose(h["t"].numpy()[hit],
                               trace_wide_ref(pg, to, td, torch.from_numpy(
                                   tm))["t"].numpy()[hit], rtol=1e-4,
                               atol=1e-5)
    # normals are unit length and face the ray
    n = h["n_geom"].numpy()[hit]
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    assert np.all((n * d[hit]).sum(-1) <= 1e-6)


def test_scene_data_from_numpy_carries_the_reference_scene(built):
    """The reference's instanced SceneData, carried across as numpy
    arrays keyed by field path, traces as the port's own build does."""
    from cadrays_tpu_torch.ops.traverse import trace_gather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref
    from cadrays_tpu_torch.scene.flatten import scene_data_from_numpy

    ref, port = built["torus_grid"]
    arrays = {}
    for part in ("geometry", "materials", "lights", "envmap", "emissive",
                 "textures"):
        obj = getattr(ref, part)
        for f in dataclasses.fields(obj):
            arrays[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    carried = scene_data_from_numpy(arrays, device="cpu")
    cg, pg = carried.geometry, port.geometry
    assert cg.instanced and cg.wide_leaf == pg.wide_leaf == 64
    assert cg.wide_depth == pg.wide_depth
    for f in ("wtris_packed", "wdelta", "winst", "inst_inv", "inst_lo",
              "inst_hi", "inst_bridge", "node_inst", "tri_inst"):
        assert torch.equal(getattr(cg, f), getattr(pg, f)), f
    o, d, tm = (torch.from_numpy(a) for a in _rays(pg, 512, 5))
    for fn in (trace_wide_ref, trace_gather):
        a, b = fn(cg, o, d, tm), fn(pg, o, d, tm)
        for k in a:
            assert torch.equal(a[k], b[k]), (fn.__name__, k)


def test_flatten_returns_the_cached_snapshot_whatever_instancing_asks():
    """scene.py mirrors cadrays_tpu/scene/scene.py:201-202: an unchanged
    Scene returns its cached snapshot, whatever `instancing` asks."""
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    cam = cornell_camera()
    sc = cornell_box(full=False)
    baked = sc.flatten(cam, device="cpu")
    assert not sc.flatten(cam, instancing=True, device="cpu") \
        .geometry.instanced
    sc.touch()
    inst = sc.flatten(cam, instancing=True, device="cpu")
    assert inst.geometry.instanced
    assert sc.flatten(cam, device="cpu").geometry.instanced
    assert inst.geometry.num_triangles == baked.geometry.num_triangles


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["torus_grid", "cornell"])
def test_render_persistent_matches_reference(built, name):
    from cadrays_tpu.integrator.params import RenderParams as JParams
    from cadrays_tpu.integrator.persistent import render_persistent as jrender
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.persistent import render_persistent
    from cadrays_tpu_torch.testing.scenes import cornell_camera, torus_grid

    ref, port = built[name]
    if name == "torus_grid":
        jc = _torus_grid_ref(3, 24, 12, lit=True)[1]
        pc = torus_grid(3, 24, 12, lit=True, device="cpu")[1]
    else:
        jc, pc = jcam(), cornell_camera()
    W = H = 16
    spp, n_steps = 4, 4 * 4 + 4
    jimg, jcnt = jax.jit(
        lambda s: jrender(s, jc, JParams(ray_depth=4), W, H, spp, n_steps)
    )(ref)
    img, cnt = render_persistent(port, pc, RenderParams(ray_depth=4), W, H,
                                 spp, n_steps)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    a = np.asarray(jimg) / np.maximum(np.asarray(jcnt), 1)[:, None]
    b = img.numpy() / np.maximum(cnt.numpy(), 1)[:, None]
    assert np.isfinite(b).all()
    res = compare(b.reshape(H, W, 3), a.reshape(H, W, 3), pix_tol=0.02)
    assert res["match"], res
    assert b.mean() > 0.01, b.mean()  # lit surfaces, not only background


def test_instanced_renders_match_baked():
    """The port's instanced renders against its baked ones, as
    tests/test_instances.py:48-78 holds the reference's: the small
    Cornell box at 24x24, depth 3, 8 spp (at most 0.5% of pixels off by
    more than 5e-3), and the non-uniformly scaled sphere at depth 2
    (at most 2%: nearly all silhouette at this size)."""
    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.renderer import render_persistent_image
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    cam = cornell_camera()
    cases = [
        (cornell_box(full=False).flatten(cam, device="cpu"),
         cornell_box(full=False).flatten(cam, instancing=True, device="cpu"),
         cam, 3, 0.005),
        (_squashed("cadrays_tpu_torch", False)[0],
         *_squashed("cadrays_tpu_torch", True), 2, 0.02)]
    for baked, inst, c, depth, frac in cases:
        assert inst.geometry.instanced and not baked.geometry.instanced
        params = RenderParams(ray_depth=depth)
        img_b = render_persistent_image(baked, c, params, 24, 24, spp=8)
        img_i = render_persistent_image(inst, c, params, 24, 24, spp=8)
        bad = (img_i - img_b).abs().amax(-1) > 5e-3
        assert float(bad.float().mean()) < frac
        assert float(img_i.mean()) > 0.01
