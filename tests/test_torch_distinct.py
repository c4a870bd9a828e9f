"""The port's CAD assembly of distinct parts against the reference
(cadrays_tpu_torch.testing.scenes.distinct_parts, K1 variants (c) and
(d), ops/wide.trace_wide_rebinned).

- Tables: ``distinct_parts()`` builds every GeometryData field of the
  reference's bench/cad_distinct.py scene bit for bit, at its full size
  (54 parts, 611,136 triangles), except the reference's padded (T, 128)
  triangle table, which the port keeps as a placeholder.
- (c): ``trace_wide_ref`` against the reference's interpret-mode
  ``trace_wide(..., hbm_tris=True)`` on the 600-triangle mesh of
  tests/test_wide_bvh.py:146-164.
- (d): ``trace_wide_ref`` with a hand-built ``start`` table against the
  reference's ``trace_gather`` on a scene of the seeded instances alone.
- Rebinned: ``trace_wide_rebinned`` under the reference's own contract
  (tests/_rebinned_check.py): tri equal to ``trace_gather``'s, t at
  rtol 1e-4 / atol 1e-4, any-hit masks equal.
- Closest hits elsewhere: hit masks equal, t at rtol 1e-5 (atol 1e-6),
  tri equal except on ties, which need t within rtol 1e-6 and the
  float64 hit point on both triangles (the arbiter of
  tests/test_torch_bruteforce.py).
- A 16x16 render of a six-part assembly passes ``compare(pix_tol=0.02)``
  against the reference's.
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cadrays_tpu_torch.testing.regression import compare

ROUNDING = 2.0 ** -20  # float64 distance of a tie's hit point off a triangle
EMPTY = 0x7FFFFFFF


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


def _cad_distinct():
    """The reference's bench/cad_distinct.py, loaded by path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench", "cad_distinct.py")
    spec = importlib.util.spec_from_file_location("_cad_distinct", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def full():
    """(reference SceneData, its camera, port SceneData, its camera) of
    the full-size assembly."""
    from cadrays_tpu_torch.testing.scenes import distinct_parts

    ref, rcam = _cad_distinct().build_scene()
    port, pcam = distinct_parts(device="cpu")
    return ref, rcam, port, pcam


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _inside64(geom, o, d, tri):
    """Float64 signed distance of each ray's hit point to the nearest
    edge of its triangle (in the triangle's instance's space on an
    instanced scene), scaled by the cosine of incidence."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    if geom.instanced:
        tf = geom.inst_tf.numpy().astype(np.float64)
        m = np.zeros((tf.shape[0], 4, 4))
        m[:, :3] = tf
        m[:, 3, 3] = 1.0
        minv = np.linalg.inv(m)[geom.tri_inst.numpy()[tri]]
        o = np.einsum("nij,nj->ni", minv[:, :3, :3], o) + minv[:, :3, 3]
        d = np.einsum("nij,nj->ni", minv[:, :3, :3], d)
    v = geom.vertices.numpy().astype(np.float64)
    tv = geom.tri_v.numpy()[tri]
    p0 = v[tv[:, 0]]
    e1, e2 = v[tv[:, 1]] - p0, v[tv[:, 2]] - p0
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    tvec = o - p0
    qv = np.cross(tvec, e1)
    u = (tvec * pv).sum(-1) / det
    w = (d * qv).sum(-1) / det
    nrm = np.cross(e1, e2)
    cos = np.abs((d * nrm).sum(-1)) / (np.linalg.norm(nrm, axis=-1)
                                        * np.linalg.norm(d, axis=-1))
    return np.minimum(np.minimum(u, w), 1 - u - w) * cos


def _assert_closest(pgeom, o, d, got, want, what):
    """got, want: dicts of numpy arrays; tri ids of the port's tables."""
    hit = want["tri"] >= 0
    assert hit.sum() > 20, (what, int(hit.sum()))
    np.testing.assert_array_equal(got["tri"] >= 0, hit, err_msg=what)
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-5,
                               atol=1e-6, err_msg=what)
    diff = hit & (got["tri"] != want["tri"])
    if diff.any():
        np.testing.assert_allclose(got["t"][diff], want["t"][diff],
                                   rtol=1e-6, atol=0, err_msg=what)
        for tri in (got["tri"][diff], want["tri"][diff]):
            inside = _inside64(pgeom, o[diff], d[diff], tri)
            assert np.all(inside >= -ROUNDING), (what, inside.min())
    assert diff.sum() <= 0.01 * hit.sum(), (what, int(diff.sum()))


# ---------------------------------------------------------------------------
# tables at full size
# ---------------------------------------------------------------------------

def test_tables_bit_equal_at_full_size(full):
    ref, rcam, port, pcam = full
    g, pg = ref.geometry, port.geometry
    for f in dataclasses.fields(pg):
        want, got = getattr(g, f.name), getattr(pg, f.name)
        if f.name == "wtris_hbm":
            # the reference pads the compact table to 128 columns for its
            # TPU DMA; the port keeps the placeholder
            assert np.asarray(want).shape == (611_264, 128)
            assert tuple(got.shape) == (1, 128)
        elif isinstance(got, torch.Tensor):
            assert _bits(np.asarray(want)) == _bits(got.numpy()), f.name
        else:
            assert got == want, f.name
    assert pg.tri_v.shape[0] == 611_136 and pg.inst_inv.shape[0] == 54
    assert pg.wtris_packed.shape[0] == 611_264
    assert pg.wmeta.shape[0] == 3_483 and pg.wide_depth == 7
    assert pg.wide_leaf == 64 and pg.nodes_packed.shape[0] == 371_483
    assert tuple(pg.tris_hbm.shape) == (1, 128)
    for k in ("kd", "ks", "base_rough"):
        np.testing.assert_array_equal(getattr(port.materials, k).numpy(),
                                      np.asarray(getattr(ref.materials, k)))
    for f in dataclasses.fields(port.lights):
        np.testing.assert_allclose(getattr(port.lights, f.name).numpy(),
                                   np.asarray(getattr(ref.lights, f.name)),
                                   rtol=1e-6, err_msg=f.name)
    for k in ("eye", "at", "up", "fovy_deg"):
        np.testing.assert_allclose(np.asarray(getattr(pcam, k)),
                                   np.asarray(getattr(rcam, k)), rtol=1e-6)


def test_meshes_bit_equal_small_assembly():
    """``min_tris=0`` keeps the part families and seeds: the parts of a
    six-part assembly are the reference's (bench/cad_distinct.py:83-119)."""
    from cadrays_tpu_torch.testing.scenes import _distinct_meshes

    ref = _cad_distinct().build_parts(6, min_tris=0)
    port = _distinct_meshes(6, 0)
    assert len(port) == len(ref) == 6
    for a, b in zip(ref, port):
        for k in ("vertices", "indices", "normals", "uvs"):
            assert _bits(np.asarray(getattr(a, k))) == \
                _bits(getattr(b, k)), k


# ---------------------------------------------------------------------------
# K1 (c): a triangle table of any size
# ---------------------------------------------------------------------------

def test_variant_c_matches_reference_hbm_kernel():
    """tests/test_wide_bvh.py:146-164: the reference's streamed-triangle
    kernel in interpret mode on a 600-triangle mesh (closest hit; each
    call compiles the interpreted kernel for about 12 s), against the
    port's plain version of K1 over the (T, 12) table."""
    from cadrays_tpu.core.bsdf import material as jmaterial
    from cadrays_tpu.geometry.mesh import TriangleMesh as JMesh
    from cadrays_tpu.ops.pallas_wide import trace_wide as jtrace_wide
    from cadrays_tpu.scene.flatten import build_tris_hbm
    from cadrays_tpu.scene.flatten import flatten_parts as jflatten
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.mesh import TriangleMesh
    from cadrays_tpu_torch.ops.wide import trace_wide_ref
    from cadrays_tpu_torch.scene.flatten import flatten_parts

    rng = np.random.default_rng(31)
    base = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.1, (600, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1, (600, 3)).astype(np.float32)
    verts = np.concatenate([base, base + e1, base + e2])
    idx = np.arange(1800, dtype=np.int32).reshape(3, 600).T.copy()
    ref = jflatten([JMesh(verts, idx)], [jmaterial(kd=(1, 1, 1))], [0])
    rg = ref.geometry.replace(tris_hbm=build_tris_hbm(
        ref.geometry.tris_packed))
    pg = flatten_parts([TriangleMesh(verts, idx)], [material(kd=(1, 1, 1))],
                       [0], device="cpu").geometry
    assert tuple(pg.tris_hbm.shape) == (1, 128)

    rng = np.random.default_rng(37)
    o = rng.uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    d = rng.normal(0, 1, (256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(256, 1e30, np.float32)
    want = _np(jtrace_wide(rg, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(tm), interpret=True, hbm_tris=True))
    got = _np(trace_wide_ref(pg, *(torch.from_numpy(a) for a in (o, d, tm))))
    _assert_closest(pg, o, d, got, want, "hbm_tris")


# ---------------------------------------------------------------------------
# K1 (d) and the rebinned driver, on the fixture of tests/_rebinned_check.py
# ---------------------------------------------------------------------------

def _five(pkg, keep=range(5)):
    """tests/_rebinned_check.py:27-39: five distinct meshes, overlapping
    boxes, translated; ``keep`` builds the scene of some of them."""
    mat = __import__(f"{pkg}.core.bsdf", fromlist=["material"]).material
    prim = __import__(f"{pkg}.geometry.primitives",
                      fromlist=["box", "sphere", "torus"])
    build = __import__(f"{pkg}.scene.instances",
                       fromlist=["build_instanced"]).build_instanced
    meshes = [prim.box(1, 1, 1), prim.sphere(0.6, 12, 8),
              prim.torus(0.7, 0.25, 12, 8), prim.box(0.5, 2.0, 0.5),
              prim.sphere(0.4, 10, 6)]
    tfs = []
    for i in range(5):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (i * 0.9, (i % 2) * 0.8, 0.2 * i)
        tfs.append(m)
    keep = list(keep)
    kw = {"device": "cpu"} if pkg == "cadrays_tpu_torch" else {}
    return build([meshes[i] for i in keep], [tfs[i] for i in keep],
                 [mat()], [0] * len(keep), **kw)


def _rebin_rays(n, seed=7):
    """tests/_rebinned_check.py:44-48, drawn with numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, np.full(n, 1e30, np.float32)


def test_five_mesh_seeds_are_nodes_and_leaves():
    """The fixture's BLAS entries: the 12-triangle boxes are leaves, the
    others wide nodes, and both packages agree on them."""
    ref, port = _five("cadrays_tpu"), _five("cadrays_tpu_torch")
    bridge = port.geometry.inst_bridge.numpy()
    np.testing.assert_array_equal(bridge, np.asarray(
        ref.geometry.inst_bridge))
    assert list(bridge >= 0) == [True, False, False, True, False]
    assert list(bridge >> 24)[0] == 12


@pytest.mark.parametrize("any_hit", [False, True])
def test_variant_d_seeded_walks_only_the_seeded_instances(any_hit):
    """Four blocks of 96 rays: a wide-node seed (the torus), a leaf seed
    (the unit box), two seeds (a sphere's node over the tall box's leaf)
    and an empty row. Each block's rays are aimed at its instances. The
    oracle is the reference's trace_gather on the scene of the seeded
    instances alone, its tri ids moved to the full scene's."""
    from cadrays_tpu.ops.traverse import trace_gather as jgather
    from cadrays_tpu_torch.ops.wide import trace_wide_ref

    pg = _five("cadrays_tpu_torch").geometry
    bridge = pg.inst_bridge.numpy()
    rows = [(2,), (0,), (1, 3), ()]
    B = 96
    start = np.full((len(rows), 4), [EMPTY, 0, EMPTY, 0], np.int32)
    for r, inst in enumerate(rows):
        if inst:
            start[r, 0:2] = bridge[inst[-1]], inst[-1]
        if len(inst) == 2:
            start[r, 2:4] = bridge[inst[0]], inst[0]
    rng = np.random.default_rng(5)
    lo, hi = pg.inst_lo.numpy(), pg.inst_hi.numpy()
    o = np.zeros((len(rows) * B, 3), np.float32)
    d = np.zeros_like(o)
    for r, inst in enumerate(rows):
        aim = rng.choice(inst or [0], B)
        target = rng.uniform(lo[aim], hi[aim])
        src = rng.uniform(lo.min(0) - 1.0, hi.max(0) + 1.0, (B, 3))
        dd = target - src
        o[r * B:(r + 1) * B] = src
        d[r * B:(r + 1) * B] = dd / np.linalg.norm(dd, axis=-1,
                                                   keepdims=True)
    tm = np.full(o.shape[0], 1e30, np.float32)
    tm[::17] = 0.0
    got = _np(trace_wide_ref(pg, *(torch.from_numpy(a) for a in (o, d, tm)),
                             any_hit=any_hit, start=torch.from_numpy(start),
                             block=B))
    assert np.all(got["tri"][3 * B:] == -1)  # the empty row
    assert np.all(got["tri"][::17] == -1)
    full_off = {i: int(np.nonzero(pg.tri_inst.numpy() == i)[0].min())
                for i in range(5)}
    for r, inst in enumerate(rows[:3]):
        sub = _five("cadrays_tpu", keep=inst).geometry
        sl = slice(r * B, (r + 1) * B)
        want = _np(jgather(sub, jnp.asarray(o[sl]), jnp.asarray(d[sl]),
                           jnp.asarray(tm[sl]), any_hit=any_hit))
        # sub-scene id -> full-scene id: same BLAS order, other offset
        s_inst = np.asarray(sub.tri_inst)
        s_off = {k: int(np.nonzero(s_inst == k)[0].min())
                 for k in range(len(inst))}
        hit = want["tri"] >= 0
        k = s_inst[np.where(hit, want["tri"], 0)]
        want["tri"] = np.where(hit, want["tri"] + np.array(
            [full_off[inst[j]] - s_off[j] for j in range(len(inst))])[k], -1)
        part = {key: val[sl] for key, val in got.items()}
        if any_hit:
            np.testing.assert_array_equal(part["tri"] >= 0, hit)
        else:
            _assert_closest(pg, o[sl], d[sl], part, want, f"seeds {inst}")


@pytest.mark.parametrize("block", [128, 1])
@pytest.mark.parametrize("any_hit", [False, True])
def test_rebinned_matches_reference_gather(block, any_hit):
    """tests/_rebinned_check.py's contract on the port's driver."""
    from cadrays_tpu.ops.traverse import trace_gather as jgather
    from cadrays_tpu_torch.ops.wide import trace_wide_rebinned

    ref, port = _five("cadrays_tpu"), _five("cadrays_tpu_torch")
    o, d, tm = _rebin_rays(2048)
    stats = {}
    a = _np(trace_wide_rebinned(port.geometry, *(torch.from_numpy(x) for x in
                                                 (o, d, tm)),
                                any_hit=any_hit, block=block, stats=stats))
    b = _np(jgather(ref.geometry, jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(tm), any_hit=any_hit))
    assert stats["rounds"] >= 1
    assert (b["tri"] >= 0).sum() > 100
    if any_hit:
        np.testing.assert_array_equal(a["tri"] >= 0, b["tri"] >= 0)
        return
    np.testing.assert_array_equal(a["tri"], b["tri"])
    hit = b["tri"] >= 0
    np.testing.assert_allclose(a["t"][hit], b["t"][hit], rtol=1e-4,
                               atol=1e-4)


def test_rebinned_max_rounds_stops_early():
    """max_rounds cuts the rounds: a ray's best t only falls from one
    round to the next, and the full run tests candidates the first
    round leaves pending."""
    from cadrays_tpu_torch.ops.wide import trace_wide_rebinned

    pg = _five("cadrays_tpu_torch").geometry
    o, d, tm = (torch.from_numpy(a) for a in _rebin_rays(2048))
    res, rounds = [], []
    for m in (1, 2, 0):
        stats = {}
        res.append(trace_wide_rebinned(pg, o, d, tm, block=128,
                                       max_rounds=m, stats=stats))
        rounds.append(stats["rounds"])
    assert rounds[0] == 1 and rounds[1] == 2 and rounds[2] > 2, rounds
    for a, b in zip(res, res[1:]):
        assert bool((b["t"] <= a["t"]).all())
        kept = a["tri"] >= 0
        assert bool((b["tri"][kept] >= 0).all())
    assert int((res[2]["tri"] >= 0).sum()) > int((res[0]["tri"] >= 0).sum())


def test_rebinned_needs_instance_tables():
    from cadrays_tpu_torch.ops.wide import trace_wide_rebinned
    from cadrays_tpu_torch.testing.scenes import cornell_box

    g = cornell_box(full=False).flatten(device="cpu").geometry
    o = torch.zeros(4, 3)
    with pytest.raises(AssertionError, match="instance candidate"):
        trace_wide_rebinned(g, o, o + 1.0, torch.ones(4))


def test_start_table_is_checked():
    from cadrays_tpu_torch.ops.wide import trace_wide, trace_wide_ref

    pg = _five("cadrays_tpu_torch").geometry
    o, d, tm = (torch.from_numpy(a) for a in _rebin_rays(64))
    good = torch.tensor([[int(pg.inst_bridge[1]), 1, EMPTY, 0]] * 2,
                        dtype=torch.int32)
    trace_wide(pg, o, d, tm, start=good, block=32)
    for bad, block, what in [(good, 16, "cover"), (good.long(), 32, "int32"),
                             (good[:, :3], 32, "int32"), (good, 0, "block")]:
        for fn in (trace_wide, trace_wide_ref):
            with pytest.raises(ValueError, match=what):
                fn(pg, o, d, tm, start=bad, block=block)


def test_rebinned_on_the_full_assembly_matches_trace(full):
    """At full size, on 2,048 bounce rays (distinct_bounce_rays over a
    64x64 frame, every other pixel): the
    rebinned walk finds the closest hits of the walk from the root, tri
    equal except ties, t, u and v bit-equal where tri is."""
    from cadrays_tpu_torch.ops.wide import trace_wide_rebinned, trace_wide_ref
    from cadrays_tpu_torch.testing.scenes import distinct_bounce_rays

    _, _, port, pcam = full
    pg = port.geometry
    o, d = distinct_bounce_rays(pg, pcam, 64, 64, quarter=2)
    tm = torch.full((o.shape[0],), 1e30)
    stats = {}
    a = trace_wide_rebinned(pg, o, d, tm, block=32, stats=stats)
    b = trace_wide_ref(pg, o, d, tm)
    assert stats["rounds"] > 1
    same = a["tri"] == b["tri"]
    for k in ("t", "u", "v"):
        assert torch.equal(a[k][same], b[k][same]), k
    _assert_closest(pg, o.numpy(), d.numpy(), _np(a), _np(b), "rebinned")


# ---------------------------------------------------------------------------
# render, carried state
# ---------------------------------------------------------------------------

def _small_ref(n_parts):
    """bench/cad_distinct.py:122-151 at n_parts with no top-up, built by
    the reference from its own parts (build_scene always tops up to
    600k triangles)."""
    from cadrays_tpu.core.bsdf import material
    from cadrays_tpu.core.camera import Camera
    from cadrays_tpu.core.lights import positional_light
    from cadrays_tpu.scene.instances import build_instanced

    parts = _cad_distinct().build_parts(n_parts, min_tris=0)
    n = len(parts)
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(11)
    tfs = []
    for k in range(n):
        i, j = divmod(k, side)
        m = np.eye(4, dtype=np.float32)
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             np.float32) @ np.array(
            [[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m[:3, 3] = (i * 3.4, j * 3.4, rng.uniform(0.0, 1.2))
        tfs.append(m)
    mats = [material(kd=(0.75, 0.72, 0.68)),
            material(kd=(0.35, 0.45, 0.75), ks=(0.2, 0.2, 0.2),
                     base_rough=0.3)]
    ext = side * 3.4
    lights = positional_light(position=(ext / 2, -ext * 0.3, ext * 1.2),
                              intensity=900.0)
    data = build_instanced(parts, tfs, mats, [k % 2 for k in range(n)],
                           lights=lights)
    cam = Camera.look_at(eye=(ext / 2, -ext * 0.75, ext * 0.6),
                         at=(ext / 2, ext / 2, 0.4), up=(0, 0, 1),
                         fovy_deg=45.0)
    return data, cam


def test_small_assembly_renders_as_the_reference():
    from cadrays_tpu.integrator.params import RenderParams as JParams
    from cadrays_tpu.integrator.persistent import render_persistent as jrender
    from cadrays_tpu_torch.integrator.params import RenderParams
    from cadrays_tpu_torch.integrator.persistent import render_persistent
    from cadrays_tpu_torch.testing.scenes import distinct_parts

    ref, jc = _small_ref(6)
    port, pc = distinct_parts(n_parts=6, min_tris=0, device="cpu")
    for f in ("wtris_packed", "wmeta", "wboxes", "inst_bridge", "inst_lo"):
        assert _bits(np.asarray(getattr(ref.geometry, f))) == \
            _bits(getattr(port.geometry, f).numpy()), f
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
    assert b.mean() > 0.005, b.mean()  # lit parts, not only background


def test_scene_data_from_numpy_carries_the_reference_scene(full):
    """The reference's full-size SceneData, carried across as numpy
    arrays keyed by field path, drops the padded table and traces as the
    port's own build does."""
    from cadrays_tpu_torch.ops.wide import trace_wide_ref
    from cadrays_tpu_torch.scene.flatten import scene_data_from_numpy
    from cadrays_tpu_torch.testing.scenes import distinct_bounce_rays

    ref, _, port, pcam = full
    arrays = {}
    for part in ("geometry", "materials", "lights", "envmap", "emissive",
                 "textures"):
        obj = getattr(ref, part)
        for f in dataclasses.fields(obj):
            arrays[f"{part}.{f.name}"] = np.asarray(getattr(obj, f.name))
    assert arrays["geometry.wtris_hbm"].shape == (611_264, 128)
    carried = scene_data_from_numpy(arrays, device="cpu")
    cg, pg = carried.geometry, port.geometry
    assert tuple(cg.wtris_hbm.shape) == (1, 128)
    assert cg.instanced and cg.wide_depth == pg.wide_depth == 7
    for f in ("wtris_packed", "wboxes", "wmeta", "winst", "worder", "wdelta",
              "inst_inv", "inst_lo", "inst_hi", "inst_bridge"):
        assert torch.equal(getattr(cg, f), getattr(pg, f)), f
    o, d = distinct_bounce_rays(pg, pcam, 64, 64, quarter=4)
    tm = torch.full((o.shape[0],), 1e30)
    a, b = trace_wide_ref(cg, o, d, tm), trace_wide_ref(pg, o, d, tm)
    for k in a:
        assert torch.equal(a[k], b[k]), k
