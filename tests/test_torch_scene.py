"""Port's scene flattening against the reference (cadrays_tpu_torch.scene).

Every table of the full Cornell box must come out equal, bit for bit:
both packages build it in numpy with the same BVH builder. Scene data
carried across as numpy arrays (scene_data_from_numpy) must equal the
port's own flatten.
"""
import dataclasses
import fcntl
import subprocess

import numpy as np
import pytest
import torch


def _build_reference_native_libraries():
    """Build the reference's native libraries, complete, before any test
    of any worker loads them.

    The reference compiles each library straight to its final path when
    the file is missing or older than its source. Under pytest-xdist
    several workers can do that at once, and a worker that finds the
    half-written file fails to load it ("file too short"), in whichever
    test file first needs the library. Every worker imports this module
    while it collects, before it runs any test. So each worker calls the
    reference's own loader here, under an fcntl lock on the library's
    source: the first builds the library once, and the others find it
    complete and up to date. A failed build is left to the reference to
    report where a test needs the library.
    """
    from cadrays_tpu.modeling import csg
    from cadrays_tpu.native import build

    for src, load in ((build._SRC, build.load_library),
                      (csg._SRC, csg._load)):
        with open(src, "rb") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                load()
            except (OSError, RuntimeError, subprocess.SubprocessError):
                pass


_build_reference_native_libraries()


def _tree_to_numpy(obj, prefix=""):
    """Flatten a (flax) dataclass tree into {field path: numpy array},
    static fields included."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(_tree_to_numpy(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def both():
    from cadrays_tpu.testing.scenes import cornell_box as jcornell
    from cadrays_tpu.testing.scenes import cornell_camera as jcam
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    ref = jcornell(full=True, sphere_res=24).flatten(jcam())
    port = cornell_box(full=True, sphere_res=24).flatten(cornell_camera(),
                                                         device="cpu")
    return ref, port


TABLES = ["vertices", "normals", "uvs", "tri_v", "tri_mat", "bvh_min",
          "bvh_max", "bvh_skip", "bvh_first", "bvh_count", "nodes_packed",
          "tris_packed", "wboxes", "wmeta", "worder", "winst",
          "wtris_packed", "tris_hbm"]


@pytest.mark.parametrize("name", TABLES)
def test_geometry_table_bit_equal(both, name):
    ref, port = both
    a = np.asarray(getattr(ref.geometry, name))
    b = getattr(port.geometry, name).numpy()
    assert a.shape == b.shape
    # compare bit patterns: the packed tables hold bitcast ints
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_wide_tree_shape_and_statics(both):
    ref, port = both
    g = port.geometry
    assert g.wide_leaf == ref.geometry.wide_leaf == 64
    assert g.wide_depth == ref.geometry.wide_depth == 3
    assert g.instanced is False and ref.geometry.instanced is False
    assert g.tris_packed.shape == (4578, 12)
    assert g.nodes_packed.shape == (2691, 8)
    assert g.wboxes.shape == (33, 48)


def test_materials_lights_emissive_equal(both):
    ref, port = both
    r = _tree_to_numpy(ref)
    for sub in ("materials", "lights"):
        for f in dataclasses.fields(getattr(port, sub)):
            a = r[f"{sub}.{f.name}"]
            b = getattr(getattr(port, sub), f.name).numpy()
            np.testing.assert_array_equal(a, b, err_msg=f"{sub}.{f.name}")
    assert port.materials.kd.shape == (9, 3)
    assert port.emissive.count == ref.emissive.count == 0
    assert port.envmap.enabled is False and port.textures.enabled is False


def test_shade_table_equal(both):
    from cadrays_tpu.ops.hit import build_shade_table as jtable
    from cadrays_tpu_torch.ops.hit import build_shade_table

    ref, port = both
    a = np.asarray(jtable(ref.geometry, ref.materials))
    b = build_shade_table(port.geometry, port.materials).numpy()
    np.testing.assert_array_equal(a, b)


def test_scene_data_from_numpy_equals_flatten(both):
    from cadrays_tpu_torch.scene.flatten import scene_data_from_numpy

    ref, port = both
    carried = scene_data_from_numpy(_tree_to_numpy(ref), device="cpu")
    a = _tree_to_numpy(carried)
    b = _tree_to_numpy(port)
    assert set(a) == set(b)
    for k in sorted(b):
        if k == "version":
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_render_params_from_dict():
    from cadrays_tpu.integrator.params import RenderParams as JParams
    from cadrays_tpu_torch.integrator.params import render_params_from_dict

    jp = JParams(ray_depth=4).replace(seed=np.uint32(3000000000))
    p = render_params_from_dict(_tree_to_numpy(jp))
    assert p.ray_depth == 4 and p.seed == 3000000000
    assert p.radiance_clamp == 30.0 and p.background_color == (0.0, 0.0, 0.0)
    assert p.persistent is True and p.sort_every == 1


def test_flatten_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from cadrays_tpu_torch.testing.scenes import cornell_box

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cornell_box().flatten()
